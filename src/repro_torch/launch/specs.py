"""input_specs(): every (arch x shape) cell's step and its arguments on the
``meta`` device, each with its spec (port of ``repro.launch.specs``).

``decode`` shapes run ``trainer.make_serve_step`` (one new token against
a dense cache of ``seq_len`` tokens), ``prefill`` a last-logit forward,
``train`` the whole train step (forward, backward, clip, optimizer).
Frontend stubs: a VLM's prefix patch embeddings and an audio model's
encoder frames are zeros made from the token batch.

Nothing is allocated: the arguments are meta tensors, and the step runs
on them to count FLOPs and track intermediate bytes (``op_stats``).
``repro``'s ``unroll`` (a scan unrolled for XLA's cost analysis) has no
counterpart here, since the port's layers are a Python loop.

``partitioned=True`` (with a ``DeviceMesh`` from ``mesh.device_mesh``)
makes every argument a DTensor whose local shard is rank 0's block of
its spec (``sharding.placements``): parameters, optimizer slots, tokens,
labels and the decode cache; the frontend stubs are made sharded like
the tokens.  The steps stay the port's own; DTensor's sharding
propagation partitions them, and ``op_stats`` counts rank 0's program.
A train cell's gradients are redistributed to their parameter's
placements as autograd makes them (a hook on each parameter): the
reduce-scatter an SPMD program gives a sharded parameter's gradient.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ..configs import get_config, shape_supported, skip_reason
from ..configs.base import ModelConfig
from ..configs.shapes import SHAPES, InputShape
from ..models import transformer as T
from ..training import optimizer as opt_mod
from ..training import trainer
from . import sharding as sh
from .mesh import LaunchMesh

# archs whose optimizer state must be factored to fit a card's memory
ADAFACTOR_ARCHS = {"kimi-k2-1t-a32b", "llava-next-34b", "qwen1.5-32b",
                   "jamba-v0.1-52b", "llama4-scout-17b-a16e"}
_I64, _F32 = torch.int64, torch.float32


@dataclasses.dataclass
class Output:
    """One output of a step: its shape, dtype and spec, whether it is an
    argument updated in place (``alias``), and the part of it the step
    writes (``written``: the shape of a decode cache's new column, else
    the whole)."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: sh.Spec
    alias: bool = False
    written: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class CellSpec:
    """A cell's step and its meta arguments: ``step_fn(*args)``.
    ``arg_specs`` holds the spec of every tensor of ``args`` by the path
    ``flat_args`` names it; ``outputs`` what the step returns or updates."""
    arch: str
    shape: InputShape
    step_fn: Callable
    args: Tuple
    kind: str                 # train | prefill | decode
    cfg: ModelConfig
    mesh: LaunchMesh
    arg_specs: Dict[str, sh.Spec]
    outputs: List[Output]
    opts: Dict
    device_mesh: Any = None     # the DeviceMesh of a partitioned cell

    @property
    def partitioned(self) -> bool:
        """Whether the arguments are DTensors over ``device_mesh``."""
        return self.device_mesh is not None

    def flat_args(self) -> Dict[str, torch.Tensor]:
        """Every tensor of ``args`` by path (the keys of ``arg_specs``)."""
        return flatten_args(self.kind, self.args)

    @property
    def local_batch(self) -> int:
        """The batch a device holds: the tokens' shard."""
        toks = self.flat_args()["tokens"]
        return sh.shard_shape(toks.shape, self.arg_specs["tokens"],
                              self.mesh)[0]


def _tree(pre: str, tree, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _tree(f"{pre}.{k}", v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _tree(f"{pre}.{i}", v, out)
    else:
        out[pre] = tree


def flatten_args(kind: str, args: Tuple) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if kind == "train":
        state, (tokens, labels) = args
        out["step"] = state.step
        _tree("params", state.params, out)
        _tree("opt", state.opt_state, out)
        out["tokens"], out["labels"] = tokens, labels
        return out
    model, tokens = args[0], args[1]
    _tree("params", dict(model.named_parameters()), out)
    out["tokens"] = tokens
    if kind == "decode":
        _tree("cache", args[2], out)
        out["cache_len"] = args[3]
    return out


def _extras_fn(cfg: ModelConfig, dtype: torch.dtype
               ) -> Optional[Callable[[torch.Tensor], Dict]]:
    """Stub frontend inputs as a function of the token batch (split over
    the batch as the tokens are, where they are a DTensor)."""
    key = {"vision": "prefix_embeds", "audio": "encoder_embeds"}.get(
        cfg.frontend)
    if key is None:
        return None

    def fn(tokens):
        shape = (tokens.shape[0], cfg.frontend_seq, cfg.d_model)
        if not hasattr(tokens, "placements"):
            return {key: torch.zeros(shape, dtype=dtype,
                                     device=tokens.device)}
        from torch.distributed.tensor import DTensor
        local = tokens.to_local()
        return {key: DTensor.from_local(
            torch.zeros((local.shape[0],) + shape[1:], dtype=dtype,
                        device=local.device),
            tokens.device_mesh, tokens.placements, run_check=False,
            shape=torch.Size(shape),
            stride=(shape[1] * shape[2], shape[2], 1))}
    return fn


def make_optimizer_for(arch: str, cfg: ModelConfig):
    kind = "adafactor" if arch in ADAFACTOR_ARCHS else "adamw"
    sched = opt_mod.cosine_schedule(3e-4, warmup=100, total=10000)
    return opt_mod.make_optimizer(kind, sched), kind


def reduced_config(cfg: ModelConfig, num_periods: int) -> ModelConfig:
    """The same arch with ``num_periods`` periods (remainder layers
    kept): the tests' cheap cells."""
    return dataclasses.replace(
        cfg, num_layers=num_periods * cfg.period + cfg.remainder_layers)


def _slot_spec(slot: str, ndim: int, pspec: sh.Spec) -> sh.Spec:
    """An optimizer slot's spec from its parameter's (``repro``'s
    ``_opt_shardings``): ``m``, ``v`` mirror it; Adafactor's ``vr`` (the
    parameter's shape less its last axis) and ``vc`` (less its second to
    last) drop the factored axis."""
    ps = list(pspec) + [None] * (len(pspec) + 2)
    if slot == "vc":
        return tuple(ps[:ndim - 1] + [ps[ndim]])
    return tuple(ps[:ndim])


def _opt_specs(opt_state: Dict, p_specs: Dict[str, sh.Spec]
               ) -> Dict[str, sh.Spec]:
    out: Dict[str, sh.Spec] = {}
    for k, v in opt_state.items():
        if k in ("m", "v"):
            for name, t in v.items():
                out[f"opt.{k}.{name}"] = p_specs[name]
        elif k == "slots":
            for name, slots in v.items():
                for s, t in slots.items():
                    out[f"opt.slots.{name}.{s}"] = _slot_spec(
                        s, t.dim(), p_specs[name])
        else:
            flat: Dict[str, torch.Tensor] = {}
            _tree(f"opt.{k}", v, flat)
            out.update({p: sh.replicated(t.dim()) for p, t in flat.items()})
    return out


def input_specs(arch: str, shape: Union[str, InputShape], mesh: LaunchMesh,
                *, microbatches: int = 1, remat: bool = True,
                num_periods: Optional[int] = None, ce_impl: str = "gather",
                fsdp: bool = True, moe_groups: int = 1,
                partitioned: bool = False, device_mesh=None,
                device: str = "meta",
                cfg: Optional[ModelConfig] = None) -> CellSpec:
    """The cell's step and its arguments on the meta device, with specs.
    ``shape``: a name of ``configs.shapes.SHAPES`` or an ``InputShape``;
    ``cfg``: a config in place of ``get_config(arch)`` (a smoke config).
    ``partitioned``: the arguments as DTensors over ``device_mesh`` (a
    ``DeviceMesh`` with the mesh's axes, ``mesh.device_mesh``), their
    local shards zeros on ``device`` (``meta``: nothing allocated)."""
    cell = _input_specs(arch, shape, mesh, microbatches=microbatches,
                        remat=remat, num_periods=num_periods,
                        ce_impl=ce_impl, fsdp=fsdp, moe_groups=moe_groups,
                        cfg=cfg)
    if not partitioned:
        return cell
    if device_mesh is None:
        raise ValueError("a partitioned cell needs a device_mesh "
                         "(launch.mesh.device_mesh)")
    return partition(cell, device_mesh, device)


def _dtensor(t: torch.Tensor, spec: sh.Spec, mesh: LaunchMesh, dmesh,
             device: str):
    """A DTensor of ``t``'s shape and dtype under ``spec``, its local
    shard zeros on ``device``."""
    from torch.distributed.tensor import DTensor
    spec = sh.legalize(spec, t.shape, mesh)
    local = torch.zeros(sh.shard_shape(t.shape, spec, mesh), dtype=t.dtype,
                        device=device)
    return DTensor.from_local(local, dmesh, sh.placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _grad_like(param, grad):
    """A parameter's gradient on the parameter's placements."""
    return grad.redistribute(param.device_mesh, param.placements)


def partition(cell: CellSpec, dmesh, device: str = "meta") -> CellSpec:
    """The cell with every argument a DTensor over ``dmesh`` (its spec's
    placements; local shards zeros on ``device``)."""
    mesh, specs = cell.mesh, cell.arg_specs

    def dt(path: str, t: torch.Tensor):
        return _dtensor(t.detach(), specs[path], mesh, dmesh, device)

    def tree(pre: str, x):
        if isinstance(x, dict):
            return {k: tree(f"{pre}.{k}", v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(tree(f"{pre}.{i}", v) for i, v in enumerate(x))
        return dt(pre, x)

    if cell.kind == "train":
        state, (tokens, labels) = cell.args
        params = {n: dt(f"params.{n}", p) for n, p in state.params.items()}
        new = trainer.make_state(cell.cfg, params,
                                 tree("opt", state.opt_state))
        new.step = dt("step", state.step)
        for p in new.params.values():
            p.register_hook(functools.partial(_grad_like, p))
        args = (new, (dt("tokens", tokens), dt("labels", labels)))
    else:
        model = T.Transformer.from_state_dict(cell.cfg, {
            n: dt(f"params.{n}", p)
            for n, p in cell.args[0].named_parameters()})
        args = (model, dt("tokens", cell.args[1]))
        if cell.kind == "decode":
            args += (tree("cache", cell.args[2]),
                     dt("cache_len", cell.args[3]))
    return dataclasses.replace(cell, args=args, device_mesh=dmesh)


def _input_specs(arch: str, shape: Union[str, InputShape],
                 mesh: LaunchMesh, *, microbatches: int, remat: bool,
                 num_periods: Optional[int], ce_impl: str, fsdp: bool,
                 moe_groups: int, cfg: Optional[ModelConfig]) -> CellSpec:
    cfg = cfg or get_config(arch)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if not shape_supported(cfg, shape.name):
        raise ValueError(f"{arch} skips {shape.name}: "
                         f"{skip_reason(cfg, shape.name)}")
    if num_periods is not None:
        cfg = reduced_config(cfg, num_periods)
    if moe_groups > 1 and cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_groups=moe_groups)
    opts = dict(microbatches=microbatches, remat=remat,
                num_periods=num_periods, ce_impl=ce_impl, fsdp=fsdp,
                moe_groups=moe_groups)
    dtype = T.torch_dtype(cfg)
    B, S = shape.global_batch, shape.seq_len
    extras = _extras_fn(cfg, dtype)
    tok_spec = sh.batch_sharding(mesh, 2, B)
    meta = dict(device="meta", dtype=_I64)

    if shape.kind == "train":
        optimizer, _ = make_optimizer_for(arch, cfg)
        state = trainer.abstract_state(cfg, optimizer)
        p_specs = sh.params_shardings(state.params, mesh, cfg, fsdp=fsdp)
        specs = {"step": sh.replicated(0)}
        specs.update({f"params.{n}": s for n, s in p_specs.items()})
        specs.update(_opt_specs(state.opt_state, p_specs))
        specs["tokens"] = specs["labels"] = tok_spec
        tokens = torch.empty((B, S), **meta)
        labels = torch.empty((B, S), **meta)
        step_fn = trainer.make_train_step(
            cfg, optimizer, microbatches=microbatches, remat=remat,
            extras_fn=extras, ce_impl=ce_impl)
        args = (state, (tokens, labels))
        outputs = [Output(p, tuple(t.shape), t.dtype, specs[p], alias=True)
                   for p, t in flatten_args("train", args).items()
                   if p not in ("tokens", "labels")]
        outputs += [Output(f"metrics.{k}", (), _F32, ())
                    for k in ("loss", "grad_norm", "ce", "moe_aux")]
        return CellSpec(arch, shape, step_fn, args, "train", cfg, mesh,
                        specs, outputs, opts)

    model = T.Transformer.from_state_dict(cfg, trainer.meta_params(cfg))
    p_specs = sh.params_shardings(dict(model.named_parameters()), mesh, cfg,
                                  fsdp=fsdp)
    specs = {f"params.{n}": s for n, s in p_specs.items()}
    specs["tokens"] = tok_spec
    V = cfg.vocab_size

    if shape.kind == "prefill":
        tokens = torch.empty((B, S), **meta)
        step_fn = trainer.make_prefill_step(cfg, extras)
        outputs = [Output("logits", (B, 1, V), _F32,
                          sh.batch_sharding(mesh, 3, B))]
        return CellSpec(arch, shape, step_fn, (model, tokens), "prefill",
                        cfg, mesh, specs, outputs, opts)

    # decode: one token against a dense cache of S tokens
    enc_len = cfg.frontend_seq if cfg.cross_attention else 0
    cache = T.init_cache(model, B, S, enc_len=enc_len)
    c_specs = sh.cache_shardings(cache, mesh, cfg, B)
    tokens = torch.empty((B, 1), **meta)
    cache_len = torch.empty((B,), **meta)
    len_spec = sh.batch_sharding(mesh, 1, B)
    outputs = [Output("logits", (B, V), _F32, sh.batch_sharding(mesh, 2, B))]
    for i, (layer, lspec) in enumerate(zip(cache, c_specs)):
        for key, t in layer.items():
            specs[f"cache.{i}.{key}"] = lspec[key]
            # k / v gain one column; xk / xv are read only; a Mamba
            # layer's conv and ssm states are replaced whole
            written = ((B, t.shape[1], 1, t.shape[3]) if key in ("k", "v")
                       else (0,) if key in ("xk", "xv") else None)
            outputs.append(Output(f"cache.{i}.{key}", tuple(t.shape),
                                  t.dtype, lspec[key], alias=True,
                                  written=written))
    specs["cache_len"] = len_spec
    outputs.append(Output("cache_len", (B,), _I64, len_spec))
    step_fn = trainer.make_serve_step(cfg)
    return CellSpec(arch, shape, step_fn, (model, tokens, cache, cache_len),
                    "decode", cfg, mesh, specs, outputs, opts)
