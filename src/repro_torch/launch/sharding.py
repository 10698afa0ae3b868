"""Partitioning rules (port of ``repro.launch.sharding``): parameter,
batch, cache and pool specs for every arch.

A spec is a tuple with one entry a tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names (the dimension
split over their product).  ``repro``'s ``PartitionSpec`` becomes this
plain tuple and its ``NamedSharding`` the pair (mesh, spec); no array
carries one outside the dry run.  The dry run (``launch/dryrun.py``)
divides each tensor by its spec (``shard_shape``) to reckon a device's
bytes, and on a mesh of more than one card partitions the step with
DTensor: ``placements`` turns a spec into one placement a mesh axis.

Scheme (per pod: mesh axes ``data`` x ``model``; two pods add ``pod``):

* TP over ``model``: attention heads, the FFN's hidden axis, the expert
  axis (EP), Mamba's inner channels, and ``d_model`` of the embedding;
* FSDP over ``data``: the other large axis of every weight matrix (and
  the embedding's vocabulary);
* DP over ``pod`` (and ``data``): the batch axis of tokens and caches;
* a decode cache splits its sequence over ``model`` (split-K decode), or
  over every axis when the batch does not divide (``long_500k``).

Rules match on the port's state-dict names (``layers.{i}.attn.wq.w``,
``layers.{i}.ffn.wi``, ``embed``), one layer a leaf: a port leaf's spec
is ``repro``'s for the period-stacked leaf without its leading
replicated axis.  ``repro``'s ``with_sharding`` and its activation
constraints (``layers.hint``, ``set_activation_mesh``) have no
counterpart: DTensor's sharding propagation places the activations.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..configs.base import ModelConfig
from .mesh import LaunchMesh

Entry = Any                       # None | str | Tuple[str, ...]
Spec = Tuple[Entry, ...]


def param_pspec(name: str, ndim: int, cfg: ModelConfig,
                fsdp: bool = True) -> Spec:
    """The spec of one parameter by its state-dict name (``repro``'s
    rules on its last three components)."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    gparent = parts[-3] if len(parts) > 2 else ""
    dp = "data" if fsdp else None

    def spec(*axes) -> Spec:
        return (None,) * (ndim - len(axes)) + tuple(axes)

    # embedding: vocab over data, d_model over model; the head transposed
    if leaf == "embed":
        return spec(dp, "model")
    if leaf == "lm_head":
        return spec("model", dp)

    # attention projections
    if parent in ("wq", "wk", "wv") or leaf in ("wq", "wk", "wv"):
        if leaf == "b":
            return spec("model")
        return spec(dp, "model")
    if parent == "wo" and gparent in ("attn", "xattn"):
        if leaf == "b":
            return spec(None)
        return spec("model", dp)

    # MoE: experts over model (EP)
    if leaf == "router":
        return spec(dp, None)
    if parent == "ffn" and leaf == "wi" and ndim >= 3:
        return spec("model", dp, None)
    if parent == "ffn" and leaf == "wo" and ndim >= 3:
        return spec("model", None, dp)

    # dense MLP
    if gparent == "ffn" and parent == "wi":
        return spec(dp, "model")
    if gparent == "ffn" and parent == "wo":
        return spec("model", dp)

    # mamba
    if parent == "in_proj":
        return spec(dp, "model")
    if parent == "out_proj":
        return spec("model", dp)
    if leaf == "conv_w":
        return spec(None, "model")
    if leaf in ("conv_b", "norm") and parent == "mamba":
        return spec("model")
    if leaf in ("A_log", "D", "dt_bias"):
        return spec("model")

    # norms and everything else small: replicated
    return ()


def _axis_size(mesh: LaunchMesh, entry: Entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= mesh.shape[a]
        return n
    return mesh.shape[entry]


def _entry(entry: Entry) -> Entry:
    """``PartitionSpec``'s normal form: a 1-tuple is its axis, an empty
    tuple ``None``."""
    if isinstance(entry, (tuple, list)):
        return None if not entry else (entry[0] if len(entry) == 1
                                       else tuple(entry))
    return entry


def legalize(spec: Spec, shape: Sequence[int], mesh: LaunchMesh) -> Spec:
    """One entry a dimension, dropping axes that do not divide it (an
    input's shards tile it exactly)."""
    out = []
    for i, dim in enumerate(shape):
        entry = _entry(spec[i]) if i < len(spec) else None
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec,
                mesh: LaunchMesh) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``spec`` (the
    counterpart of ``NamedSharding.shard_shape``); the spec must tile the
    shape exactly."""
    out = []
    for i, dim in enumerate(shape):
        n = _axis_size(mesh, spec[i] if i < len(spec) else None)
        if dim % n:
            raise ValueError(f"spec {spec} does not tile {tuple(shape)} on "
                             f"mesh {mesh.shape}")
        out.append(dim // n)
    return tuple(out)


def placements(spec: Spec, mesh: LaunchMesh) -> Tuple[Any, ...]:
    """DTensor placements of a (legalized) spec, one a mesh axis:
    ``Shard(d)`` on every axis that splits dimension ``d``, else
    ``Replicate()``.  A dimension split over several axes (``("pod",
    "data")``) is sharded on each in order, which DTensor reads as the
    first axis the major one, as ``shard_shape`` and ``repro``'s
    ``NamedSharding`` tile it; so the axes must come in the mesh's
    order."""
    from torch.distributed.tensor import Replicate, Shard
    out: List[Any] = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        entry = _entry(entry)
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dimension {d} "
                             f"are not in the mesh's order "
                             f"{mesh.axis_names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def params_shardings(params: Dict[str, torch.Tensor], mesh: LaunchMesh,
                     cfg: ModelConfig, fsdp: bool = True) -> Dict[str, Spec]:
    """The legalized spec of every tensor of ``params`` (any device,
    ``meta`` included), by name."""
    return {name: legalize(param_pspec(name, t.dim(), cfg, fsdp), t.shape,
                           mesh)
            for name, t in params.items()}


# --------------------------------------------------------------------- #
# batch / cache / pool
# --------------------------------------------------------------------- #
def batch_axes(mesh: LaunchMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_sharding(mesh: LaunchMesh, ndim: int, global_batch: int) -> Spec:
    """The leading batch dimension over (pod, data), or over the longest
    prefix of those axes that divides the batch."""
    axes = batch_axes(mesh)
    size = _axis_size(mesh, axes)
    if global_batch % size != 0 or global_batch < size:
        for cut in range(len(axes), 0, -1):
            sz = _axis_size(mesh, axes[:cut])
            if global_batch % sz == 0 and global_batch >= sz:
                axes = axes[:cut]
                break
        else:
            axes = ()
    return (_entry(axes),) + (None,) * (ndim - 1)


# a dense cache's attention tensors, head-major (B, Hkv, L, hd)
KV_KEYS = ("k", "v", "xk", "xv")


def _tail_rank(name: str) -> int:
    return {"k": 4, "v": 4, "xk": 4, "xv": 4, "conv": 3, "ssm": 4}.get(name, 0)


def cache_spec(name: str, shape: Sequence[int], mesh: LaunchMesh,
               global_batch: int) -> Spec:
    """The spec of one dense-cache tensor by its key: head-major ``k`` /
    ``v`` / ``xk`` / ``xv`` (B, Hkv, L, hd) batch over the data axes and
    sequence over ``model`` (every axis when the batch does not divide);
    a Mamba layer's ``conv`` (B, K-1, conv_dim) and ``ssm`` (B, H, P, S)
    batch over ``data`` (or nothing) and channels or heads over
    ``model``."""
    dp = batch_axes(mesh)
    dp_size = _axis_size(mesh, dp) if dp else 1
    batch_ok = global_batch % dp_size == 0 and global_batch >= dp_size
    ndim = len(shape)
    lead: List[Entry] = [None] * (ndim - _tail_rank(name))
    if name in KV_KEYS:
        if batch_ok:
            spec = lead + [dp if len(dp) > 1 else dp[0], None, "model", None]
        else:
            spec = lead + [None, None, tuple(list(dp) + ["model"]), None]
    elif name == "conv":
        spec = lead + [dp[0] if (batch_ok and dp) else None, None, "model"]
    elif name == "ssm":
        spec = lead + [dp[0] if (batch_ok and dp) else None, "model", None,
                       None]
    else:
        spec = [None] * ndim
    return legalize(tuple(spec), shape, mesh)


def cache_shardings(cache: List[Dict[str, torch.Tensor]], mesh: LaunchMesh,
                    cfg: ModelConfig, global_batch: int
                    ) -> List[Dict[str, Spec]]:
    """Specs of the port's dense decode cache (``transformer.init_cache``:
    one dict a layer), in its structure."""
    return [{key: cache_spec(key, t.shape, mesh, global_batch)
             for key, t in layer.items()} for layer in cache]


def paged_pool_spec(mesh: LaunchMesh, n_kv: int) -> Spec:
    """Spec of the serving engine's paged KV pool ``(n_attn, page_rows,
    page, n_kv, head_dim)``: page rows over ``data``, KV heads over
    ``model`` when they divide it; size-1 axes dropped and trailing
    ``None`` trimmed (``repro``'s normal form)."""
    shape = mesh.shape
    data = "data" if shape.get("data", 1) > 1 else None
    model = shape.get("model", 1)
    heads = "model" if model > 1 and n_kv % model == 0 else None
    spec = [None, data, None, heads, None]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def replicated(ndim: int = 0) -> Spec:
    return (None,) * ndim
