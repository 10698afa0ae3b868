"""Training step (port of ``repro.training.trainer``): loss, microbatch
accumulation, clip, update.

The port trains a ``Transformer``'s own parameters: ``TrainState.params``
are its ``nn.Parameter``s by state-dict name, with gradients switched on
(a model built for serving keeps them off), and ``train_step`` updates
them in place under ``torch.no_grad()``.  Gradients come from autograd
through the plain-torch model; ``remat`` recomputes each period of layers
in the backward pass (``Transformer.run(remat=True)``).

``repro`` accumulates microbatches with ``lax.scan`` or, for exact cost
accounting, a Python loop; both sum into float32 zeros in microbatch
order, which the port's one loop does.  So at ``microbatches > 1`` the
gradient that is clipped and fed to the optimizer is float32 even for
bf16 weights; at ``microbatches == 1`` it is in the weight's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..models import transformer as T
from . import optimizer as O

_F32 = torch.float32


@dataclasses.dataclass
class TrainState:
    """``step`` (0-d int32), ``params`` (the model's parameters by
    state-dict name: the very tensors ``model`` computes with),
    ``opt_state`` and the ``model`` itself."""
    step: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt_state: Dict
    model: Optional[T.Transformer] = dataclasses.field(default=None,
                                                       repr=False)

    def tree(self) -> Dict:
        """The saved part: ``step``, ``params`` and ``opt_state``."""
        return {"step": self.step, "params": self.params,
                "opt_state": self.opt_state}

    def with_tree(self, tree: Dict) -> "TrainState":
        """A new state on ``tree`` (the structure of ``tree()``) for this
        state's config."""
        return make_state(self.model.cfg, tree["params"],
                          tree["opt_state"], tree["step"])


def make_state(cfg: ModelConfig, params: Dict[str, torch.Tensor],
               opt_state: Dict, step=0) -> TrainState:
    """Wrap ``params`` (by state-dict name, no copy) in a ``Transformer``
    whose parameters require gradients."""
    model = T.Transformer.from_state_dict(
        cfg, {k: nn.Parameter(v.detach(), requires_grad=True)
              for k, v in params.items()})
    for p in model.parameters():
        p.requires_grad_(True)
    dev = model.embed.device
    step = torch.as_tensor(step, dtype=torch.int32).to(dev)
    return TrainState(step, dict(model.named_parameters()), opt_state,
                      model)


def init_state(cfg: ModelConfig, optimizer: O.Optimizer,
               generator: torch.Generator, device="cuda",
               dtype=None) -> TrainState:
    """Random weights from ``generator`` (on ``device``) and a fresh
    optimizer state."""
    params = T.init_params(cfg, generator, device=device, dtype=dtype)
    return make_state(cfg, params, optimizer.init(params))


def meta_params(cfg: ModelConfig, dtype=None) -> Dict[str, torch.Tensor]:
    """Every parameter as a ``meta`` tensor of its shape and of the dtype
    ``init_params`` gives it (float32 router and Mamba scalars)."""
    dtype = T.torch_dtype(cfg, dtype)
    params = {}
    for name, (shape, kind) in T.param_shapes(cfg).items():
        dt = _F32 if kind in ("router", "ones32", "zeros32") else dtype
        params[name] = torch.empty(shape, dtype=dt, device="meta")
    return params


def abstract_state(cfg: ModelConfig, optimizer: O.Optimizer,
                   dtype=None) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device: nothing is
    allocated (``state_bytes`` reads it)."""
    params = meta_params(cfg, dtype)
    return make_state(cfg, params, optimizer.init(params))


def state_bytes(state: TrainState) -> Dict[str, int]:
    """Bytes of the parameters and of the optimizer's state."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in O.leaves(tree))
    return {"params": nbytes(state.params),
            "opt_state": nbytes(state.opt_state),
            "n_params": sum(t.numel() for t in state.params.values())}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token CE. logits: (B, T, V) f32; labels: (B, T) int."""
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def cross_entropy_onehot(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """``repro``'s vocab-sharding-friendly CE (a one-hot contraction in
    place of the gather); numerically the same."""
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(),
                                         logits.shape[-1]).to(logits.dtype)
    gold = torch.einsum("btv,btv->bt", logits, onehot)
    return torch.mean(lse - gold)


CE_IMPLS = {"gather": cross_entropy, "onehot": cross_entropy_onehot}


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01,
                 remat: bool = True, ce_impl: str = "gather") -> Callable:
    """``loss_fn(model, tokens, labels, extras=None) -> (loss, {"ce",
    "moe_aux"})``: ``ce + aux_weight * moe_aux``."""
    ce_fn = CE_IMPLS[ce_impl]

    def loss_fn(model: T.Transformer, tokens, labels,
                extras: Optional[Dict] = None):
        extras = extras or {}
        logits, aux, _ = model.run(tokens, remat=remat, **extras)
        ce = ce_fn(logits, labels)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "moe_aux": aux}
    return loss_fn


def make_micro_step(cfg: ModelConfig, *, aux_weight: float = 0.01,
                    remat: bool = True, ce_impl: str = "gather",
                    extras_fn: Optional[Callable] = None) -> Callable:
    """``micro(state, tokens, labels) -> (loss, {"ce", "moe_aux"},
    grads)``: one microbatch's loss and metrics (0-d, detached) and its
    gradient by parameter name, in the weights' dtypes (zeros for a
    parameter the loss does not reach)."""
    loss_fn = make_loss_fn(cfg, aux_weight=aux_weight, remat=remat,
                           ce_impl=ce_impl)

    def micro(state: TrainState, tokens, labels):
        extras = extras_fn(tokens) if extras_fn else {}
        names = list(state.params)
        with torch.enable_grad():
            loss, met = loss_fn(state.model, tokens, labels, extras)
            grads = torch.autograd.grad(
                loss, [state.params[k] for k in names], allow_unused=True)
        grads = {k: (torch.zeros_like(state.params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        return loss.detach(), {k: v.detach() for k, v in met.items()}, grads
    return micro


def apply_update(state: TrainState, grads: Dict[str, torch.Tensor],
                 optimizer: O.Optimizer, clip_norm: float
                 ) -> torch.Tensor:
    """Clip ``grads`` by their global norm, update the optimizer state and
    add the updates to the weights in place, advance ``step``; returns
    the norm before clipping.  ``grads`` is emptied once clipped, so the
    unclipped gradient is freed before the optimizer's temporaries."""
    clipped, gnorm = O.clip_by_global_norm(grads, clip_norm)
    grads.clear()
    updates, state.opt_state = optimizer.update(clipped, state.opt_state,
                                                state.params)
    del clipped
    with torch.no_grad():
        for k, p in state.params.items():
            p.add_(updates.pop(k))
    state.step = state.step + 1
    return gnorm


def make_train_step(cfg: ModelConfig, optimizer: O.Optimizer, *,
                    microbatches: int = 1, remat: bool = True,
                    clip_norm: float = 1.0, aux_weight: float = 0.01,
                    extras_fn: Optional[Callable[[torch.Tensor], Dict]]
                    = None, ce_impl: str = "gather",
                    ) -> Callable[[TrainState, Tuple],
                                  Tuple[TrainState, Dict]]:
    """Build ``train_step(state, (tokens, labels)) -> (state, metrics)``:
    the state's weights and optimizer state are updated in place and its
    ``step`` advanced; ``metrics`` holds 0-d float32 ``loss``,
    ``grad_norm``, ``ce`` and ``moe_aux``.  ``microbatches > 1`` splits
    the batch and sums the gradients in float32 (activation memory /
    microbatches).  ``extras_fn`` makes stub frontend inputs (VLM prefix
    embeds, audio encoder frames) from a token batch."""
    micro = make_micro_step(cfg, aux_weight=aux_weight, remat=remat,
                            ce_impl=ce_impl, extras_fn=extras_fn)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        tokens, labels = batch
        if microbatches == 1:
            loss, met, grads = micro(state, tokens, labels)
        else:
            B = tokens.shape[0]
            assert B % microbatches == 0
            mb = B // microbatches
            dev = tokens.device
            loss = torch.zeros((), dtype=_F32, device=dev)
            met = {"ce": torch.zeros((), dtype=_F32, device=dev),
                   "moe_aux": torch.zeros((), dtype=_F32, device=dev)}
            grads = {k: torch.zeros(p.shape, dtype=_F32, device=p.device)
                     for k, p in state.params.items()}
            for i in range(microbatches):
                sl = slice(i * mb, (i + 1) * mb)
                l_i, m_i, g_i = micro(state, tokens[sl], labels[sl])
                loss = loss + l_i
                met = {k: met[k] + m_i[k] for k in met}
                for k, g in g_i.items():
                    grads[k] += g
                del g_i
            inv = 1.0 / microbatches
            loss = loss * inv
            met = {k: v * inv for k, v in met.items()}
            for g in grads.values():
                g.mul_(inv)
        gnorm = apply_update(state, grads, optimizer, clip_norm)
        return state, {"loss": loss, "grad_norm": gnorm, **met}

    return train_step


# --------------------------------------------------------------------- #
# inference steps over the trained model
# --------------------------------------------------------------------- #
def make_prefill_step(cfg: ModelConfig,
                      extras_fn: Optional[Callable] = None) -> Callable:
    """Full-prompt forward returning last-position logits (B, 1, V)."""
    @torch.no_grad()
    def prefill_step(model: T.Transformer, tokens):
        extras = extras_fn(tokens) if extras_fn else {}
        logits, _, _ = model.run(tokens, last_only=True, **extras)
        return logits
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode against a dense cache (``transformer.decode_step``:
    logits (B, V), the cache updated in place)."""
    def serve_step(model: T.Transformer, tokens, cache, cache_len):
        logits, new_cache = T.decode_step(model, tokens, cache, cache_len)
        return logits, new_cache, cache_len + 1
    return serve_step
