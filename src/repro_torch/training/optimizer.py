"""Optimizers (port of ``repro.training.optimizer``): init/update pairs
over dicts of tensors keyed by the model's state-dict names (nested dicts
work too).

AdamW for most archs; Adafactor (factored second moment, no first
moment) where full Adam state would not fit.  Plus global-norm clipping,
the cosine schedule with warmup, and the int8 gradient compression with
error feedback.

The arithmetic is ``repro``'s, step for step, in float32 tensor math:
the schedule and the bias corrections ``1 - b ** count`` are float32
tensor ops, as ``jnp`` takes them (Python float64 math parts in the last
bit); a division by a constant divides by a float32 tensor (a Python
divisor may become a multiplication by its reciprocal); a weight's update
is rounded to the weight's dtype before it is added.

``update`` writes each leaf's new moments into ``state``'s own tensors,
one leaf at a time, and returns that state: a 4B-parameter model never
holds two copies of its Adam moments, only one leaf's float32
temporaries.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Tree = Any
_F32 = torch.float32


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the leaves of ``rest`` at
    the same keys)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32, device=like.device)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1
                    ) -> Callable[[Any], torch.Tensor]:
    """``step -> lr`` as a float32 0-d tensor: linear warmup, then cosine
    decay to ``min_ratio * base_lr`` at ``total``."""
    def fn(step):
        step = torch.as_tensor(step).to(_F32)
        warm = base_lr * step / _f32(max(warmup, 1), step)
        frac = torch.clamp((step - warmup) / _f32(max(total - warmup, 1),
                                                   step), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(_F32)))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / norm)`` (in float32, cast
    back to the leaf's dtype); returns the scaled tree and the norm."""
    norm = global_norm(tree)
    scale = torch.minimum(_f32(1.0, norm),
                          _f32(max_norm, norm)
                          / torch.clamp(norm, min=1e-9))
    return _map(lambda x: (x.to(_F32) * scale).to(x.dtype), tree), norm


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def _zeros_like(p: torch.Tensor, dtype) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _count(params: Tree) -> torch.Tensor:
    dev = next(iter(leaves(params))).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(schedule: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """AdamW with float32 moments (``repro``'s default ``state_dtype``)."""
    def init(params):
        return {"m": _map(lambda p: _zeros_like(p, _F32), params),
                "v": _map(lambda p: _zeros_like(p, _F32), params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        lr = schedule(count)
        cf = count.to(_F32)
        c1 = 1 - torch.pow(_f32(b1, cf), cf)
        c2 = 1 - torch.pow(_f32(b2, cf), cf)

        def upd(g, m, v, p):
            # repro's ops in its order, each rounded to float32; the
            # moments are updated in place
            g = g.to(_F32)
            t = (1 - b1) * g
            m.mul_(b1).add_(t)                  # b1 m + (1 - b1) g
            torch.mul(g, 1 - b2, out=t).mul_(g)
            v.mul_(b2).add_(t)                  # b2 v + (1 - b2) g g
            step = m / c1
            step.div_(torch.div(v, c2, out=t).sqrt_().add_(eps))
            step.add_(torch.mul(p.to(_F32), weight_decay, out=t))
            return step.mul_(-lr).to(p.dtype)

        updates = _map(upd, grads, state["m"], state["v"], params)
        state["count"] = count
        return updates, state

    return Optimizer(init, update)


def adafactor(schedule: Callable, decay: float = 0.8, eps: float = 1e-30,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern): row and column
    statistics ``vr`` / ``vc`` for every leaf of two or more dimensions,
    a full ``v`` for the others."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(p):
            if _factored(p.shape):
                return {"vr": _zeros_like(p[..., 0], _F32),
                        "vc": _zeros_like(p[..., 0, :], _F32)}
            return {"v": _zeros_like(p, _F32)}
        return {"slots": _map(one, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        lr = schedule(count)
        beta = 1.0 - torch.pow(count.to(_F32), -decay)

        def one(g, p, slot):
            g = g.to(_F32)
            g2 = g * g + eps
            if _factored(p.shape):
                vr = beta * slot["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * slot["vc"] + (1 - beta) * g2.mean(-2)
                r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                step = g / (torch.sqrt(r)[..., None]
                            * torch.sqrt(vc)[..., None, :] + 1e-9)
                slot["vr"].copy_(vr)
                slot["vc"].copy_(vc)
            else:
                v = beta * slot["v"] + (1 - beta) * g2
                step = g / (torch.sqrt(v) + 1e-9)
                slot["v"].copy_(v)
            step = step + weight_decay * p.to(_F32)
            return (-lr * step).to(p.dtype)

        def walk(g, p, s):
            if isinstance(g, dict):
                return {k: walk(g[k], p[k], s[k]) for k in g}
            return one(g, p, s)

        updates = walk(grads, params, state["slots"])
        state["count"] = count
        return updates, state

    return Optimizer(init, update)


def make_optimizer(name: str, schedule: Callable, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(schedule, **kw)
    if name == "adafactor":
        return adafactor(schedule, **kw)
    raise ValueError(name)


# --------------------------------------------------------------------- #
# gradient compression (cross-pod DP all-reduce)
# --------------------------------------------------------------------- #
@torch.no_grad()
def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize g+err to int8 with a per-tensor scale; returns (q, scale,
    new_err).  Error feedback keeps the scheme unbiased over steps;
    rounding goes half to even, as ``jnp.round``."""
    gf = g.to(_F32) + err
    scale = (torch.clamp(torch.max(torch.abs(gf)), min=1e-12)
             / _f32(127.0, gf))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(_F32) * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale
