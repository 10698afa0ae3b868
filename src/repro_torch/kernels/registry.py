"""Pluggable decode-attention backend registry (port of
``repro.kernels.registry``).

Every decode-attention implementation is registered behind one interface
so the engine, the CLI and the tests resolve backends by *name*:

    backend = registry.get("codec-cuda")
    out = backend(q, k_pool, v_pool, plan, window=0)        # (B, h_q, d)

``partials`` returns per-query mergeable flash statistics ``(o, m, l)`` so
the serving engine can POR-merge a backend's frozen-plan output with its
per-step tail-page attention.  ``prepare(plan, device)`` uploads the host
``DecodePlan`` into the device arrays the backend consumes; the engine
caches the result across decode steps.

Registered backends: ``codec-cuda`` (the CUDA PAC kernel; the engine's
default), ``codec-torch`` (the plan as dense torch ops) and the python
oracle ``ref``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import ops
from . import ref as ref_mod


@dataclasses.dataclass(frozen=True)
class AttentionBackend:
    """One decode-attention implementation.

    ``partials_fn(q, k_pool, v_pool, plan, prepared, window)`` returns
    per-query flash statistics ``(o, m, l)`` — ``o`` normalised within the
    plan-covered KV — a valid partial for further POR merges.

    ``partials_arrays_fn(q, k_pool, v_pool, prepared, *, num_queries,
    window)`` consumes only the device arrays from ``prepare`` and
    ``advance_fn(prepared, delta)`` moves every query position by
    ``delta`` steps on the device; together they let a future fused step
    reuse one set of prepared arrays for a whole plan epoch.
    ``shardable`` marks backends whose partials are valid over one
    device's slice of the pool (none yet in this port).
    """

    name: str
    partials_fn: Callable[..., Tuple]
    prepare: Callable[..., Any] = ops.plan_arrays
    plan_kind: str = "codec"
    needs_plan: bool = True
    supports_window: bool = True
    supports_gqa: bool = True
    description: str = ""
    partials_arrays_fn: Optional[Callable[..., Tuple]] = None
    advance_fn: Optional[Callable[[Any, Any], Any]] = None
    shardable: bool = False

    @property
    def jit_safe(self) -> bool:
        """Whether the backend can run from prepared arrays alone."""
        return (self.partials_arrays_fn is not None
                and self.advance_fn is not None)

    def partials(self, q, k_pool, v_pool, plan, prepared=None, *,
                 window: int = 0):
        """Per-query mergeable (o, m, l) over the plan-covered KV."""
        if window and not self.supports_window:
            raise ValueError(
                f"backend {self.name!r} does not support sliding windows")
        if self.needs_plan and plan is None:
            raise ValueError(
                f"backend {self.name!r} requires a compiled DecodePlan")
        if prepared is None:
            prepared = self.prepare(plan, q.device)
        return self.partials_fn(q, k_pool, v_pool, plan, prepared, window)

    def __call__(self, q, k_pool, v_pool, plan, *, window: int = 0,
                 prepared=None) -> torch.Tensor:
        """Full decode attention: (B, h_q, d) -> (B, h_q, d)."""
        o, _, _ = self.partials(q, k_pool, v_pool, plan, prepared,
                                window=window)
        return o.to(q.dtype)


_REGISTRY: Dict[str, AttentionBackend] = {}


def register(backend: AttentionBackend) -> AttentionBackend:
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get(name: str) -> AttentionBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown attention backend {name!r}; "
            f"registered: {sorted(_REGISTRY)}") from None


def names(*, window: Optional[bool] = None,
          gqa: Optional[bool] = None,
          shardable: Optional[bool] = None) -> List[str]:
    """Registered backend names, optionally filtered by capability."""
    out = []
    for n, b in sorted(_REGISTRY.items()):
        if window is not None and b.supports_window != window:
            continue
        if gqa is not None and b.supports_gqa != gqa:
            continue
        if shardable is not None and b.shardable != shardable:
            continue
        out.append(n)
    return out


# --------------------------------------------------------------------- #
# built-in backends
# --------------------------------------------------------------------- #
def _codec_partials(impl: str):
    def fn(q, k_pool, v_pool, plan, pa, window):
        return ops.codec_partials_arrays(q, k_pool, v_pool, pa,
                                         plan.num_queries, window=window,
                                         impl=impl)
    return fn


def _codec_partials_arrays(impl: str):
    def fn(q, k_pool, v_pool, pa, *, num_queries, window):
        return ops.codec_partials_arrays(q, k_pool, v_pool, pa,
                                         num_queries, window=window,
                                         impl=impl)
    return fn


def _ref_partials(q, k_pool, v_pool, plan, prepared, window):
    return ref_mod.codec_ref_stats(q, k_pool, v_pool, plan, window=window)


register(AttentionBackend(
    name="codec-cuda",
    partials_fn=_codec_partials("cuda"),
    partials_arrays_fn=_codec_partials_arrays("cuda"),
    advance_fn=ops.advance_plan_arrays,
    description="CoDec PAC CUDA kernel over the lane-scheduled plan "
                "(its plain torch version for CPU tensors)"))

register(AttentionBackend(
    name="codec-torch",
    partials_fn=_codec_partials("torch"),
    partials_arrays_fn=_codec_partials_arrays("torch"),
    advance_fn=ops.advance_plan_arrays,
    description="CoDec plan semantics as dense torch ops"))

register(AttentionBackend(
    name="ref",
    partials_fn=_ref_partials,
    prepare=lambda plan, device: None,
    description="python-loop oracle (slow, exact)"))
