"""Pluggable decode-attention backend registry (port of
``repro.kernels.registry``).

Every decode-attention implementation is registered behind one interface
so the engine, the CLI and the tests resolve backends by *name*:

    backend = registry.get("codec-cuda")
    out = backend(q, k_pool, v_pool, plan, window=0)        # (B, h_q, d)

``parts`` returns a backend's raw partials with the per-query CSR over
them (``ops.Parts``): the serving engine hands them, with its per-step
tail page, to one ``por.por_epilogue`` call per layer.  ``partials``
returns the same reduced to per-query mergeable flash statistics
``(o, m, l)``.  ``prepare(plan, device)`` uploads the host
``DecodePlan`` into the device arrays the backend consumes; the engine
caches the result across decode steps.

Registered backends (five):

* ``codec-cuda`` — the CUDA PAC kernel over the CoDec plan (the engine's
  default);
* ``codec-torch`` — the same plan as dense torch ops;
* ``flash`` — the FlashDecoding baseline at the plan level: the same CUDA
  PAC kernel over ``core.plan.flash_plan`` (every request its own task
  chain, shared prefix KV re-read once per request), so on the card it
  differs from ``codec-cuda`` only in prefix sharing;
* ``hydragen`` — Hydragen's shared-prefix decomposition as torch ops;
* ``ref`` — the python-loop oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import hydragen as hydragen_mod
from . import ops
from . import ref as ref_mod


@dataclasses.dataclass(frozen=True)
class AttentionBackend:
    """One decode-attention implementation.

    ``partials_fn(q, k_pool, v_pool, plan, prepared, window)`` returns
    per-query flash statistics ``(o, m, l)`` — ``o`` normalised within the
    plan-covered KV — a valid partial for further POR merges.
    ``parts_fn`` (same arguments) returns the raw partials before that
    reduction as ``ops.Parts``; a backend without one reduces inside
    ``partials_fn`` and hands its per-query statistics on as one part a
    query (``ops.identity_parts``).

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
    parts_fn: Optional[Callable[..., "ops.Parts"]] = None
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

    def _prepared(self, q, plan, prepared, window):
        if window and not self.supports_window:
            raise ValueError(
                f"backend {self.name!r} does not support sliding windows")
        if self.needs_plan and plan is None:
            raise ValueError(
                f"backend {self.name!r} requires a compiled DecodePlan")
        return self.prepare(plan, q.device) if prepared is None else prepared

    def partials(self, q, k_pool, v_pool, plan, prepared=None, *,
                 window: int = 0):
        """Per-query mergeable (o, m, l) over the plan-covered KV."""
        prepared = self._prepared(q, plan, prepared, window)
        return self.partials_fn(q, k_pool, v_pool, plan, prepared, window)

    def parts(self, q, k_pool, v_pool, plan, prepared=None, *,
              window: int = 0) -> "ops.Parts":
        """Raw partials over the plan-covered KV with their per-query CSR,
        for ``por.por_epilogue``."""
        prepared = self._prepared(q, plan, prepared, window)
        if self.parts_fn is None:
            return ops.identity_parts(*self.partials_fn(
                q, k_pool, v_pool, plan, prepared, window))
        return self.parts_fn(q, k_pool, v_pool, plan, prepared, window)

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


def _codec_parts(impl: str):
    def fn(q, k_pool, v_pool, plan, pa, window):
        return ops.codec_parts_arrays(q, k_pool, v_pool, pa, window=window,
                                      impl=impl)
    return fn


def _codec_partials_arrays(impl: str):
    def fn(q, k_pool, v_pool, pa, *, num_queries, window):
        return ops.codec_partials_arrays(q, k_pool, v_pool, pa,
                                         num_queries, window=window,
                                         impl=impl)
    return fn


def _hydragen_partials_arrays(q, k_pool, v_pool, ha, *, num_queries,
                              window):
    return hydragen_mod.hydragen_partials_arrays(q, k_pool, v_pool, ha,
                                                 num_queries, window=window)


def _ref_partials(q, k_pool, v_pool, plan, prepared, window):
    return ref_mod.codec_ref_stats(q, k_pool, v_pool, plan, window=window)


register(AttentionBackend(
    name="codec-cuda",
    partials_fn=_codec_partials("cuda"),
    parts_fn=_codec_parts("cuda"),
    partials_arrays_fn=_codec_partials_arrays("cuda"),
    advance_fn=ops.advance_plan_arrays,
    description="CoDec PAC CUDA kernel over the lane-scheduled plan "
                "(its plain torch version for CPU tensors)"))

register(AttentionBackend(
    name="codec-torch",
    partials_fn=_codec_partials("torch"),
    parts_fn=_codec_parts("torch"),
    partials_arrays_fn=_codec_partials_arrays("torch"),
    advance_fn=ops.advance_plan_arrays,
    description="CoDec plan semantics as dense torch ops"))

register(AttentionBackend(
    name="flash",
    partials_fn=_codec_partials("cuda"),
    parts_fn=_codec_parts("cuda"),
    partials_arrays_fn=_codec_partials_arrays("cuda"),
    advance_fn=ops.advance_plan_arrays,
    plan_kind="flash",
    description="FlashDecoding baseline: the CUDA PAC kernel over the "
                "per-request plan, shared prefix KV re-read once per "
                "request"))

register(AttentionBackend(
    name="hydragen",
    partials_fn=hydragen_mod.hydragen_partials,
    prepare=hydragen_mod.prepare,
    partials_arrays_fn=_hydragen_partials_arrays,
    advance_fn=hydragen_mod.advance,
    description="Hydragen-style batched shared-prefix decomposition: "
                "one dense matmul per shared node for all sharing "
                "queries, per-request suffix attention, LSE merge"))

register(AttentionBackend(
    name="ref",
    partials_fn=_ref_partials,
    prepare=lambda plan, device: None,
    description="python-loop oracle (slow, exact)"))
