"""Plan arrays and the CoDec decode-attention op (port of
``repro.kernels.ops``).

``codec_parts_arrays`` runs the PAC stage over a compiled plan's device
arrays and returns the raw partials flattened to rows with the per-query
CSR over their live rows (``Parts``): what the engine's epilogue
(``por.por_epilogue``) consumes.  Two implementations of PAC:

* ``cuda``  — ``pac.pac``: the hand-written CUDA kernel on the card (its
              plain version for CPU tensors);
* ``torch`` — ``pac.pac_torch``: the same task/plan semantics as dense
              torch ops (the twin of ``repro``'s ``pac_xla``).

``codec_partials_arrays`` is the public op: those parts reduced to
per-query mergeable flash statistics ``(o, m, l)`` by the plain segment
log-sum-exp (``combine_parts``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import pac as pac_mod
from . import ref as ref_mod

MASK_VALUE = ref_mod.MASK_VALUE


class PlanArrays(NamedTuple):
    """Device copies of a DecodePlan's arrays (int32), with the per-query
    CSR over the live task slots (``plan_csr``)."""
    step_task: torch.Tensor
    step_page: torch.Tensor
    step_valid: torch.Tensor
    step_first: torch.Tensor
    step_last: torch.Tensor
    step_pos: torch.Tensor
    step_kvlen: torch.Tensor
    task_qnum: torch.Tensor
    task_npages: torch.Tensor
    task_kvlen: torch.Tensor
    task_pos: torch.Tensor
    task_pages: torch.Tensor
    q_gather: torch.Tensor
    q_pos: torch.Tensor
    seg_offsets: torch.Tensor   # (B+1,) query b's rows: seg_offsets[b]..
    seg_rows: torch.Tensor      # (nnz,) flattened task slots, ascending


class Parts(NamedTuple):
    """A backend's raw partials flattened to rows, and the CSR over the
    rows that belong to each query: query ``b`` reduces rows
    ``seg_rows[seg_offsets[b]:seg_offsets[b+1]]``.  Rows the CSR does not
    list (dead task slots, the trash row) are never read; they may hold
    NaN."""
    o: torch.Tensor             # (P, h, d) float32
    m: torch.Tensor             # (P, h)
    l: torch.Tensor             # (P, h)
    seg_offsets: torch.Tensor   # (B+1,) int32
    seg_rows: torch.Tensor      # (nnz,) int32


def plan_csr(plan):
    """(seg_offsets (B+1,), seg_rows (nnz,)) int32 from ``plan.seg_ids``:
    the flattened task slots whose id is a query (below ``num_queries``;
    dead slots and the trash row carry ``num_queries``), stably sorted by
    query, so every live slot appears once, in ascending order within its
    query."""
    seg = np.asarray(plan.seg_ids, np.int64)
    nq = plan.num_queries
    live = np.nonzero(seg < nq)[0]
    rows = live[np.argsort(seg[live], kind="stable")]
    offsets = np.zeros(nq + 1, np.int64)
    np.cumsum(np.bincount(seg[live], minlength=nq), out=offsets[1:])
    return offsets.astype(np.int32), rows.astype(np.int32)


def plan_arrays(plan, device="cuda") -> PlanArrays:
    """Upload a plan's arrays, the CSR included, in one host->device copy.

    The int32 arrays are packed into one buffer and split into contiguous
    views on the device.
    """
    arrs = [np.ascontiguousarray(getattr(plan, f), dtype=np.int32)
            for f in PlanArrays._fields[:-2]] + list(plan_csr(plan))
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrs]))
    flat = flat.to(device)
    views, off = [], 0
    for a in arrs:
        views.append(flat[off:off + a.size].view(a.shape))
        off += a.size
    return PlanArrays(*views)


def advance_plan_arrays(pa: PlanArrays, delta) -> PlanArrays:
    """Advance all query positions by ``delta`` steps, device-side.

    Dead q-slots advance too — harmless, they are masked out by
    ``task_qnum`` in every implementation.
    """
    return pa._replace(q_pos=pa.q_pos + delta)


def gather_queries(q: torch.Tensor, q_gather: torch.Tensor) -> torch.Tensor:
    """(B, h, d) -> task-major (T+1, max_q, h, d)."""
    return q[q_gather.long()]


def single_page_attention(q: torch.Tensor,        # (B, h_q, d)
                          k_pages: torch.Tensor,  # (B, page, n_kv, d)
                          v_pages: torch.Tensor,
                          pos_base: torch.Tensor,  # (B,) abs pos of page[0]
                          q_pos: torch.Tensor,     # (B,)
                          window: int = 0):
    """Per-request attention over one (tail) page -> partial (o, m, l).

    The engine's growing-tail path: the frozen CoDec plan covers all full
    pages; this covers each request's last partial page and the result is
    POR-merged with the frozen partials.  Row ``b`` equals
    ``ref.pac_ref(q[b:b+1], k_pages[b], v_pages[b], pos_base=pos_base[b],
    q_pos=q_pos[b:b+1])``, batched.
    """
    B, h_q, d = q.shape
    _, page, n_kv, _ = k_pages.shape
    group = h_q // n_kv
    scale = 1.0 / float(np.sqrt(d))
    qf = q.float().reshape(B, n_kv, group, d)
    kf = k_pages.float().permute(0, 2, 1, 3)            # (B, n_kv, page, d)
    vf = v_pages.float().permute(0, 2, 1, 3)
    s = torch.einsum("bhgd,bhnd->bhgn", qf, kf) * scale  # (B, n_kv, g, page)
    pos = pos_base.long()[:, None] + torch.arange(page, device=q.device)
    qp = q_pos.long()[:, None]
    mask = pos <= qp                                     # (B, page)
    if window > 0:
        mask = mask & (pos > qp - window)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1)                                   # (B, n_kv, g)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    u = torch.einsum("bhgn,bhnd->bhgd", p, vf)
    o = u / torch.clamp(l, min=1e-30)[..., None]
    return (o.reshape(B, h_q, d), m.reshape(B, h_q), l.reshape(B, h_q))


def identity_parts(o: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor) -> Parts:
    """Per-query statistics (B, h, d) / (B, h) as parts: one row a query."""
    B = o.shape[0]
    idx = torch.arange(B + 1, dtype=torch.int32, device=o.device)
    return Parts(o, m, l, idx, idx[:B])


def combine_parts(parts: Parts):
    """Segment-LSE reduction of parts -> per-query (o, m, l), as plain
    torch ops.  Rows outside the CSR are selected away (never multiplied:
    they may hold NaN) and reduce into the trash segment, as in
    ``repro``'s ``codec_partials_arrays``."""
    o, m, l, offsets, rows = parts
    B = offsets.shape[0] - 1
    dev = m.device
    seg = torch.full((m.shape[0],), B, dtype=torch.int64, device=dev)
    seg[rows.long()] = torch.repeat_interleave(
        torch.arange(B, device=dev), (offsets[1:] - offsets[:-1]).long(),
        output_size=rows.shape[0])
    live = seg < B
    m = torch.where(live[:, None], m, torch.full_like(m, MASK_VALUE))
    l = torch.where(live[:, None], l, torch.zeros_like(l))
    o = torch.where(live[:, None, None], o, torch.zeros_like(o))
    return ref_mod.combine_partials_stats_ref(o, m, l, seg, B)


def codec_parts_arrays(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, pa: PlanArrays, *,
                       window: int = 0, impl: str = "cuda") -> Parts:
    """PAC over the plan -> its raw partials as ``Parts``.  Dead slots
    (padding, the trash row) are never finalised by the kernel: they hold
    ``torch.empty`` garbage, NaNs included, and no CSR row names them."""
    if impl == "cuda":
        o, m, l = pac_mod.pac(q, pa, k_pool, v_pool, window=window)
    elif impl == "torch":
        o, m, l = pac_mod.pac_torch(gather_queries(q, pa.q_gather), pa.q_pos,
                                    k_pool, v_pool, pa.task_pages,
                                    pa.task_kvlen, pa.task_pos,
                                    window=window)
    else:
        raise ValueError(impl)
    P = o.shape[0] * o.shape[1]
    h, d = o.shape[2], o.shape[3]
    return Parts(o.reshape(P, h, d), m.reshape(P, h), l.reshape(P, h),
                 pa.seg_offsets, pa.seg_rows)


def codec_partials_arrays(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, pa: PlanArrays,
                          num_queries: int, *, window: int = 0,
                          impl: str = "cuda"):
    """Plan-covered attention -> per-query mergeable (o, m, l) stats."""
    parts = codec_parts_arrays(q, k_pool, v_pool, pa, window=window,
                               impl=impl)
    if parts.seg_offsets.shape[0] != num_queries + 1:
        raise ValueError(f"plan arrays hold {parts.seg_offsets.shape[0] - 1}"
                         f" queries, expected {num_queries}")
    return combine_parts(parts)


def codec_attention(q, k_pool, v_pool, plan, *, impl: str = "cuda",
                    window: int = 0) -> torch.Tensor:
    """Convenience entry taking a host DecodePlan object."""
    if impl == "ref":
        o, _, _ = ref_mod.codec_ref_stats(q, k_pool, v_pool, plan,
                                          window=window)
        return o.to(q.dtype)
    out, _, _ = codec_partials_arrays(q, k_pool, v_pool,
                                      plan_arrays(plan, q.device),
                                      plan.num_queries, window=window,
                                      impl=impl)
    return out.to(q.dtype)
