"""Plan arrays and the CoDec decode-attention op (port of
``repro.kernels.ops``).

``codec_partials_arrays`` is the public op: stacked decode queries + paged
KV pool + a compiled plan's device arrays -> per-query mergeable flash
statistics ``(o, m, l)``, with two implementations of the PAC stage:

* ``cuda``  — ``pac.pac``: the hand-written CUDA kernel on the card (its
              plain version for CPU tensors);
* ``torch`` — ``pac.pac_torch``: the same task/plan semantics as dense
              torch ops (the twin of ``repro``'s ``pac_xla``).

Both feed the flattened segment-LSE reduction (``combine_partials_stats``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import pac as pac_mod
from . import ref as ref_mod

MASK_VALUE = ref_mod.MASK_VALUE


class PlanArrays(NamedTuple):
    """Device copies of a DecodePlan's arrays (int32; ``seg_ids`` int64)."""
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
    seg_ids: torch.Tensor


def plan_arrays(plan, device="cuda") -> PlanArrays:
    """Upload a plan's arrays in one host->device copy.

    The int32 arrays are packed into one buffer and split into contiguous
    views on the device; ``seg_ids`` (indices of the segment reduction,
    which ``scatter_reduce`` wants as int64) travel as a second copy.
    """
    fields = PlanArrays._fields[:-1]
    arrs = [np.ascontiguousarray(getattr(plan, f), dtype=np.int32)
            for f in fields]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrs]))
    flat = flat.to(device)
    views, off = [], 0
    for a in arrs:
        views.append(flat[off:off + a.size].view(a.shape))
        off += a.size
    seg = torch.from_numpy(np.asarray(plan.seg_ids, np.int64)).to(device)
    return PlanArrays(*views, seg)


def advance_plan_arrays(pa: PlanArrays, delta) -> PlanArrays:
    """Advance all query positions by ``delta`` steps, device-side.

    Dead q-slots advance too — harmless, they are masked out by
    ``task_qnum`` in every implementation.
    """
    return pa._replace(q_pos=pa.q_pos + delta)


def gather_queries(q: torch.Tensor, q_gather: torch.Tensor) -> torch.Tensor:
    """(B, h, d) -> task-major (T+1, max_q, h, d)."""
    return q[q_gather.long()]


def combine_partials_stats(o_parts, m_parts, l_parts, seg_ids,
                           num_queries: int):
    """Segment-LSE reduction of task-major partials -> per-query (o, m, l)."""
    P = o_parts.shape[0] * o_parts.shape[1]
    h, d = o_parts.shape[2], o_parts.shape[3]
    return ref_mod.combine_partials_stats_ref(
        o_parts.reshape(P, h, d), m_parts.reshape(P, h),
        l_parts.reshape(P, h), seg_ids, num_queries)


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


def codec_partials_arrays(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, pa: PlanArrays,
                          num_queries: int, *, window: int = 0,
                          impl: str = "cuda"):
    """Plan-covered attention -> per-query mergeable (o, m, l) stats."""
    if impl == "cuda":
        o, m, l = pac_mod.pac(q, pa, k_pool, v_pool, window=window)
    elif impl == "torch":
        o, m, l = pac_mod.pac_torch(gather_queries(q, pa.q_gather), pa.q_pos,
                                    k_pool, v_pool, pa.task_pages,
                                    pa.task_kvlen, pa.task_pos,
                                    window=window)
    else:
        raise ValueError(impl)
    # dead slots (padding, the trash row) are never finalised by the
    # kernel: they hold torch.empty garbage, NaNs included.  Select, never
    # multiply, so nothing of them can reach a segment.
    slot = torch.arange(pa.q_gather.shape[1], device=q.device)
    live = slot[None, :] < pa.task_qnum[:, None]              # (T+1, max_q)
    m = torch.where(live[..., None], m, torch.full_like(m, MASK_VALUE))
    l = torch.where(live[..., None], l, torch.zeros_like(l))
    o = torch.where(live[..., None, None], o, torch.zeros_like(o))
    return combine_partials_stats(o, m, l, pa.seg_ids, num_queries)


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
