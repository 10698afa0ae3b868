"""Plain-torch oracles for the CoDec kernels (port of ``repro.kernels.ref``).

Everything here is deliberately simple and materialises full score
matrices; used as the ground truth for kernel tests and the ``ref``
attention backend.
"""

from __future__ import annotations

from typing import Optional, Tuple

import math

import numpy as np
import torch

# -inf would turn fully masked rows into NaN (exp(-inf - -inf)); the finite
# mask keeps them at p = 0, l = 0, o = 0.
MASK_VALUE = -1e30


def _fold_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(nq, h_q, d) -> (n_kv, nq*group, d); head h belongs to kv h//group."""
    nq, h_q, d = q.shape
    group = h_q // n_kv
    return (q.reshape(nq, n_kv, group, d)
             .permute(1, 0, 2, 3)
             .reshape(n_kv, nq * group, d))


def _unfold_gqa(x: torch.Tensor, nq: int) -> torch.Tensor:
    """(n_kv, nq*group, ...) -> (nq, h_q, ...)."""
    n_kv, rows = x.shape[:2]
    group = rows // nq
    tail = x.shape[2:]
    return (x.reshape(n_kv, nq, group, *tail)
             .permute(1, 0, 2, *(3 + i for i in range(len(tail))))
             .reshape(nq, n_kv * group, *tail))


def pac_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_len: Optional[int] = None,
            pos_base: int = 0,
            q_pos: Optional[torch.Tensor] = None,
            window: int = 0,
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention computation (paper Alg. 2) + flash statistics.

    q: (nq, h_q, d); k, v: (n, n_kv, d).  Returns (o, m, l) with
    o: (nq, h_q, d) normalised *within this node*, m: (nq, h_q) running
    max, l: (nq, h_q) softmax denominator at frame m.  ``kv_len`` masks
    padding rows of k/v; ``pos_base``/``q_pos``/``window`` implement the
    visibility mask of §4.1.
    """
    nq, h_q, d = q.shape
    n, n_kv, _ = k.shape
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = _fold_gqa(q.float(), n_kv)                          # (n_kv, R, d)
    kf = k.float().permute(1, 0, 2)                          # (n_kv, n, d)
    vf = v.float().permute(1, 0, 2)
    s = torch.einsum("hrd,hnd->hrn", qf, kf) * scale         # (n_kv, R, n)

    pos = pos_base + torch.arange(n, device=dev)
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if kv_len is None
             else pos < pos_base + kv_len)
    mask = valid[None, :].expand(nq, n)
    if q_pos is not None:
        qp = q_pos.to(device=dev, dtype=torch.int64)[:, None]
        mask = mask & (pos[None, :] <= qp)                   # causality
        if window and window > 0:
            mask = mask & (pos[None, :] > qp - window)
    group = h_q // n_kv
    mask_r = (mask.repeat_interleave(group, dim=0)
              .reshape(1, nq * group, n).expand(n_kv, nq * group, n))

    s = torch.where(mask_r, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1)                                       # (n_kv, R)
    p = torch.exp(s - m[..., None]) * mask_r
    l = p.sum(dim=-1)
    u = torch.einsum("hrn,hnd->hrd", p, vf)
    o = u / torch.clamp(l, min=1e-30)[..., None]
    return _unfold_gqa(o, nq), _unfold_gqa(m, nq), _unfold_gqa(l, nq)


def por_ref(o1, m1, l1, o2, m2, l2):
    """Partial output reduction (paper Alg. 3): LSE merge of two partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m) * l1
    a2 = torch.exp(m2 - m) * l2
    l = a1 + a2
    o = ((o1 * a1[..., None] + o2 * a2[..., None])
         / torch.clamp(l, min=1e-30)[..., None])
    return o, m, l


def combine_partials_stats_ref(o_parts, m_parts, l_parts, seg_ids,
                               num_queries: int):
    """Segment-LSE reduction returning per-query (o, m, l) partials.

    o_parts: (P, h, d); m/l: (P, h); seg_ids: (P,) in [0, num_queries]
    (num_queries = trash).  Returns ((B,h,d), (B,h), (B,h)) — itself a
    valid partial, so the result can be POR-merged with further partials
    (the engine's per-step tail page).

    On CUDA ``index_add_`` sums with atomics, in an order that changes from
    run to run: results agree with the CPU to about one ulp, not bitwise.
    """
    num_seg = num_queries + 1
    h = m_parts.shape[1]
    seg = seg_ids.to(device=m_parts.device, dtype=torch.int64)
    m_max = torch.full((num_seg, h), float("-inf"), dtype=m_parts.dtype,
                       device=m_parts.device)
    m_max = m_max.scatter_reduce(0, seg[:, None].expand(-1, h), m_parts,
                                 reduce="amax", include_self=True)
    m_max = torch.clamp(m_max, min=MASK_VALUE)   # empty segments -> guard
    alpha = torch.exp(m_parts - m_max[seg]) * l_parts
    denom = torch.zeros((num_seg, h), dtype=alpha.dtype,
                        device=alpha.device).index_add_(0, seg, alpha)
    numer = torch.zeros((num_seg,) + tuple(o_parts.shape[1:]),
                        dtype=o_parts.dtype, device=o_parts.device
                        ).index_add_(0, seg, o_parts * alpha[..., None])
    out = numer / torch.clamp(denom, min=1e-30)[..., None]
    return out[:num_queries], m_max[:num_queries], denom[:num_queries]


def codec_ref_stats(q, k_pool, v_pool, plan, window: int = 0):
    """Shared-prefix decode attention oracle driven by a DecodePlan.

    q: (B, h_q, d); pools: (P, page, n_kv, d).  Loops tasks in Python —
    slow, exact.  Returns per-query mergeable (o, m, l).
    """
    ps = plan.page_size
    dev = q.device
    parts_o, parts_m, parts_l, segs = [], [], [], []
    for t in range(plan.num_tasks):
        npages = int(plan.task_npages[t])
        kvlen = int(plan.task_kvlen[t])
        nq = int(plan.task_qnum[t])
        if nq == 0 or kvlen == 0:
            continue
        pages = torch.as_tensor(np.asarray(plan.task_pages[t, :npages]),
                                device=dev, dtype=torch.int64)
        k = k_pool[pages].reshape(npages * ps, *k_pool.shape[2:])
        v = v_pool[pages].reshape(npages * ps, *v_pool.shape[2:])
        rows = torch.as_tensor(np.asarray(plan.q_gather[t, :nq]),
                               device=dev, dtype=torch.int64)
        qp = torch.as_tensor(np.asarray(plan.q_pos[t, :nq]), device=dev)
        o, m, l = pac_ref(q[rows], k, v, kv_len=kvlen,
                          pos_base=int(plan.task_pos[t]), q_pos=qp,
                          window=window)
        parts_o.append(o)
        parts_m.append(m)
        parts_l.append(l)
        segs.append(rows)
    if not parts_o:   # nothing planned: every query gets the empty partial
        B, h_q, d = q.shape
        return (torch.zeros(B, h_q, d, device=dev),
                torch.full((B, h_q), MASK_VALUE, device=dev),
                torch.zeros(B, h_q, device=dev))
    return combine_partials_stats_ref(
        torch.cat(parts_o), torch.cat(parts_m), torch.cat(parts_l),
        torch.cat(segs), plan.num_queries)
