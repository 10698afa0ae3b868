"""Hydragen-style batched shared-prefix decode attention (port of
``repro.kernels.hydragen``), as plain torch ops.

A distinct point in the shared-prefix design space (Juravsky et al.,
"Hydragen"; Ye et al., "ChunkAttention"): instead of CoDec's page-level
task scheduling, decompose decode attention into

1. **prefix phase** — for every *shared* forest node, attention of all
   sharing queries against the node's KV as ONE batched dense matmul.
   Every prefix token precedes every live query position, so no causal
   comparison is needed inside the matmul (only page-remainder validity,
   plus the sliding-window bound when ``window > 0``);
2. **suffix phase** — per-request attention over each request's private
   (single-query) KV slices, batched across requests;
3. **merge** — both phases emit flash partials ``(o, m, l)`` that the
   segment log-sum-exp reduction (``ref.combine_partials_stats_ref``)
   folds into exact full-softmax outputs.

``prepare`` consumes the existing ``DecodePlan`` task-major arrays and
splits tasks by sharing degree on the host: shared tasks
(``task_qnum > 1``) form the prefix batch, single-query tasks the suffix
batch.  Window pruning done by the planner carries over unchanged.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import ref as ref_mod

MASK_VALUE = ref_mod.MASK_VALUE


class HydragenArrays(NamedTuple):
    """Device arrays for the two phases (int64, shapes fixed per plan)."""

    # shared-prefix groups: (S, ...) — tasks with > 1 sharing query
    px_pages: torch.Tensor    # (S, max_pages) global page ids
    px_kvlen: torch.Tensor    # (S,) valid tokens in the slice
    px_pos: torch.Tensor      # (S,) absolute position of first token
    px_qnum: torch.Tensor     # (S,) live queries of the group
    px_gather: torch.Tensor   # (S, max_q) query rows (pad 0)
    px_qpos: torch.Tensor     # (S, max_q) absolute query positions
    px_seg: torch.Tensor      # (S * max_q,) segment ids (trash = B)

    # per-request suffixes: (U, ...) — single-query tasks
    sf_pages: torch.Tensor    # (U, max_pages)
    sf_kvlen: torch.Tensor    # (U,)
    sf_pos: torch.Tensor      # (U,)
    sf_gather: torch.Tensor   # (U,) the one query row
    sf_qpos: torch.Tensor     # (U,)
    sf_seg: torch.Tensor      # (U,)


def _bucket_rows(n: int) -> int:
    """Bucketed group count: smallest power of two >= n (0 stays 0).

    Both phase batches are padded to bucketed row counts so their shapes
    stay stable across plan rebuilds; padded rows are dead (``qnum 0`` /
    ``kvlen 0``, segment = trash) and fully masked.  An empty batch stays
    empty and its phase is skipped.
    """
    return 0 if n <= 0 else 1 << (n - 1).bit_length()


def prepare(plan, device="cuda") -> HydragenArrays:
    """Split a DecodePlan's tasks into prefix/suffix batches (host side)
    and upload them in one host-to-device copy."""
    T = plan.num_tasks
    max_q = plan.max_q
    trash = plan.num_queries
    qnum = np.asarray(plan.task_qnum[:T])
    seg = np.asarray(plan.seg_ids[:(T + 1) * max_q]).reshape(-1, max_q)[:T]
    shared = np.nonzero(qnum > 1)[0]
    single = np.nonzero(qnum == 1)[0]
    S, U = _bucket_rows(len(shared)), _bucket_rows(len(single))

    def rows(a, n, fill=0):
        a = np.asarray(a, np.int64)
        if a.shape[0] < n:
            pad = np.full((n - a.shape[0],) + a.shape[1:], fill, np.int64)
            a = np.concatenate([a, pad], 0)
        return a

    arrs = [
        rows(plan.task_pages[shared], S),
        rows(plan.task_kvlen[shared], S),
        rows(plan.task_pos[shared], S),
        rows(qnum[shared], S),
        rows(plan.q_gather[shared], S),
        rows(plan.q_pos[shared], S),
        rows(seg[shared].reshape(-1), S * max_q, fill=trash),
        rows(plan.task_pages[single], U),
        rows(plan.task_kvlen[single], U),
        rows(plan.task_pos[single], U),
        rows(plan.q_gather[single, 0], U),
        rows(plan.q_pos[single, 0], U),
        rows(seg[single, 0], U, fill=trash),
    ]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrs]))
    flat = flat.to(device)
    views, off = [], 0
    for a in arrs:
        views.append(flat[off:off + a.size].view(a.shape))
        off += a.size
    return HydragenArrays(*views)


def advance(ha: HydragenArrays, delta) -> HydragenArrays:
    """Advance all query positions by ``delta`` decode steps, device-side
    (dead slots advance too — they are masked by ``px_qnum`` / ``kvlen``)."""
    return ha._replace(px_qpos=ha.px_qpos + delta, sf_qpos=ha.sf_qpos + delta)


def _gather_kv(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """(P, page, n_kv, d)[(G, max_pages)] -> (G, n, n_kv, d)."""
    G, max_pages = pages.shape
    page = pool.shape[1]
    return pool[pages].reshape(G, max_pages * page, *pool.shape[2:])


def _prefix_phase(q, k_pool, v_pool, ha: HydragenArrays, window: int):
    """Batched dense matmul per shared node — no causal comparison.

    Returns flattened partials: o (S*max_q, h, d), m/l (S*max_q, h).
    """
    S, max_q = ha.px_gather.shape
    _, _, n_kv, d = k_pool.shape
    h_q = q.shape[1]
    group = h_q // n_kv
    scale = 1.0 / math.sqrt(d)

    k_t = _gather_kv(k_pool, ha.px_pages)                 # (S, n, kv, d)
    v_t = _gather_kv(v_pool, ha.px_pages)
    n = k_t.shape[1]
    qg = q[ha.px_gather].float()                          # (S, max_q, h, d)
    qf = (qg.reshape(S, max_q, n_kv, group, d)
          .permute(0, 2, 1, 3, 4)
          .reshape(S, n_kv, max_q * group, d))
    kf = k_t.float().permute(0, 2, 1, 3)                  # (S, kv, n, d)
    vf = v_t.float().permute(0, 2, 1, 3)

    # the Hydragen GEMM: every sharing query vs the whole node KV
    s = torch.einsum("shrd,shnd->shrn", qf, kf) * scale

    off = torch.arange(n, device=q.device)
    valid = off[None, :] < ha.px_kvlen[:, None]           # (S, n) padding
    mask = valid[:, None, :].expand(S, max_q, n)
    if window > 0:
        pos = ha.px_pos[:, None] + off[None, :]
        mask = mask & (pos[:, None, :] > ha.px_qpos[:, :, None] - window)
    mask_r = (mask[:, :, None, :].expand(S, max_q, group, n)
              .reshape(S, 1, max_q * group, n).expand_as(s))

    s = torch.where(mask_r, s, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask_r
    l = p.sum(dim=-1)
    u = torch.einsum("shrn,shnd->shrd", p, vf)
    o = u / torch.clamp(l, min=1e-30)[..., None]

    def unfold(x):
        tail = x.shape[3:]
        return (x.reshape(S, n_kv, max_q, group, *tail)
                .permute(0, 2, 1, 3, *(4 + i for i in range(len(tail))))
                .reshape(S * max_q, h_q, *tail))

    o, m, l = unfold(o), unfold(m), unfold(l)
    # dead query slots (slot >= qnum) must not pollute their gather row
    slot = torch.arange(max_q, device=q.device)
    live = (slot[None, :] < ha.px_qnum[:, None]).reshape(S * max_q)
    m = torch.where(live[:, None], m, MASK_VALUE)
    l = torch.where(live[:, None], l, 0.0)
    o = torch.where(live[:, None, None], o, 0.0)
    return o, m, l


def _suffix_phase(q, k_pool, v_pool, ha: HydragenArrays, window: int):
    """Per-request attention over private KV slices, batched over tasks.

    Returns o (U, h, d), m/l (U, h).  The causal bound IS applied here:
    a suffix slice may contain the query's own newest token.
    """
    U = ha.sf_gather.shape[0]
    _, _, n_kv, d = k_pool.shape
    h_q = q.shape[1]
    group = h_q // n_kv
    scale = 1.0 / math.sqrt(d)

    k_t = _gather_kv(k_pool, ha.sf_pages)                 # (U, n, kv, d)
    v_t = _gather_kv(v_pool, ha.sf_pages)
    n = k_t.shape[1]
    qf = q[ha.sf_gather].float().reshape(U, n_kv, group, d)
    kf = k_t.float().permute(0, 2, 1, 3)                  # (U, kv, n, d)
    vf = v_t.float().permute(0, 2, 1, 3)

    s = torch.einsum("shgd,shnd->shgn", qf, kf) * scale   # (U, kv, g, n)

    off = torch.arange(n, device=q.device)
    pos = ha.sf_pos[:, None] + off[None, :]               # (U, n)
    qp = ha.sf_qpos[:, None]
    mask = (off[None, :] < ha.sf_kvlen[:, None]) & (pos <= qp)
    if window > 0:
        mask = mask & (pos > qp - window)
    mask_r = mask[:, None, None, :].expand_as(s)

    s = torch.where(mask_r, s, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask_r
    l = p.sum(dim=-1)
    u = torch.einsum("shgn,shnd->shgd", p, vf)
    o = u / torch.clamp(l, min=1e-30)[..., None]
    return (o.reshape(U, h_q, d), m.reshape(U, h_q), l.reshape(U, h_q))


def hydragen_partials_arrays(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, ha: HydragenArrays,
                             num_queries: int, *, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Both phases + segment-LSE merge -> per-query (o, m, l)."""
    parts_o, parts_m, parts_l, segs = [], [], [], []
    if ha.px_pages.shape[0] > 0:               # an empty phase is skipped
        o, m, l = _prefix_phase(q, k_pool, v_pool, ha, window)
        parts_o.append(o); parts_m.append(m); parts_l.append(l)
        segs.append(ha.px_seg)
    if ha.sf_pages.shape[0] > 0:
        o, m, l = _suffix_phase(q, k_pool, v_pool, ha, window)
        parts_o.append(o); parts_m.append(m); parts_l.append(l)
        segs.append(ha.sf_seg)
    if not parts_o:                        # zero-task plan: all-trash
        h_q, d = q.shape[1], q.shape[2]
        dev = q.device
        parts_o = [torch.zeros((1, h_q, d), device=dev)]
        parts_m = [torch.full((1, h_q), MASK_VALUE, device=dev)]
        parts_l = [torch.zeros((1, h_q), device=dev)]
        segs = [torch.full((1,), num_queries, dtype=torch.int64, device=dev)]
    return ref_mod.combine_partials_stats_ref(
        torch.cat(parts_o), torch.cat(parts_m), torch.cat(parts_l),
        torch.cat(segs), num_queries)


def hydragen_partials(q, k_pool, v_pool, plan, prepared=None,
                      window: int = 0):
    """Registry entry point (plan + optional cached ``prepare`` output)."""
    if prepared is None:
        prepared = prepare(plan, q.device)
    return hydragen_partials_arrays(q, k_pool, v_pool, prepared,
                                    plan.num_queries, window=window)


def hydragen_attention(q, k_pool, v_pool, plan, *, window: int = 0,
                       prepared=None) -> torch.Tensor:
    """Full decode attention through the Hydragen decomposition."""
    o, _, _ = hydragen_partials(q, k_pool, v_pool, plan, prepared, window)
    return o.to(q.dtype)
