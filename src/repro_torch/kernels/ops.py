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

from typing import List, NamedTuple

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


def plan_host_arrays(plan, *, padded: bool = False) -> List[np.ndarray]:
    """A plan's int32 arrays in ``PlanArrays`` order, the CSR last.

    ``padded`` pads ``seg_rows`` to the plan's capacity, one entry per task
    slot (``task_qnum.shape[0] * max_q``), so that its length depends on
    the plan's shapes alone and not on how many slots are live: the fused
    step's fixed buffers need that.  The padding is never read: the
    epilogue and ``combine_parts`` read only the first ``seg_offsets[-1]``
    entries.
    """
    arrs = [np.ascontiguousarray(getattr(plan, f), dtype=np.int32)
            for f in PlanArrays._fields[:-2]]
    offsets, rows = plan_csr(plan)
    if padded:
        rows = np.pad(rows, (0, plan.task_qnum.shape[0] * plan.max_q
                             - rows.size))
    return arrs + [offsets, rows]


def _views(flat: torch.Tensor, arrs) -> List[torch.Tensor]:
    """Contiguous views of ``flat`` shaped as ``arrs``, in order."""
    views, off = [], 0
    for a in arrs:
        views.append(flat[off:off + a.size].view(a.shape))
        off += a.size
    return views


def upload(cls, arrs, device):
    """``cls`` over device views of the numpy arrays ``arrs`` (one dtype),
    packed into one buffer and uploaded in one host->device copy."""
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrs]))
    return cls(*_views(flat.to(device), arrs))


def plan_arrays(plan, device="cuda") -> PlanArrays:
    """Upload a plan's arrays, the CSR included, in one host->device
    copy."""
    return upload(PlanArrays, plan_host_arrays(plan), device)


class StaticArrays:
    """Device arrays at fixed addresses, refreshed from pinned host memory.

    A CUDA graph replays fixed pointers, so the fused decode step keeps
    each family of per-epoch arrays (a backend's prepared plan, the step's
    base) in one device buffer for as long as their shapes hold.  ``load``
    writes new values into a pinned host buffer and refreshes the device
    buffer from it with one asynchronous ``copy_`` on the current stream,
    outside any graph; it first waits until the previous copy has read the
    host buffer.  ``arrays`` is ``cls`` over views of the device buffer.
    On the CPU both buffers are plain tensors.
    """

    def __init__(self, cls, arrs, device):
        device = torch.device(device)
        self.shapes = tuple(a.shape for a in arrs)
        cuda = device.type == "cuda"
        host = torch.from_numpy(np.concatenate([a.ravel() for a in arrs]))
        self._host = host.pin_memory() if cuda else host
        self._dev = torch.empty_like(self._host, device=device)
        self.arrays = cls(*_views(self._dev, arrs))
        self._copied = torch.cuda.Event() if cuda else None
        self._copy()

    def _copy(self) -> None:
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def load(self, arrs) -> None:
        if tuple(a.shape for a in arrs) != self.shapes:
            raise ValueError(f"arrays of shapes {[a.shape for a in arrs]} "
                             f"do not fit the buffer's {self.shapes}")
        if self._copied is not None:
            self._copied.synchronize()
        np.concatenate([a.ravel() for a in arrs], out=self._host.numpy())
        self._copy()


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
    P = m.shape[0]
    dev = m.device
    # the query of each CSR entry (B past offsets[-1], where a padded CSR
    # holds unused entries: they are sent to a spare slot P), with no
    # host sync
    j = torch.arange(rows.shape[0], device=dev)
    seg = torch.full((P + 1,), B, dtype=torch.int64, device=dev)
    seg[torch.where(j < offsets[-1], rows.long(), P)] = torch.searchsorted(
        offsets[1:].long(), j, right=True)
    seg = seg[:P]
    live = seg < B
    m = torch.where(live[:, None], m, torch.full_like(m, MASK_VALUE))
    l = torch.where(live[:, None], l, torch.zeros_like(l))
    o = torch.where(live[:, None, None], o, torch.zeros_like(o))
    return ref_mod.combine_partials_stats_ref(o, m, l, seg, B)


def codec_parts_arrays(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, pa: PlanArrays, *,
                       window: int = 0, impl: str = "cuda",
                       out=None) -> Parts:
    """PAC over the plan -> its raw partials as ``Parts``.  Dead slots
    (padding, the trash row) are never finalised by the kernel: they hold
    ``torch.empty`` garbage, NaNs included, and no CSR row names them.
    ``out``: preallocated ``(o, m, l)`` for the CUDA kernel to write
    (``pac_outputs``); the plain versions allocate their own."""
    if impl == "cuda":
        kw = {} if out is None else {"out": out}
        o, m, l = pac_mod.pac(q, pa, k_pool, v_pool, window=window, **kw)
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


def pac_outputs(pa: PlanArrays, h_q: int, d: int, device):
    """Float32 ``(o, m, l)`` of the task-major shapes PAC writes for
    ``pa``, to be passed as its ``out``."""
    Tp1, max_q = pa.q_gather.shape
    return (torch.empty((Tp1, max_q, h_q, d), device=device),
            torch.empty((Tp1, max_q, h_q), device=device),
            torch.empty((Tp1, max_q, h_q), device=device))


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
