"""Sharded paged KV pool: pages over ``data``, KV heads over ``model``
(port of ``repro.distributed.kv_pool``).

Page rows are laid out as ``D`` blocks of ``pages_per_shard + 1`` rows,
one block a data shard; the last row of every block is that shard's
**trash page** (the write sink for padded rows and for the tail writes of
shards that do not hold a row's tail).  Global page row ``g`` lives on
shard ``g // stride`` as local row ``g % stride``.

The tensors lead with the model axis: ``k`` / ``v`` are ``(M, n_layers,
D * stride, page, n_kv / M, head_dim)``, so the slab of shard ``(d, m)``
in one layer, ``k[m, layer, d * stride:(d + 1) * stride]``, is one
contiguous ``(stride, page, n_kv / M, head_dim)`` tensor: PAC and the
epilogue run on it as on a single-device pool, with local page rows.
Host-side prefill and ``gather_context`` take global rows and write and
read across the slabs.  (``repro`` keeps one logical array with a
``NamedSharding`` and re-pins it at each plan epoch, ``canonicalize()``;
here the layout is the tensor's own and never drifts, so nothing of the
kind is needed.)

Allocation goes through one :class:`ShardedPageAllocator` over ``D``
per-shard :class:`~repro_torch.serving.kv_cache.PageAllocator`\\ s: the
single-device invariants (refcounts, free-list partition, ``check()``)
hold per shard.  Placement is deterministic: a node's pages stay on one
shard until its ``seq_split_pages`` quota is reached, then continue on
the next-freest shard, so a long shared prefix lands as runs of pages on
several shards: the sequence split that the plan partitioner turns into a
cross-shard POR merge.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..serving.kv_cache import PageAllocator, PagedKVPool


class ShardedPageAllocator:
    """Facade over per-shard allocators with a placement policy.

    Page ids are global *rows* into the pool array: row ``g`` lives on
    shard ``g // stride`` as local row ``g % stride`` where ``stride =
    pages_per_shard + 1`` (local row ``pages_per_shard`` is the shard's
    trash page and is never allocated).
    """

    def __init__(self, num_shards: int, pages_per_shard: int,
                 seq_split_pages: int = 0):
        self.num_shards = num_shards
        self.pages_per_shard = pages_per_shard
        self.stride = pages_per_shard + 1
        # quota of consecutive pages one affinity key keeps on a shard
        # before placement moves on (0 = only move when the shard fills)
        self.seq_split_pages = int(seq_split_pages)
        self.shards = [PageAllocator(pages_per_shard)
                       for _ in range(num_shards)]
        # hint (node id) -> [shard, pages placed there since last move,
        # live refcount over the hint's rows].  Insertion order doubles
        # as LRU order: entries are re-appended on every use, and the
        # size bound only evicts entries whose live count is zero — a
        # FIFO pop could drop a LIVE node's entry, resetting its
        # seq_split_pages quota and scattering later growth.
        self._affinity: Dict[int, List[int]] = {}
        self._row_hint: Dict[int, int] = {}     # global row -> hint

    # -- id mapping ---------------------------------------------------- #
    def shard_of(self, row: int) -> int:
        return row // self.stride

    def local_of(self, row: int) -> int:
        return row % self.stride

    # -- aggregate accounting (engine-facing API) ---------------------- #
    @property
    def num_pages(self) -> int:
        return self.num_shards * self.pages_per_shard

    @property
    def num_free(self) -> int:
        return sum(s.num_free for s in self.shards)

    @property
    def num_used(self) -> int:
        return sum(s.num_used for s in self.shards)

    @property
    def peak_used(self) -> int:
        return sum(s.peak_used for s in self.shards)

    @property
    def total_allocs(self) -> int:
        return sum(s.total_allocs for s in self.shards)

    def occupancy(self) -> float:
        return self.num_used / max(self.num_pages, 1)

    def shard_occupancy(self) -> List[float]:
        return [s.occupancy() for s in self.shards]

    # -- alloc / release ------------------------------------------------ #
    def _touch(self, hint: int) -> None:
        """LRU-touch: re-append the entry so the size bound sees it last."""
        self._affinity[hint] = self._affinity.pop(hint)

    def _pick(self, hint: Optional[int]) -> int:
        if hint is not None:
            st = self._affinity.get(hint)
            if (st is not None and self.shards[st[0]].num_free > 0
                    and (self.seq_split_pages <= 0
                         or st[1] < self.seq_split_pages)):
                self._touch(hint)
                return st[0]
        # next-freest shard, deterministic ties (lowest index); when an
        # affinity key moves on, exclude its current shard so a reached
        # quota really splits the run even if that shard is the freest
        prev = self._affinity.get(hint, [None, 0])[0] if hint is not None \
            else None
        best, best_free = -1, -1
        for i, s in enumerate(self.shards):
            if i == prev and any(j != prev and x.num_free > 0
                                 for j, x in enumerate(self.shards)):
                continue
            if s.num_free > best_free:
                best, best_free = i, s.num_free
        if best_free <= 0:
            raise MemoryError(
                f"KV pool exhausted: need 1, have {self.num_free}")
        if hint is not None:
            st = self._affinity.get(hint)
            if st is None:
                self._affinity[hint] = [best, 0, 0]
            else:
                st[0], st[1] = best, 0
                self._touch(hint)
            self._trim()
        return best

    def _trim(self) -> None:
        # bound on stale node ids: evict oldest entry with NO live pages
        # (live entries must keep their quota state — see _affinity)
        while len(self._affinity) > 8192:
            dead = next((k for k, v in self._affinity.items() if v[2] == 0),
                        None)
            if dead is None:
                return
            del self._affinity[dead]

    def alloc(self, n: int, hint: Optional[int] = None) -> List[int]:
        if n > self.num_free:
            raise MemoryError(
                f"KV pool exhausted: need {n}, have {self.num_free}")
        rows = []
        for _ in range(n):
            sh = self._pick(hint)
            local = self.shards[sh].alloc(1)[0]
            row = sh * self.stride + local
            if hint is not None:
                st = self._affinity[hint]
                st[1] += 1
                st[2] += 1
                self._row_hint[row] = hint
            rows.append(row)
        return rows

    def alloc_replicas(self, n: int,
                       hint: Optional[int] = None) -> Dict[int, List[int]]:
        """Allocate ``n`` pages on EVERY shard (replication placement).

        Returns ``{shard: [global rows]}`` with one ``n``-page run per
        shard.  All-or-nothing: raises ``MemoryError`` without touching
        any shard if one of them cannot fit ``n`` pages.  The affinity
        entry is pinned to the freest shard (the replica the scheduler
        treats as primary) and its live count covers ALL replica rows,
        so the entry survives the size bound while any replica lives.
        """
        if any(s.num_free < n for s in self.shards):
            raise MemoryError(
                f"KV pool exhausted for replication: need {n} pages on "
                f"each of {self.num_shards} shards, free per shard = "
                f"{[s.num_free for s in self.shards]}")
        primary = max(range(self.num_shards),
                      key=lambda i: (self.shards[i].num_free, -i))
        out: Dict[int, List[int]] = {}
        for sh in range(self.num_shards):
            locals_ = self.shards[sh].alloc(n)
            out[sh] = [sh * self.stride + lo for lo in locals_]
        if hint is not None:
            st = self._affinity.get(hint)
            if st is None:
                st = self._affinity[hint] = [primary, 0, 0]
            else:
                st[0] = primary
                self._touch(hint)
            for rows in out.values():
                for g in rows:
                    self._row_hint[g] = hint
                    st[2] += 1
            self._trim()
        return out

    def _by_shard(self, rows: List[int]) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for g in rows:
            sh, local = self.shard_of(g), self.local_of(g)
            if sh >= self.num_shards or local >= self.pages_per_shard:
                raise ValueError(f"page row {g} outside the pool")
            out.setdefault(sh, []).append(local)
        return out

    def retain(self, rows: List[int]) -> None:
        for sh, locals_ in self._by_shard(rows).items():
            self.shards[sh].retain(locals_)
        for g in rows:
            h = self._row_hint.get(g)
            if h is not None and h in self._affinity:
                self._affinity[h][2] += 1

    def release(self, rows: List[int]) -> None:
        for sh, locals_ in self._by_shard(rows).items():
            self.shards[sh].release(locals_)
        for g in rows:
            h = self._row_hint.get(g)
            if h is None:
                continue
            if self.local_of(g) not in self.shards[self.shard_of(g)]._refs:
                del self._row_hint[g]     # row fully freed
            st = self._affinity.get(h)
            if st is not None:
                st[2] = max(0, st[2] - 1)

    def used_page_ids(self) -> Dict[int, int]:
        """Allocated GLOBAL rows -> refcount across every shard (the
        engine's self-check compares this with forest page ownership)."""
        out: Dict[int, int] = {}
        for sh, s in enumerate(self.shards):
            for local, refs in s.used_page_ids().items():
                out[sh * self.stride + local] = refs
        return out

    def check(self) -> None:
        """Per-shard structural invariants (tests call after workloads)."""
        for s in self.shards:
            s.check()


class ShardedKVPool(PagedKVPool):
    """The mesh's paged pool, with the engine-facing API of
    ``PagedKVPool`` (global page rows) and per-shard slabs for the step."""

    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 n_kv: int, head_dim: int, *, mesh,
                 seq_split_pages: int = 0, dtype=torch.float32,
                 device="cuda"):
        D, M = mesh.shape["data"], mesh.shape["model"]
        per_shard = num_pages // D
        if per_shard < 1 or num_pages % D:
            raise ValueError(
                f"num_pages={num_pages} must be a positive multiple of "
                f"the data axis ({D}): silent truncation would change "
                f"eviction behaviour in capacity-tuned runs")
        if n_kv % M:
            raise ValueError(f"model axis {M} must divide the {n_kv} KV "
                             f"heads")
        self.mesh = mesh
        self.n_layers = n_layers
        self.num_pages = D * per_shard          # allocatable pages
        self.page_size = page_size
        self.device = torch.device(device)
        self.model_shards = M
        self.allocator = ShardedPageAllocator(D, per_shard, seq_split_pages)
        rows = D * self.allocator.stride
        self.k = torch.zeros((M, n_layers, rows, page_size, n_kv // M,
                              head_dim), dtype=dtype, device=self.device)
        self.v = torch.zeros_like(self.k)

    @property
    def num_shards(self) -> int:
        return self.allocator.num_shards

    @property
    def page_stride(self) -> int:
        return self.allocator.stride

    @property
    def local_trash(self) -> int:
        """Shard-local row of every shard's trash page."""
        return self.allocator.pages_per_shard

    @property
    def trash_page(self) -> int:
        """Global row of shard 0's trash page (the sharded step always
        uses each shard's local trash row)."""
        return self.local_trash

    def shard_of(self, row: int) -> int:
        return self.allocator.shard_of(row)

    def local_of(self, row: int) -> int:
        return self.allocator.local_of(row)

    def shard_occupancy(self) -> List[float]:
        return self.allocator.shard_occupancy()

    @property
    def kv_shape(self) -> Tuple[int, int]:
        return (self.model_shards * self.k.shape[4], self.k.shape[5])

    @property
    def page_bytes(self) -> int:
        """K+V bytes of one page across all attention layers."""
        per = (self.k.shape[0] * self.k.shape[1] * self.k.shape[3]
               * self.k.shape[4] * self.k.shape[5])
        return 2 * per * self.k.element_size()

    def layer_pools(self, layer: int):
        raise TypeError("a sharded pool has no single-device layer view; "
                        "use shard_pools(layer, data_shard, model_shard)")

    def shard_pools(self, layer: int, d: int,
                    m: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard ``(d, m)``'s contiguous ``(stride, page, n_kv / M, hd)``
        slab of one layer, indexed by local page rows."""
        s = self.page_stride
        return (self.k[m, layer, d * s:(d + 1) * s],
                self.v[m, layer, d * s:(d + 1) * s])

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(n, n_kv, hd) -> (M, n, n_kv / M, hd) on the pool's type."""
        n, hkv, hd = x.shape
        M = self.model_shards
        return x.to(self.k.dtype).view(n, M, hkv // M, hd).transpose(0, 1)

    def write_tokens(self, layer: int, pages, offsets,
                     k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Scatter n tokens into (global page row, offset) slots of one
        layer, every model shard's head block at once."""
        pg, of = self._index(pages), self._index(offsets)
        m = torch.arange(self.model_shards, device=self.device)[:, None]
        self.k[:, layer].index_put_((m, pg[None], of[None]),
                                    self._heads(k_new))
        self.v[:, layer].index_put_((m, pg[None], of[None]),
                                    self._heads(v_new))

    def write_tail(self, layer: int, rows: torch.Tensor,
                   offsets: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor) -> None:
        """The sharded step's tail writes: ``rows`` (D, B) global page
        rows (each shard's local tail page, or its trash page, plus the
        shard's first row), ``offsets`` (B,); ``k_new`` / ``v_new`` (B,
        n_kv, hd) go to every shard's row.  Trash slots may be written by
        several rows at once: nothing reads them."""
        m = torch.arange(self.model_shards, device=self.device)
        idx = (m[:, None, None], rows[None], offsets[None, None])
        self.k[:, layer].index_put_(idx, self._heads(k_new)[:, None])
        self.v[:, layer].index_put_(idx, self._heads(v_new)[:, None])

    def copy_pages(self, dst: List[int], src: List[int]) -> None:
        """Copy whole pages, every layer and head block (replica
        promotion); sources are gathered before any write."""
        d, s = self._index(dst), self._index(src)
        self.k[:, :, d] = self.k[:, :, s]
        self.v[:, :, d] = self.v[:, :, s]

    def gather_context(self, layer: int, pages: List[int], length: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (length, n_kv, hd) copy of a page run (prefill reuse)."""
        idx = self._index(pages)
        shape = (len(pages) * self.page_size,) + self.kv_shape

        def dense(t):
            return t[:, layer, idx].permute(1, 2, 0, 3, 4).reshape(shape)
        return dense(self.k)[:length], dense(self.v)[:length]

    def fill_slot(self, page: int, off: int, value: float) -> None:
        self.k[:, :, page, off] = value

    def zero_pages(self, pages: List[int]) -> None:
        idx = self._index(pages)
        self.k[:, :, idx] = 0.0
        self.v[:, :, idx] = 0.0


class RankKVPool(ShardedKVPool):
    """One rank's share of the pool on a process mesh: the host allocator
    is the whole mesh's (global page rows, alike on every rank), the
    tensors only shard ``(d, m)``'s slab, ``k`` / ``v`` of ``(n_layers,
    stride, page, n_kv / M, head_dim)``: ``1 / (D * M)`` of the
    single-controller pool's bytes.  Writes keep the rank's own rows and
    head block (other rows go to its trash page); what reads another
    rank's slab (prefill's ``gather_context``, replica ``copy_pages``) is
    a gather over the mesh in which each rank writes only what it
    holds."""

    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 n_kv: int, head_dim: int, *, mesh,
                 seq_split_pages: int = 0, dtype=torch.float32,
                 device="cuda"):
        D, M = mesh.shape["data"], mesh.shape["model"]
        per_shard = num_pages // D
        if per_shard < 1 or num_pages % D:
            raise ValueError(
                f"num_pages={num_pages} must be a positive multiple of "
                f"the data axis ({D})")
        if n_kv % M:
            raise ValueError(f"model axis {M} must divide the {n_kv} KV "
                             f"heads")
        self.mesh = mesh
        self.d, self.m = mesh.coords
        self.n_layers = n_layers
        self.num_pages = D * per_shard
        self.page_size = page_size
        self.device = torch.device(device)
        self.model_shards = M
        self.allocator = ShardedPageAllocator(D, per_shard, seq_split_pages)
        self.k = torch.zeros((n_layers, self.allocator.stride, page_size,
                              n_kv // M, head_dim), dtype=dtype,
                             device=self.device)
        self.v = torch.zeros_like(self.k)

    @property
    def kv_shape(self) -> Tuple[int, int]:
        return (self.model_shards * self.k.shape[3], self.k.shape[4])

    @property
    def page_bytes(self) -> int:
        """K+V bytes of one page across all attention layers and heads
        (the whole mesh's, as the single-controller pool counts it)."""
        per = (self.k.shape[0] * self.k.shape[2] * self.k.shape[3]
               * self.model_shards * self.k.shape[4])
        return 2 * per * self.k.element_size()

    def shard_pools(self, layer: int, d: int,
                    m: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if (d, m) != (self.d, self.m):
            raise ValueError(f"rank ({self.d}, {self.m}) holds no slab of "
                             f"shard ({d}, {m})")
        return self.k[layer], self.v[layer]

    def _local(self, rows: torch.Tensor) -> torch.Tensor:
        """Global page rows -> this rank's local rows; rows of other data
        shards -> its trash page (no host sync: graph-safe)."""
        s = self.page_stride
        return torch.where(rows // s == self.d, rows % s, self.local_trash)

    def _own_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n_kv, hd) -> this rank's (..., n_kv / M, hd) block."""
        h = self.k.shape[3]
        return x[..., self.m * h:(self.m + 1) * h, :].to(self.k.dtype)

    def write_tokens(self, layer: int, pages, offsets,
                     k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Scatter n tokens into (global page row, offset) slots: the
        rank's own rows and head block (other rows land in its trash
        page)."""
        pg, of = self._local(self._index(pages)), self._index(offsets)
        self.k[layer].index_put_((pg, of), self._own_heads(k_new))
        self.v[layer].index_put_((pg, of), self._own_heads(v_new))

    def write_tail(self, layer: int, rows: torch.Tensor,
                   offsets: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor) -> None:
        """The rank step's tail writes: ``rows`` (B,) this shard's local
        tail (or trash) rows, ``offsets`` (B,); ``k_new`` / ``v_new`` (B,
        n_kv, hd), of which the rank keeps its head block."""
        self.k[layer].index_put_((rows, offsets), self._own_heads(k_new))
        self.v[layer].index_put_((rows, offsets), self._own_heads(v_new))

    def _gather_rows(self, rows: torch.Tensor, axis: str, kind: str,
                     layer: Optional[int] = None) -> torch.Tensor:
        """K and V of the global page rows ``rows`` from the ranks that
        hold them, gathered over ``axis``: ``(2, layers, n, page, heads,
        hd)``, every layer or ``layer`` alone, with this rank's head
        block (``"data"``) or every head (``"world"``).  Each row's head
        block is written by the one rank that holds it and is zero
        elsewhere, so the sum over the group leaves every element its
        holder's bits.  The gather is guarded (``ProcessMesh.guard``,
        ``kind``): a rank that gathers alone raises with the others."""
        h = self.k.shape[3]
        src = ((self.k, self.v) if layer is None
               else (self.k[layer:layer + 1], self.v[layer:layer + 1]))
        heads = h * (self.model_shards if axis == "world" else 1)
        h0 = self.m * h if axis == "world" else 0
        buf = self.k.new_zeros((2, src[0].shape[0], rows.shape[0])
                               + tuple(self.k.shape[2:3]) + (heads,)
                               + tuple(self.k.shape[4:]))
        own = (rows // self.page_stride == self.d)[:, None, None, None]
        loc = self._local(rows)
        for i, t in enumerate(src):
            buf[i, ..., h0:h0 + h, :] = torch.where(own, t[:, loc], 0)
        self.mesh.guard(kind, buf.nbytes)
        return self.mesh.slot_gather(buf, axis)

    def copy_pages(self, dst: List[int], src: List[int]) -> None:
        """Copy whole pages, every layer (replica promotion): each source
        row comes from the rank of its data shard over the data group;
        each rank keeps the destinations that are its own."""
        kv = self._gather_rows(self._index(src), "data", "copy_pages")
        loc = self._local(self._index(dst))
        self.k[:, loc] = kv[0]
        self.v[:, loc] = kv[1]

    def gather_context(self, layer: int, pages: List[int], length: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (length, n_kv, hd) copy of a page run (prefill reuse),
        assembled over the whole mesh: pages from their data shards, head
        blocks from their model shards."""
        kv = self._gather_rows(self._index(pages), "world",
                               "gather_context", layer)
        shape = (len(pages) * self.page_size,) + self.kv_shape
        return (kv[0, 0].reshape(shape)[:length],
                kv[1, 0].reshape(shape)[:length])

    def fill_slot(self, page: int, off: int, value: float) -> None:
        # only the page's own data shard holds it (the trash page stays
        # clean)
        if self.shard_of(page) == self.d:
            self.k[:, self.local_of(page), off] = value

    def zero_pages(self, pages: List[int]) -> None:
        idx = self._local(self._index(pages))
        self.k[:, idx] = 0.0
        self.v[:, idx] = 0.0
