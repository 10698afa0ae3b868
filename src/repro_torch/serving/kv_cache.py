"""Paged KV-cache pool + page allocator (PagedAttention layout, paper §4.1/§6).

The port of ``repro.serving.kv_cache``.  The pool holds all attention
layers' KV pages: ``k/v: (n_attn_layers, num_pages + 1, page_size, n_kv,
head_dim)``.  Pages are allocated from a free list with reference counts
so prefix nodes shared by multiple requests are freed only when the last
request releases them.  The forest nodes record their ``page_ids``; the
plan compiler reads them directly — the CUDA PAC kernel follows this exact
layout.  Unlike the JAX pool, writes update the device tensors in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


class PageAllocator:
    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        # accounting (watermarks / pressure diagnostics)
        self.peak_used = 0
        self.total_allocs = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._refs)

    def occupancy(self) -> float:
        return self.num_used / max(self.num_pages, 1)

    def used_page_ids(self) -> Dict[int, int]:
        """Allocated page id -> refcount (the engine's leak check)."""
        return dict(self._refs)

    def alloc(self, n: int, hint: Optional[int] = None) -> List[int]:
        """``hint`` (a forest node id) is a placement affinity key: one
        allocator ignores it, the mesh's (``distributed.kv_pool``) keeps a
        node's pages together or sequence-splits them."""
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.total_allocs += n
        self.peak_used = max(self.peak_used, self.num_used)
        return pages

    def retain(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"retain of unallocated page id {p}")
            self._refs[p] += 1

    def release(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"release of unallocated page id {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)

    def check(self) -> None:
        """Structural invariants (tests call this after workloads)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page ids on the free list")
        if free & set(self._refs):
            raise AssertionError("page both free and referenced")
        if len(free) + len(self._refs) != self.num_pages:
            raise AssertionError(
                f"page partition broken: {len(free)} free + "
                f"{len(self._refs)} used != {self.num_pages}")
        if any(r <= 0 for r in self._refs.values()):
            raise AssertionError("non-positive refcount")


class PagedKVPool:
    """Device-resident paged pool for all attention layers."""

    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 n_kv: int, head_dim: int, dtype=torch.float32,
                 device="cuda"):
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.device = torch.device(device)
        # one extra physical page past the allocator's range: a write sink
        # that no plan ever reads
        self.k = torch.zeros((n_layers, num_pages + 1, page_size, n_kv,
                              head_dim), dtype=dtype, device=self.device)
        self.v = torch.zeros_like(self.k)
        self.allocator = PageAllocator(num_pages)

    @property
    def trash_page(self) -> int:
        """Physical page id of the write sink (never allocated)."""
        return self.num_pages

    @property
    def num_free(self) -> int:
        return self.allocator.num_free

    def occupancy(self) -> float:
        return self.allocator.occupancy()

    @property
    def page_bytes(self) -> int:
        """K+V bytes of one page across all attention layers."""
        per = self.k.shape[0] * self.k.shape[2] * self.k.shape[3] \
            * self.k.shape[4]
        return 2 * per * self.k.element_size()

    @property
    def kv_shape(self) -> Tuple[int, int]:
        """(n_kv, head_dim) of one token's K or V."""
        return tuple(self.k.shape[3:])

    def layer_pools(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.k[layer], self.v[layer]

    def fill_slot(self, page: int, off: int, value: float) -> None:
        """Set K at one token slot of every layer (fault injection and its
        scrub)."""
        self.k[:, page, off] = value

    def zero_pages(self, pages: List[int]) -> None:
        """Zero K and V of whole pages in every layer."""
        idx = self._index(pages)
        self.k[:, idx] = 0.0
        self.v[:, idx] = 0.0

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(idx, dtype=torch.int64).to(self.device)

    def write_tokens(self, layer: int, pages, offsets,
                     k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Scatter n tokens into (page, offset) slots of one layer, in place.

        pages/offsets: (n,) host or device indices; k_new/v_new:
        (n, n_kv, head_dim).
        """
        pg, of = self._index(pages), self._index(offsets)
        self.k[layer].index_put_((pg, of), k_new.to(self.k.dtype))
        self.v[layer].index_put_((pg, of), v_new.to(self.v.dtype))

    def copy_slots(self, src_pages, src_offs, dst_pages, dst_offs) -> None:
        """Copy token slots across pages, all layers at once, in place.

        The speculative engine's commit path: an accepted draft token's
        KV was computed into its draft node's page during verification;
        committing moves it to the request's leaf tail slot so the draft
        page can be released and the committed layout stays identical to
        what non-speculative decode would have produced.  Every source is
        gathered into a temporary before any write (as ``repro``'s
        functional update reads them), so a destination that is also a
        source cannot corrupt the copy.  The copies run on the current
        stream, after whatever wrote the sources there.
        """
        sp, so = self._index(src_pages), self._index(src_offs)
        dp, do = self._index(dst_pages), self._index(dst_offs)
        k_src = self.k[:, sp, so]          # (n_layers, n, n_kv, d) copies
        v_src = self.v[:, sp, so]
        self.k[:, dp, do] = k_src
        self.v[:, dp, do] = v_src

    def gather_context(self, layer: int, pages: List[int], length: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (length, n_kv, hd) copy of a page run (prefill reuse)."""
        idx = self._index(pages)
        ps = self.page_size
        k = self.k[layer, idx].reshape(len(pages) * ps, *self.k.shape[3:])
        v = self.v[layer, idx].reshape(len(pages) * ps, *self.v.shape[3:])
        return k[:length], v[:length]

    def bytes_used(self) -> int:
        return (self.k.numel() + self.v.numel()) * self.k.element_size()
