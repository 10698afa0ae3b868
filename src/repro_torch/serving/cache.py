"""Cross-request prefix cache policy (port of ``repro.serving.cache``:
ChunkAttention-style persistence).

With a :class:`CachePolicy` installed, the engine stops freeing a
finished request's prefix nodes: completed requests *detach* from the
:class:`~repro.core.tree.PrefixForest` but their page-backed nodes stay
resident, so the next request sharing the prefix (hot system prompt,
RAG document) skips that prefill entirely.  Residency is bounded by two
knobs:

* ``ttl_steps`` — a cached node untouched for this many engine steps is
  evicted by the per-step sweep;
* ``max_pages`` — LRU eviction keeps total cached (requestless,
  unpinned) pages at or below this cap.

Cached nodes are also the **first reclaim tier** under memory pressure:
the watermark/preemption machinery in the engine evicts LRU cache
entries before touching any live request's KV.

Recency is tracked in ``node.meta["touch"]`` (last-touch engine step),
which :meth:`PrefixForest._split` propagates to both halves so a split
cannot launder a cold node into a fresh one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..core.tree import ROOT_ID, Node, PrefixForest

__all__ = ["CachePolicy", "PrefixCache"]


@dataclass(frozen=True)
class CachePolicy:
    """Retention knobs for the persistent prefix cache.

    ``ttl_steps=None`` disables time-based expiry; ``max_pages=None``
    leaves residency bounded only by pool pressure (cache entries are
    still the first reclaim tier).
    """

    ttl_steps: Optional[int] = None
    max_pages: Optional[int] = None


class PrefixCache:
    """Bookkeeping for cached prefix nodes living inside the forest.

    The cache owns no storage of its own — cached state *is* forest
    nodes plus their KV pages.  This object tracks the LRU clock,
    decides which requestless nodes are retained vs freed, and keeps
    hit/eviction statistics for ``step_stats``.
    """

    def __init__(self, forest: PrefixForest,
                 policy: Optional[CachePolicy] = None):
        self.forest = forest
        self.policy = policy or CachePolicy()
        self.clock = 0          # advanced once per engine step
        self.stats = {
            "hits": 0,            # admissions with match_len > 0
            "misses": 0,          # admissions with no cached prefix
            "hit_tokens": 0,      # prompt tokens served from cache
            "lookup_tokens": 0,   # prompt tokens looked up
            "evicted_nodes": 0,
            "evicted_pages": 0,
        }

    # ------------------------------------------------------------- #
    # clock / recency
    # ------------------------------------------------------------- #
    def tick(self) -> None:
        self.clock += 1

    def stamp(self, node: Node) -> None:
        """Mark ``node`` as touched at the current step (LRU recency)."""
        if node.id != ROOT_ID:
            node.meta["touch"] = self.clock

    # ------------------------------------------------------------- #
    # admission-side stats
    # ------------------------------------------------------------- #
    def record_lookup(self, matched: int, total: int) -> None:
        if matched > 0:
            self.stats["hits"] += 1
        else:
            self.stats["misses"] += 1
        self.stats["hit_tokens"] += int(matched)
        self.stats["lookup_tokens"] += int(total)

    @property
    def hit_rate(self) -> float:
        n = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / n if n else 0.0

    # ------------------------------------------------------------- #
    # retention / eviction decisions
    # ------------------------------------------------------------- #
    def retainable(self, node: Node) -> bool:
        """Should a requestless node be kept resident as cache?

        Only page-backed prompt/generated content is worth keeping;
        empty leaves and unverified draft tokens are not.
        """
        return (node.id != ROOT_ID
                and len(node.page_ids) > 0
                and node.tokens is not None and len(node.tokens) > 0
                and not node.meta.get("draft"))

    def _evictable(self, node: Node) -> bool:
        """Cached leaf nodes eligible for eviction right now.

        Interior cached nodes become evictable once their children go
        (eviction walks leaves upward), so LRU order is enforced among
        current leaves of the cached region.
        """
        return (node.id != ROOT_ID
                and not node.children
                and not node.requests
                and not node.meta.get("pins")
                and not node.meta.get("draft")
                and len(node.page_ids) > 0)

    def candidates(self) -> List[Node]:
        """Evictable nodes, least recently touched first."""
        out = [n for n in self.forest.real_nodes() if self._evictable(n)]
        out.sort(key=lambda n: (n.meta.get("touch", -1), n.id))
        return out

    def expired(self) -> List[Node]:
        """Evictable nodes whose TTL has lapsed (oldest first)."""
        ttl = self.policy.ttl_steps
        if ttl is None:
            return []
        return [n for n in self.candidates()
                if self.clock - n.meta.get("touch", 0) > ttl]

    def resident_pages(self) -> int:
        """Pages held only by cached (requestless, unpinned) nodes."""
        return sum(len(n.page_ids) for n in self.forest.real_nodes()
                   if not n.requests and not n.meta.get("pins")
                   and not n.meta.get("draft") and n.id != ROOT_ID)

    def over_cap(self) -> int:
        """How many pages above ``max_pages`` the cache currently sits."""
        cap = self.policy.max_pages
        if cap is None:
            return 0
        return max(0, self.resident_pages() - cap)
