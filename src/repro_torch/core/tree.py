"""KV-cache prefix forest (paper §4.1) — the port's copy of
``repro.core.tree``.

The decode batch's KV cache is organised as a forest of nodes. Each node
holds a chunk of tokens shared by the set of requests whose prefix path
passes through it. A virtual root (id 0, length 0) connects unrelated
prefixes so a single plan covers the whole batch — including the fully
non-shared case (every request a direct child of the root).

Sharing granularity is ``block_size`` tokens (one KV page): only whole
pages are shared; a partial trailing page is always private to its leaf.
Radix insertion therefore operates on page-sized token blocks and splits
nodes only at page boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT_ID = 0


@dataclasses.dataclass
class Node:
    """One chunk of prefix KV cache.

    ``length`` is the token count; ``start_pos`` the absolute position of
    the first token within any request that contains this node.  ``tokens``
    is optional (synthetic workloads only carry lengths).  ``page_ids`` is
    assigned by the KV-cache manager when the node is materialised.
    """

    id: int
    parent: int
    length: int
    start_pos: int
    tokens: Optional[np.ndarray] = None
    children: List[int] = dataclasses.field(default_factory=list)
    requests: List[int] = dataclasses.field(default_factory=list)
    page_ids: List[int] = dataclasses.field(default_factory=list)
    # engine bookkeeping: the filled-token count ("filled"), the pin
    # refcount of preempted requests waiting to resume ("pins") and the
    # prefix cache's last-touch step ("touch")
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def end_pos(self) -> int:
        return self.start_pos + self.length


class PrefixForest:
    """Forest of KV-cache nodes with query<->node index structures."""

    def __init__(self, block_size: int = 64):
        self.block_size = int(block_size)
        self.nodes: Dict[int, Node] = {ROOT_ID: Node(ROOT_ID, -1, 0, 0)}
        self._next_id = 1
        # request id -> leaf node id
        self.leaf_of: Dict[int, int] = {}
        # optional observer called as on_split(upper, lower) after a node
        # split; the engine uses it to extend per-request pin bookkeeping
        # over the new lower half
        self.on_split = None

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def _new_node(self, parent: int, length: int, start_pos: int,
                  tokens: Optional[np.ndarray] = None) -> Node:
        node = Node(self._next_id, parent, length, start_pos, tokens)
        self._next_id += 1
        self.nodes[node.id] = node
        self.nodes[parent].children.append(node.id)
        return node

    def add_node(self, parent: int, length: int,
                 tokens: Optional[np.ndarray] = None) -> Node:
        """Append a child under ``parent`` (it starts at the parent's end
        position: forest nodes are contiguous along a path)."""
        if tokens is not None:
            tokens = np.asarray(tokens)
            assert len(tokens) == length, (len(tokens), length)
        return self._new_node(parent, int(length),
                              self.nodes[parent].end_pos, tokens)

    def add_draft(self, parent: int, token: int) -> Node:
        """Grow a one-token *draft* node under ``parent``.

        Draft nodes hold speculative continuations (serving/speculation):
        sibling drafts share all ancestor KV, and each draft node is one
        branch position a verification plan can query.  They are marked
        ``meta["draft"] = True`` so engine invariants (eviction, release)
        can tell them from committed nodes; remove them with
        ``prune_leaf`` once verification accepts or rejects them.
        """
        node = self.add_node(parent, 1, np.asarray([token], np.int32))
        node.meta["draft"] = True
        return node

    def add_chain(self, request_id: int, lengths: Sequence[int],
                  parent: int = ROOT_ID) -> int:
        """Append a chain of nodes under ``parent`` and attach a request.

        Used by synthetic workload builders where only lengths matter.
        Returns the leaf node id.
        """
        cur = self.nodes[parent]
        for ln in lengths:
            cur = self._new_node(cur.id, int(ln), cur.end_pos)
        self.attach_request(request_id, cur.id)
        return cur.id

    def attach_request(self, request_id: int, leaf_id: int) -> None:
        """Register ``request_id`` as owning the path root..leaf_id."""
        self.leaf_of[request_id] = leaf_id
        nid = leaf_id
        while nid != ROOT_ID:
            node = self.nodes[nid]
            node.requests.append(request_id)
            nid = node.parent

    def detach_request(self, request_id: int) -> None:
        """Unregister a request from its path (inverse of
        ``attach_request``); nodes and pages are left in place —
        the caller decides what to prune/release."""
        nid = self.leaf_of.pop(request_id)
        while nid != ROOT_ID:
            node = self.nodes[nid]
            node.requests.remove(request_id)
            nid = node.parent

    def prune_leaf(self, node_id: int) -> List[int]:
        """Remove a childless, requestless node; returns its ``page_ids``
        so the caller can release them through the page allocator."""
        node = self.nodes[node_id]
        assert not node.children, f"prune_leaf({node_id}): has children"
        assert not node.requests, f"prune_leaf({node_id}): has requests"
        self.nodes[node.parent].children.remove(node_id)
        del self.nodes[node_id]
        return node.page_ids

    def _match_child(self, cur: Node, remaining: np.ndarray):
        """First child of ``cur`` sharing >= one full page with
        ``remaining`` -> (child, page-aligned match length), else None.
        The single sharing rule both insertion and pure matching follow."""
        bs = self.block_size
        for cid in cur.children:
            child = self.nodes[cid]
            if child.tokens is None or len(child.tokens) == 0:
                continue
            if child.meta.get("draft"):
                # unverified speculative tokens may be rolled back after
                # the verify step: never match new requests into them
                continue
            if child.tokens[0] != remaining[0]:
                continue
            m = (_common_prefix_len(child.tokens, remaining) // bs) * bs
            if m > 0:
                return child, m
        return None

    def insert_tokens(self, request_id: int, tokens: np.ndarray) -> int:
        """Radix-insert a token sequence, sharing page-aligned prefixes.

        Returns the leaf node id holding this request's private tail.
        """
        tokens = np.asarray(tokens)
        pos = 0
        cur = self.nodes[ROOT_ID]
        n = len(tokens)
        while pos < n:
            matched = self._match_child(cur, tokens[pos:])
            if matched is None:
                break
            child, m = matched
            if m < child.length:
                self._split(child, m)
            pos += m
            cur = self.nodes[child.id]
        # private tail (possibly empty -> still make a leaf so the request
        # has somewhere to append generated tokens)
        tail = tokens[pos:]
        leaf = self._new_node(cur.id, len(tail), cur.end_pos,
                              tail.copy() if len(tail)
                              else np.zeros(0, tokens.dtype))
        self.attach_request(request_id, leaf.id)
        return leaf.id

    def match_len(self, tokens: np.ndarray) -> int:
        """Page-aligned length of the longest cached prefix of ``tokens``.

        Pure query (no insertion/splitting): admission uses it to estimate
        how many *new* KV pages a prompt would need.
        """
        tokens = np.asarray(tokens)
        pos = 0
        cur = self.nodes[ROOT_ID]
        n = len(tokens)
        while pos < n:
            matched = self._match_child(cur, tokens[pos:])
            if matched is None:
                break
            child, m = matched
            pos += m
            if m < child.length:
                break          # insertion would split here; match stops
            cur = child
        return pos

    def match_path(self, tokens: np.ndarray) -> Tuple[int, int]:
        """``(deepest matched node id, matched length)`` of a prompt.

        Pure query like :meth:`match_len` — no insertion or splitting.
        The deepest node a prompt descends through is the cascade-prefill
        group key: waiting requests whose ``match_path`` lands on a node
        of a just-admitted request's path share that prefix's compute and
        are co-scheduled so the shared span is computed once for the
        whole group (``repro``'s DESIGN §14).  A prompt matching nothing
        returns ``(ROOT_ID, 0)``.
        """
        tokens = np.asarray(tokens)
        pos = 0
        cur = self.nodes[ROOT_ID]
        n = len(tokens)
        while pos < n:
            matched = self._match_child(cur, tokens[pos:])
            if matched is None:
                break
            child, m = matched
            pos += m
            if m < child.length:
                return child.id, pos   # partial: still descends into it
            cur = child
        return cur.id, pos

    def _split(self, node: Node, at: int) -> None:
        """Split ``node`` so its first ``at`` tokens become the parent part.

        ``at`` must be page aligned.  Existing requests keep passing
        through both halves; children/pages move to the new lower half.
        """
        assert 0 < at < node.length and at % self.block_size == 0
        lower = Node(self._next_id, node.id, node.length - at,
                     node.start_pos + at)
        self._next_id += 1
        if node.tokens is not None:
            lower.tokens = node.tokens[at:].copy()
            node.tokens = node.tokens[:at].copy()
        lower.children = node.children
        for cid in lower.children:
            self.nodes[cid].parent = lower.id
        lower.requests = list(node.requests)
        pages_per = at // self.block_size
        lower.page_ids = node.page_ids[pages_per:]
        node.page_ids = node.page_ids[:pages_per]
        node.length = at
        node.children = [lower.id]
        self.nodes[lower.id] = lower
        # filled counts split at the boundary; a cached end-of-node SSM
        # state belongs to the lower half's end
        filled = node.meta.get("filled")
        if filled is not None:
            lower.meta["filled"] = max(0, filled - at)
            node.meta["filled"] = min(filled, at)
        if "ssm" in node.meta:
            lower.meta["ssm"] = node.meta.pop("ssm")
        # pins guard the whole pinned span: a waiting request that pinned
        # this node counted all its pages toward its admission estimate,
        # so both halves stay protected (and LRU recency travels too)
        for key in ("pins", "touch"):
            if key in node.meta:
                lower.meta[key] = node.meta[key]
        # fix leaf_of for requests whose leaf was the split node
        for rid, leaf in list(self.leaf_of.items()):
            if leaf == node.id:
                self.leaf_of[rid] = lower.id
        if self.on_split is not None:
            self.on_split(node, lower)

    def append_token(self, request_id: int,
                     token: Optional[int] = None) -> None:
        """Grow the request's private leaf by one generated token."""
        leaf = self.nodes[self.leaf_of[request_id]]
        if len(leaf.requests) > 1:
            # leaf became shared (identical prompts): fork a private child
            leaf = self._new_node(leaf.id, 0, leaf.end_pos,
                                  np.zeros(0, np.int32))
            self.leaf_of[request_id] = leaf.id
            leaf.requests = [request_id]
        leaf.length += 1
        if leaf.tokens is not None and token is not None:
            leaf.tokens = np.append(leaf.tokens, token)

    # ------------------------------------------------------------------ #
    # queries / paths
    # ------------------------------------------------------------------ #
    @property
    def request_ids(self) -> List[int]:
        return sorted(self.leaf_of)

    def real_nodes(self) -> List[Node]:
        return [n for nid, n in sorted(self.nodes.items())
                if nid != ROOT_ID and n.length > 0]

    def path(self, request_id: int) -> List[Node]:
        """Prefix path root..leaf (excluding virtual root), top-down."""
        out: List[Node] = []
        nid = self.leaf_of[request_id]
        while nid != ROOT_ID:
            node = self.nodes[nid]
            out.append(node)
            nid = node.parent
        return list(reversed(out))

    def context_len(self, request_id: int) -> int:
        return sum(n.length for n in self.path(request_id))

    def total_tokens(self) -> int:
        return sum(n.length for n in self.real_nodes())

    def total_context(self) -> int:
        return sum(self.context_len(r) for r in self.request_ids)

    def mean_sharing_degree(self) -> float:
        """n̄_q from §4.3: Σ n_i·n_q_i / Σ n_i — the predicted IO ratio."""
        num = sum(n.length * len(n.requests) for n in self.real_nodes())
        den = self.total_tokens()
        return num / max(den, 1)

    # Analytic global-memory-access counts (paper Fig. 6 metric): bytes of
    # KV read from HBM by decode attention, ignoring Q/O traffic.  Callers
    # on the card pass the pool's element size as ``bytes_per``.
    def codec_io_bytes(self, n_kv: int, head_dim: int,
                       bytes_per: int = 2) -> int:
        return 2 * self.total_tokens() * n_kv * head_dim * bytes_per

    def flash_io_bytes(self, n_kv: int, head_dim: int,
                       bytes_per: int = 2) -> int:
        return 2 * self.total_context() * n_kv * head_dim * bytes_per

    def validate(self) -> None:
        """Structural invariants (used by tests)."""
        for nid, node in self.nodes.items():
            if nid == ROOT_ID:
                continue
            parent = self.nodes[node.parent]
            assert nid in parent.children
            assert node.start_pos == parent.end_pos, (
                f"node {nid} start {node.start_pos} != parent end "
                f"{parent.end_pos}")
            if node.parent != ROOT_ID:
                # a shared node's requests must be the union of its subtree
                kid_reqs = set()
                for cid in node.children:
                    kid_reqs |= set(self.nodes[cid].requests)
                leaf_reqs = {r for r, l in self.leaf_of.items() if l == nid}
                assert set(node.requests) == kid_reqs | leaf_reqs
        for rid in self.request_ids:
            for node in self.path(rid):
                assert rid in node.requests


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    m = min(len(a), len(b))
    neq = np.nonzero(a[:m] != b[:m])[0]
    return int(neq[0]) if len(neq) else m


# ---------------------------------------------------------------------- #
# synthetic workload builders (paper §7.2 workload suite)
# ---------------------------------------------------------------------- #
def two_level(num_requests: int, shared_len: int, unique_len: int,
              block_size: int = 64) -> PrefixForest:
    """Root doc shared by everyone; one private tail per request."""
    f = PrefixForest(block_size)
    shared = f.add_node(ROOT_ID, shared_len)
    for r in range(num_requests):
        leaf = f.add_node(shared.id, unique_len)
        f.attach_request(r, leaf.id)
    return f


def full_kary(depth: int, arity: int, node_len: int,
              block_size: int = 64) -> PrefixForest:
    """Full k-ary tree of uniform chunks; one request per leaf."""
    f = PrefixForest(block_size)
    frontier = [f.add_node(ROOT_ID, node_len)]
    for _ in range(depth - 1):
        nxt = []
        for node in frontier:
            for _ in range(arity):
                nxt.append(f.add_node(node.id, node_len))
        frontier = nxt
    for r, leaf in enumerate(frontier):
        f.attach_request(r, leaf.id)
    return f


def degenerate(depth: int, node_len: int,
               block_size: int = 64) -> PrefixForest:
    """Left-spine tree (the paper's 'DT'): at each level one request
    leaves."""
    f = PrefixForest(block_size)
    spine = f.add_node(ROOT_ID, node_len)
    rid = 0
    for _ in range(depth - 1):
        leaf = f.add_node(spine.id, node_len)
        f.attach_request(rid, leaf.id)
        rid += 1
        spine = f.add_node(spine.id, node_len)
    f.attach_request(rid, spine.id)
    return f


def shared_ratio(num_requests: int, total_context: int, ratio: float,
                 block_size: int = 64) -> PrefixForest:
    """Two-level tree whose shared tokens are about ``ratio`` of the
    tree's tokens: with ``S`` shared and ``U`` unique tokens a request,
    ``ratio = S / (S + B·U)``; ``S`` is the context less one request's
    unique part, and ``U = S (1 - ratio) / (ratio B)``."""
    b = num_requests
    # (the JAX package's expression, ``* b / b`` included: the float
    # rounding of the first guess feeds ``s``)
    u = max(1, int(round((total_context * (1 - ratio))
                         / (1 - ratio + ratio * b) * b / b)))
    s = max(block_size, total_context - u)
    if ratio > 0:
        u = max(1, int(round(s * (1 - ratio) / (ratio * b))))
    return two_level(b, s, u, block_size)
