"""Tree-structured speculative decoding on the prefix forest (the port's
copy of ``repro.serving.speculation``, ``repro``'s DESIGN §10).

The paper's §2.5 motivation beyond document QA: in speculative decoding
the verifier scores a *tree* of draft continuations, where sibling
branches share all ancestor KV — exactly the access pattern a CoDec
plan exploits.  This module holds the engine-independent pieces of the
draft-propose / tree-verify / accept-rollback loop:

* :class:`SpecConfig` — the bounded draft-tree shape;
* :class:`NGramProposer` — a deterministic self-drafting proposer
  (prompt-lookup decoding: match the sequence's own recent n-gram
  against its history and replay what followed), so speculative mode
  needs no second model;
* :class:`DraftState` — the engine's per-request bookkeeping of live
  draft nodes and their virtual query ids;
* :func:`accept_walk` — the greedy acceptance rule over a scored draft
  tree.

Draft nodes are ordinary :class:`~repro_torch.core.tree.PrefixForest`
nodes (``PrefixForest.add_draft``), one token each, each carrying a
*virtual request id* attached at the node so
``core.plan.build_verify_plan`` gives every branch position its own query
lane.  The engine (``serving/engine.py``) owns page allocation, the
verification dispatch, KV commits, and rollback ordering.  Pure Python:
no torch here either.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Bounds on the per-request draft tree grown each verify step.

    ``depth``      — max tokens per draft chain (branch length);
    ``branch``     — max sibling branches forked at the committed leaf;
    ``max_nodes``  — total draft nodes per request per step (each draft
                     node occupies one KV page for the step's duration);
    ``ngram``      — longest suffix n-gram the proposer matches (it
                     falls back to shorter grams down to 1).
    """

    depth: int = 4
    branch: int = 2
    max_nodes: int = 6
    ngram: int = 3

    def __post_init__(self):
        if self.depth < 1 or self.branch < 1 or self.ngram < 1:
            raise ValueError("depth/branch/ngram must be >= 1")
        if self.max_nodes < 1:
            raise ValueError("max_nodes must be >= 1")


class NGramProposer:
    """Deterministic prompt-lookup proposer (self-drafting).

    ``propose(seq)`` matches the last ``n``-gram of ``seq`` (longest
    first, ``n = cfg.ngram .. 1``) against earlier positions, most
    recent match first, and proposes the tokens that followed each
    match as a draft chain.  Distinct first tokens become sibling
    branches (up to ``cfg.branch``); total proposed tokens are capped
    at ``cfg.max_nodes``.  Pure and deterministic: the same sequence
    always yields the same draft tree, which keeps speculative runs
    reproducible and the differential harness meaningful.
    """

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg

    def propose(self, seq: Sequence[int],
                max_tokens: int = 0) -> List[List[int]]:
        """-> draft branches (token chains), all forking at the leaf.

        ``max_tokens`` additionally caps the total (0 = no extra cap);
        the engine passes the request's remaining generation budget so
        drafts past ``max_new`` are never grown.
        """
        cfg = self.cfg
        budget = cfg.max_nodes if max_tokens <= 0 else min(
            cfg.max_nodes, max_tokens)
        n_seq = len(seq)
        if n_seq < 2 or budget < 1:
            return []
        for n in range(min(cfg.ngram, n_seq - 1), 0, -1):
            key = tuple(seq[-n:])
            branches: List[List[int]] = []
            seen_first = set()
            # scan most-recent match first (recency wins ties)
            for i in range(n_seq - n - 1, -1, -1):
                if tuple(seq[i:i + n]) != key:
                    continue
                cont = list(seq[i + n:i + n + cfg.depth])
                if not cont or cont[0] in seen_first:
                    continue
                seen_first.add(cont[0])
                branches.append(cont)
                if len(branches) >= cfg.branch:
                    break
            if branches:
                return _cap_total(branches, budget)
        return []


def _cap_total(branches: List[List[int]], budget: int) -> List[List[int]]:
    """Trim chains round-robin-free: earlier (more recent) branches keep
    their full depth first; later branches get what remains."""
    out: List[List[int]] = []
    left = budget
    for chain in branches:
        take = min(len(chain), left)
        if take <= 0:
            break
        out.append(chain[:take])
        left -= take
    return out


class DraftState:
    """Live draft bookkeeping for one request (one verify step's tree).

    ``nodes`` lists draft node ids in creation order (parents before
    children within a chain) and ``virts`` the virtual query id attached
    to each; rollback walks ``nodes`` in reverse so leaves are pruned
    before their parents.
    """

    __slots__ = ("rid", "nodes", "virts")

    def __init__(self, rid: int):
        self.rid = rid
        self.nodes: List[int] = []
        self.virts: List[int] = []


def accept_walk(forest, leaf_id: int, argmax_of: Callable[[int], int],
                room: int) -> Tuple[List[int], int]:
    """Greedy acceptance over a scored draft tree.

    ``argmax_of(node_id)`` is the model's greedy next token at that
    node's head (the committed leaf's head is the normal decode
    position).  Starting at the committed leaf: if a draft child holds
    exactly the greedy token, it is accepted and the walk descends;
    otherwise the greedy token is the correction (or, past the last
    accepted draft, the bonus) and the walk stops.  ``room`` caps the
    number of accepted tokens (the request's remaining ``max_new``
    budget).

    Returns ``(accepted_node_ids, final_token)`` — the accepted chain
    top-down plus the token the engine carries as the next ``pending``.
    Greedy equivalence: every accepted token *is* the argmax given its
    exact prefix, so the committed stream is byte-identical to
    non-speculative greedy decode regardless of what was proposed.
    """
    accepted: List[int] = []
    cur = forest.nodes[leaf_id]
    while True:
        g = int(argmax_of(cur.id))
        nxt = None
        for cid in cur.children:
            ch = forest.nodes[cid]
            if (ch.meta.get("draft") and ch.tokens is not None
                    and len(ch.tokens) and int(ch.tokens[0]) == g):
                nxt = ch
                break
        if nxt is None or len(accepted) >= room:
            return accepted, g
        accepted.append(nxt.id)
        cur = nxt
