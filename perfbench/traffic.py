"""The one traffic generator: a mix file of parameters in, a request stream
out.

A mix (``traffic/<name>.json``) describes a closed loop of ``clients``
that each send their next request as soon as the previous one ends.  The
stream is one sequence of requests, taken in order by whichever client is
free.  It is cut into blocks of ``clients`` requests; inside a block every
size is stratified (the block holds the same set of lengths for every seed,
the seed only orders them), so two seeds ask for the same work in another
order and a window that consumes a few blocks sees the stated
distributions.  Token ids come from the seed.

Keys of a mix:

* ``clients``: concurrent clients of the closed loop;
* ``documents`` (optional): ``lengths`` of the shared documents and their
  ``popularity`` (``"zipf"`` with exponent ``zipf_s``, by rank in the order
  given); every request asks about one document, and the documents are
  prefilled into the prefix cache during set-up;
* ``private_tokens``: ``[low, high]``, uniform: the request's own tokens
  (the question after a document, or the whole prompt);
* ``output_tokens``: ``[low, high]``, uniform, greedy (random weights
  have no end-of-sequence token, so the output length is ``max_new``).

The clients' first requests start in the loop's steady state: the
request of block 0 that a client takes first is taken up part-way, as if
a stratified share of its output had already been generated: those tokens
join its prompt (drawn like its private tokens) and it generates the rest.
So completions are spread out from the start, every context length of the
steady state is present at once, and no wave of simultaneous completions
follows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

# stream ids under the seed: each draw has its own, so adding one never
# moves another
_ORDER, _PRIVATE, _DOC, _STAGGER = 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class Request:
    index: int                 # position in the stream
    doc: Optional[int]         # document asked about, or None
    private: np.ndarray        # the request's own prompt tokens (int64)
    max_new: int               # output tokens (greedy)


def stratified(low: int, high: int, n: int) -> np.ndarray:
    """``n`` integers of ``[low, high]`` at the midpoints of ``n`` equal
    strata of the uniform distribution."""
    span = high - low + 1
    return low + ((2 * np.arange(n, dtype=np.int64) + 1) * span) // (2 * n)


def popularity(docs: dict) -> np.ndarray:
    """Each document's share of the requests."""
    n = len(docs["lengths"])
    if docs.get("popularity", "zipf") != "zipf":
        raise ValueError(f"unknown popularity {docs['popularity']!r}")
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** docs.get("zipf_s", 1.0)
    return w / w.sum()


def apportion(shares: np.ndarray, n: int) -> np.ndarray:
    """Whole counts summing to ``n`` in proportion to ``shares`` (largest
    remainder)."""
    exact = shares * n
    counts = np.floor(exact).astype(np.int64)
    rest = n - int(counts.sum())
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[:rest]] += 1
    return counts


class Traffic:
    """The request stream of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.clients = int(mix["clients"])
        self.private_range = tuple(mix["private_tokens"])
        self.output_range = tuple(mix["output_tokens"])
        docs = mix.get("documents")
        self.doc_lengths: List[int] = list(docs["lengths"]) if docs else []
        self.shares = popularity(docs) if docs else np.zeros(0)
        self._blocks: Dict[int, tuple] = {}
        self._docs: Dict[int, np.ndarray] = {}

    def _rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *stream])

    def document(self, d: int) -> np.ndarray:
        if d not in self._docs:
            self._docs[d] = self._rng(_DOC, d).integers(
                1, self.vocab, self.doc_lengths[d], dtype=np.int64)
        return self._docs[d]

    def _block(self, b: int) -> tuple:
        if b not in self._blocks:
            k = self.clients
            rng = self._rng(_ORDER, b)
            private = rng.permutation(stratified(*self.private_range, k))
            output = rng.permutation(stratified(*self.output_range, k))
            docs = (rng.permutation(np.repeat(np.arange(len(self.doc_lengths)),
                                              apportion(self.shares, k)))
                    if self.doc_lengths else None)
            if b == 0:
                frac = self._rng(_STAGGER).permutation(k)
                rest = np.maximum(1, ((2 * frac + 1) * output) // (2 * k))
                private, output = private + (output - rest), rest
            self._blocks[b] = (private, output, docs)
        return self._blocks[b]

    def request(self, i: int) -> Request:
        """The ``i``-th request of the stream."""
        b, j = divmod(i, self.clients)
        private, output, docs = self._block(b)
        tokens = self._rng(_PRIVATE, i).integers(1, self.vocab,
                                                 int(private[j]),
                                                 dtype=np.int64)
        return Request(i, None if docs is None else int(docs[j]), tokens,
                       int(output[j]))

    def prompt(self, req: Request) -> np.ndarray:
        if req.doc is None:
            return req.private
        return np.concatenate([self.document(req.doc), req.private])

    def peak_pages(self, page_size: int) -> int:
        """KV pages the loop can hold live at once: every document, and
        every client's longest request with one page of slack (a first
        request's prompt and output together are no longer than that)."""
        longest = self.private_range[1] + self.output_range[1]
        docs = sum(math.ceil(n / page_size) for n in self.doc_lengths)
        return docs + self.clients * (math.ceil(longest / page_size) + 1)
