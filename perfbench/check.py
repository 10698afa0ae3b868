"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests that finished in the window, drawn from the seed and always
holding the longest of them, is run once through the plain reference:
each prompt with its served tokens.  For every served token the gap by
which the reference's logit of that token lies below the reference's best
logit at that position is read; the number compared is the widest gap.
Greedy decoding serves the program's best token, so a sound program reads
a gap of rounding size and a wrong one reads the gap of a wrong token.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_SAMPLE = 9   # stream id of the sample's draw under the seed
# the sample holds at least this many requests and served tokens
SAMPLE_REQUESTS = 3
SAMPLE_TOKENS = 512


def sample(finished: Sequence, seed: int) -> List:
    """Of the ``finished`` records: the longest (prompt and served tokens;
    the earliest on a tie), then others in an order drawn from the seed
    until the sample holds ``SAMPLE_REQUESTS`` records and
    ``SAMPLE_TOKENS`` served tokens (or every record)."""
    if not finished:
        return []
    recs = sorted(finished, key=lambda r: r.rid)
    longest = max(recs, key=lambda r: (r.prompt_len + len(r.tokens),
                                       -r.rid))
    rest = [r for r in recs if r is not longest]
    order = np.random.default_rng([seed, _SAMPLE]).permutation(len(rest))
    out = [longest]
    for i in order:
        if (len(out) >= SAMPLE_REQUESTS
                and sum(len(r.tokens) for r in out) >= SAMPLE_TOKENS):
            break
        out.append(rest[i])
    return out


def short_streams(picked: Sequence) -> int:
    """Sampled records that served fewer tokens than they asked for."""
    return sum(1 for r in picked if len(r.tokens) != r.max_new)


def groups(recs: Sequence) -> Dict[Optional[int], List]:
    """The sampled records by the document they share (None: no shared
    prefix, one group a record)."""
    out: Dict = {}
    for r in recs:
        key = r.doc if r.doc is not None else ("own", r.rid)
        out.setdefault(key, []).append(r)
    return out


@torch.no_grad()
def reference_logits(ref, recs: Sequence, traffic) -> Dict[int, torch.Tensor]:
    """Per record, the reference's float32 logits (n_served, V) at the
    positions that chose its served tokens."""
    out = {}
    for key, members in groups(recs).items():
        prefix = (traffic.document(key).tolist()
                  if not isinstance(key, tuple) else [])
        suffixes, first = [], []
        for r in members:
            private = r.private.tolist()
            suffixes.append(private + list(r.tokens[:-1]))
            first.append(len(private) - 1)
        for r, lg in zip(members, ref.logits(prefix, suffixes, first)):
            out[r.rid] = lg
    return out


def widest_gap(logits: torch.Tensor, tokens: Sequence[int]) -> float:
    """max over positions of (best logit - logit of the token there)."""
    idx = torch.as_tensor(list(tokens), device=logits.device)[:, None]
    best = logits.max(-1).values
    got = logits.gather(-1, idx)[:, 0]
    return float((best - got).max())
