"""Deterministic, shardable synthetic data pipeline.

Every (step, dp_rank) pair maps to a unique counter-mode PRNG stream, so

* resume after preemption is exact: the iterator's only state is ``step``;
* elastic re-sharding is exact: rank r of world W draws rows
  ``[r*B/W, (r+1)*B/W)`` of the *global* batch, so changing W re-slices
  the same global stream rather than changing the data;
* no host coordination is needed — each host computes its slice locally.

The token distribution is a Zipf-like categorical with a per-sequence
shift so batches are not degenerate (useful for loss-goes-down checks).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Deterministic LM token stream: next-token targets = shifted input."""

    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_world: int = 1,
                 start_step: int = 0):
        assert cfg.global_batch % dp_world == 0, (cfg.global_batch, dp_world)
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_world = dp_world
        self.step = start_step

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.dp_world

    def _rows(self, step: int) -> Tuple[int, int]:
        lo = self.dp_rank * self.local_batch
        return lo, lo + self.local_batch

    def global_row(self, step: int, row: int) -> np.ndarray:
        """One global-batch row — the unit of determinism."""
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[step, row, 0, 0]))
        # Zipf-ish categorical over a row-dependent permutation offset
        ranks = rng.integers(1, 1024, size=cfg.seq_len + 1)
        toks = (ranks * ranks + row) % cfg.vocab_size
        return toks.astype(np.int32)

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self._rows(step)
        rows = np.stack([self.global_row(step, r) for r in range(lo, hi)])
        return rows[:, :-1], rows[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        b = self.batch(self.step)
        self.step += 1
        return b

    # checkpointable state --------------------------------------------- #
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.step = int(st["step"])
