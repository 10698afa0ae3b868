"""What a run records, and the arithmetic the metric readers share.

Every time is a ``time.perf_counter`` reading of the benchmark's own
process.  Token times are when the engine's ``on_token`` callback fires:
on the fused path, at the flush that brought the token to the host, which
is when a streaming client sees it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The exact ``q``-th percentile of ``values`` by linear interpolation
    between order statistics (numpy's default, ``method="linear"``)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class ReqRecord:
    rid: int
    doc: Optional[int]
    private: np.ndarray
    prompt_len: int
    max_new: int
    t_submit: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    t_done: Optional[float] = None
    reason: Optional[str] = None
    decode_steps: int = 0            # engine steps that decoded it


@dataclasses.dataclass
class StepRecord:
    t0: float
    t1: float
    docs: List[Optional[int]]        # per decoded row
    ctx: List[int]                   # positions each row attends over


@dataclasses.dataclass
class RunRecord:
    cell: object                     # spec.Cell
    seed: int
    seconds: float
    setup_s: float
    t_open: float
    t_close: float
    reqs: Dict[int, ReqRecord]
    window_tokens: int
    # engine.stats / cache.stats / step_stats over the window, less the
    # traced sub-window
    stats_delta: Dict[str, float]
    steps: List[dict]
    traffic: object = None
    trace: object = None             # devtrace.Trace of the sub-window
    traced_steps: List[StepRecord] = dataclasses.field(default_factory=list)
    host_spans: List = dataclasses.field(default_factory=list)
    telemetry_events: List[dict] = dataclasses.field(default_factory=list)
    peaks: Optional[dict] = None
    host: dict = dataclasses.field(default_factory=dict)   # hostprobe.py

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t_open <= t < self.t_close

    def completed(self) -> List[ReqRecord]:
        """Requests that ended ``done`` in the window."""
        return [r for r in self.reqs.values()
                if r.reason == "done" and self.in_window(r.t_done)]
