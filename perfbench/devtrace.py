"""The traced sub-window: ``torch.profiler`` over a few seconds of the
window, read into device intervals on the host's ``perf_counter`` clock.

A marker range recorded right after the profiler starts, at a known
``perf_counter`` reading, ties the profiler's time base to the host
clock, so the host spans (the engine's telemetry, the harness's own) and
the device's operations share one timeline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARK = "perfbench.mark"


@dataclasses.dataclass
class Trace:
    start: float                               # perf_counter seconds
    end: float
    ops: List[Tuple[str, float, float]]        # device ops (name, t0, t1)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def clipped(self) -> List[Tuple[str, float, float]]:
        return [(n, max(a, self.start), min(b, self.end))
                for n, a, b in self.ops if b > self.start and a < self.end]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        return sum(b - a for a, b in union(
            [(a, b) for _, a, b in self.clipped()]))

    def seconds_of(self, patterns: Sequence[str]) -> float:
        """Device seconds of the ops whose name holds one of
        ``patterns``."""
        return sum(b - a for n, a, b in self.clipped()
                   if any(p in n for p in patterns))

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for n, a, b in self.clipped():
            tot[n] = tot.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]

    def gaps(self) -> List[Tuple[float, float]]:
        """Intervals of the window in which no device op ran."""
        out, t = [], self.start
        for a, b in union([(a, b) for _, a, b in self.clipped()]):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out


def union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Tracer:
    """Start with ``start()``; ``stop()`` returns the ``Trace``.  Both
    wait for the device first, so the trace holds exactly the work
    enqueued between them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t_mark = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t_mark = time.perf_counter()
        with torch.profiler.record_function(MARK):
            pass
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        self._sync()
        t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        events = self.prof.events()
        mark = next(e for e in events if e.name == MARK)
        # profiler microseconds -> perf_counter seconds
        shift = self.t_mark - mark.time_range.start / 1e6
        ops = []
        for e in events:
            if _on_device(e):
                ops.append((e.name, e.time_range.start / 1e6 + shift,
                            e.time_range.end / 1e6 + shift))
        self.prof = None
        return Trace(self.t0, t1, ops)


def _on_device(e) -> bool:
    dt = getattr(e, "device_type", None)
    return (dt is not None and dt != torch.autograd.DeviceType.CPU
            and e.time_range.end > e.time_range.start)


def name_gap(t: float, spans: Sequence[Tuple[str, float, float]]) -> str:
    """The innermost host span open at ``t`` (``spans``: (name, t0, t1) on
    the perf_counter clock), or ``"host"``."""
    best: Optional[Tuple[str, float, float]] = None
    for s in spans:
        if s[1] <= t < s[2] and (best is None or s[2] - s[1]
                                 < best[2] - best[1]):
            best = s
    return best[0] if best else "host"


def idle_gaps(trace: Trace, spans, k: int = 10) -> List[List]:
    """The ``k`` longest idle gaps, each named by the host span open at its
    start."""
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:k]
    return [[name_gap(a, spans), b - a] for a, b in gaps]
