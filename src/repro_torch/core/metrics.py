"""Typed metrics primitives for the serving telemetry layer (the port's
copy of ``repro.core.metrics``, ``repro``'s DESIGN §13).

Three instrument kinds, deliberately minimal and allocation-free on the
hot path:

* :class:`Counter` — a monotone float/int total (``inc``);
* :class:`Gauge` — a point-in-time value (``set``);
* :class:`Histogram` — fixed upper-bound buckets with count/sum/min/max,
  supporting interpolated quantile estimates.

A :class:`MetricsRegistry` holds instruments by name with get-or-create
semantics and produces plain-dict snapshots.  Snapshots are
NON-DESTRUCTIVE: every reader owns its own previous snapshot and takes
deltas with :func:`delta` — two readers polling at different cadences
(serve.py per report interval, serve_replay per pass) can never
double-count or starve each other.  :func:`hist_quantile` estimates
quantiles from a (possibly delta'd) histogram snapshot, so per-interval
percentiles fall out of cumulative state without per-sample storage.

The serving layer's instrument catalog and the trace-span side live in
``serving/telemetry.py``; this module is engine-agnostic.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence


def default_time_buckets(lo: float = 1e-5, hi: float = 120.0,
                         growth: float = 1.25) -> tuple:
    """Log-spaced seconds buckets covering micro-benchmarks to stalls.

    ~70 buckets at 1.25x growth: quantile interpolation error is
    bounded by one bucket's width (<= 25% relative), fine for p50/p99
    reporting and cheap enough to snapshot every step.
    """
    bounds = []
    b = lo
    while b < hi:
        bounds.append(b)
        b *= growth
    bounds.append(hi)
    return tuple(bounds)


class Counter:
    """Monotone total.  ``inc`` rejects negative increments so registry
    consumers can rely on counters never decreasing."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc {n})")
        self.value += n

    def snapshot(self) -> Dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Point-in-time value (occupancy, queue depth, hit rate)."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Fixed-bucket histogram over ``bounds`` (inclusive upper edges,
    with an implicit +inf overflow bucket)."""

    __slots__ = ("name", "help", "bounds", "counts", "count", "sum",
                 "min", "max")
    kind = "histogram"

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None,
                 help: str = ""):
        self.name = name
        self.help = help
        bounds = tuple(bounds) if bounds is not None \
            else default_time_buckets()
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"histogram {name!r} bounds must be strictly increasing")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        # linear scan from the low end would be O(buckets); bisect keeps
        # the hot path O(log buckets)
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        return hist_quantile(self.snapshot(), q)

    def snapshot(self) -> Dict:
        return {"type": self.kind, "bounds": list(self.bounds),
                "counts": list(self.counts), "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None}


def hist_quantile(snap: Dict, q: float) -> float:
    """Interpolated quantile from a histogram snapshot (or a
    :func:`delta` of two snapshots).  Returns 0.0 when empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    counts = snap["counts"]
    bounds = snap["bounds"]
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (target - cum) / c
            v = lo + (hi - lo) * frac
            # cumulative (non-delta'd) snapshots carry exact extremes;
            # clamp so e.g. p99 of one sample returns the sample
            if snap.get("min") is not None:
                v = max(v, snap["min"])
            if snap.get("max") is not None:
                v = min(v, snap["max"])
            return v
        cum += c
    return bounds[-1]


def delta(now: Dict, prev: Dict) -> Dict:
    """Per-metric difference of two registry snapshots.

    Counters/histogram tallies subtract; gauges pass through at their
    current value (a gauge has no meaningful delta); histogram min/max
    are dropped (extremes do not difference).  Metrics absent from
    ``prev`` (registered mid-flight) difference against zero.
    """
    out = {}
    for name, s in now.items():
        p = prev.get(name)
        if s["type"] == "gauge" or p is None and s["type"] != "histogram":
            out[name] = dict(s)
        elif s["type"] == "counter":
            out[name] = {"type": "counter",
                         "value": s["value"] - p["value"]}
        elif s["type"] == "histogram":
            pc = p["counts"] if p is not None else [0] * len(s["counts"])
            out[name] = {"type": "histogram", "bounds": s["bounds"],
                         "counts": [a - b for a, b in
                                    zip(s["counts"], pc)],
                         "count": s["count"]
                         - (p["count"] if p else 0),
                         "sum": s["sum"] - (p["sum"] if p else 0.0),
                         "min": None, "max": None}
    return out


class MetricsRegistry:
    """Name-keyed instrument store with get-or-create semantics."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = Histogram(name, bounds, help)
            self._metrics[name] = m
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not histogram")
        return m

    def _get_or_create(self, cls, name, help):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict state of every instrument; safe to hold across
        steps and difference later with :func:`delta`."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def to_json(self, indent: Optional[int] = None) -> str:
        snap = self.snapshot()
        for s in snap.values():        # inf min/max are not valid JSON
            for k in ("min", "max"):
                if k in s and s[k] is not None and not math.isfinite(s[k]):
                    s[k] = None
        return json.dumps(snap, indent=indent)
