"""Engine-wide telemetry: metrics registry + structured tracing (the
port's copy of ``repro.serving.telemetry``, ``repro``'s DESIGN §13).

One :class:`Telemetry` object per engine owns

* a :class:`~repro_torch.core.metrics.MetricsRegistry` pre-registered
  with the serving instrument catalog (:data:`METRIC_CATALOG`), kept in
  sync with the engine's cumulative ``stats``/cache/pool state once per
  step;
* per-request and engine-track *spans* emitted through an injectable
  :class:`TraceSink` and exportable as Chrome trace-event JSON
  (``export_trace`` — load the file in Perfetto / ``chrome://tracing``);
* the sampled-profiling policy (``profile_every=N``): ``should_profile``
  tells the fused decode path which steps to block on the device and
  split into dispatch/device/flush phases, leaving every other step on
  the async fast path (on the card: a synchronize after the step's graph
  replay, none on the other steps).

Span timestamps come from the engine's injectable clock (DESIGN §12), so
a fake stepped clock yields byte-identical traces across runs.  All of
this layer only *reads* engine state — token streams are byte-identical
with telemetry on or off (asserted by tests/test_torch_telemetry.py).

On a mesh the engine adds each decode step's epoch ``merge_bytes`` and
``merge_rounds`` to their counters, and ``replica_promotions``,
``replica_demotions`` and ``calibrations`` follow its stats (0 on one
shard, as in ``repro``).  The
``spec_*`` counters follow the speculative engine's stats, and its
decode steps emit the ``spec_propose``, ``spec_verify`` and
``spec_accept`` spans.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ..core import metrics as metrics_mod

# track key for engine-scoped (non-request) spans
ENGINE = "engine"

# pid values group Perfetto tracks: one process for the engine phases,
# one whose threads are the individual requests
_PID_ENGINE = 1
_PID_REQUESTS = 2

METRICS_SCHEMA = "codec-metrics/1"

# name -> (kind, help).  Histograms observe seconds unless named _bytes.
METRIC_CATALOG: Dict[str, Tuple[str, str]] = {
    # request lifecycle
    "requests_submitted": ("counter", "add_request calls accepted"),
    "requests_admitted": ("counter", "admissions (re-admissions incl.)"),
    "requests_done": ("counter", "requests finished with reason=done"),
    "requests_failed": ("counter", "requests quarantined FAILED"),
    "requests_cancelled": ("counter", "requests cancelled"),
    "requests_timed_out": ("counter", "deadline/queue-timeout expiries"),
    "preemptions": ("counter", "evict-and-requeue preemptions"),
    "reclaims": ("counter", "finished-KV reclaims under pressure"),
    "tokens_generated": ("counter", "tokens entered committed streams"),
    # prefill
    "prefill_tokens": ("counter", "prompt tokens prefilled"),
    "recompute_tokens": ("counter", "tokens recomputed after eviction"),
    "prefill_chunks": ("counter", "chunked prefill continuations"),
    "prefill_stalls": ("counter", "prefill chunks stalled on pages"),
    # cascade prefill (DESIGN §14)
    "cascade_groups": ("counter", "cascade group advances (>=2 members)"),
    "cascade_shared_tokens": ("counter",
                              "shared-span tokens siblings reused "
                              "(computed once, saved N-1 times)"),
    "cascade_suffix_tokens": ("counter",
                              "suffix tokens in batched dispatches"),
    "cascade_batches": ("counter", "batched suffix prefill dispatches"),
    # decode machinery
    "engine_steps": ("counter", "engine step() calls"),
    "decode_steps": ("counter", "steps that dispatched a decode"),
    "plan_rebuilds": ("counter", "plan/epoch rebuilds"),
    "fused_dispatches": ("counter", "fused jitted dispatches"),
    "token_flushes": ("counter", "deferred-token sync points"),
    "merge_bytes": ("counter", "cross-shard POR merge wire bytes"),
    "merge_rounds": ("counter", "cross-shard POR merge rounds"),
    "calibrations": ("counter", "CostModel.fit adoptions"),
    # speculation
    "spec_steps": ("counter", "speculative verify steps"),
    "spec_proposed": ("counter", "draft tokens proposed"),
    "spec_accepted": ("counter", "draft tokens accepted"),
    "spec_draft_stalls": ("counter", "draft growth stalled on pages"),
    # prefix cache
    "cache_hits": ("counter", "prefix-cache lookup hits"),
    "cache_misses": ("counter", "prefix-cache lookup misses"),
    "cache_hit_tokens": ("counter", "prompt tokens served from cache"),
    "cache_lookup_tokens": ("counter", "prompt tokens looked up"),
    "cache_evicted_nodes": ("counter", "cached nodes evicted"),
    "cache_evicted_pages": ("counter", "cached pages evicted"),
    # faults / degradation ladder (DESIGN §12)
    "faults_injected": ("counter", "injector seams fired"),
    "dispatch_failures": ("counter", "ResourceExhausted dispatches"),
    "dispatch_recoveries": ("counter", "degradation-ladder recoveries"),
    "replica_promotions": ("counter", "prefix replicas created"),
    "replica_demotions": ("counter", "prefix replicas dropped"),
    "nan_rows": ("counter", "rows quarantined for non-finite logits"),
    "callback_errors": ("counter", "user callbacks that raised"),
    "invariant_checks": ("counter", "engine.check() runs"),
    # gauges
    "pool_occupancy": ("gauge", "KV pool fraction in use"),
    "pool_free_pages": ("gauge", "KV pages free"),
    "backoff_pages": ("gauge", "admission-shrink ladder holdback"),
    "running": ("gauge", "requests in the decode batch"),
    "waiting": ("gauge", "requests queued"),
    "prefilling": ("gauge", "requests mid-prefill"),
    "cache_hit_rate": ("gauge", "cumulative prefix-cache hit rate"),
    "cache_resident_pages": ("gauge", "pages held as cache content"),
    "cache_resident_bytes": ("gauge", "bytes held as cache content"),
    "compile_count": ("gauge", "fused-step jit cache entries"),
    # latency histograms (seconds)
    "ttft_s": ("histogram", "submit -> first committed token"),
    "tpot_s": ("histogram", "per-request mean inter-token gap"),
    "e2e_s": ("histogram", "submit -> stream close"),
    "queue_wait_s": ("histogram", "submit -> first admission"),
    "prefill_chunk_s": ("histogram", "one chunked-prefill dispatch"),
    "dispatch_s": ("histogram", "decode dispatch (submit, per step)"),
    "flush_s": ("histogram", "flush_tokens device sync wait"),
    "step_s": ("histogram", "whole engine step wall time"),
    "plan_build_s": ("histogram", "plan/epoch rebuild wall time"),
    # sampled profiling (profile_every): blocked per-phase splits
    "profile_dispatch_s": ("histogram", "sampled: host submit phase"),
    "profile_device_s": ("histogram", "sampled: device execute wait"),
    "profile_host_s": ("histogram", "sampled: host prep before submit"),
}

# engine.stats key -> counter name (synced as monotone deltas each step)
ENGINE_STAT_COUNTERS: Dict[str, str] = {
    "steps": "decode_steps",
    "admitted": "requests_admitted",
    "preempted": "preemptions",
    "reclaimed": "reclaims",
    "prefill_tokens": "prefill_tokens",
    "recompute_tokens": "recompute_tokens",
    "prefill_chunks": "prefill_chunks",
    "prefill_stalls": "prefill_stalls",
    "cascade_groups": "cascade_groups",
    "cascade_shared_tokens": "cascade_shared_tokens",
    "cascade_suffix_tokens": "cascade_suffix_tokens",
    "cascade_batches": "cascade_batches",
    "replans": "plan_rebuilds",
    "fused_calls": "fused_dispatches",
    "token_flushes": "token_flushes",
    "calibrations": "calibrations",
    "spec_steps": "spec_steps",
    "spec_proposed": "spec_proposed",
    "spec_accepted": "spec_accepted",
    "spec_draft_stalls": "spec_draft_stalls",
    "cancelled": "requests_cancelled",
    "timed_out": "requests_timed_out",
    "failed": "requests_failed",
    "callback_errors": "callback_errors",
    "faults_injected": "faults_injected",
    "dispatch_failures": "dispatch_failures",
    "dispatch_recoveries": "dispatch_recoveries",
    "replica_promotions": "replica_promotions",
    "replica_demotions": "replica_demotions",
    "nan_rows": "nan_rows",
    "invariant_checks": "invariant_checks",
}

# cache.stats key -> counter name
CACHE_STAT_COUNTERS: Dict[str, str] = {
    "hits": "cache_hits",
    "misses": "cache_misses",
    "hit_tokens": "cache_hit_tokens",
    "lookup_tokens": "cache_lookup_tokens",
    "evicted_nodes": "cache_evicted_nodes",
    "evicted_pages": "cache_evicted_pages",
}


class TraceSink:
    """Receives every finished trace event (a Chrome trace-event dict).

    The default :class:`MemoryTraceSink` buffers for ``export_trace``;
    inject a custom sink to stream events elsewhere (a file, a test
    assertion, a live UI).  ``emit`` must not raise into the engine.
    """

    def emit(self, event: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError


class MemoryTraceSink(TraceSink):
    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)


class Telemetry:
    """Metrics + tracing + profiling policy for one :class:`DecodeEngine`.

    Construct directly (``DecodeEngine(telemetry=Telemetry(...))``) or
    let the engine build a default one with ``telemetry=True``.  The
    engine binds its injectable clock at construction so span
    timestamps share the deadline clock (fake clocks give
    deterministic traces).
    """

    def __init__(self, profile_every: int = 0,
                 sink: Optional[TraceSink] = None, clock=None):
        if profile_every < 0:
            raise ValueError(
                f"profile_every must be >= 0, got {profile_every}")
        self.profile_every = int(profile_every)
        self.sink = sink if sink is not None else MemoryTraceSink()
        self.clock = clock          # engine calls bind_clock if None
        self.metrics = metrics_mod.MetricsRegistry()
        for name, (kind, help_) in METRIC_CATALOG.items():
            getattr(self.metrics, kind)(name, help=help_)
        self._t0: Optional[float] = None
        # per-track open-span stacks: track -> [(name, ts, args)]
        self._open: Dict[Any, List[Tuple[str, float, Optional[Dict]]]] = {}
        # last synced cumulative stats, per source ("engine", "cache")
        self._seen: Dict[str, Dict[str, float]] = {}
        self._meta_emitted: set = set()

    # ---- clock ----------------------------------------------------- #
    def bind_clock(self, clock) -> None:
        """Adopt the engine's clock unless one was injected directly."""
        if self.clock is None:
            self.clock = clock

    def _now(self) -> float:
        return self.clock() if self.clock is not None else 0.0

    def _ts_us(self, t: float) -> float:
        if self._t0 is None:
            self._t0 = t
        return (t - self._t0) * 1e6

    # ---- spans ------------------------------------------------------ #
    def _track(self, track) -> Tuple[int, int]:
        """(pid, tid) for a track key: ENGINE or a request id."""
        if track == ENGINE:
            return _PID_ENGINE, 0
        return _PID_REQUESTS, int(track)

    def _emit_meta(self, pid: int, tid: int) -> None:
        if pid not in self._meta_emitted:
            self._meta_emitted.add(pid)
            name = "engine" if pid == _PID_ENGINE else "requests"
            self.sink.emit({"ph": "M", "pid": pid, "tid": 0, "ts": 0,
                            "name": "process_name",
                            "args": {"name": name}})
        if (pid, tid) not in self._meta_emitted and pid == _PID_REQUESTS:
            self._meta_emitted.add((pid, tid))
            self.sink.emit({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                            "name": "thread_name",
                            "args": {"name": f"request {tid}"}})

    def begin(self, name: str, track=ENGINE,
              args: Optional[Dict] = None) -> None:
        """Open a span; close it with :meth:`end` (LIFO per track)."""
        self._open.setdefault(track, []).append((name, self._now(), args))

    def end(self, track=ENGINE, args: Optional[Dict] = None) -> None:
        """Close the innermost open span on ``track`` as an "X" event."""
        stack = self._open.get(track)
        if not stack:
            return
        name, t_start, a0 = stack.pop()
        merged = dict(a0 or {})
        if args:
            merged.update(args)
        self.complete(name, t_start, self._now(), track=track,
                      args=merged or None)

    def end_all(self, track) -> None:
        """Close every open span on ``track`` (terminal transitions)."""
        while self._open.get(track):
            self.end(track)

    def complete(self, name: str, t_start: float, t_end: float,
                 track=ENGINE, args: Optional[Dict] = None) -> None:
        """Emit a finished span from explicit clock readings."""
        pid, tid = self._track(track)
        self._emit_meta(pid, tid)
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": self._ts_us(t_start),
              "dur": max(0.0, self._ts_us(t_end) - self._ts_us(t_start)),
              "cat": "engine" if pid == _PID_ENGINE else "request"}
        if args:
            ev["args"] = args
        self.sink.emit(ev)

    def instant(self, name: str, track=ENGINE,
                args: Optional[Dict] = None) -> None:
        pid, tid = self._track(track)
        self._emit_meta(pid, tid)
        ev = {"name": name, "ph": "i", "pid": pid, "tid": tid,
              "ts": self._ts_us(self._now()), "s": "t",
              "cat": "engine" if pid == _PID_ENGINE else "request"}
        if args:
            ev["args"] = args
        self.sink.emit(ev)

    # ---- profiling policy ------------------------------------------- #
    def should_profile(self, step_index: int) -> bool:
        """True on steps the fused path should block and phase-split."""
        return (self.profile_every > 0
                and step_index % self.profile_every == 0)

    # ---- stat syncing ----------------------------------------------- #
    def sync_counters(self, source: str,
                      stats: Dict[str, float],
                      mapping: Dict[str, str]) -> None:
        """Fold a cumulative stats dict into registry counters.

        Each call increments by the delta since the previous call for
        the same ``source`` — callers hand over the SAME cumulative
        dict every time and the registry stays monotone regardless of
        how many readers poll it afterwards.
        """
        seen = self._seen.setdefault(source, {})
        for key, name in mapping.items():
            cur = float(stats.get(key, 0))
            d = cur - seen.get(key, 0.0)
            if d > 0:
                self.metrics[name].inc(d)
            seen[key] = cur

    def set_gauges(self, values: Dict[str, float]) -> None:
        for name, v in values.items():
            self.metrics[name].set(v)

    def observe(self, name: str, v: float) -> None:
        self.metrics[name].observe(v)

    # ---- export ------------------------------------------------------ #
    def trace_events(self) -> List[Dict[str, Any]]:
        """Finished events (open spans are excluded until ended)."""
        if isinstance(self.sink, MemoryTraceSink):
            return list(self.sink.events)
        raise TypeError(
            "trace_events()/export_trace() need the default "
            "MemoryTraceSink; a custom sink owns its own events")

    def export_trace(self, path: str) -> None:
        """Write Chrome trace-event JSON (Perfetto-loadable)."""
        doc = {"traceEvents": self.trace_events(),
               "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f, indent=None)

    def export_metrics(self, path: str,
                       extra: Optional[Dict] = None) -> None:
        """Write the registry snapshot as schema-tagged JSON."""
        doc = {"schema": METRICS_SCHEMA,
               "metrics": json.loads(self.metrics.to_json())}
        if extra:
            doc.update(extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
