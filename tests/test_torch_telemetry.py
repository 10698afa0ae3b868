"""Telemetry: the port's ``core/metrics.py``, ``serving/telemetry.py``
and the engine's hooks against ``repro``'s.

* The metrics primitives: the same observations give the same registry
  snapshots, quantiles and deltas; the instrument catalog and both
  stat-to-counter maps are ``repro``'s.
* The engine on a fake clock that moves one unit a step: the port's
  ``codec-cuda`` engine (its plain path on the CPU) and ``repro``'s
  ``codec-xla`` engine on the same weights emit the same trace events
  (name, phase, track, timestamp, duration, args), the same counters and
  gauges and the same histogram counts; the histograms that read the
  engine clock are equal whole (``compile_count`` counts each engine's
  fused programs, one a bucket signature, and the port keys its
  signatures on its own host arrays' shapes, so its count may differ
  from ``repro``'s: 3 against 4 on the fixed workload).  Three
  workloads:
  ``test_differential.py``'s fixed one on its 9-page pool (chunked
  prefill, a preemption), eager and fused with ``profile_every=2``; its
  burst 0 with cascade prefill (shared and batched chunk spans); and two
  waves over one document with the prefix cache, fused.
* The port alone: streams are the same with telemetry on and off
  (eager, fused, cached), ``profile_every`` splits only the sampled
  fused steps, flush waits land in ``flush_time``, counters stay
  monotone and two readers never double-count, and the Chrome trace and
  the metrics export are well formed.

``repro`` runs once per workload (cached in a module fixture): its engine
compiles each new shape, which takes most of this file's time.  Widths
are ``smoke_config("qwen3-4b")``.
"""

import json

import jax
import numpy as np
import pytest

from repro.core import metrics as JM
from repro.models import transformer as JT
from repro.serving import cache as jcache, engine as jengine
from repro.serving import telemetry as jtelemetry
from repro_torch.configs import PAPER_ARCH, smoke_config
from repro_torch.core import metrics as M
from repro_torch.models.transformer import Transformer
from repro_torch.serving import cache, engine, telemetry
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = smoke_config(PAPER_ARCH)
PAGE = 8
DOC = list(range(10, 10 + 48))
FIXED = [(DOC + [100 + 3 * i + j for j in range(3)], 6, 0)
         for i in range(4)]
PRESSURE = dict(num_pages=9, prefill_chunk=8)

# histograms of engine-clock differences: equal whole on a fake clock
CLOCK_HISTS = ("ttft_s", "e2e_s", "tpot_s", "queue_wait_s", "step_s",
               "prefill_chunk_s", "plan_build_s")


def make_burst_workload(seed):
    """``test_differential.py``'s seeded burst: a decoy head, then
    requests sharing uncached documents, all arriving at step 0."""
    rng = np.random.default_rng(seed)
    decoy = rng.integers(0, CFG.vocab_size, 3 * PAGE).tolist()
    docs = [rng.integers(0, CFG.vocab_size,
                         int(rng.integers(3, 7)) * PAGE).tolist()
            for _ in range(int(rng.integers(1, 3)))]
    out = [(decoy + rng.integers(0, CFG.vocab_size, 2).tolist(), 4, 0)]
    for _ in range(int(rng.integers(3, 6))):
        doc = docs[int(rng.integers(0, len(docs)))]
        tail = rng.integers(0, CFG.vocab_size,
                            int(rng.integers(1, 5))).tolist()
        out.append((doc + tail, int(rng.integers(3, 7)), 0))
    return out


# two waves over one document: the second arrives once the first is done
WAVES = ([(DOC + [200 + i, 230 + i], 4, 0) for i in range(3)]
         + [(DOC + [240 + i, 250 + i], 4, 9) for i in range(3)])

# name -> (workload, engine options)
WORKLOADS = {
    "pressure-eager": (FIXED, dict(PRESSURE)),
    "pressure-fused": (FIXED, dict(PRESSURE, fused=True)),
    "cascade-eager": (make_burst_workload(0),
                      dict(prefill_chunk=PAGE, cascade=True)),
    "cached-fused": (WAVES, dict(fused=True, cache=True)),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _kw(kw):
    out = dict(page_size=PAGE, num_pages=256, max_q=8, temperature=0.0)
    out.update(kw)
    return out


def traced(make, tm, workload, max_steps=96):
    """Run ``workload`` on a fake clock one unit a step; returns the
    streams, the trace events and the registry snapshot."""
    clock = FakeClock()
    eng = make(telemetry=tm, clock=clock)
    arrivals = {}
    for i, (_, _, arr) in enumerate(workload):
        arrivals.setdefault(arr, []).append(i)
    rid_of = {}
    for s in range(max_steps):
        for i in arrivals.pop(s, []):
            prompt, max_new, _ = workload[i]
            rid_of[i] = eng.add_request(prompt, max_new=max_new)
        if not arrivals and not eng.has_work():
            break
        eng.step()
        clock.t += 1.0
    assert not arrivals and not eng.has_work()
    eng.flush_tokens()
    eng._stream_ready()
    eng._notify_done()
    events = [(e["name"], e["ph"], e["pid"], e["tid"], e["ts"],
               e.get("dur"), e.get("args")) for e in tm.trace_events()]
    return {"streams": {i: [int(t) for t in eng.requests[r].generated]
                        for i, r in rid_of.items()},
            "events": events,
            "metrics": eng.publish_metrics().snapshot(),
            "signatures": len(eng.bucket_signatures),
            "timing": [{k: s[k] for k in ("dispatch_time", "compute_time",
                                          "host_time", "profiled",
                                          "flush_time") if k in s}
                       for s in eng.step_stats]}


@pytest.fixture(scope="module")
def shared():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        CFG, from_jax_params(CFG, jax.tree.map(np.asarray, params)))
    return params, model


def _port_make(model, opts):
    opts = dict(opts)
    if opts.pop("cache", False):
        opts["cache"] = cache.CachePolicy()

    def make(**kw):
        return engine.DecodeEngine(CFG, model, backend="codec-cuda",
                                   device="cpu", **_kw(dict(opts, **kw)))
    return make


@pytest.fixture(scope="module")
def repro_run(shared):
    params, _ = shared
    runs = {}

    def get(name):
        if name not in runs:
            wl, opts = WORKLOADS[name]
            opts = dict(opts)
            if opts.pop("cache", False):
                opts["cache"] = jcache.CachePolicy()

            def make(**kw):
                return jengine.DecodeEngine(CFG, params, backend="codec-xla",
                                            **_kw(dict(opts, **kw)))
            runs[name] = traced(
                make, jtelemetry.Telemetry(profile_every=2), wl)
        return runs[name]
    return get


# --------------------------------------------------------------------- #
# metrics primitives and the catalog
# --------------------------------------------------------------------- #
def test_catalog_and_counter_maps_match_repro():
    assert telemetry.METRIC_CATALOG == jtelemetry.METRIC_CATALOG
    assert telemetry.ENGINE_STAT_COUNTERS == \
        jtelemetry.ENGINE_STAT_COUNTERS
    assert telemetry.CACHE_STAT_COUNTERS == jtelemetry.CACHE_STAT_COUNTERS
    assert telemetry.METRICS_SCHEMA == jtelemetry.METRICS_SCHEMA
    assert M.default_time_buckets() == JM.default_time_buckets()


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_snapshots_quantiles_and_delta_match_repro(seed):
    rng = np.random.default_rng(seed)
    samples = rng.lognormal(mean=-4.0, sigma=1.5, size=500).tolist()
    incs = rng.integers(0, 5, 40).tolist()
    out = []
    for mod in (M, JM):
        reg = mod.MetricsRegistry()
        c, g = reg.counter("c", "a counter"), reg.gauge("g")
        h = reg.histogram("h")
        hb = reg.histogram("hb", bounds=(0.001, 0.01, 0.1))
        snaps = []
        for i, v in enumerate(samples):
            h.observe(v)
            hb.observe(v)
            if i < len(incs):
                c.inc(incs[i])
            g.set(i % 7)
            if i % 100 == 50:
                snaps.append(reg.snapshot())
        now = reg.snapshot()
        out.append({
            "snap": now,
            "json": reg.to_json(),
            "names": reg.names(),
            "q": [mod.hist_quantile(now[n], q) for n in ("h", "hb")
                  for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)],
            "delta": [mod.delta(now, s) for s in snaps],
            "dq": [mod.hist_quantile(mod.delta(now, s)["h"], 0.5)
                   for s in snaps],
            "mean": h.mean,
        })
    assert out[0] == out[1]


def test_primitives_reject_what_repro_rejects():
    for mod in (M, JM):
        reg = mod.MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)
        with pytest.raises(TypeError):
            reg.gauge("c")
        with pytest.raises(ValueError):
            mod.Histogram("h", bounds=(2.0, 1.0))
        with pytest.raises(ValueError):
            mod.hist_quantile(mod.Histogram("h").snapshot(), 1.5)
        assert mod.hist_quantile(mod.Histogram("h").snapshot(), 0.5) == 0.0
    with pytest.raises(ValueError):
        telemetry.Telemetry(profile_every=-1)


# --------------------------------------------------------------------- #
# the engine on a fake clock, against repro
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_trace_and_metrics_match_repro(shared, repro_run, name):
    _, model = shared
    wl, opts = WORKLOADS[name]
    got = traced(_port_make(model, opts),
                 telemetry.Telemetry(profile_every=2), wl)
    want = repro_run(name)
    assert got["streams"] == want["streams"]
    assert len(got["events"]) == len(want["events"])
    for i, (a, b) in enumerate(zip(got["events"], want["events"])):
        assert a == b, (i, a, b)
    gm, wm = got["metrics"], want["metrics"]
    assert gm.keys() == wm.keys()
    for k, s in wm.items():
        if k in CLOCK_HISTS:
            assert gm[k] == s, k
        elif s["type"] == "histogram":
            assert gm[k]["count"] == s["count"], k
        elif k != "compile_count":
            assert gm[k] == s, k
    # compile_count: the port's step states, one a bucket signature (on
    # the card one captured graph each), against repro's jit programs,
    # one a signature of its own (keyed on its prepared arrays' shapes)
    if opts.get("fused"):
        assert gm["compile_count"]["value"] == got["signatures"] >= 1
        assert wm["compile_count"]["value"] == want["signatures"]
    # the same steps were sampled, on the fused path only
    assert [sorted(t) for t in got["timing"]] == \
        [sorted(t) for t in want["timing"]]


def test_workloads_reach_their_hooks(repro_run):
    """The records show each workload took the path it is named for."""
    def names(run):
        return {e[0] for e in run["events"]}
    p = repro_run("pressure-fused")
    assert {"evict", "flush", "plan_build", "prefill_chunk", "queued",
            "prefill", "decode", "step", "done"} <= names(p)
    assert p["metrics"]["preemptions"]["value"] >= 1
    assert p["metrics"]["profile_device_s"]["count"] >= 1
    c = repro_run("cascade-eager")
    args = [e[6] for e in c["events"] if e[0] == "prefill_chunk"]
    assert any(a.get("shared") for a in args)
    assert any(a.get("batched") for a in args)
    assert c["metrics"]["cascade_batches"]["value"] >= 1
    w = repro_run("cached-fused")
    assert w["metrics"]["cache_hits"]["value"] >= 3
    assert w["metrics"]["compile_count"]["value"] >= 1


# --------------------------------------------------------------------- #
# the port alone
# --------------------------------------------------------------------- #
def _streams(eng, prompts, max_new=6):
    rids = [eng.add_request(list(p), max_new=max_new) for p in prompts]
    eng.run(100)
    return {i: list(eng.requests[r].generated) for i, r in enumerate(rids)}


@pytest.mark.parametrize("mode", ["eager", "fused", "cached"])
def test_streams_identical_with_telemetry_on_off(shared, mode):
    _, model = shared
    opts = {"fused": mode == "fused", "cache": mode == "cached"}
    prompts = [DOC + [100], DOC + [101], DOC + [102]]
    off = _streams(_port_make(model, opts)(telemetry=None), prompts)
    on = _streams(_port_make(model, opts)(
        telemetry=telemetry.Telemetry(profile_every=3)), prompts)
    assert on == off
    assert all(off.values())


def test_profile_every_splits_only_sampled_steps(shared):
    _, model = shared
    tm = telemetry.Telemetry(profile_every=2)
    eng = _port_make(model, {"fused": True})(telemetry=tm)
    for i in range(2):
        eng.add_request(DOC + [100 + i], max_new=8)
    eng.run(100)
    decode = [s for s in eng.step_stats if "dispatch_time" in s]
    profiled = [s for s in eng.step_stats if s.get("profiled")]
    assert profiled and len(profiled) < len(decode)
    assert [s["step"] for s in profiled] == \
        [s["step"] for s in decode if s["step"] % 2 == 0]
    for s in profiled:
        assert s["dispatch_time"] >= 0 and s["compute_time"] >= 0 \
            and s["host_time"] >= 0
    assert all("compute_time" not in s and "host_time" not in s
               for s in decode if not s.get("profiled"))
    snap = tm.metrics.snapshot()
    for h in ("profile_device_s", "profile_dispatch_s", "profile_host_s"):
        assert snap[h]["count"] == len(profiled), h
    assert snap["dispatch_s"]["count"] == len(decode)
    # the eager path times every step and samples none
    tm = telemetry.Telemetry(profile_every=2)
    eng = _port_make(model, {})(telemetry=tm)
    eng.add_request(DOC + [100], max_new=4)
    eng.run(100)
    rows = [s for s in eng.step_stats if "dispatch_time" in s]
    assert rows and all("compute_time" in s and not s.get("profiled")
                        for s in rows)
    assert tm.metrics.snapshot()["profile_device_s"]["count"] == 0


def test_flush_time_attribution(shared):
    """Deferred token syncs land in their own ``flush_time`` key, never in
    the dispatch split of the step that ran the flush."""
    _, model = shared
    tm = telemetry.Telemetry()
    eng = _port_make(model, {"fused": True})(telemetry=tm)
    for i in range(2):
        eng.add_request(DOC + [100 + i], max_new=6)
    eng.run(100)
    rows = [s for s in eng.step_stats if "flush_time" in s]
    assert rows, "no step recorded a flush"
    assert all(s["flush_time"] >= 0 for s in rows)
    assert all(s.get("dispatch_time", 0) >= 0 for s in eng.step_stats)
    assert sum(s["flush_time"] for s in rows) \
        <= eng.stats["decode_sync_time"] + 1e-9
    snap = tm.metrics.snapshot()
    assert snap["flush_s"]["count"] == eng.stats["token_flushes"]
    assert snap["flush_s"]["sum"] == pytest.approx(
        eng.stats["decode_sync_time"])


def test_counters_monotone_and_two_readers_agree(shared):
    """Counters never fall across three waves with the cache on, and a
    per-step reader and an every-other-step reader of the cache hits
    both see the true total."""
    _, model = shared
    tm = telemetry.Telemetry()
    eng = _port_make(model, {"cache": True})(telemetry=tm)
    prev = eng.publish_metrics().snapshot()
    interval_prev, step_total, interval_total = prev, 0.0, 0.0
    for wave in range(3):
        for i in range(2):
            eng.add_request(DOC + [100 + 10 * wave + i], max_new=4)
        k = 0
        while eng.has_work():
            eng.step()
            now = eng.publish_metrics().snapshot()
            for name, s in now.items():
                if s["type"] == "counter":
                    assert s["value"] >= prev[name]["value"], name
                elif s["type"] == "histogram":
                    assert s["count"] >= prev[name]["count"], name
            step_total += M.delta(now, prev)["cache_hits"]["value"]
            prev = now
            k += 1
            if k % 2 == 0:
                now = eng.publish_metrics().snapshot()
                interval_total += M.delta(
                    now, interval_prev)["cache_hits"]["value"]
                interval_prev = now
        eng.flush_tokens()
        eng._stream_ready()
        for r in list(eng.requests):
            eng.release(r)
    snap = eng.publish_metrics().snapshot()
    final = snap["cache_hits"]["value"]
    assert snap["requests_done"]["value"] == 6
    assert snap["ttft_s"]["count"] == 6
    assert final > 0 and final == eng.cache.stats["hits"]
    assert step_total == final
    tail = M.delta(snap, interval_prev)["cache_hits"]["value"]
    assert interval_total + tail == final
    assert sum(s.get("cache_hits", 0) for s in eng.step_stats) == final


def _check_trace_shape(events):
    assert events, "no trace events"
    for ev in events:
        assert {"name", "ph", "pid", "tid"} <= set(ev)
    spans = {}
    for ev in events:
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
    for track, ss in spans.items():
        ss.sort()
        for (s0, e0, n0), (s1, e1, n1) in zip(ss, ss[1:]):
            assert not (s1 < e0 < e1), \
                f"{track}: {n1} partially overlaps {n0}"
    return spans


@pytest.mark.parametrize("fused", [False, True])
def test_trace_export_valid_chrome_json(shared, tmp_path, fused):
    _, model = shared
    tm = telemetry.Telemetry(profile_every=2)
    eng = _port_make(model, {"fused": fused, "prefill_chunk": 16,
                             "cascade": True})(telemetry=tm)
    _streams(eng, [DOC + [100], DOC + [101]], max_new=4)
    path = tmp_path / "trace.json"
    tm.export_trace(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    spans = _check_trace_shape(doc["traceEvents"])
    req_tracks = [t for (pid, t) in spans if pid == 2]
    assert len(req_tracks) == 2
    for (pid, tid), ss in spans.items():
        if pid == 2:
            names = [n for (_, _, n) in ss]
            assert "queued" in names and "prefill" in names \
                and "decode" in names
    instants = {ev["tid"] for ev in doc["traceEvents"]
                if ev["ph"] == "i" and ev["pid"] == 2
                and ev["name"] == "done"}
    assert instants == set(req_tracks)


def test_metrics_export_schema(shared, tmp_path):
    _, model = shared
    eng = _port_make(model, {})(telemetry=True)
    _streams(eng, [DOC + [100]], max_new=3)
    path = tmp_path / "metrics.json"
    eng.export_metrics(str(path), extra={"passes": {"cold": {}}})
    doc = json.loads(path.read_text())
    assert doc["schema"] == "codec-metrics/1"
    assert doc["passes"] == {"cold": {}}
    assert set(doc["metrics"]) >= set(telemetry.METRIC_CATALOG)
    for name, (kind, _) in telemetry.METRIC_CATALOG.items():
        assert doc["metrics"][name]["type"] == kind
    assert doc["metrics"]["requests_done"]["value"] == 1
    off = _port_make(model, {})()
    assert off.publish_metrics() is None
    with pytest.raises(RuntimeError):
        off.export_metrics(str(path))
