"""One run of one cell: set-up, the closed loop, the window, the check.

Set-up builds the weights on the device from the seed, the port's engine
as the configuration file deploys it, prefills the mix's documents into
the prefix cache, starts every client (their first requests staggered,
``traffic.py``) and runs the loop until a sixteenth of the clients have
completed a request, so the replacement requests' prefill and every shape
the window's steps take have run once.  Then the window opens for
``seconds``: the loop runs on unchanged, and the benchmark only reads the
clock in its callbacks.  With ``trace`` a sub-window of ``TRACE_SECONDS``
in its middle runs under ``torch.profiler`` and the engine keeps its
telemetry (the per-layer metrics); without it the engine runs as
deployed, and the end-to-end metrics are read.

After the window the program's state is freed and the sampled requests
are run through the plain reference (``check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import torch

from . import (check, devtrace, hostprobe, spec, traffic as traffic_mod,
               weights, work)
from .reference import dense
from .record import ReqRecord, RunRecord, StepRecord

# seconds of the window that a --trace 1 run records with torch.profiler
TRACE_SECONDS = 2.0
# the loop's warm-up ends once 1 / WARM_SHARE of the clients have completed
WARM_SHARE = 16
# engine counters the per-layer metrics read, as window deltas
STAT_KEYS = ("steps", "decode_time", "plan_time", "advance_time")
CACHE_KEYS = ("hit_tokens", "lookup_tokens")
# the configuration file's keys, as the port's ModelConfig names them
PORT_KEYS = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
             "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
             "tie_word_embeddings": "tie_embeddings",
             "attention_bias": "qkv_bias", "torch_dtype": "dtype"}


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: its registered
    config with every key of the file applied."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_config"])
    return dataclasses.replace(base, **{v: cfg[k]
                                        for k, v in PORT_KEYS.items()})


class Loop:
    """The closed loop: a free client sends the stream's next request at
    once; ``on_token`` / ``on_done`` read the clock."""

    def __init__(self, engine, traffic):
        self.engine = engine
        self.traffic = traffic
        self.idle: List[int] = list(range(traffic.clients))
        self.client: Dict[int, int] = {}
        self.recs: Dict[int, ReqRecord] = {}
        self.next_index = 0
        self.done = 0
        self.window = (float("inf"), float("inf"))
        self.window_tokens = 0
        self.spans: Optional[list] = None     # harness spans, when tracing
        # the window's time in engine steps and in add_request calls
        self.split = {"steps": 0, "step_s": 0.0, "submits": 0,
                      "submit_s": 0.0}

    def on_token(self, rid: int, tok: int) -> None:
        t = time.perf_counter()
        r = self.recs[rid]
        r.tokens.append(int(tok))
        if r.t_first is None:
            r.t_first = t
        r.t_last = t
        if self.window[0] <= t < self.window[1]:
            self.window_tokens += 1

    def on_done(self, rid: int, reason: str) -> None:
        r = self.recs[rid]
        r.t_done = time.perf_counter()
        r.reason = reason
        self.done += 1
        self.idle.append(self.client.pop(rid))

    def submit_idle(self) -> None:
        while self.idle:
            client = self.idle.pop(0)
            req = self.traffic.request(self.next_index)
            self.next_index += 1
            prompt = self.traffic.prompt(req)
            t = time.perf_counter()
            rid = self.engine.add_request(prompt.tolist(),
                                          max_new=req.max_new,
                                          on_token=self.on_token,
                                          on_done=self.on_done)
            t1 = time.perf_counter()
            if self.spans is not None:
                self.spans.append(("perfbench.add_request", t, t1))
            if self.window[0] <= t < self.window[1]:
                self.split["submits"] += 1
                self.split["submit_s"] += t1 - t
            self.client[rid] = client
            self.recs[rid] = ReqRecord(rid, req.doc, req.private,
                                       len(prompt), req.max_new, t)

    def step(self, steps: Optional[list] = None) -> None:
        self.submit_idle()
        t0 = time.perf_counter()
        out = self.engine.step()
        t1 = time.perf_counter()
        for rid in out:
            self.recs[rid].decode_steps += 1
        if self.window[0] <= t0 < self.window[1]:
            self.split["steps"] += 1
            self.split["step_s"] += t1 - t0
        if self.spans is not None:
            self.spans.append(("perfbench.step", t0, t1))
        if steps is not None and out:
            rows = [self.recs[rid] for rid in out]
            steps.append(StepRecord(t0, t1, [r.doc for r in rows],
                                    [r.prompt_len + r.decode_steps
                                     for r in rows]))


def snapshot(engine) -> Dict[str, float]:
    s = {k: float(engine.stats[k]) for k in STAT_KEYS}
    if engine.cache is not None:
        s.update({"cache_" + k: float(engine.cache.stats[k])
                  for k in CACHE_KEYS})
    step = engine.fused_step or engine.spec_step
    s["graphs"] = float(step.graphs if step is not None else 0)
    s["step_records"] = float(len(engine.step_stats))
    return s


def _minus(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: a[k] - b[k] for k in a}


def build_engine(cell, port_cfg, model, traffic, device, telemetry):
    from repro_torch.serving.cache import CachePolicy
    from repro_torch.serving.engine import DecodeEngine
    srv = cell.config["serving"]
    engine = DecodeEngine(
        port_cfg, model, page_size=srv["page_size"],
        num_pages=traffic.peak_pages(srv["page_size"]),
        backend=srv["backend"], fused=srv["fused"],
        cache=CachePolicy() if srv["prefix_cache"] else None,
        cascade=srv["cascade"], telemetry=telemetry,
        clock=time.perf_counter, device=device)
    kv = engine.pool.k.dtype
    if kv != weights.DTYPES[srv["kv_dtype"]]:
        raise RuntimeError(f"the engine's KV pool is {kv}, the "
                           f"configuration states {srv['kv_dtype']}")
    return engine


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, log=sys.stderr) -> dict:
    """Run ``cell`` once; returns the result line's object, ``checks``
    last (``correct`` is set from them by ``run.py``)."""
    run, memory_peak, w = execute(cell, seed, seconds, trace, device,
                                  t_process, log)
    device = torch.device(device)
    result = assemble(run, memory_peak, device, trace)
    t_check = time.perf_counter()
    result["checks"] = correctness(run, w)
    print(f"perfbench: correctness check {time.perf_counter() - t_check:.1f}"
          f" s", file=log)
    return result


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float, log=sys.stderr):
    """Set-up, warm-up and the window; returns the ``RunRecord``, the
    device's peak memory and the weights, the program's state freed."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.telemetry import Telemetry

    device = torch.device(device)
    marks = [("start", t_process)]

    def mark(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append((name, time.perf_counter()))

    cfg = cell.config
    pcfg = port_config(cfg)
    mark("imports")
    w = weights.make_weights(cfg, seed, device)
    model = Transformer.from_state_dict(pcfg, w)
    traffic = traffic_mod.Traffic(cell.traffic, seed, cfg["vocab_size"])
    tm = None
    t_origin = 0.0
    if trace:
        tm = Telemetry(clock=time.perf_counter)
        t_origin = time.perf_counter()
        tm.complete("perfbench.origin", t_origin, t_origin)
    mark("weights")
    engine = build_engine(cell, pcfg, model, traffic, device, tm)
    mark("engine")

    # the documents, prefilled into the prefix cache
    for d in range(len(traffic.doc_lengths)):
        engine.add_request(traffic.document(d).tolist(), max_new=1)
    while engine.has_work():
        engine.step()
    mark("documents")

    loop = Loop(engine, traffic)
    loop.submit_idle()
    mark("clients")
    warm = max(1, traffic.clients // WARM_SHARE)
    while loop.done < warm:
        loop.step()
    mark("warm-up")
    print("perfbench: set-up " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.1f} s" for a, b in zip(marks, marks[1:]))
        + f"; graphs {snapshot(engine)['graphs']:.0f}, pool "
        f"{engine.pool.num_pages} pages", file=log)

    probe = hostprobe.Probe()
    probe.open()
    t_open = time.perf_counter()
    t_close = t_open + seconds
    loop.window = (t_open, t_close)
    s_open = snapshot(engine)
    graphs_open = s_open["graphs"]
    tracer = devtrace.Tracer(device) if trace else None
    t_trace = t_open + max(0.0, (seconds - TRACE_SECONDS) / 2)
    s_t0 = s_t1 = None
    traced_steps: List[StepRecord] = []
    trace_data = None
    while True:
        tracing = tracer is not None and s_t0 is not None and s_t1 is None
        loop.step(traced_steps if tracing else None)
        now = time.perf_counter()
        if tracer is not None and s_t0 is None and now >= t_trace:
            s_t0 = snapshot(engine)
            loop.spans = []
            tracer.start()
        elif tracing and now >= tracer.t0 + TRACE_SECONDS:
            trace_data = tracer.stop()
            s_t1 = snapshot(engine)
            host_spans = loop.spans
            loop.spans = None
        if now >= t_close and (tracer is None or s_t1 is not None):
            break
    s_close = snapshot(engine)
    host = probe.close(loop.split)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        memory_peak = int(torch.cuda.max_memory_allocated(device))
    else:
        memory_peak = 0
    delta = _minus(s_close, s_open)
    if s_t0 is not None:
        delta = _minus(delta, _minus(s_t1, s_t0))
    steps = engine.step_stats[int(s_open["step_records"]):
                              int(s_close["step_records"])]
    if s_t0 is not None:
        cut = (int(s_t0["step_records"] - s_open["step_records"]),
               int(s_t1["step_records"] - s_open["step_records"]))
        steps = steps[:cut[0]] + steps[cut[1]:]
    print(f"perfbench: window {seconds:.1f} s, {engine.stats['steps']} "
          f"decode steps in all, graphs captured in the window "
          f"{s_close['graphs'] - graphs_open:.0f}", file=log)
    flat = dict(host["loop"], **{k: v for k, v in host.items()
                                 if k != "loop"})
    print("perfbench: host " + ", ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in flat.items()), file=log)

    run = RunRecord(cell=cell, seed=seed, seconds=seconds,
                    setup_s=t_open - t_process, t_open=t_open,
                    t_close=t_close, reqs=loop.recs,
                    window_tokens=loop.window_tokens, stats_delta=delta,
                    steps=steps, traffic=traffic, host=host)
    if trace:
        run.trace = trace_data
        run.traced_steps = traced_steps
        events = [dict(e, t=t_origin + e["ts"] / 1e6,
                       t_end=t_origin + (e["ts"] + e.get("dur", 0)) / 1e6)
                  for e in tm.sink.events if e.get("ph") == "X"]
        run.telemetry_events = events
        run.host_spans = [
            (e["name"], e["t"], e["t_end"]) for e in events
            if e["cat"] == "engine" or e["name"] == "prefill_chunk"
        ] + host_spans
        if device.type == "cuda":
            run.peaks = spec.peaks(torch.cuda.get_device_name(device))

    # the program's state goes before the reference runs
    del engine, model, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    return run, memory_peak, w


def attempted_failed(run: RunRecord):
    live = [r for r in run.reqs.values() if r.t_submit < run.t_close
            and (r.t_done is None or r.t_done >= run.t_open)]
    failed = [r for r in live if r.reason not in (None, "done")
              and r.t_done < run.t_close]
    return len(live), len(failed)


def assemble(run: RunRecord, memory_peak: int, device, trace: bool) -> dict:
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in run.cell.metrics[kind]:
        v = spec.reader(m.name)(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    attempted, failed = attempted_failed(run)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": False, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev, "host": run.host}
    if run.trace is not None and run.peaks is not None:
        cfg, docs = run.cell.config, run.traffic.doc_lengths
        s = run.traced_steps[len(run.traced_steps) // 2]
        print(f"perfbench: a traced step's work is bound by "
              f"{work.step(cfg, docs, s.docs, s.ctx).bound_by(run.peaks)}, "
              f"its attention by "
              f"{work.attention(cfg, docs, s.docs, s.ctx).bound_by(run.peaks)}",
              file=sys.stderr)
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in run.trace.top_ops(10)],
            "idle_gaps": devtrace.idle_gaps(run.trace, run.host_spans, 10)}
    return out


def correctness(run: RunRecord, w) -> Dict[str, dict]:
    """The numbers compared, each with its value and limit."""
    picked = check.sample(run.completed(), run.seed)
    short = check.short_streams(picked)
    gap = None                        # nothing compared
    if picked and not short:
        logits = check.reference_logits(dense.Dense(run.cell.config, w),
                                        picked, run.traffic)
        gap = max(check.widest_gap(logits[r.rid], r.tokens) for r in picked)
    return checks(run, gap, short)


def checks(run: RunRecord, gap: Optional[float],
           short: int) -> Dict[str, dict]:
    """The widest logit gap (None: nothing compared), the sampled streams
    cut short and the failed requests, each against the cell's limit."""
    _, failed = attempted_failed(run)
    return {
        "logit_gap": {"value": gap,
                      "limit": run.cell.limits["logit_gap"]["limit"]},
        "short_streams": {"value": short, "limit": 0},
        "failed": {"value": failed, "limit": 0},
    }


def is_correct(checks: Dict[str, dict]) -> bool:
    c = checks
    return (c["logit_gap"]["value"] is not None
            and c["logit_gap"]["value"] <= c["logit_gap"]["limit"]
            and c["short_streams"]["value"] <= 0
            and c["failed"]["value"] <= 0)
