"""Serve a shared-document workload through the port's decode engine.

    python -m repro_torch.launch.serve --arch qwen3-4b --requests 8 \\
        --doc-len 4096 --q-len 64 --max-new 32 --num-lanes 16

Every request is one shared document followed by its own question (token
ids drawn from ``--seed``); the weights are random, drawn from the same
seed on the device.  Prints prefill time, TPOT (decode seconds per engine
step, from the host clock around the decode loop up to a final
synchronize; each step emits one token for every running request) and the
CUDA kernel launch counts.  ``--fused`` decodes with one CUDA-graph replay
a token (``serving/step_fn.py``) and prints graph replays, graphs captured
and capture seconds.  ``--profile N`` traces decode steps 2..N+1 with
``torch.profiler`` and prints the device-busy share, the kernel and graph
launches the host issued and the kernels by device time, the top 12 or
``--top N`` (0: all).  Traced steps, graph captures and ``on_step``
callbacks are left out of TPOT.  Every run without ``--cache`` prints the
decode KV bytes CoDec reads per step against FlashDecoding's.
``--compare`` serves the
same prompts through ``codec-cuda`` and then the ``flash`` baseline,
prints both TPOTs and whether the greedy streams are equal, and exits 1
when they differ.  Runs on the card unless ``--device cpu``.

Serving under memory pressure: ``--max-pages`` sizes the KV pool (an
undersized pool preempts and recomputes), ``--prefill-chunk`` (an int or
``auto``) prefills long prompts in chunks interleaved with decode steps,
``--reserve-pages`` holds free pages back from admission and
``--max-running`` caps the admitted requests.  ``--arrivals scripted``
(one request every ``1/--rate`` steps) or ``poisson`` (exponential gaps at
``--rate`` requests a step, from ``--seed``) adds the requests as the loop
reaches their steps instead of all before it; the run then also prints its
loop steps, the row buckets it went through, both step times (§2 of
PERF.md), prefill seconds inside the loop, generated tokens per second and
the pressure counters.

The request lifecycle: ``--cache`` (or ``--cache-ttl`` / ``--cache-pages``,
which imply it) keeps finished requests' prefix KV resident and serves a
second wave of new questions over the same document through the same
engine, printing its time, hit rate and resident pages; ``--stream``
registers per-request streaming callbacks and prints first-token
latencies; ``--max-steps`` bounds the engine steps of each wave (0: none,
the loop runs until every request has ended); ``--deadline`` and
``--max-queue`` give every request an end-to-end and a queueing deadline
in seconds; ``--check-every`` runs the engine's invariant self-check
every N steps; ``--inject`` takes a fault schedule
(``serving/faults.py``'s grammar, e.g. ``dispatch@3*2,nan_logits@5:0``)
and ``--nan-guard`` quarantines rows whose logits turn non-finite; the
run then prints the faults fired, recoveries and each request's outcome.
Sampling at ``temperature > 0`` is the engine's ``temperature=`` argument,
as in ``repro``: the CLI has no flag for it.

Telemetry and cascade prefill (``repro``'s DESIGN §13-§14): the CLI runs
with the engine's telemetry on, as ``repro``'s does (``--no-telemetry``
turns it off), and ends with a one-line summary from its metrics registry
(requests done, tokens, p50 TTFT, TPOT, end-to-end and queue wait, the
trace's event count); ``--report-every N`` prints a one-line report of the
last N engine steps; ``--profile-every N`` makes every Nth fused step wait
for the card after its graph replay and prints the medians of its host
preparation, launch and device wait; ``--trace-out`` writes the Chrome
trace-event JSON (Perfetto, ``chrome://tracing``) and ``--metrics-out``
the registry (schema ``codec-metrics/1``), each suffixed with the backend
under ``--compare``.  ``--cascade`` prefills requests that share an
unfilled prefix as one group (the shared span once, the suffixes in one
batch) and prints the cascade counters.  ``serve()`` drives an engine
its caller built: there both are the engine's keywords
(``DecodeEngine(telemetry=, cascade=)``), off unless asked for.

Tree-speculative decoding (``repro``'s DESIGN §10): ``--speculative``
drafts token trees from each request's own history (``--spec-depth``,
``--spec-branch``, ``--spec-nodes`` bound them) and verifies them in one
dispatch a step (with ``--fused`` one CUDA-graph replay, a graph per
verify signature); the run then prints its verify dispatches, committed
tokens and drafts accepted.  Greedy only.

Mesh serving (``repro``'s DESIGN §9): ``--mesh DxM`` (e.g. ``2x2``)
serves over ``D`` data shards (KV pages) by ``M`` model shards (KV
heads), every shard on the one device, fused (it implies ``--fused``) and
through a shardable backend; ``--seq-split-pages`` is the pages a node
keeps on one data shard before moving on to the next, ``--replicate``
copies hot short prefix nodes onto every data shard, ``--calibrate``
times every mesh step and refits the cost model from them.  The run then
prints the shards' occupancy, the sequence-split and replicated nodes,
the merged rows, the replica promotions and, when calibrated, the fitted
coefficients.  ``--compare`` on a mesh compares ``codec-cuda`` with
``codec-torch`` (``flash`` does not shard).

``--dist-backend {nccl,gloo}`` runs the mesh as processes, one rank a
shard (``distributed.process_mesh``), under ``torchrun --nproc-per-node
D*M`` (which sets the ranks' environment; the group initializes from
it): each rank holds the weights and its own slab of the pool, on
``cuda:{LOCAL_RANK}`` unless ``--device`` names another.  Every rank
builds the same traffic from ``--seed`` and runs the same host logic;
rank 0 alone prints and exports telemetry.  NCCL captures each step's
collectives into its graph; gloo runs the step uncaptured.  The run
fixes ``PYTHONHASHSEED`` (re-executing itself once when it is unset).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, served_archs
from ..core import metrics as metrics_mod
from ..core.plan import bucket_pow2
from ..distributed.mesh import decode_mesh, parse_mesh, process_mesh
from ..kernels import pac as pac_mod, por as por_mod
from ..models.transformer import build_model
from ..serving.cache import CachePolicy
from ..serving.engine import DecodeEngine
from ..serving.faults import FaultPlan
from ..serving.speculation import SpecConfig
from ..serving.telemetry import Telemetry


def doc_prompts(n: int, doc_len: int, q_len: int, vocab: int,
                seed: int = 0) -> List[List[int]]:
    """``n`` prompts: one shared document + a private question each."""
    rng = np.random.default_rng(seed)
    doc = rng.integers(1, vocab, doc_len).tolist()
    return [doc + rng.integers(1, vocab, q_len).tolist() for _ in range(n)]


def build_schedule(arrivals: str, rate: float, rng: np.random.Generator,
                   n: int) -> List[int]:
    """The loop step at which each of ``n`` requests arrives.

    * ``scripted``: a fixed staircase — one request per ``1/rate`` steps;
    * ``poisson``: exponential inter-arrival gaps at ``rate`` requests a
      step, drawn from ``rng`` (open-loop replay).
    """
    if arrivals == "scripted":
        steps = [int(i / rate) for i in range(n)]
    elif arrivals == "poisson":
        gaps = rng.exponential(scale=1.0 / rate, size=n)
        steps = np.floor(np.cumsum(gaps)).astype(int).tolist()
    else:
        raise ValueError(f"arrivals must be 'scripted' or 'poisson', got "
                         f"{arrivals!r}")
    return steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


# host-side CUDA API calls (``cuda*`` and ``cu*``, by name prefix, as the
# trace names them) that launch a kernel, and those that launch a graph
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


# the engine counters of serving under memory pressure
PRESSURE_COUNTERS = ("preempted", "recompute_tokens", "prefill_chunks",
                     "prefill_stalls", "reclaimed")
# the engine counters of cascade prefill
CASCADE_COUNTERS = ("cascade_groups", "cascade_shared_tokens",
                    "cascade_suffix_tokens", "cascade_batches")


def telemetry_summary(telemetry: Telemetry) -> Dict[str, float]:
    """p50s in ms (None where nothing was observed) of the registry's
    latency histograms (request TTFT, TPOT, end to end, queue wait;
    engine step; and, where steps were sampled, their host preparation,
    launch and device wait), with the requests done, tokens generated and
    trace events, as of the engine's last step."""
    snap = telemetry.metrics.snapshot()
    out = {"requests_done": snap["requests_done"]["value"],
           "tokens": snap["tokens_generated"]["value"],
           "trace_events": len(telemetry.trace_events())}
    for name in ("ttft_s", "tpot_s", "e2e_s", "queue_wait_s", "step_s",
                 "profile_host_s", "profile_dispatch_s",
                 "profile_device_s"):
        h = snap[name]
        out[name[:-2] + "_p50_ms"] = (
            1e3 * metrics_mod.hist_quantile(h, 0.5) if h["count"] else None)
    out["profiled_steps"] = snap["profile_device_s"]["count"]
    return out


def metrics_reporter(engine: DecodeEngine, every: int):
    """An ``on_step`` hook printing a one-line report every ``every``
    decode steps from the engine's registry: tokens in the interval, rows
    running and waiting, pool occupancy, p50 step and TTFT (reader-owned
    snapshots, so other readers of the registry do not disturb it)."""
    prev = [engine.publish_metrics().snapshot()]

    def report(eng):
        if eng.stats["steps"] % every:
            return
        now = eng.publish_metrics().snapshot()
        d = metrics_mod.delta(now, prev[0])
        prev[0] = now
        line = (f"    [step {eng.stats['steps']}] "
                f"+{d['tokens_generated']['value']:.0f} tok, run/wait "
                f"{d['running']['value']:.0f}/{d['waiting']['value']:.0f},"
                f" pool {d['pool_occupancy']['value']:.0%}, step p50 "
                f"{1e3 * metrics_mod.hist_quantile(d['step_s'], 0.5):.1f}"
                f" ms")
        if d["ttft_s"]["count"]:
            line += (f", ttft p50 "
                     f"{1e3 * metrics_mod.hist_quantile(d['ttft_s'], 0.5):.0f}"
                     f" ms")
        if eng.cache is not None:
            line += f", cache hit {d['cache_hit_rate']['value']:.0%}"
        print(line)
    return report


def _count_calls(calls: Dict[str, int], prefixes) -> int:
    return sum(n for k, n in calls.items() if k.startswith(prefixes))


def profile_summary(prof, wall_s: float, steps: int,
                    top: int = 12) -> Dict[str, object]:
    """Per-step device busy time, idle share, the host's kernel and graph
    launches and the top kernels (all of them for ``top`` 0) of a
    ``torch.profiler`` trace over ``steps`` decode steps."""
    events = prof.key_averages()
    # device-side entries only (kernels, memcpy, memset): a host op's own
    # device time repeats its kernels'
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    calls = {e.key: e.count for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.key.startswith(("cuda", "cu"))}
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    wall_ms = 1e3 * wall_s / steps
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "kernel_launches_per_step": _count_calls(
                calls, KERNEL_LAUNCH_CALLS) / steps,
            "graph_launches_per_step": _count_calls(
                calls, GRAPH_LAUNCH_CALLS) / steps,
            "api_calls_per_step": {k: n / steps for k, n in calls.items()},
            "top": [(e.key[:60], _device_us(e) / 1e3 / steps,
                     e.count / steps)
                    for e in sorted(kernels, key=_device_us,
                                    reverse=True)[:top or None]]}


def serve(engine: DecodeEngine, prompts: List[List[int]], max_new: int,
          on_step=None, profile_steps: int = 0, profile_top: int = 12,
          arrival_steps: Optional[Sequence[int]] = None,
          max_steps: Optional[int] = None, on_token=None, on_done=None,
          deadline_s: Optional[float] = None,
          max_queue_s: Optional[float] = None) -> Dict[str, object]:
    """Serve ``prompts`` to the end: admit and prefill every prompt, then
    step until all are done; with ``arrival_steps`` each prompt is added
    at the start of its loop step instead, and the loop runs on while
    arrivals remain, even when the engine is idle.

    Two step times, from the host clock around the loop, stopped after a
    final synchronize (the fused path enqueues steps ahead of the card, so
    its engine-side ``decode_time`` counts enqueueing, not decoding; both
    paths are timed by these rules): ``step_ms``, the loop over its steps;
    and ``tpot_ms``, the decode time a step: the loop less graph captures
    (``capture_s``), prefill seconds inside the loop (``prefill_loop_s``:
    on the card the stream time between the events the engine records
    around each chunk, read after the synchronizes), the
    traced steps and ``on_step(engine)``, which runs after every step,
    over the decode steps.  ``profile_steps`` > 0 traces that many loop
    steps after the first with ``torch.profiler`` (from a synchronize to a
    synchronize, profiler set-up included; its ``profile_top`` kernels by
    device time are kept, 0: all).  Returns the streams, the timings, the
    row buckets the decode steps went through (consecutive repeats
    merged), the bucket signatures and graphs captured, the pressure
    counters, the pool's peak pages in use and the pages it handed out,
    and each request's outcome.  ``max_steps`` bounds the loop's steps;
    ``on_token``, ``on_done``, ``deadline_s`` and ``max_queue_s`` go to
    every ``add_request``.
    """
    def add(p):
        engine.add_request(p, max_new=max_new, on_token=on_token,
                           on_done=on_done, deadline_s=deadline_s,
                           max_queue_s=max_queue_s)

    dev = engine.device
    arrivals, prefill_s = [], 0.0
    _sync(dev)
    if arrival_steps is None:
        t0 = time.perf_counter()
        for p in prompts:
            add(p)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
    else:
        arrivals = sorted(zip(arrival_steps, range(len(prompts))))
    stats = engine.stats
    steps0, decode0 = stats["steps"], stats["decode_time"]
    capture0, prefill0 = stats["capture_time"], engine.prefill_time()
    pressure0 = {k: stats[k] for k in PRESSURE_COUNTERS}
    tokens0 = sum(len(q.generated) for q in engine.requests.values())
    prof, profile, hook_s, i, nxt = None, None, 0.0, 0, 0
    traced_s = traced_prefill = traced_steps = 0.0
    buckets: List[int] = []
    loop0 = time.perf_counter()
    while ((nxt < len(arrivals) or engine.has_work())
           and (max_steps is None or i < max_steps)):
        while nxt < len(arrivals) and arrivals[nxt][0] <= i:
            add(prompts[arrivals[nxt][1]])
            nxt += 1
        if profile_steps and i == 1:
            _sync(dev)              # the untraced steps' work ends here
            trace0 = time.perf_counter()
            trace_prefill0, trace_steps0 = (engine.prefill_time(),
                                            stats["steps"])
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            w0 = time.perf_counter()
        engine.step()
        i += 1
        rows = engine.step_stats[-1]["decoded"]
        if rows and (not buckets or buckets[-1] != bucket_pow2(rows)):
            buckets.append(bucket_pow2(rows))
        if prof is not None and i == 1 + profile_steps:
            _sync(dev)
            wall = time.perf_counter() - w0
            prof.__exit__(None, None, None)
            profile = profile_summary(prof, wall, profile_steps, profile_top)
            prof = None
            traced_s = time.perf_counter() - trace0
            traced_prefill = engine.prefill_time() - trace_prefill0
            traced_steps = stats["steps"] - trace_steps0
        if on_step is not None:
            h0 = time.perf_counter()
            on_step(engine)
            hook_s += time.perf_counter() - h0
    engine.flush_tokens()
    _sync(dev)
    loop_s = time.perf_counter() - loop0
    steps = stats["steps"] - steps0
    capture_s = stats["capture_time"] - capture0
    prefill_loop_s = engine.prefill_time() - prefill0 - traced_prefill
    tokens = sum(len(q.generated) for q in engine.requests.values()) \
        - tokens0
    timed = steps - traced_steps
    fused = engine.fused_step or engine.spec_step
    return {"streams": {r: q.generated for r, q in engine.requests.items()},
            "prefill_s": prefill_s, "loop_s": loop_s, "steps": steps,
            "loop_steps": i,
            "decode_s": stats["decode_time"] - decode0,
            "traced_s": traced_s, "capture_s": capture_s, "hook_s": hook_s,
            "prefill_loop_s": prefill_loop_s,
            "step_ms": 1e3 * loop_s / max(i, 1),
            "tpot_ms": 1e3 * (loop_s - traced_s - capture_s - hook_s
                              - prefill_loop_s) / max(timed, 1),
            "tokens_per_s": tokens / loop_s if loop_s > 0 else 0.0,
            "buckets": buckets,
            "signatures": len(engine.bucket_signatures),
            "graphs": 0 if fused is None else fused.graphs,
            "pressure": {k: stats[k] - pressure0[k]
                         for k in PRESSURE_COUNTERS},
            "peak_pages": engine.pool.allocator.peak_used,
            "allocs": engine.pool.allocator.total_allocs,
            "plan_s": stats["plan_time"],
            "advance_s": stats["advance_time"],
            "replans": stats["replans"], "profile": profile,
            "outcomes": outcomes(engine)}


def outcomes(engine: DecodeEngine) -> Dict[str, int]:
    """Requests by state: done, waiting, running, cancelled, ..."""
    out: Dict[str, int] = {}
    for q in engine.requests.values():
        out[q.state] = out.get(q.state, 0) + 1
    return out


def run(args, cfg, model, backend: str) -> Dict[str, object]:
    """Serve the prompts of ``args`` through ``backend``; print TPOT, the
    decode KV IO, the profile and the launch counts."""
    device = torch.device(args.device)
    cache = (CachePolicy(ttl_steps=args.cache_ttl,
                         max_pages=args.cache_pages)
             if args.cache else None)
    telemetry = (None if args.no_telemetry
                 else Telemetry(profile_every=args.profile_every))
    mesh_d, mesh_m = parse_mesh(args.mesh)
    mesh = (args.process_mesh if args.process_mesh is not None
            else decode_mesh(mesh_d, mesh_m, device=device)
            if mesh_d * mesh_m > 1 else None)
    engine = DecodeEngine(cfg, model, page_size=args.page_size,
                          num_pages=args.max_pages, backend=backend,
                          num_lanes=args.num_lanes,
                          fused=args.fused or mesh is not None, mesh=mesh,
                          seq_split_pages=args.seq_split_pages,
                          replicate=args.replicate,
                          calibrate=args.calibrate,
                          prefill_chunk=args.prefill_chunk,
                          reserve_pages=args.reserve_pages,
                          max_running=args.max_running, cache=cache,
                          cascade=args.cascade,
                          speculative=(SpecConfig(
                              depth=args.spec_depth, branch=args.spec_branch,
                              max_nodes=args.spec_nodes)
                              if args.speculative else None),
                          faults=(FaultPlan.parse(args.inject)
                                  if args.inject else None),
                          nan_guard=args.nan_guard,
                          check_every=args.check_every,
                          telemetry=telemetry, device=device)
    prompts = doc_prompts(args.requests, args.doc_len, args.q_len,
                          cfg.vocab_size, args.seed)
    steps = None
    if args.arrivals != "all":
        steps = build_schedule(args.arrivals, args.rate,
                               np.random.default_rng(args.seed), len(prompts))
    max_steps = args.max_steps or None
    first_tok: Dict[int, float] = {}

    def on_token(rid, tok):
        first_tok.setdefault(rid, time.perf_counter())

    on_step = (metrics_reporter(engine, args.report_every)
               if telemetry is not None and args.report_every > 0 else None)
    pac_mod.launches = por_mod.launches = por_mod.epilogue_launches = 0
    por_mod.mesh_merge_launches = 0
    t_submit = time.perf_counter()
    res = serve(engine, prompts, args.max_new, on_step=on_step,
                profile_steps=args.profile,
                profile_top=args.top, arrival_steps=steps,
                max_steps=max_steps,
                on_token=on_token if args.stream else None,
                deadline_s=args.deadline, max_queue_s=args.max_queue)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device {name}: {cfg.name} x{cfg.num_layers} layers, "
          f"{args.requests} requests, doc {args.doc_len} + q {args.q_len}, "
          f"{args.max_new} new tokens, backend {backend}, "
          f"{args.num_lanes} lanes, {'fused' if engine.fused else 'eager'}"
          + (f", mesh {args.mesh}" if mesh is not None else ""))
    print(f"prefill {res['prefill_s']:.3f} s, TPOT {res['tpot_ms']:.3f} ms "
          f"over {res['steps']} steps (decode loop {res['loop_s']:.3f} s, "
          f"less traced {res['traced_s']:.3f} s, capture "
          f"{res['capture_s']:.3f} s and prefill in the loop "
          f"{res['prefill_loop_s']:.3f} s; plan builds {res['replans']}, "
          f"{res['plan_s']:.3f} s; per-step plan advance "
          f"{res['advance_s']:.3f} s)")
    if steps is not None or res["pressure"]["preempted"]:
        print(f"{args.arrivals} arrivals: {res['loop_steps']} loop steps, "
              f"{res['steps']} decode steps, row buckets {res['buckets']}; "
              f"step {res['step_ms']:.3f} ms wall, decode {res['tpot_ms']:.3f} "
              f"ms a step; prefill in the loop {res['prefill_loop_s']:.3f} s; "
              f"{res['tokens_per_s']:.1f} generated tokens/s; pressure "
              + ", ".join(f"{k} {v}" for k, v in res["pressure"].items())
              + f"; peak pages {res['peak_pages']} of "
              f"{engine.pool.num_pages}, {res['allocs']} handed out")
    if args.cascade:
        print("cascade prefill: " + ", ".join(
            f"{k} {engine.stats[k]}" for k in CASCADE_COUNTERS)
            + f"; prefill {engine.prefill_time():.3f} s of prefill work")
    if engine.fused:
        step = engine.fused_step or engine.spec_step
        print(f"fused step: graph replays {step.replays} over "
              f"{engine.stats['fused_calls']} steps, graphs captured "
              f"{step.graphs} for {len(engine.bucket_signatures)} "
              f"bucket signatures, capture {res['capture_s']:.3f} s, token "
              f"flushes {engine.stats['token_flushes']}"
              + ("" if step.captures else " (uncaptured: the body runs "
                 "eagerly each step)"))
    st = engine.stats
    if mesh is not None:
        occ = "/".join(f"{o:.0%}" for o in engine.pool.shard_occupancy())
        # max over the per-window plans of the last epoch (a node split
        # across shards appears in every window's plan)
        splits = max((sp.seq_splits
                      for sp in engine._sharded_plans.values()), default=0)
        last = next(iter(engine._sharded_plans.values()), None)
        ls = last.stats() if last is not None else {}
        line = (f"mesh {args.mesh}: shard occupancy {occ}, {splits} "
                f"seq-split nodes, {ls.get('replicated_nodes', 0)} "
                f"replicated nodes / {ls.get('merge_row_count', 0)} merge "
                f"rows (last plan); replica promotions "
                f"{st['replica_promotions']}, demotions "
                f"{st['replica_demotions']}")
        if engine.cost_model.calibrated:
            hw = engine.cost_model.hw
            line += (f" | calibrated ({st['calibrations']} fits; shards "
                     f"run in turn on one device): hbm "
                     f"{hw.hbm_bw / 1e9:.1f} GB/s, ici {hw.ici_bw / 1e9:.1f}"
                     f" GB/s, page step {hw.grid_step_overhead * 1e6:.3f} "
                     f"us, merge round {hw.launch_overhead * 1e6:.3f} us")
        print(line)
    if engine.spec is not None:
        committed = sum(len(q.generated) for q in engine.requests.values())
        print(f"speculation: {st['spec_steps']} verify dispatches for "
              f"{committed} committed tokens; {st['spec_accepted']}/"
              f"{st['spec_proposed']} drafts accepted (+"
              f"{st['spec_accepted'] / max(st['spec_steps'], 1):.2f} extra "
              f"tokens/dispatch, {st['spec_draft_stalls']} page stalls)")
    if engine.cache is None and engine.attn_layer_idx:
        # with the cache on, finished requests have left the forest: the
        # line would count cached nodes against no request (and an
        # attention-free model reads no KV)
        esize = engine.pool.k.element_size()
        io_c = engine.forest.codec_io_bytes(cfg.num_kv_heads, cfg.head_dim,
                                            esize)
        io_f = engine.forest.flash_io_bytes(cfg.num_kv_heads, cfg.head_dim,
                                            esize)
        print(f"decode KV IO per layer and step: codec {io_c / 1e6:.1f} MB "
              f"vs flash {io_f / 1e6:.1f} MB per-request "
              f"({io_f / io_c:.2f}x saved)")
    prof = res["profile"]
    if prof is not None:
        print(f"profile over {args.profile} decode steps: wall "
              f"{prof['wall_ms']:.3f} ms/step, device busy "
              f"{prof['device_busy_ms']:.3f} ms/step, idle share "
              f"{prof['idle_share']:.3f}, {prof['kernels_per_step']:.0f} "
              f"kernels/step; host launches/step: kernels "
              f"{prof['kernel_launches_per_step']:.1f}, graphs "
              f"{prof['graph_launches_per_step']:.1f}")
        for kname, ms, count in prof["top"]:
            print(f"  {ms:9.4f} ms/step  {count:7.1f}/step  {kname}")
    if engine.injector is not None or args.nan_guard or args.deadline:
        fired = (dict(engine.injector.fired)
                 if engine.injector is not None else {})
        print(f"faults: {st['faults_injected']} injected {fired}, "
              f"{st['dispatch_failures']} dispatch failures / "
              f"{st['dispatch_recoveries']} recovered, {st['nan_rows']} "
              f"NaN rows quarantined, {st['callback_errors']} callback "
              f"errors, {st['invariant_checks']} self-checks | outcomes "
              f"{res['outcomes']}")
    if args.stream and first_tok:
        ttft = sorted(1e3 * (t - t_submit) for t in first_tok.values())
        print(f"streaming: first token after {ttft[0]:.0f}-{ttft[-1]:.0f} "
              f"ms ({len(first_tok)} streams)")
    if engine.cache is not None:
        # a second wave: new questions over the same document, served by
        # the same engine, whose admission finds the document resident
        warm = [p[:args.doc_len] + q[args.doc_len:] for p, q in zip(
            prompts, doc_prompts(args.requests, args.doc_len, args.q_len,
                                 cfg.vocab_size, args.seed + 1))]
        p0 = engine.prefill_time()
        wres = serve(engine, warm, args.max_new, max_steps=max_steps)
        cs = engine.cache.stats
        last = engine.step_stats[-1] if engine.step_stats else {}
        print(f"prefix cache: warm wave prefill "
              f"{wres['prefill_s']:.3f} s ({engine.prefill_time() - p0:.3f} "
              f"s of prefill work), TPOT {wres['tpot_ms']:.3f} ms, hit rate "
              f"{engine.cache.hit_rate:.0%} ({cs['hits']} hits / "
              f"{cs['misses']} misses, {cs['hit_tokens']} of "
              f"{cs['lookup_tokens']} prompt tokens cached), resident "
              f"{last.get('cache_resident_pages', 0)} pages "
              f"({last.get('cache_resident_bytes', 0) / 1e6:.1f} MB), "
              f"{cs['evicted_nodes']} nodes / {cs['evicted_pages']} pages "
              f"evicted")
    unfinished = [r for r, q in engine.requests.items()
                  if len(q.generated) < q.max_new and not q.finished]
    if unfinished:
        print(f"WARNING: {len(unfinished)} requests unfinished within "
              f"{max_steps} steps: {unfinished}")
    if telemetry is not None:
        s = telemetry_summary(telemetry)

        def ms(k):
            return "-" if s[k] is None else f"{s[k]:.1f} ms"
        print(f"telemetry: {s['requests_done']:.0f} done, "
              f"{s['tokens']:.0f} tokens; p50 ttft {ms('ttft_p50_ms')}, "
              f"tpot {ms('tpot_p50_ms')}, e2e {ms('e2e_p50_ms')}, queue "
              f"wait {ms('queue_wait_p50_ms')}, step {ms('step_p50_ms')};"
              f" {s['trace_events']} trace events")
        if s["profiled_steps"]:
            print(f"sampled steps ({s['profiled_steps']}, every "
                  f"{args.profile_every}): p50 host prep "
                  f"{ms('profile_host_p50_ms')}, launch "
                  f"{ms('profile_dispatch_p50_ms')}, device wait "
                  f"{ms('profile_device_p50_ms')}")
        suffix = f".{backend}" if args.compare else ""
        rank0 = args.process_mesh is None or args.process_mesh.rank == 0
        if args.trace_out and rank0:
            telemetry.export_trace(args.trace_out + suffix)
            print(f"trace -> {args.trace_out + suffix}")
        if args.metrics_out and rank0:
            engine.export_metrics(args.metrics_out + suffix)
            print(f"metrics -> {args.metrics_out + suffix}")
    print(json.dumps({"backend": backend,
                      "pac_launches": pac_mod.launches,
                      "epilogue_launches": por_mod.epilogue_launches,
                      "por_launches": por_mod.launches,
                      "mesh_merge_launches": por_mod.mesh_merge_launches,
                      "tokens": {str(r): len(t)
                                 for r, t in res["streams"].items()}}))
    return res


def _chunk(v: str):
    if v in ("none", ""):
        return None
    return v if v == "auto" else int(v)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=served_archs(),
                    help="any decoder-only config (Mamba and hybrid too)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--doc-len", type=int, default=4096)
    ap.add_argument("--q-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-pages", type=int, default=1024,
                    help="KV pool size in pages; an undersized pool "
                         "preempts and recomputes")
    ap.add_argument("--prefill-chunk", type=_chunk, default=None,
                    help="prefill token budget per step: int, 'auto' "
                         "(cost-model-driven), or 'none' (whole prompt)")
    ap.add_argument("--reserve-pages", type=int, default=0,
                    help="admission low watermark: free pages kept back "
                         "for decode growth of the running batch")
    ap.add_argument("--max-running", type=int, default=None,
                    help="cap on concurrently admitted requests")
    ap.add_argument("--arrivals", choices=("all", "scripted", "poisson"),
                    default="all",
                    help="all requests before the loop, or arriving at "
                         "loop steps (scripted staircase or Poisson)")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="arrivals per engine step (scripted, poisson)")
    ap.add_argument("--num-lanes", type=int, default=16)
    ap.add_argument("--backend", default="codec-cuda")
    ap.add_argument("--fused", action="store_true",
                    help="one CUDA-graph replay per decode step")
    ap.add_argument("--speculative", action="store_true",
                    help="tree-speculative decoding: self-drafted token "
                         "trees verified in one dispatch a step; greedy "
                         "only")
    ap.add_argument("--spec-depth", type=int, default=4,
                    help="max draft chain length per branch")
    ap.add_argument("--spec-branch", type=int, default=2,
                    help="max sibling draft branches at the leaf")
    ap.add_argument("--spec-nodes", type=int, default=6,
                    help="total draft nodes per request per step")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL shards for mesh serving, all on "
                         "--device (implies --fused, needs a shardable "
                         "backend)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="run --mesh as processes, one rank a shard, under "
                         "torchrun --nproc-per-node DATA*MODEL")
    ap.add_argument("--seq-split-pages", type=int, default=0,
                    help="pages a node keeps on one data shard before it "
                         "moves on to the next (0: only when one fills)")
    ap.add_argument("--replicate", action="store_true",
                    help="copy hot short prefix nodes onto every data "
                         "shard when the saved merge outweighs the extra "
                         "reads")
    ap.add_argument("--calibrate", action="store_true",
                    help="time every mesh step (waits for the device) and "
                         "refit the cost model's coefficients from them")
    ap.add_argument("--compare", action="store_true",
                    help="serve through codec-cuda, then flash; exit 1 "
                         "when the streams differ")
    ap.add_argument("--cache", action="store_true",
                    help="persistent cross-request prefix cache: finished "
                         "requests detach but their prefix KV stays "
                         "resident (serves a second wave over the same "
                         "document to show warm-cache admission)")
    ap.add_argument("--cache-ttl", type=int, default=None,
                    help="evict cached nodes untouched for this many "
                         "engine steps (implies --cache)")
    ap.add_argument("--cache-pages", type=int, default=None,
                    help="LRU cap on resident cached pages "
                         "(implies --cache)")
    ap.add_argument("--stream", action="store_true",
                    help="register per-request streaming callbacks and "
                         "report first-token latencies")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="engine step budget of each wave (0 = until "
                         "every request has ended)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request end-to-end deadline in seconds; "
                         "requests past it end TIMED_OUT with their KV "
                         "released")
    ap.add_argument("--max-queue", type=float, default=None,
                    help="max seconds a request may wait unadmitted "
                         "before it times out")
    ap.add_argument("--check-every", type=int, default=0,
                    help="run the engine invariant self-check every N "
                         "steps (0 = only after recoveries)")
    ap.add_argument("--inject", default=None,
                    help="fault schedule, e.g. 'dispatch@3*2,"
                         "nan_logits@5:0,stall@8=0.01' or "
                         "'seed:7[:rate]' (serving/faults.py grammar)")
    ap.add_argument("--nan-guard", action="store_true",
                    help="per-row NaN/inf logit guard: poisoned rows "
                         "are quarantined as FAILED instead of "
                         "streaming garbage")
    ap.add_argument("--cascade", action="store_true",
                    help="cascade prefill: co-admit waiting requests "
                         "sharing forest paths, compute shared unfilled "
                         "spans once a group and batch the per-request "
                         "suffix chunks into one forward")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="turn off the metrics registry and tracing "
                         "(on by default)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (Perfetto, "
                         "chrome://tracing); with --compare the backend "
                         "name is suffixed")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics registry as JSON "
                         "(schema codec-metrics/1)")
    ap.add_argument("--profile-every", type=int, default=0, metavar="N",
                    help="wait for the card after every Nth fused step's "
                         "replay and split it into host prep, launch and "
                         "device wait (0 = never; other steps untouched)")
    ap.add_argument("--report-every", type=int, default=0, metavar="N",
                    help="print a one-line metrics report every N decode "
                         "steps (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N decode steps with torch.profiler")
    ap.add_argument("--top", type=int, default=12, metavar="N",
                    help="kernels listed from the trace (0: all)")
    args = ap.parse_args(argv)
    if args.cache_ttl is not None or args.cache_pages is not None:
        args.cache = True
    args.process_mesh = None
    if args.dist_backend is None:
        return _main(args)
    if os.environ.get("PYTHONHASHSEED") != "0":
        # every rank must iterate its sets alike
        if argv is not None:
            raise RuntimeError("--dist-backend needs PYTHONHASHSEED=0")
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, "-m",
                                  "repro_torch.launch.serve"]
                 + sys.argv[1:])
    import torch.distributed as dist
    dist.init_process_group(args.dist_backend)
    try:
        device = (None if args.device == "cuda"
                  else torch.device(args.device))
        args.process_mesh = process_mesh(*parse_mesh(args.mesh),
                                         device=device)
        args.device = str(args.process_mesh.device)
        if args.process_mesh.rank == 0:
            return _main(args)
        with contextlib.redirect_stdout(io.StringIO()):
            return _main(args)
    finally:
        dist.destroy_process_group()


def _main(args) -> int:
    cfg = get_config(args.arch)
    model = build_model(cfg, seed=args.seed, device=torch.device(args.device),
                        dtype=torch.bfloat16)
    if args.compare:
        # flash does not shard: on a mesh the pair is the two shardable
        # codec backends
        d, m = parse_mesh(args.mesh)
        other = ("codec-torch" if d * m > 1 or args.process_mesh
                 else "flash")
        codec = run(args, cfg, model, "codec-cuda")
        base = run(args, cfg, model, other)
        match = codec["streams"] == base["streams"]
        print(f"TPOT codec-cuda {codec['tpot_ms']:.3f} ms, {other} "
              f"{base['tpot_ms']:.3f} ms")
        print(f"outputs codec == {other}: {match}")
        return 0 if match else 1
    run(args, cfg, model, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
