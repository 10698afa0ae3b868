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
callbacks are left out of TPOT.  Every run prints the decode KV bytes
CoDec reads per step against FlashDecoding's.  ``--compare`` serves the
same prompts through ``codec-cuda`` and then the ``flash`` baseline,
prints both TPOTs and whether the greedy streams are equal, and exits 1
when they differ.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..kernels import pac as pac_mod, por as por_mod
from ..models.transformer import build_model
from ..serving.engine import DecodeEngine


def doc_prompts(n: int, doc_len: int, q_len: int, vocab: int,
                seed: int = 0) -> List[List[int]]:
    """``n`` prompts: one shared document + a private question each."""
    rng = np.random.default_rng(seed)
    doc = rng.integers(1, vocab, doc_len).tolist()
    return [doc + rng.integers(1, vocab, q_len).tolist() for _ in range(n)]


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
          on_step=None, profile_steps: int = 0,
          profile_top: int = 12) -> Dict[str, object]:
    """Admit + prefill every prompt, then decode until all are done.

    TPOT is the host clock around the decode loop, stopped after a final
    synchronize, over the steps it ran: the fused path enqueues steps
    ahead of the card, so its engine-side ``decode_time`` counts
    enqueueing, not decoding, and both paths are timed by this one rule.
    Left out of it, and returned apart: ``profile_steps`` > 0 traces that
    many decode steps after the first with ``torch.profiler`` (from a
    synchronize to a synchronize, profiler set-up included; its ``profile_top`` kernels by device
    time are kept, 0: all), graph captures (``capture_s``) and the time of
    ``on_step(engine)``, which runs after every decode step.
    Returns the streams and host-clock timings.
    """
    dev = engine.device
    _sync(dev)
    t0 = time.perf_counter()
    for p in prompts:
        engine.add_request(p, max_new=max_new)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    steps0 = engine.stats["steps"]
    decode0 = engine.stats["decode_time"]
    capture0 = engine.stats["capture_time"]
    prof, profile, traced_s, hook_s, i = None, None, 0.0, 0.0, 0
    loop0 = time.perf_counter()
    while engine.has_work():
        if profile_steps and i == 1:
            _sync(dev)              # the untraced steps' work ends here
            trace0 = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            w0 = time.perf_counter()
        engine.step()
        i += 1
        if prof is not None and i == 1 + profile_steps:
            _sync(dev)
            wall = time.perf_counter() - w0
            prof.__exit__(None, None, None)
            profile = profile_summary(prof, wall, profile_steps, profile_top)
            prof = None
            traced_s = time.perf_counter() - trace0
        if on_step is not None:
            h0 = time.perf_counter()
            on_step(engine)
            hook_s += time.perf_counter() - h0
    _sync(dev)
    loop_s = time.perf_counter() - loop0
    steps = engine.stats["steps"] - steps0
    capture_s = engine.stats["capture_time"] - capture0
    timed = steps - (profile_steps if profile is not None else 0)
    return {"streams": {r: q.generated for r, q in engine.requests.items()},
            "prefill_s": prefill_s, "loop_s": loop_s, "steps": steps,
            "decode_s": engine.stats["decode_time"] - decode0,
            "traced_s": traced_s, "capture_s": capture_s, "hook_s": hook_s,
            "tpot_ms": 1e3 * (loop_s - traced_s - capture_s - hook_s)
            / max(timed, 1),
            "plan_s": engine.stats["plan_time"],
            "advance_s": engine.stats["advance_time"],
            "replans": engine.stats["replans"], "profile": profile}


def run(args, cfg, model, backend: str) -> Dict[str, object]:
    """Serve the prompts of ``args`` through ``backend``; print TPOT, the
    decode KV IO, the profile and the launch counts."""
    device = torch.device(args.device)
    engine = DecodeEngine(cfg, model, page_size=args.page_size,
                          num_pages=args.max_pages, backend=backend,
                          num_lanes=args.num_lanes, fused=args.fused,
                          device=device)
    prompts = doc_prompts(args.requests, args.doc_len, args.q_len,
                          cfg.vocab_size, args.seed)
    pac_mod.launches = por_mod.launches = por_mod.epilogue_launches = 0
    res = serve(engine, prompts, args.max_new, profile_steps=args.profile,
                profile_top=args.top)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device {name}: {cfg.name} x{cfg.num_layers} layers, "
          f"{args.requests} requests, doc {args.doc_len} + q {args.q_len}, "
          f"{args.max_new} new tokens, backend {backend}, "
          f"{args.num_lanes} lanes, {'fused' if engine.fused else 'eager'}")
    print(f"prefill {res['prefill_s']:.3f} s, TPOT {res['tpot_ms']:.3f} ms "
          f"over {res['steps']} steps (decode loop {res['loop_s']:.3f} s, "
          f"less traced {res['traced_s']:.3f} s and capture "
          f"{res['capture_s']:.3f} s; plan builds {res['replans']}, "
          f"{res['plan_s']:.3f} s; per-step plan advance "
          f"{res['advance_s']:.3f} s)")
    if engine.fused:
        print(f"fused step: graph replays {engine.fused_step.replays} over "
              f"{engine.stats['fused_calls']} steps, graphs captured "
              f"{engine.fused_step.graphs} for {len(engine.bucket_signatures)} "
              f"bucket signatures, capture {res['capture_s']:.3f} s, token "
              f"flushes {engine.stats['token_flushes']}")
    esize = engine.pool.k.element_size()
    io_c = engine.forest.codec_io_bytes(cfg.num_kv_heads, cfg.head_dim,
                                        esize)
    io_f = engine.forest.flash_io_bytes(cfg.num_kv_heads, cfg.head_dim,
                                        esize)
    print(f"decode KV IO per layer and step: codec {io_c / 1e6:.1f} MB vs "
          f"flash {io_f / 1e6:.1f} MB per-request ({io_f / io_c:.2f}x "
          f"saved)")
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
    print(json.dumps({"backend": backend,
                      "pac_launches": pac_mod.launches,
                      "epilogue_launches": por_mod.epilogue_launches,
                      "por_launches": por_mod.launches,
                      "tokens": {str(r): len(t)
                                 for r, t in res["streams"].items()}}))
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--doc-len", type=int, default=4096)
    ap.add_argument("--q-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-pages", type=int, default=1024)
    ap.add_argument("--num-lanes", type=int, default=16)
    ap.add_argument("--backend", default="codec-cuda")
    ap.add_argument("--fused", action="store_true",
                    help="one CUDA-graph replay per decode step")
    ap.add_argument("--compare", action="store_true",
                    help="serve through codec-cuda, then flash; exit 1 "
                         "when the streams differ")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N decode steps with torch.profiler")
    ap.add_argument("--top", type=int, default=12, metavar="N",
                    help="kernels listed from the trace (0: all)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = build_model(cfg, seed=args.seed, device=torch.device(args.device),
                        dtype=torch.bfloat16)
    if args.compare:
        codec = run(args, cfg, model, "codec-cuda")
        flash = run(args, cfg, model, "flash")
        match = codec["streams"] == flash["streams"]
        print(f"TPOT codec-cuda {codec['tpot_ms']:.3f} ms, flash "
              f"{flash['tpot_ms']:.3f} ms")
        print(f"outputs codec == flash: {match}")
        return 0 if match else 1
    run(args, cfg, model, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
