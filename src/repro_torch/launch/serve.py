"""Serve a shared-document workload through the port's decode engine.

    python -m repro_torch.launch.serve --arch qwen3-4b --requests 8 \\
        --doc-len 4096 --q-len 64 --max-new 32 --num-lanes 16

Every request is one shared document followed by its own question (token
ids drawn from ``--seed``); the weights are random, drawn from the same
seed on the device.  Prints prefill time, TPOT (decode seconds per engine
step; each step emits one token for every running request) and the CUDA
kernel launch counts.  ``--profile N`` traces decode steps 2..N+1 with
``torch.profiler`` and prints the device-busy share and the kernels by
device time, the top 12 or ``--top N`` (0: all; those steps are left out
of TPOT).  Every run prints the
decode KV bytes CoDec reads per step against FlashDecoding's.
``--compare`` serves the same prompts through ``codec-cuda`` and then the
``flash`` baseline, prints both TPOTs and whether the greedy streams are
equal, and exits 1 when they differ.  Runs on the card unless
``--device cpu``.
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


def profile_summary(prof, wall_s: float, steps: int,
                    top: int = 12) -> Dict[str, object]:
    """Per-step device busy time, idle share and the top kernels (all of
    them for ``top`` 0) of a ``torch.profiler`` trace over ``steps``
    decode steps."""
    # device-side entries only (kernels, memcpy, memset): a host op's own
    # device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    wall_ms = 1e3 * wall_s / steps
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top": [(e.key[:60], _device_us(e) / 1e3 / steps,
                     e.count / steps)
                    for e in sorted(kernels, key=_device_us,
                                    reverse=True)[:top or None]]}


def serve(engine: DecodeEngine, prompts: List[List[int]], max_new: int,
          on_step=None, profile_steps: int = 0,
          profile_top: int = 12) -> Dict[str, object]:
    """Admit + prefill every prompt, then decode until all are done.

    ``on_step(engine)`` runs after every decode step (outside the engine's
    own decode timer).  ``profile_steps`` > 0 traces that many decode
    steps after the first with ``torch.profiler`` (left out of TPOT) and
    keeps its ``profile_top`` kernels by device time (0: all).
    Returns the streams and host-clock timings.
    """
    dev = engine.device
    _sync(dev)
    t0 = time.perf_counter()
    for p in prompts:
        engine.add_request(p, max_new=max_new)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    decode0, steps0 = engine.stats["decode_time"], engine.stats["steps"]
    prof, profile, traced_s, i = None, None, 0.0, 0
    while engine.has_work():
        if profile_steps and i == 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            w0, d0 = time.perf_counter(), engine.stats["decode_time"]
        engine.step()
        i += 1
        if prof is not None and i == 1 + profile_steps:
            _sync(dev)
            wall = time.perf_counter() - w0
            traced_s = engine.stats["decode_time"] - d0
            prof.__exit__(None, None, None)
            profile = profile_summary(prof, wall, profile_steps, profile_top)
            prof = None
        if on_step is not None:
            on_step(engine)
    _sync(dev)
    steps = engine.stats["steps"] - steps0
    decode_s = engine.stats["decode_time"] - decode0
    timed = steps - (profile_steps if profile is not None else 0)
    return {"streams": {r: q.generated for r, q in engine.requests.items()},
            "prefill_s": prefill_s, "decode_s": decode_s, "steps": steps,
            "tpot_ms": 1e3 * (decode_s - traced_s) / max(timed, 1),
            "plan_s": engine.stats["plan_time"],
            "advance_s": engine.stats["advance_time"],
            "replans": engine.stats["replans"], "profile": profile}


def run(args, cfg, model, backend: str) -> Dict[str, object]:
    """Serve the prompts of ``args`` through ``backend``; print TPOT, the
    decode KV IO, the profile and the launch counts."""
    device = torch.device(args.device)
    engine = DecodeEngine(cfg, model, page_size=args.page_size,
                          num_pages=args.max_pages, backend=backend,
                          num_lanes=args.num_lanes, device=device)
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
          f"{args.num_lanes} lanes")
    print(f"prefill {res['prefill_s']:.3f} s, TPOT {res['tpot_ms']:.3f} ms "
          f"over {res['steps']} steps (plan builds {res['replans']}, "
          f"{res['plan_s']:.3f} s; per-step plan advance "
          f"{res['advance_s']:.3f} s)")
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
              f"kernels/step")
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
