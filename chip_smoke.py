#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. identify the card (``nvidia-smi``) and build the CUDA kernels with
   ``nvcc`` from ``src/repro_torch/kernels/csrc``;
2. hold PAC and POR against their plain torch versions at the full
   qwen3-4b attention width (h_q=32, n_kv=8, d=128, page 16, max_q 32)
   over three plan forests, in float32 and bfloat16 KV;
3. serve qwen3-4b at full width and depth (36 layers, bf16 random weights)
   through the engine's default ``codec-cuda`` backend: 8 requests over a
   shared 4096-token document + 64-token questions, 32 greedy tokens each;
   the kernels' launch counts must equal attention layers x decode steps.
   Then PAC and POR are checked and timed at the plan and pool shapes that
   run left behind;
4. at 4 layers, full width, f32 weights: greedy streams through
   ``codec-cuda`` and ``codec-torch`` must be equal;
5. print the ``kernels`` JSON line and the closing device line.

It needs CUDA and exits at once when ``torch.cuda.is_available()`` is
false; it imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM datasheet peaks (dense): HBM bytes/s and FLOP/s by input type
HBM_BW = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# f32: the kernel and the plain version sum the same products in different
# orders (and index_add_ on CUDA in a run-dependent order): ~1 ulp per add
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
POR_TOL = 1e-6
H_Q, N_KV, D, PAGE, MAX_Q, LANES = 32, 8, 128, 16, 32, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """Mean device milliseconds of ``fn`` from CUDA events.

    Before each launch the L2 cache is flushed (the engine meets every
    layer's pool cold) and the stream is held in a ~1 ms spin, so the host
    has queued ``fn``'s launches before the start event fires: the events
    then bracket device work only, not the wrapper's host overhead."""

    def __init__(self):
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in
               zip(got, want))


def assert_close(name, got, want, tol) -> float:
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")
    return max_err(got, want)


def live_slots(pa):
    slot = torch.arange(pa.q_gather.shape[1], device=pa.q_gather.device)
    return slot[None, :] < pa.task_qnum[:, None]


def pac_bound(plan, pa, q, k_pool):
    """Least time for PAC on these inputs: the KV tokens the plan's valid
    steps cover (K and V, read once), the queries, the plan arrays and the
    live partials written, over HBM; its FLOPs over the peak for the KV
    type.  Returns (ms, "bytes" | "operations")."""
    valid = plan.step_valid.astype(bool)
    kv_tokens = int(plan.step_kvlen[valid].sum())
    esize = k_pool.element_size()
    live = int(live_slots(pa).sum())
    h_q, d = q.shape[1], q.shape[2]
    n_kv = k_pool.shape[2]
    plan_bytes = sum(t.numel() * t.element_size() for t in pa)
    nbytes = (2 * kv_tokens * n_kv * d * esize + q.numel() * q.element_size()
              + plan_bytes + live * h_q * (d + 2) * 4)
    qnum = plan.task_qnum[plan.step_task[valid]]
    flops = 4.0 * float(np.sum(qnum * plan.step_kvlen[valid])) * h_q * d
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[k_pool.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def por_bound(o):
    n = o.numel()
    rows = o.shape[0] * o.shape[1]
    nbytes = 3 * 4 * (n + 2 * rows)     # two partials in, one out
    return 1e3 * nbytes / HBM_BW, "bytes"


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions at full width
# --------------------------------------------------------------------- #
def check_kernels(forest_name, forest, window, dtype, gen):
    from repro_torch.core import cost_model, plan as plan_mod
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    pages = plan_mod.assign_dense_pages(forest)
    cm = cost_model.CostModel(H_Q, N_KV, D, page_size=PAGE)
    plan = plan_mod.pad_plan(plan_mod.build_plan(
        forest, cm, num_lanes=LANES, max_q=MAX_Q, window=window))
    B = len(forest.request_ids)
    k = torch.randn(pages, PAGE, N_KV, D, generator=gen, device="cuda"
                    ).to(dtype)
    v = torch.randn(pages, PAGE, N_KV, D, generator=gen, device="cuda"
                    ).to(dtype)
    q = torch.randn(B, H_Q, D, generator=gen, device="cuda").to(dtype)
    pa = ops.plan_arrays(plan, "cuda")
    live = live_slots(pa)
    got = pac_mod.pac(q, pa, k, v, window=window)
    want = pac_mod.pac_torch(q[pa.q_gather.long()], pa.q_pos, k, v,
                             pa.task_pages, pa.task_kvlen, pa.task_pos,
                             window=window)
    torch.cuda.synchronize()
    err = assert_close(f"pac {forest_name} {dtype}", [x[live] for x in got],
                       [x[live] for x in want], TOL[dtype])
    full = ops.codec_partials_arrays(q, k, v, pa, plan.num_queries,
                                     window=window, impl="cuda")
    full_t = ops.codec_partials_arrays(q, k, v, pa, plan.num_queries,
                                       window=window, impl="torch")
    err = max(err, assert_close(f"codec {forest_name} {dtype}", full,
                                full_t, TOL[dtype]))
    # POR: merge the plan partials with a second partial set
    other = ops.single_page_attention(q, k[:B], v[:B],
                                      torch.zeros(B, device="cuda"),
                                      torch.full((B,), PAGE - 1,
                                                 device="cuda"))
    merged = por_mod.por(*full_t, *other)
    plain = por_mod.por_torch(*full_t, *other)
    torch.cuda.synchronize()
    por_err = assert_close(f"por {forest_name} {dtype}", merged, plain,
                           POR_TOL)
    log(f"  {forest_name:<10} window={window:<4} {str(dtype):<15} tasks="
        f"{plan.num_tasks:<3} steps/lane={plan.max_steps:<4} "
        f"pac max|err|={err:.3e} (tol {TOL[dtype]:g})  "
        f"por max|err|={por_err:.3e} (tol {POR_TOL:g})")


def phase_kernels():
    from repro_torch.core import tree
    gen = torch.Generator(device="cuda").manual_seed(1)
    forests = [
        ("two-level", lambda: tree.two_level(8, 4096, 64, block_size=PAGE), 0),
        ("3-ary x3", lambda: tree.full_kary(3, 3, 320, block_size=PAGE), 0),
        ("windowed", lambda: tree.two_level(8, 2048, 64, block_size=PAGE),
         512),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, make, window in forests:
            check_kernels(name, make(), window, dtype, gen)


# --------------------------------------------------------------------- #
# phase 3: serve qwen3-4b at full width and depth
# --------------------------------------------------------------------- #
def phase_serve(timer):
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine

    cfg = get_config(PAPER_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  model {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.param_count() / 1e9:.2f} B params, bf16, "
        f"random weights from seed 0 in {time.perf_counter() - t0:.1f} s")
    engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                          num_lanes=LANES, max_q=MAX_Q, device="cuda")
    log(f"  KV pool: {engine.pool.bytes_used() / 2**30:.2f} GiB f32, "
        f"{engine.pool.num_pages} pages of {PAGE}")
    prompts = doc_prompts(8, 4096, 64, cfg.vocab_size, seed=0)
    finite = []

    def on_step(eng):
        finite.append(bool(torch.isfinite(eng.last_logits).all()))

    pac_mod.launches = por_mod.launches = 0
    res = serve(engine, prompts, max_new=32, on_step=on_step)
    launches = {"pac": pac_mod.launches, "por": por_mod.launches}
    n_attn = len(engine.attn_layer_idx)
    expect = n_attn * res["steps"]
    lens = sorted({len(t) for t in res["streams"].values()})
    log(f"  streams: {len(res['streams'])} requests, lengths {lens}; "
        f"decode steps {res['steps']}; plan builds {res['replans']}")
    assert lens == [32], lens
    assert finite and all(finite), "non-finite logits"
    assert launches == {"pac": expect, "por": expect}, (launches, expect)
    log(f"  launches: PAC {launches['pac']}, POR {launches['por']} = "
        f"{n_attn} attention layers x {res['steps']} decode steps")
    log(f"  prefill {res['prefill_s'] * 1e3:.1f} ms (8 prompts, 4160 tokens "
        f"each, 4096 shared); TPOT {res['tpot_ms']:.3f} ms per step of 8 "
        f"tokens; plan builds {res['plan_s'] * 1e3:.2f} ms total, per-step "
        f"plan advance {res['advance_s'] * 1e3 / res['steps']:.3f} ms")

    # PAC and POR at the shapes this run gave them: the last plan, layer
    # 0's pool and bf16 queries of the batch's shape
    plan, pa = engine._plans[0]
    k_pool, v_pool = engine.pool.layer_pools(0)
    B = plan.num_queries
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(B, cfg.num_heads, cfg.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    live = live_slots(pa)
    got = pac_mod.pac(q, pa, k_pool, v_pool)
    want = pac_mod.pac_torch(q[pa.q_gather.long()], pa.q_pos, k_pool,
                             v_pool, pa.task_pages, pa.task_kvlen,
                             pa.task_pos)
    torch.cuda.synchronize()
    pac_err = assert_close("pac main path", [x[live] for x in got],
                           [x[live] for x in want], TOL[torch.float32])
    o_f = ops.codec_partials_arrays(q, k_pool, v_pool, pa, B, impl="cuda")
    tail = torch.arange(B, device="cuda")
    o_t = ops.single_page_attention(q, k_pool[tail], v_pool[tail],
                                    torch.zeros(B, device="cuda"),
                                    torch.full((B,), PAGE - 1,
                                               device="cuda"))
    merged = por_mod.por(*o_f, *o_t)
    plain = por_mod.por_torch(*o_f, *o_t)
    torch.cuda.synchronize()
    por_err = assert_close("por main path", merged, plain, POR_TOL)

    pac_ms = timer(lambda: pac_mod.pac(q, pa, k_pool, v_pool))
    pac_plain_ms = timer(lambda: pac_mod.pac_torch(
        q[pa.q_gather.long()], pa.q_pos, k_pool, v_pool, pa.task_pages,
        pa.task_kvlen, pa.task_pos))
    por_ms = timer(lambda: por_mod.por(*o_f, *o_t))
    por_plain_ms = timer(lambda: por_mod.por_torch(*o_f, *o_t))
    pac_b, pac_by = pac_bound(plan, pa, q, k_pool)
    por_b, por_by = por_bound(o_f[0])
    log(f"  main-path plan: {plan.num_tasks} tasks on {plan.num_lanes} lanes"
        f", {plan.max_steps} steps/lane, {int(plan.step_valid.sum())} "
        f"valid page steps")
    log(f"  PAC {pac_ms:.4f} ms/launch (plain {pac_plain_ms:.4f}, bound "
        f"{pac_b:.4f} by {pac_by}), max|err| {pac_err:.3e}; "
        f"{pac_ms * n_attn:.3f} ms per decode step")
    log(f"  POR {por_ms:.4f} ms/launch (plain {por_plain_ms:.4f}, bound "
        f"{por_b:.5f} by {por_by}), max|err| {por_err:.3e}; "
        f"{por_ms * n_attn:.3f} ms per decode step")
    kernels = [
        {"name": "pac", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pac.cu",
         "replaces": "src/repro/kernels/pac.py:138",
         "launches": launches["pac"], "max_abs_err": pac_err,
         "ms": pac_ms, "plain_ms": pac_plain_ms, "bound_ms": pac_b,
         "bound_by": pac_by, "library_ms": None},
        {"name": "por", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/por.cu",
         "replaces": "src/repro/kernels/por.py:44",
         "launches": launches["por"], "max_abs_err": por_err,
         "ms": por_ms, "plain_ms": por_plain_ms, "bound_ms": por_b,
         "bound_by": por_by, "library_ms": None},
    ]
    del engine, model, got, want, o_f, o_t, merged, plain
    torch.cuda.empty_cache()
    return kernels


# --------------------------------------------------------------------- #
# phase 4: backends agree on the card
# --------------------------------------------------------------------- #
def phase_backends():
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine

    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    prompts = doc_prompts(8, 4096, 64, cfg.vocab_size, seed=1)
    streams, top2 = {}, {}
    for backend in ("codec-cuda", "codec-torch"):
        engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                              num_lanes=LANES, max_q=MAX_Q, backend=backend,
                              device="cuda")
        gaps = []
        res = serve(engine, prompts, max_new=32, on_step=lambda e: gaps.append(
            torch.topk(e.last_logits, 2).values.cpu()))
        streams[backend], top2[backend] = res["streams"], gaps
        del engine
        torch.cuda.empty_cache()
    a, b = streams["codec-cuda"], streams["codec-torch"]
    if a != b:
        for r in sorted(a):
            diff = [i for i, (x, y) in enumerate(zip(a[r], b[r])) if x != y]
            if diff:
                i = diff[0]
                g = top2["codec-cuda"][i - 1][r] if i > 0 else None
                log(f"  request {r} first differs at token {i}: "
                    f"{a[r][i]} vs {b[r][i]}; codec-cuda top-2 logits there "
                    f"{None if g is None else g.tolist()}")
        raise AssertionError("codec-cuda and codec-torch streams differ")
    log(f"  {cfg.num_layers} layers f32: codec-cuda == codec-torch on "
        f"{len(a)} streams x 32 tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build

    # the plain versions must run in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()

    log("== 1. identify + build")
    card = nvidia_smi()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build.load()
    info = build.build_info
    log(f"  kernels built in {info['seconds']:.1f} s "
        f"({'cached' if info['cached'] else 'nvcc sm_90a'})")
    for line in str(info.get("log", "")).splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    log("== 2. kernels vs plain versions at full width")
    phase_kernels()
    timer = Timer()

    log("== 3. serve qwen3-4b, full width and depth")
    kernels = phase_serve(timer)

    log("== 4. codec-cuda vs codec-torch streams")
    phase_backends()

    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
