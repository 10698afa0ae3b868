#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. identify the card (``nvidia-smi``) and build the CUDA kernels with
   ``nvcc`` from ``src/repro_torch/kernels/csrc``;
2. hold PAC, POR, the POR epilogue and ``flash_decode`` against their
   plain torch versions at the full qwen3-4b attention width (h_q=32,
   n_kv=8, d=128): PAC/POR at max_q 32 over plans that stress PAC's ring
   and its lanes — three codec plan forests at page 16, the flash plan of
   the served forest (~130 steps a lane), a plan with more lanes than
   work, and page 64 — in float32 and bfloat16 KV; the epilogue over
   engine-shaped plans (leaves cut to full pages, each request's last page
   its tail) of the served forest under the codec and the flash plan, with
   a tail-only request (an empty segment), with no task at all, under a
   window of 512 and at page 64, q and KV in float32 and bfloat16, NaN in
   every dead slot and in the output it writes; ``flash_decode`` over
   uneven ``kv_lens`` with NaN past every one, with and without a window;
3. serve qwen3-4b at full width and depth (36 layers, bf16 random weights)
   through the engine's default ``codec-cuda`` backend: 8 requests over a
   shared 4096-token document + 64-token questions, 32 greedy tokens each;
   PAC and the epilogue must each launch attention layers x decode steps
   times, the pairwise POR kernel never.  Then PAC, POR and the epilogue
   are checked and timed at the plan and pool shapes that run left
   behind, the epilogue beside its plain version and beside the route it
   replaced (select, segment reduction, tail page, pairwise POR, cast);
4. CoDec against FlashDecoding on that run's last decode state (layer 0's
   pool and plan): the engine's attention, the ``flash`` backend over a
   per-request plan and ``flash_decode`` over a dense copy of every
   request's context must agree; PAC under both plans, ``flash_decode``
   and one SDPA call are timed against their bounds, and PAC once more
   over the codec plan rebuilt at 32 lanes;
5. serve the same workload again through the ``flash`` backend (36
   layers), with the same launch counts, and print its TPOT beside
   ``codec-cuda``'s;
6. at 4 layers, full width, f32 weights: greedy streams through
   ``codec-cuda``, ``codec-torch``, ``flash`` and ``hydragen`` must be
   equal;
7. print the ``kernels`` JSON line and the closing device line.

It needs CUDA and exits at once when ``torch.cuda.is_available()`` is
false; it imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import statistics
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
# orders (and index_add_ on CUDA in a run-dependent order): ~1 ulp per add.
# bf16 KV: PAC's tensor cores see q and P as bf16 hi + lo terms (max |err|
# ~4e-4 measured at these shapes), flash_decode stays on f32 FFMA
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
POR_TOL = 1e-6
# the epilogue against its plain version on the same partials: f32 output
# within 1e-5 (sums in another order), bf16 output within one bf16 step
# (the two round f32 values that differ in their last bits) wherever it
# differs by more than 1e-5 (near zero a step is finer than that)
EPI_TOL, EPI_ULPS = 1e-5, 1
H_Q, N_KV, D, PAGE, MAX_Q, LANES = 32, 8, 128, 16, 32, 16
BACKENDS = ("codec-cuda", "codec-torch", "flash", "hydragen")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_reports(text):
    """(kernel, report) for each registers / spill line of nvcc's
    ``-Xptxas -v`` output, the kernel's name demangled where ``c++filt``
    is at hand."""
    out, name = [], ""
    for line in text.splitlines():
        if "Compiling entry function" in line or "Function properties for" \
                in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
        elif ("registers" in line or "spill" in line) and name:
            out.append((name, line.split(":", 1)[-1].strip()))
    names = sorted({n for n, _ in out})
    if names and shutil.which("c++filt"):
        dem = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        pretty = dict(zip(names, dem.stdout.splitlines()))
        out = [(pretty.get(n, n).replace("(anonymous namespace)::", ""), r)
               for n, r in out]
    return out


class Timer:
    """Mean device milliseconds of ``fn`` over ``reps`` launches, from CUDA
    events; the median of the same launches is kept in ``self.median``
    (one stalled launch moves the mean, not the median).

    Before each launch the L2 cache is flushed (the engine meets every
    layer's pool cold) and the stream is held in a spin of ~5 ms, so the
    host has queued all of ``fn``'s launches before the start event fires:
    the events then bracket device work only, not the host's (a plain
    version or a replaced route issues dozens of launches, which a spin of
    ~1 ms did not always cover)."""

    def __init__(self):
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
        self.median = float("nan")

    def __call__(self, fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(10_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        self.median = statistics.median(times)
        return statistics.mean(times)


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in
               zip(got, want))


def assert_close(name, got, want, tol) -> float:
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")
    return max_err(got, want)


def bf16_ulps(got, want, atol=EPI_TOL) -> int:
    """Largest distance, in bf16 steps, between two bf16 tensors, over the
    elements that differ by more than ``atol``."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    far = (got.float() - want.float()).abs() > atol
    steps = (ordered(got) - ordered(want)).abs()[far]
    return int(steps.max()) if steps.numel() else 0


def cut_leaves(forest, rows):
    """What the engine's decode step derives from the forest for ``rows``:
    each leaf cut to its full pages (the plan's ``truncate``) and each
    request's tail arrays (tail_pages, tail_base, q_pos) on the card."""
    ps = forest.block_size
    truncate = {}
    tail = np.zeros((3, len(rows)), np.int64)
    for i, r in enumerate(rows):
        leaf = forest.nodes[forest.leaf_of[r]]
        tp = (leaf.length - 1) // ps
        truncate[leaf.id] = tp * ps
        tail[:, i] = (leaf.page_ids[tp], leaf.start_pos + tp * ps,
                      forest.context_len(r) - 1)
    return truncate, list(torch.as_tensor(tail, device="cuda").unbind(0))


def engine_state(forest, cm, lanes, max_q, max_kv, window=0, flash=False):
    """The plan the engine builds for this forest (leaves cut, rows in
    request order, padded) and each request's tail arrays."""
    from repro_torch.core import plan as plan_mod
    rows = sorted(forest.request_ids)
    truncate, tails = cut_leaves(forest, rows)
    make = plan_mod.flash_plan if flash else plan_mod.build_plan
    plan = plan_mod.pad_plan(make(
        forest, cm, lanes, max_q, max_kv,
        req_rows={r: i for i, r in enumerate(rows)}, window=window,
        truncate=truncate))
    return plan, tails


def epilogue_bound(q, parts, k_pool, tails, window=0):
    """Least time for the epilogue on these inputs: the live partial rows
    (o, m, l), the tail K and V tokens each query sees, q, the CSR and the
    tail arrays read once and the output written once, over HBM; its FLOPs
    (4 per query head, column and tail token; 3 per head, column and
    partial row) over the f32 peak.  Returns (ms, "bytes" | "operations").
    """
    B, h_q, d = q.shape
    _, page, n_kv, _ = k_pool.shape
    tail_pages, tail_base, q_pos = tails
    hi = torch.clamp(q_pos - tail_base, max=page - 1)
    lo = (torch.clamp(q_pos - window + 1 - tail_base, min=0) if window > 0
          else torch.zeros_like(hi))
    tokens = int(torch.clamp(hi - lo + 1, min=0).sum())
    nnz = parts.seg_rows.numel()
    nbytes = (nnz * h_q * (d + 2) * 4
              + 2 * tokens * n_kv * d * k_pool.element_size()
              + 2 * q.numel() * q.element_size()
              + (B + 1 + nnz) * 4 + 3 * B * 8)
    flops = 4.0 * tokens * h_q * d + 3.0 * nnz * h_q * d
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def parent_epilogue(q, raw, pa, seg_ids, k_pool, v_pool, tails):
    """The route the epilogue replaced, op for op as the engine ran it
    before: the dead-slot selects on PAC's task-major partials, the segment
    reduction, the tail page over gathered pages, the pairwise POR kernel
    and the cast."""
    from repro_torch.kernels import ops, por as por_mod, ref
    o, m, l = raw
    tail_pages, tail_base, q_pos = tails
    slot = torch.arange(pa.q_gather.shape[1], device=q.device)
    live = slot[None, :] < pa.task_qnum[:, None]
    m = torch.where(live[..., None], m, torch.full_like(m, ops.MASK_VALUE))
    l = torch.where(live[..., None], l, torch.zeros_like(l))
    o = torch.where(live[..., None, None], o, torch.zeros_like(o))
    P = o.shape[0] * o.shape[1]
    o_f = ref.combine_partials_stats_ref(
        o.reshape(P, *o.shape[2:]), m.reshape(P, -1), l.reshape(P, -1),
        seg_ids, q.shape[0])
    o_t = ops.single_page_attention(q, k_pool[tail_pages], v_pool[tail_pages],
                                    tail_base, q_pos)
    return por_mod.por(*o_f, *o_t)[0].to(q.dtype)


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


def fd_bound(q, k, kv_lens):
    """Least time for ``flash_decode`` (no window) on these inputs: the
    visible K and V (kv_len positions of each row, read once), q, kv_lens
    and the output over HBM; 4 FLOPs per query head, column and visible
    position over the peak for the KV type."""
    tokens = int(kv_lens.long().clamp(0, k.shape[1]).sum())
    _, _, n_kv, d = k.shape
    h_q = q.shape[1]
    nbytes = (2 * tokens * n_kv * d * k.element_size()
              + 2 * q.numel() * q.element_size() + kv_lens.numel() * 4)
    flops = 4.0 * tokens * h_q * d
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[k.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions at full width
# --------------------------------------------------------------------- #
def check_kernels(forest_name, forest, window, dtype, gen, *, lanes=LANES,
                  flash=False):
    from repro_torch.core import cost_model, plan as plan_mod
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    page = forest.block_size
    pages = plan_mod.assign_dense_pages(forest)
    cm = cost_model.CostModel(H_Q, N_KV, D, page_size=page)
    make = plan_mod.flash_plan if flash else plan_mod.build_plan
    plan = plan_mod.pad_plan(make(forest, cm, num_lanes=lanes, max_q=MAX_Q,
                                  window=window))
    B = len(forest.request_ids)
    k = torch.randn(pages, page, N_KV, D, generator=gen, device="cuda"
                    ).to(dtype)
    v = torch.randn(pages, page, N_KV, D, generator=gen, device="cuda"
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
                                      torch.full((B,), page - 1,
                                                 device="cuda"))
    merged = por_mod.por(*full_t, *other)
    plain = por_mod.por_torch(*full_t, *other)
    torch.cuda.synchronize()
    por_err = assert_close(f"por {forest_name} {dtype}", merged, plain,
                           POR_TOL)
    empty = int((plan.step_valid.sum(1) == 0).sum())
    log(f"  {forest_name:<13} page={page:<3} window={window:<4} "
        f"{str(dtype):<15} tasks={plan.num_tasks:<3} lanes={lanes} "
        f"(empty {empty}) steps/lane={plan.max_steps:<4} "
        f"pac max|err|={err:.3e} (tol {TOL[dtype]:g})  "
        f"por max|err|={por_err:.3e} (tol {POR_TOL:g})")


EPI_TYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16))


def check_epilogue(name, forest, window, gen, *, flash=False):
    """The epilogue against its plain version on an engine-shaped plan of
    ``forest``: PAC's raw partials with NaN in every dead slot, each
    request's last page as its tail, the output pre-filled with NaN; q
    and KV in each pair of types.  Returns the largest error of the f32
    output and the largest distance of the bf16 output in bf16 steps."""
    from repro_torch.core import cost_model, plan as plan_mod
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    page = forest.block_size
    pages = plan_mod.assign_dense_pages(forest)
    cm = cost_model.CostModel(H_Q, N_KV, D, page_size=page)
    plan, tails = engine_state(forest, cm, LANES, MAX_Q, 2048, window, flash)
    pa = ops.plan_arrays(plan, "cuda")
    B = plan.num_queries
    k = torch.randn(pages, page, N_KV, D, generator=gen, device="cuda")
    v = torch.randn(pages, page, N_KV, D, generator=gen, device="cuda")
    q = torch.randn(B, H_Q, D, generator=gen, device="cuda")
    nan = float("nan")
    o_err, ulps, bf_err, ml_err = 0.0, 0, 0.0, 0.0
    for qdt, kvdt in EPI_TYPES:
        qc, kc, vc = q.to(qdt), k.to(kvdt), v.to(kvdt)
        Tp1, max_q = pa.q_gather.shape
        raw = (torch.full((Tp1, max_q, H_Q, D), nan, device="cuda"),
               torch.full((Tp1, max_q, H_Q), nan, device="cuda"),
               torch.full((Tp1, max_q, H_Q), nan, device="cuda"))
        o, m, l = pac_mod.pac(qc, pa, kc, vc, window=window, out=raw)
        parts = ops.Parts(o.view(-1, H_Q, D), m.view(-1, H_Q),
                          l.view(-1, H_Q), pa.seg_offsets, pa.seg_rows)
        out = torch.full_like(qc, nan)
        got = por_mod.por_epilogue(qc, *parts, kc, vc, *tails, window=window,
                                   stats=True, out=out)
        want = por_mod.por_epilogue_torch(qc, *parts, kc, vc, *tails,
                                          window=window)
        torch.cuda.synchronize()
        tag = f"epilogue {name} q {qdt} kv {kvdt}"
        assert all(bool(torch.isfinite(g).all()) for g in got), tag
        ml_err = max(ml_err, assert_close(tag, got[1:], want[1:], EPI_TOL))
        if qdt == torch.bfloat16:
            ulps = max(ulps, bf16_ulps(got[0], want[0]))
            assert ulps <= EPI_ULPS, (tag, ulps)
            bf_err = max(bf_err, max_err(got[:1], want[:1]))
        else:
            o_err = max(o_err, assert_close(tag, got[:1], want[:1], EPI_TOL))
    empty = int((pa.seg_offsets[1:] == pa.seg_offsets[:-1]).sum())
    log(f"  epilogue {name:<13} page={page:<3} window={window:<4} "
        f"queries={B} tasks={plan.num_tasks:<3} live rows="
        f"{pa.seg_rows.numel():<4} empty segments={empty}: f32 o max|err| "
        f"{o_err:.3e} (tol {EPI_TOL:g}); bf16 o within {ulps} step(s) (tol "
        f"{EPI_ULPS}), max|err| {bf_err:.3e}; m, l max|err| {ml_err:.3e} "
        f"(rtol = atol = {EPI_TOL:g})")
    return o_err, ulps


def phase_kernels():
    from repro_torch.core import tree
    gen = torch.Generator(device="cuda").manual_seed(1)
    served = lambda page=PAGE: tree.two_level(8, 4096, 64, block_size=page)
    forests = [
        ("two-level", served, 0, {}),
        ("3-ary x3", lambda: tree.full_kary(3, 3, 320, block_size=PAGE), 0,
         {}),
        ("windowed", lambda: tree.two_level(8, 2048, 64, block_size=PAGE),
         512, {}),
        ("flash plan", served, 0, {"flash": True}),
        ("padding lanes", lambda: tree.two_level(2, 40, 9, block_size=PAGE),
         0, {"lanes": 64}),
        ("page 64", lambda: served(64), 0, {}),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, make, window, kw in forests:
            check_kernels(name, make(), window, dtype, gen, **kw)

    def tail_only():   # the served forest and a request in its tail alone
        f = served()
        f.attach_request(8, f.add_node(tree.ROOT_ID, 5).id)
        return f

    def no_task():     # every request in its tail page: a zero-task plan
        f = tree.PrefixForest(PAGE)
        for r in range(8):
            f.attach_request(r, f.add_node(tree.ROOT_ID, 3 + r).id)
        return f

    epi = [check_epilogue(name, make(), window, gen, **kw)
           for name, make, window, kw in (
               ("codec plan", served, 0, {}),
               ("flash plan", served, 0, {"flash": True}),
               ("tail-only", tail_only, 0, {}),
               ("zero-task", no_task, 0, {}),
               ("windowed", lambda: tree.two_level(8, 2048, 64,
                                                   block_size=PAGE), 512, {}),
               ("page 64", lambda: served(64), 0, {}))]
    check_flash_decode(gen)
    return max(e for e, _ in epi), max(u for _, u in epi)


def check_flash_decode(gen):
    """flash_decode against flash_decode_torch: rows at L, at 1, mid-page
    and at 3000, NaN written past every kv_len."""
    from repro_torch.kernels import flash_decode as fd
    L = 4192
    lens = torch.tensor([L, 1, 2007, 3000], dtype=torch.int32,
                        device="cuda")
    B = lens.numel()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, H_Q, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, L, N_KV, D, generator=gen, device="cuda"
                        ).to(dtype)
        v = torch.randn(B, L, N_KV, D, generator=gen, device="cuda"
                        ).to(dtype)
        for b, n in enumerate(lens.tolist()):
            k[b, n:] = float("nan")
            v[b, n:] = float("nan")
        for window in (0, 512):
            got = fd.flash_decode(q, k, v, lens, window=window)
            want = fd.flash_decode_torch(q, k, v, lens, window=window)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all()), "flash_decode: non-finite"
            err = assert_close(f"flash_decode {dtype} window={window}",
                               [got], [want], TOL[dtype])
            log(f"  flash_decode kv_lens={lens.tolist()} window={window:<4} "
                f"{str(dtype):<15} max|err|={err:.3e} (tol {TOL[dtype]:g})")
        del q, k, v


def reset_launches() -> None:
    from repro_torch.kernels import pac as pac_mod, por as por_mod
    pac_mod.launches = por_mod.launches = por_mod.epilogue_launches = 0


def read_launches():
    from repro_torch.kernels import pac as pac_mod, por as por_mod
    return {"pac": pac_mod.launches, "por_epilogue": por_mod.epilogue_launches,
            "por": por_mod.launches}


def last_state(engine):
    """The rows, leaf truncation and tail arrays of an engine's last
    decode step: every request ran to it, so its rows are all of them, in
    id order, and the forest is as that step left it."""
    rows = sorted(engine.requests)
    return (rows, *cut_leaves(engine.forest, rows))


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

    reset_launches()
    res = serve(engine, prompts, max_new=32, on_step=on_step)
    launches = read_launches()
    n_attn = len(engine.attn_layer_idx)
    expect = n_attn * res["steps"]
    lens = sorted({len(t) for t in res["streams"].values()})
    log(f"  streams: {len(res['streams'])} requests, lengths {lens}; "
        f"decode steps {res['steps']}; plan builds {res['replans']}")
    assert lens == [32], lens
    assert finite and all(finite), "non-finite logits"
    assert launches == {"pac": expect, "por_epilogue": expect, "por": 0}, \
        (launches, expect)
    log(f"  launches: PAC {launches['pac']}, epilogue "
        f"{launches['por_epilogue']} = {n_attn} attention layers x "
        f"{res['steps']} decode steps; pairwise POR {launches['por']}")
    log(f"  prefill {res['prefill_s'] * 1e3:.1f} ms (8 prompts, 4160 tokens "
        f"each, 4096 shared); TPOT {res['tpot_ms']:.3f} ms per step of 8 "
        f"tokens; plan builds {res['plan_s'] * 1e3:.2f} ms total, per-step "
        f"plan advance {res['advance_s'] * 1e3 / res['steps']:.3f} ms")

    # PAC, POR and the epilogue at the shapes this run gave them: the last
    # plan and tails, layer 0's pool and bf16 queries of the batch's shape
    plan, pa = engine._plans[0]
    k_pool, v_pool = engine.pool.layer_pools(0)
    B = plan.num_queries
    _, _, tails = last_state(engine)
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

    # the epilogue on the engine's own inputs: PAC's raw partials of this
    # plan, the CSR, the last step's tails; against its plain version and
    # the route it replaced
    raw = pac_mod.pac(q, pa, k_pool, v_pool)
    parts = ops.Parts(raw[0].view(-1, cfg.num_heads, cfg.head_dim),
                      raw[1].view(-1, cfg.num_heads),
                      raw[2].view(-1, cfg.num_heads), pa.seg_offsets,
                      pa.seg_rows)
    seg_ids = torch.as_tensor(np.asarray(plan.seg_ids, np.int64),
                              device="cuda")
    epi = por_mod.por_epilogue(q, *parts, k_pool, v_pool, *tails, stats=True)
    epi_plain = por_mod.por_epilogue_torch(q, *parts, k_pool, v_pool, *tails)
    before = parent_epilogue(q, raw, pa, seg_ids, k_pool, v_pool, tails)
    torch.cuda.synchronize()
    epi_ulps = max(bf16_ulps(epi[0], epi_plain[0]),
                   bf16_ulps(epi[0], before))
    assert epi_ulps <= EPI_ULPS, ("epilogue main path", epi_ulps)
    epi_ml_err = assert_close("epilogue main path m, l", epi[1:],
                              epi_plain[1:], EPI_TOL)
    epi_err = max_err([epi[0]], [epi_plain[0]])

    pac_ms = timer(lambda: pac_mod.pac(q, pa, k_pool, v_pool))
    pac_med = timer.median
    pac_plain_ms = timer(lambda: pac_mod.pac_torch(
        q[pa.q_gather.long()], pa.q_pos, k_pool, v_pool, pa.task_pages,
        pa.task_kvlen, pa.task_pos))
    por_ms = timer(lambda: por_mod.por(*o_f, *o_t))
    por_med = timer.median
    por_plain_ms = timer(lambda: por_mod.por_torch(*o_f, *o_t))
    epi_ms = timer(lambda: por_mod.por_epilogue(q, *parts, k_pool, v_pool,
                                                *tails))
    epi_med = timer.median
    epi_plain_ms = timer(lambda: por_mod.por_epilogue_torch(
        q, *parts, k_pool, v_pool, *tails))
    epi_plain_med = timer.median
    before_ms = timer(lambda: parent_epilogue(q, raw, pa, seg_ids, k_pool,
                                              v_pool, tails))
    before_med = timer.median
    pac_b, pac_by = pac_bound(plan, pa, q, k_pool)
    por_b, por_by = por_bound(o_f[0])
    epi_b, epi_by = epilogue_bound(q, parts, k_pool, tails)
    log(f"  main-path plan: {plan.num_tasks} tasks on {plan.num_lanes} lanes"
        f", {plan.max_steps} steps/lane, {int(plan.step_valid.sum())} "
        f"valid page steps, {parts.seg_rows.numel()} live partial rows")
    log(f"  PAC {pac_ms:.4f} ms/launch, mean of 20 (median {pac_med:.4f}; "
        f"plain {pac_plain_ms:.4f}, bound {pac_b:.4f} by {pac_by}), max|err| "
        f"{pac_err:.3e}; {pac_ms * n_attn:.3f} ms per decode step")
    log(f"  POR {por_ms:.4f} ms/launch, mean of 20 (median {por_med:.4f}; "
        f"plain {por_plain_ms:.4f}, bound {por_b:.5f} by {por_by}), max|err| "
        f"{por_err:.3e}; off the main path")
    log(f"  epilogue {epi_ms:.4f} ms/launch, mean of 20 (median "
        f"{epi_med:.4f}; bound {epi_b:.5f} by {epi_by}, {epi_b / epi_ms:.1%} "
        f"of it); plain {epi_plain_ms:.4f} (median {epi_plain_med:.4f}); "
        f"the route it replaced {before_ms:.4f} (median {before_med:.4f}), "
        f"{before_ms / epi_ms:.1f}x; bf16 output within {epi_ulps} step(s) "
        f"of both, max|err| {epi_err:.3e} (m, l {epi_ml_err:.3e}); "
        f"{epi_ms * n_attn:.3f} ms per decode step")
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
        {"name": "por_epilogue", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/por.cu",
         "replaces": "src/repro/kernels/por.py:44, "
                     "src/repro/kernels/ops.py:80, "
                     "src/repro/kernels/ops.py:91",
         "launches": launches["por_epilogue"], "max_abs_err": epi_err,
         "ms": epi_ms, "plain_ms": epi_plain_ms, "bound_ms": epi_b,
         "bound_by": epi_by, "library_ms": None},
    ]
    del got, want, o_f, o_t, merged, plain, raw, parts, epi, epi_plain
    return engine, model, res, kernels


# --------------------------------------------------------------------- #
# phase 4: CoDec against FlashDecoding on one decode state
# --------------------------------------------------------------------- #
def sdpa_backend(fn) -> str:
    """Which SDPA implementation ``fn`` ran, from its device kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:   # the name is reported, not checked
        return f"unknown (profiler: {e})"
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    joined = " ".join(names).lower()
    for tag, kind in (("cudnn", "cudnn"), ("flash", "flash"),
                      ("fmha", "efficient"), ("efficient", "efficient")):
        if tag in joined:
            return kind
    return "math (" + ", ".join(n[:40] for n in names[:3]) + ")"


def phase_compare(engine, timer):
    """The last decode state of phase 3 attended three ways: the engine's
    codec-cuda attention (frozen plan, then the epilogue with the tail
    page), the same through the ``flash`` backend over a per-request plan,
    and ``flash_decode`` over a dense copy of each request's context."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import (flash_decode as fd, ops,
                                     pac as pac_mod, por as por_mod,
                                     registry)
    cfg, forest = engine.cfg, engine.forest
    rows, truncate, tails = last_state(engine)
    tail_pages, tail_base, q_pos = tails
    B = len(rows)
    plan_c, pa_c = engine._plans[0]
    assert plan_c.num_queries == B, (plan_c.num_queries, B)
    k_pool, v_pool = engine.pool.layer_pools(0)

    # the flash plan over the same forest, rows and truncation as
    # DecodeEngine._rebuild_plans builds the codec plan
    req_rows = {r: i for i, r in enumerate(rows)}
    flash = registry.get("flash")
    plan_f = plan_mod.pad_plan(plan_mod.flash_plan(
        forest, engine.cost_model, engine.num_lanes, engine.max_q,
        engine.max_kv_per_task, req_rows=req_rows, window=0,
        truncate=truncate))
    pa_f = flash.prepare(plan_f, "cuda")

    # dense (B, L, n_kv, d) copy of each request's context, from the pool
    ctx = [forest.context_len(r) for r in rows]
    L = max(ctx)
    kd = k_pool.new_zeros((B, L) + tuple(k_pool.shape[2:]))
    vd = torch.zeros_like(kd)
    for i, r in enumerate(rows):
        kr, vr = engine._gather_prefix_upto(0, forest.path(r), ctx[i])
        kd[i, :ctx[i]], vd[i, :ctx[i]] = kr, vr
    kv_lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(3)
    q_bf = torch.randn(B, cfg.num_heads, cfg.head_dim, generator=gen,
                       device="cuda").to(torch.bfloat16)
    # the same bf16 values held in f32, so all three outputs stay f32
    q32 = q_bf.float()

    o_a = engine._attend(q32, k_pool, v_pool, 0, tail_pages, tail_base,
                         q_pos)
    o_b = por_mod.por_epilogue(q32, *flash.parts(q32, k_pool, v_pool, plan_f,
                                                 pa_f), k_pool, v_pool, *tails)
    fd.launches = 0
    o_c = fd.flash_decode(q32, kd, vd, kv_lens)
    fd_launches = fd.launches
    torch.cuda.synchronize()
    tol = TOL[torch.float32]
    err_b = assert_close("flash backend vs engine", [o_b], [o_a], tol)
    err_c = assert_close("flash_decode vs engine", [o_c], [o_a], tol)
    o_plain = fd.flash_decode_torch(q32, kd, vd, kv_lens)
    fd_err = assert_close("flash_decode vs plain", [o_c], [o_plain], tol)
    log(f"  {B} rows, contexts {sorted(set(ctx))}, KV {kd.dtype}: engine "
        f"(codec plan, {plan_c.num_tasks} tasks) vs flash backend "
        f"({plan_f.num_tasks} tasks) max|err| {err_b:.3e}, vs flash_decode "
        f"{err_c:.3e}, flash_decode vs plain {fd_err:.3e} (tol {tol:g})")

    # the SDPA yardstick: q cast to the KV type outside the timed region
    q_s = q_bf.to(kd.dtype)[:, :, None]
    k_s, v_s = kd.transpose(1, 2), vd.transpose(1, 2)
    mask = (torch.arange(L, device="cuda")[None, :]
            < kv_lens[:, None])[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q_s, k_s, v_s, attn_mask=mask, enable_gqa=True)

    sdpa_err = max_err([sdpa()[:, :, 0]], [o_c])
    backend = sdpa_backend(sdpa)

    esize = k_pool.element_size()
    io_c = forest.codec_io_bytes(cfg.num_kv_heads, cfg.head_dim, esize)
    io_f = forest.flash_io_bytes(cfg.num_kv_heads, cfg.head_dim, esize)
    log(f"  decode KV IO per layer: codec {io_c / 1e6:.2f} MB, flash "
        f"{io_f / 1e6:.2f} MB ({io_f / io_c:.2f}x)")

    # the codec plan of the same state rebuilt at 32 lanes
    plan_32 = plan_mod.pad_plan(plan_mod.build_plan(
        forest, engine.cost_model, 32, engine.max_q, engine.max_kv_per_task,
        req_rows=req_rows, window=0, truncate=truncate))
    pa_32 = ops.plan_arrays(plan_32, "cuda")
    o_32 = ops.codec_partials_arrays(q32, k_pool, v_pool, pa_32, B)
    o_ref = ops.codec_partials_arrays(q32, k_pool, v_pool, pa_c, B)
    torch.cuda.synchronize()
    err_32 = assert_close("codec plan at 32 lanes", o_32, o_ref, tol)

    t, med = {}, {}   # mean and median ms of each timed call
    for key, fn in (
            ("pac_codec", lambda: pac_mod.pac(q_bf, pa_c, k_pool, v_pool)),
            ("pac_32", lambda: pac_mod.pac(q_bf, pa_32, k_pool, v_pool)),
            ("pac_flash", lambda: pac_mod.pac(q_bf, pa_f, k_pool, v_pool)),
            ("fd", lambda: fd.flash_decode(q_bf, kd, vd, kv_lens)),
            ("sdpa", sdpa),
            ("pac_flash_plain", lambda: pac_mod.pac_torch(
                q_bf[pa_f.q_gather.long()], pa_f.q_pos, k_pool, v_pool,
                pa_f.task_pages, pa_f.task_kvlen, pa_f.task_pos)),
            ("fd_plain", lambda: fd.flash_decode_torch(q_bf, kd, vd,
                                                       kv_lens))):
        t[key] = timer(fn)
        med[key] = timer.median
    b_c, by_c = pac_bound(plan_c, pa_c, q_bf, k_pool)
    b_f, by_f = pac_bound(plan_f, pa_f, q_bf, k_pool)
    b_32, by_32 = pac_bound(plan_32, pa_32, q_bf, k_pool)
    b_fd, by_fd = fd_bound(q_bf, kd, kv_lens)
    for key, name, plan, b, by in (
            ("pac_codec", "codec plan", plan_c, b_c, by_c),
            ("pac_32", "codec, 32 lanes", plan_32, b_32, by_32),
            ("pac_flash", "flash plan", plan_f, b_f, by_f)):
        log(f"  PAC, {name:<15} {t[key]:.4f} ms/launch, mean of 20 (median "
            f"{med[key]:.4f}; bound {b:.4f} by {by}, {b / t[key]:.1%} of "
            f"it; {plan.num_lanes} lanes, "
            f"{int(plan.step_valid.sum())} page steps, "
            f"{plan.max_steps} steps/lane)")
    log(f"  PAC plain, flash plan {t['pac_flash_plain']:.4f} ms; codec "
        f"plan at 32 lanes vs 16 lanes max|err| {err_32:.3e}")
    log(f"  flash_decode     {t['fd']:.4f} ms/launch, mean of 20 (median "
        f"{med['fd']:.4f}; bound {b_fd:.4f} by {by_fd}; plain "
        f"{t['fd_plain']:.4f}); launches {fd_launches}")
    log(f"  SDPA ({backend}) {t['sdpa']:.4f} ms/call, max|err| vs "
        f"flash_decode {sdpa_err:.3e}")
    log(f"  flash plan / codec plan PAC time "
        f"{t['pac_flash'] / t['pac_codec']:.2f}x; flash_decode / "
        f"codec-plan PAC {t['fd'] / t['pac_codec']:.2f}x (medians "
        f"{med['fd'] / med['pac_codec']:.2f}x); KV bytes {io_f / io_c:.2f}x")
    log(f"  flash_decode {b_fd / t['fd']:.1%} of its bound; "
        f"flash_decode / flash-plan PAC {t['fd'] / t['pac_flash']:.2f}x")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:91",
            "launches": fd_launches, "max_abs_err": fd_err,
            "ms": t["fd"], "plain_ms": t["fd_plain"], "bound_ms": b_fd,
            "bound_by": by_fd, "library_ms": t["sdpa"]}


# --------------------------------------------------------------------- #
# phase 5: the same workload through the flash backend
# --------------------------------------------------------------------- #
def phase_serve_flash(cfg, model, codec_res):
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.serving.engine import DecodeEngine

    engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                          num_lanes=LANES, max_q=MAX_Q, backend="flash",
                          device="cuda")
    prompts = doc_prompts(8, 4096, 64, cfg.vocab_size, seed=0)
    finite = []

    def on_step(eng):
        finite.append(bool(torch.isfinite(eng.last_logits).all()))

    reset_launches()
    res = serve(engine, prompts, max_new=32, on_step=on_step)
    launches = read_launches()
    expect = len(engine.attn_layer_idx) * res["steps"]
    assert finite and all(finite), "non-finite logits"
    assert launches == {"pac": expect, "por_epilogue": expect, "por": 0}, \
        (launches, expect)
    plan, _ = engine._plans[0]
    assert int(plan.task_qnum.max()) == 1, "flash plan shares a task"
    same = sum(res["streams"][r] == codec_res["streams"][r]
               for r in codec_res["streams"])
    log(f"  flash: PAC {launches['pac']}, epilogue "
        f"{launches['por_epilogue']}, pairwise POR {launches['por']} "
        f"launches over {res['steps']} steps; last plan {plan.num_tasks} "
        f"tasks")
    log(f"  TPOT flash {res['tpot_ms']:.3f} ms vs codec-cuda "
        f"{codec_res['tpot_ms']:.3f} ms per step of 8 tokens; "
        f"{same} of {len(codec_res['streams'])} streams equal codec-cuda's "
        f"(bf16 weights: near-ties may flip a token)")
    del engine


# --------------------------------------------------------------------- #
# phase 6: backends agree on the card
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
    for backend in BACKENDS:
        engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                              num_lanes=LANES, max_q=MAX_Q, backend=backend,
                              device="cuda")
        gaps = []
        res = serve(engine, prompts, max_new=32, on_step=lambda e: gaps.append(
            torch.topk(e.last_logits, 2).values.cpu()))
        streams[backend], top2[backend] = res["streams"], gaps
        del engine
        torch.cuda.empty_cache()
    a = streams["codec-cuda"]
    for other in BACKENDS[1:]:
        b = streams[other]
        if a == b:
            continue
        for r in sorted(a):
            diff = [i for i, (x, y) in enumerate(zip(a[r], b[r])) if x != y]
            if diff:
                i = diff[0]
                g = top2["codec-cuda"][i - 1][r] if i > 0 else None
                log(f"  {other}: request {r} first differs at token {i}: "
                    f"{a[r][i]} vs {b[r][i]}; codec-cuda top-2 logits there "
                    f"{None if g is None else g.tolist()}")
        raise AssertionError(f"codec-cuda and {other} streams differ")
    log(f"  {cfg.num_layers} layers f32: {' == '.join(BACKENDS)} on "
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
    for kernel, report in ptxas_reports(str(info.get("log", ""))):
        log(f"  ptxas {kernel}: {report}")
    lib = build.load()
    log(f"  PAC blocks per SM at d={D} (occupancy query): f32 KV "
        f"{lib.codec_pac_blocks_per_sm(D, 0)}, bf16 KV "
        f"{lib.codec_pac_blocks_per_sm(D, 1)}")

    log("== 2. kernels vs plain versions at full width")
    epi_err, epi_ulps = phase_kernels()
    log(f"  epilogue over all phase-2 cases: f32 output max|err| "
        f"{epi_err:.3e} (tol {EPI_TOL:g}), bf16 output within {epi_ulps} "
        f"step(s) (tol {EPI_ULPS})")
    timer = Timer()

    log("== 3. serve qwen3-4b, full width and depth")
    engine, model, codec_res, kernels = phase_serve(timer)

    log("== 4. CoDec against FlashDecoding on one decode state")
    kernels.append(phase_compare(engine, timer))
    cfg = engine.cfg
    del engine
    torch.cuda.empty_cache()

    log("== 5. serve qwen3-4b again through the flash backend")
    phase_serve_flash(cfg, model, codec_res)
    del model
    torch.cuda.empty_cache()

    log("== 6. backend streams agree")
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
