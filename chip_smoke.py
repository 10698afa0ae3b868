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
   work, page 64 and phase 8's 24 requests over a 2048-token document —
   in float32 and bfloat16 KV; PAC and then the epilogue over
   engine-shaped plans (leaves cut to full pages, each request's last page
   its tail) of the served forest under the codec and the flash plan, with
   a tail-only request (an empty segment), with no task at all, under a
   window of 512 and at page 64, q and KV in float32 and bfloat16, NaN in
   every dead slot and in the output it writes, and in the fused step's
   form (6 requests in a bucket of 8, and phase 8's 12 in 16 and 24 in
   32: padded rows with empty segments, the trash page as tail and
   ``q_pos = -1`` must come out zero);
   ``flash_decode`` over uneven ``kv_lens`` with NaN past every one, with
   and without a window;
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
   and SDPA are timed against their bounds (SDPA twice: the math path
   with ``enable_gqa``, and the memory-efficient backend over K/V
   expanded to the query heads outside the timed region; the faster is
   the library time), and PAC once more over the codec plan rebuilt at
   32 lanes; then ``flash_decode`` over the same rows in bf16 KV (its
   tensor-core path) beside its plain version and SDPA's bf16 call with
   ``enable_gqa``;
5. serve the same workload again through the ``flash`` backend (36
   layers), with the same launch counts, and print its TPOT beside
   ``codec-cuda``'s;
6. at 4 layers, full width, f32 weights: greedy streams through
   ``codec-cuda``, ``codec-torch``, ``flash`` and ``hydragen`` must be
   equal, and each backend's fused streams (one CUDA-graph replay a
   token) equal to its eager ones;
7. the fused decode step at full depth: phase 3's workload on phase 3's
   model through ``codec-cuda`` and then ``flash``, fused, beside the
   eager serves of phases 3 and 5 in the same process (each of the four
   serves traces decode steps 2-4); graph replays must equal decode
   steps, graphs captured the bucket signatures, each graph must hold 36
   PAC and 36 epilogue launches (counted across its capture), and a
   traced steady-state window one graph launch a step and no kernel
   launch from the host; TPOT, device busy, idle share and kernels a step
   are printed for both paths;
8. serving under memory pressure at full depth, on phase 3's model: 24
   requests over a shared 2048-token document (64-token questions, 64
   greedy tokens each) arriving by a Poisson process at 0.5 a step, with
   512-token prefill chunks, on a pool of 224 pages (about 320 would hold
   every working set), eager and fused, then fused on 1024 pages; the
   pressured runs must preempt, recompute, chunk and fill the pool, the
   row bucket must grow and shrink through at least three sizes, the
   fused runs replay once a decode step and capture one graph a
   signature of 36 PAC and 36 epilogue launches, no page or node may
   leak; the same arrivals on phase 6's 4-layer f32 model must give
   equal streams pressured and unconstrained, eager and fused, for
   ``codec-cuda`` and ``flash``; steps, buckets, signatures, captures,
   both step times, prefill seconds, tokens per second and the pressure
   counters are printed, and where the bf16 fused streams part from the
   eager ones, the eager top-2 logits there; then PAC and the epilogue
   are held against their plain versions at the shape of each run's
   widest decode step (its forest and rows, the plan the engine builds,
   bucketed as the fused step holds it);
9. the request lifecycle, on phase 3's model, fused, 1024 pages: wave A
   (8 questions over a shared 2048-token document, 32 tokens each), then
   wave B (8 new questions on the same document) once A has finished,
   without the prefix cache and with it, twice in turns: wave B's
   prefill seconds (CUDA events), the prompt tokens the cache served and
   the pages it kept;
   every ``on_token`` sequence equals its stream and ``on_done`` fires
   once, ``check()`` and ``shutdown()`` leave every page free, and PAC
   and the epilogue launch (into the graphs); wave A sampled at
   temperature 0.8, fused beside eager, with the sampled and greedy
   fused TPOT.  On phase 6's 4-layer f32 model: waves A and B equal with
   and without the cache; sampled streams fused == eager, and again
   under phase 8's pressured arrivals; a seeded fault plan (an ``alloc``,
   a ``dispatch`` and a ``nan_logits`` fault) with a cancel and a
   deadline on an injected clock, fused: each request's terminal reason,
   the survivors' streams equal to a fault-free run's, ``check()``;
10. cascade prefill and telemetry, on phase 3's model, fused: (a) a
   burst of 8 questions over one uncached 2048-token document queued
   behind a decoy, cascade off and on twice in turns: the burst's
   prefill seconds (CUDA events), the cascade counters, TPOT, the bf16
   streams equal as a count; (b) phase 9's wave A with telemetry off and
   with ``Telemetry(profile_every=4)`` twice in turns: TPOT, the medians
   of the sampled steps' host preparation, launch and device wait beside
   a traced step's device busy, the request p50s, and the Chrome trace
   written to ``chiprun_out/phase10_trace.json``, parsed and checked for
   partially overlapping spans; (c) on phase 6's 4-layer f32 model, the
   burst's streams equal with cascade and telemetry on and off, eager and
   fused and with the cache, and phase 8's pressured arrivals with
   cascade on and off; PAC and the epilogue launch (into the graphs) in
   every run, which leaks no page and passes ``check()``;
11. tree-speculative decoding: (a) on phase 3's model, 8 questions over
   a 2048-token document made of 32 copies of a seeded 64-token block, 64
   greedy tokens each, ``SpecConfig()`` fused, speculative eager and
   non-speculative fused in turns, twice: verify dispatches, drafts
   proposed and accepted, committed tokens per dispatch, rows per verify
   step, graphs captured and their seconds, each verify replay's device
   time (CUDA events), TPOT per committed token beside non-speculative
   fused, the bf16 streams equal as a count; PAC and the epilogue with no
   tail once a layer and verify step (once a layer in each graph), and
   both against their plain versions at the widest verify step's plan
   (NaN in dead slots, four q/KV type pairs); (b) on phase 6's 4-layer
   f32 model, speculative streams equal non-speculative ones for
   ``codec-cuda``, ``flash`` and ``hydragen``, eager and fused, and under
   phase 8's pressured arrivals with ``max_nodes=1``, with no page, node
   or draft left and ``check()`` passing;
12. the model families beyond the dense subset: (a) gemma3-1b at full
   width and depth (26 layers: 22 with a 512-token window, 4 global;
   4 query heads over 1 KV head, head_dim 256, GeGLU, embed scale), bf16
   weights from seed 0, phase 3's workload through ``codec-cuda`` eager
   (PAC and the epilogue tallied by window: each window's layers x
   decode steps) and fused, then ``flash`` fused: TPOT, device busy and
   kernels a traced step, graphs and signatures (one plan slot a window
   in each), the KV bytes PAC reads a step by window under the codec and
   the flash plan, and PAC and the epilogue at the last decode state for
   each window, against their plain versions and their bounds; (b)
   llama4-scout-17b-a16e at full width (40 query heads over 8 KV heads,
   16 experts top-1, untied head), depth cut to 4 of 48 layers, bf16: 8
   questions over a 2048-token document, 32 tokens each, ``codec-cuda``
   eager and fused: TPOT, the MoE's device time a step (CUDA events), the
   token-choices dropped by capacity (a second eager run, counting, must
   give the same streams), PAC and the epilogue at group 5; (c) at f32:
   gemma3 at full width, 6 layers (one whole period), four backends
   equal eager and fused, and speculative streams equal plain greedy,
   eager and fused; llama4-scout at full width, 2 layers, fused equal to
   eager with 8 rows in bucket 8;
13. Mamba-2 and the hybrid jamba (bf16 weights from seed 0): (a)
   mamba2-2.7b at full width and depth (64 layers, d_model 2560, d_inner
   5120, 80 heads of 64, state 128; attention-free), one dense prefill of
   a 4160-token prompt (seconds, peak memory above the weights), then
   phase 3's workload through ``codec-cuda`` eager and fused: no PAC or
   epilogue launch, the document's node carrying every layer's SSM state,
   the prefill tokens computed against 8 x 4160, TPOT, device busy,
   kernels a step, graphs and signatures, and the SSM state bytes a step
   against the weight bytes; then phase 10's burst with cascade on,
   where the document is prefilled once; (b) jamba-v0.1-52b at full width, depth cut
   to one period (8 of 32 layers: 7 Mamba, 1 attention, 4 MoE of 16
   experts top-2 at capacity 1.25, 4 MLP; 13.3 B params), 8 questions
   over a 2048-token document, 32 tokens each, ``codec-cuda`` eager and
   fused: PAC and the epilogue once a decode step, held to their plain
   versions at the last decode state, the KV bytes PAC reads a step
   (codec against flash plan), the MoE's device ms a step, the decode
   token-choices dropped by capacity in each mode; (c) at f32, a 1024-wide
   jamba period at capacity 0 and mamba2 at full width x4: ``codec-cuda``
   == ``flash`` == ``hydragen``, eager and fused; phase 8's pressured
   arrivals (preemption, recompute from ``meta["ssm"]``) equal
   unconstrained; phase 10's burst equal with cascade on and off; phase
   9's waves equal with and without the prefix cache; (d) ROADMAP C1:
   gemma3-1b x6 at f32, two requests at unequal positions over one
   1024-token document, ``codec-cuda`` eager and fused equal the dense
   ``prefill`` + ``decode_step`` decode;
14. the mesh on one card (every shard of a ``(data, model)`` mesh on the
   one H100): (a) phase 3's model (rebuilt from seed 0) and traffic,
   fused: a single-device reference that keeps its top-2 logits, then
   1x1, 2x1 and 2x2 meshes with the document split across the data
   shards, and 2x1 with ``replicate``, each traced: TPOT, device busy
   and kernels a step beside phase 7's and beside the figures before
   the merge kernel, the launches each graph holds (PAC and the epilogue
   36 x D x M, one ``codec_mesh_merge`` a layer where rows span shards,
   no ``codec_por``), the merged rows Bm, the sequence-split nodes, the
   replica promotions, the plan's KV bytes each shard reads a step;
   bf16 streams may part from the reference only at near-ties (its
   top-2 logits within 2 bf16 steps at the first differing token); (c)
   ``codec_mesh_merge`` at the last step's shapes of the 2x1 and 2x2
   runs (bitwise equal to the stacked butterfly on ``codec_por``), the
   epilogue's mesh mode (tail-owner flags, float32 ``o``) at shard
   (0, 0) of the 2x2 run's last step and ``codec_por`` over the
   butterfly's partials, against their plain versions and bounds; (b)
   phase 6's 4-layer f32 model: 1x1, 2x1, 1x2 and 2x2, greedy and at
   temperature 0.7, byte-identical to the single-device eager engine,
   with replication at 2x1 and 2x2, and 2x2 under pressure, no page
   leaked on any shard; (d) ``calibrate=True`` at 2x2: what
   ``recalibrate`` fits (to shards that run one after another on one
   card: not the H100's coefficients); (e) the mesh over processes, one
   rank a shard holding only its slab of the pool: (i) (a)'s model and
   traffic as a 1x1 process mesh under NCCL in this process, the
   collectives captured in its graphs (PAC, the epilogue and the model
   sum's all-reduce 36 each a graph), TPOT beside (a)'s 1x1; (ii) (b)'s
   model at 2x1, 1x2 and 2x2 as gloo ranks sharing the card (spawned
   together), greedy and at 0.7: every rank's streams equal the
   single-controller mesh's and the single-device eager engine's byte
   for byte, PAC, the epilogue and (where rows merge)
   ``codec_mesh_merge`` launched in every rank, each rank's pool bytes;
   (iii) (a)'s model at 2x2 on gloo ranks: streams equal to (a)'s 2x2 or
   parting only at near-ties by (a)'s rule; no time of (ii) or (iii) is
   a mesh's TPOT;
15. training on the card (no Pallas kernel is on this path: gradients
   come from autograd through the plain-torch model): (a) qwen3-4b at
   full width and depth, bf16 weights from seed 0, AdamW with float32
   moments, remat, 4 x 512 tokens a step: the memory reckoning from
   ``abstract_state`` on the meta device, eight steps over two cycled
   ``SyntheticLM`` batches (every loss finite, the last two below the
   first), the step time (median of steps 2-8), tokens/s, peak memory,
   MFU, a traced step's device busy, idle share and kernels by kind,
   and a step by phase (forward, backward, clip, optimizer); (b) qwen3-4b
   at full width, 2 layers, f32, 2 x 64 tokens: one step on the card
   equals the same port code on the CPU from the same weights (loss and
   grad norm within 1e-5 relative, every gradient within 1e-5 of
   max|g|), remat equals no remat, 2 microbatches equal 1 in loss; (c)
   ``launch.train.main`` in-process on ``--smoke``: a straight run, a
   run resumed from its checkpoint with the same loss trace, and a data
   axis of 2 that restarts elastically at step 3; (d) (b)'s trained
   weights served through ``codec-cuda`` eager and fused: streams equal
   the dense decode, PAC and the epilogue launch, no autograd graph;
16. the serving examples and the launch layer's dry run: (a)
   ``examples/torch_port/{quickstart,serve_docqa,tree_speculation}.py``
   as subprocesses on the card, side by side: their OK lines, and PAC and
   the epilogue launched in every ``codec-cuda`` run; (b) in a child
   process with expandable segments, qwen3-4b x36 bf16 on
   ``make_host_mesh()`` (1x1): the dry run's decode (8 rows, a 4096-token
   dense cache), prefill (1 x 4096) and train (4 x 512, AdamW, remat)
   cells made on the card from seed 0: the argument bytes reckoned on the
   meta device equal the allocator's (within 512 bytes a tensor), the
   FLOPs ``FlopCounterMode`` counts over a real step equal the meta count
   op for op; the temp estimate against the step's peak and ``bound_s``
   against its median time are printed; then the decode and train cells
   on a 1x2 (data, model) mesh, and on a 2x1x2 (pod, data, model) mesh at
   twice the batch (one pod's block, plus the all-reduces over the pod
   group): partitioned on the meta device, then rank 0's local program
   run on the card under the same fake world (real CUDA shards, no-op
   collectives): its FLOPs and collectives equal the meta run's op for
   op, its argument bytes the allocator's, and ``per_device_bytes`` is
   printed against the card's peak; (c) the dry run's loop in process
   (meta runs over a pool of one process a CPU) for qwen3-4b and
   llama4-scout on both production meshes: every cell ``ok`` or
   ``skip`` with the config's reason, partitioned with collectives and a
   boolean ``fits_hbm`` (2x16x16 as one pod's block, the pod group's
   all-reduces on the network, train only), records in
   ``chiprun_out/dryrun_torch``;
17. the three kernels over every shape their TPU kernels take: (a)
   ``flash_decode`` against its plain version at d 64, 128, 256, 16 and
   96 x groups 1, 4, 5, 7, 8, 16 and 32 (8 KV heads up to group 8, else
   32 query heads; phase 4's row lengths, NaN past each), f32 and bf16,
   with and without a window of 512, bf16 within ``TOL`` and one bf16
   step, the bf16 ones without a window timed beside the plain version
   and SDPA; the epilogue
   on PAC's partials of an engine-shaped plan (8 questions over a
   2048-token document) at pages 8, 24, 32 and 128 x groups 1, 4, 8 and
   32, in codec mode and in mesh mode (owner flags, float32 ``o``), at
   gemma3-1b's layout on page 128 with f32 KV (staged 64 tokens at a
   time), group 32 at d 256, and ROADMAP C8's shapes (pages 256 and
   1024, the smoke config's d 16, d 48 and 96), f32 and bf16, timed
   beside the plain version; ``codec_mesh_merge`` at 32 and 64 shards
   under five contributor patterns, bitwise the stacked butterfly on
   ``codec_por``;
   (b) fused ``codec-cuda`` serves beside ``codec-torch`` at every
   epilogue shape the ``kernels`` line lists, equal streams: phase 6's
   4-layer f32 model at pages 32, 8, 128 and 256, the same with one KV
   head (group 32) at page 32 on one device and on ``decode_mesh(2, 1)``,
   gemma3-1b's layout (12c's 6 layers, f32) at page 128, the qwen3-4b
   smoke config (d 16) at page 16; each row's launches are its serve's;
   (c) ROADMAP C2's
   reproduction (the qwen2.5-14b smoke model, head dim 64) at
   ``decode_mesh(32, 1)`` and ``(64, 1)``: the single-device streams;
18. print the ``kernels`` JSON line and the closing device line.

It needs CUDA and exits at once when ``torch.cuda.is_available()`` is
false; it imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
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
# bf16 KV: PAC's and flash_decode's tensor cores see an f32 q and P as
# bf16 hi + lo terms (max |err| ~4e-4 measured at these shapes)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
POR_TOL = 1e-6
# the epilogue against its plain version on the same partials: f32 output
# within 1e-5 (sums in another order), bf16 output within one bf16 step
# (the two round f32 values that differ in their last bits) wherever it
# differs by more than 1e-5 (near zero a step is finer than that)
EPI_TOL, EPI_ULPS = 1e-5, 1
H_Q, N_KV, D, PAGE, MAX_Q, LANES = 32, 8, 128, 16, 32, 16
BACKENDS = ("codec-cuda", "codec-torch", "flash", "hydragen")
# decode steps traced (steps 2..PROFILE_STEPS + 1) in each full-depth serve
PROFILE_STEPS = 3


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


def engine_state(forest, cm, lanes, max_q, max_kv, window=0, flash=False,
                 bucket=0, trash_page=0):
    """The plan the engine builds for this forest (leaves cut, rows in
    request order, padded) and each request's tail arrays.  ``bucket``:
    the fused step's form instead, the plan bucketed to that many rows and
    the tails padded as the step pads them (the trash page, position 0,
    ``q_pos = -1``)."""
    from repro_torch.core import plan as plan_mod
    rows = sorted(forest.request_ids)
    truncate, tails = cut_leaves(forest, rows)
    make = plan_mod.flash_plan if flash else plan_mod.build_plan
    plan = make(forest, cm, lanes, max_q, max_kv,
                req_rows={r: i for i, r in enumerate(rows)}, window=window,
                truncate=truncate)
    if not bucket:
        return plan_mod.pad_plan(plan), tails
    pad = bucket - len(rows)
    tails = [torch.cat([t, t.new_full((pad,), fill)])
             for t, fill in zip(tails, (trash_page, 0, -1))]
    return plan_mod.bucket_plan(plan, bucket), tails


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


def check_epilogue(name, forest, window, gen, *, flash=False, bucket=0,
                   cm=None):
    """PAC and the epilogue against their plain versions on an
    engine-shaped plan of ``forest`` (``cm``: the engine's cost model; by
    default one for 2-byte KV): PAC's live slots against ``pac_torch``,
    then the epilogue on PAC's raw partials with NaN in every dead slot, each
    request's last page as its tail, the output pre-filled with NaN; q
    and KV in each pair of types.  ``bucket``: the plan and tails as the
    fused step holds them, rows padded to ``bucket`` (empty segments, the
    trash page as tail, ``q_pos = -1``; they must come out zero) and the
    CSR padded to the plan's capacity.  Returns the largest error of the
    f32 output and the largest distance of the bf16 output in bf16
    steps (PAC's error is logged)."""
    from repro_torch.core import cost_model, plan as plan_mod
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    page = forest.block_size
    pages = plan_mod.assign_dense_pages(forest)
    cm = cm or cost_model.CostModel(H_Q, N_KV, D, page_size=page)
    plan, tails = engine_state(forest, cm, LANES, MAX_Q, 2048, window, flash,
                               bucket=bucket, trash_page=pages)
    pa = ops.upload(ops.PlanArrays, ops.plan_host_arrays(
        plan, padded=bool(bucket)), "cuda")
    B = plan.num_queries
    live_rows = len(forest.request_ids)
    # one page past the forest's: the trash page padded rows take as tail
    k = torch.randn(pages + 1, page, N_KV, D, generator=gen, device="cuda")
    v = torch.randn(pages + 1, page, N_KV, D, generator=gen, device="cuda")
    q = torch.randn(B, H_Q, D, generator=gen, device="cuda")
    nan = float("nan")
    o_err, ulps, bf_err, ml_err = 0.0, 0, 0.0, 0.0
    pac_err = {torch.float32: 0.0, torch.bfloat16: 0.0}     # by KV type
    live = live_slots(pa)
    for qdt, kvdt in EPI_TYPES:
        qc, kc, vc = q.to(qdt), k.to(kvdt), v.to(kvdt)
        Tp1, max_q = pa.q_gather.shape
        raw = (torch.full((Tp1, max_q, H_Q, D), nan, device="cuda"),
               torch.full((Tp1, max_q, H_Q), nan, device="cuda"),
               torch.full((Tp1, max_q, H_Q), nan, device="cuda"))
        o, m, l = pac_mod.pac(qc, pa, kc, vc, window=window, out=raw)
        plain = pac_mod.pac_torch(qc[pa.q_gather.long()], pa.q_pos, kc, vc,
                                  pa.task_pages, pa.task_kvlen, pa.task_pos,
                                  window=window)
        if bool(live.any()):            # a zero-task plan has no live slot
            pac_err[kvdt] = max(pac_err[kvdt], assert_close(
                f"pac {name} q {qdt} kv {kvdt}", [x[live] for x in (o, m, l)],
                [x[live] for x in plain], TOL[kvdt]))
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
        assert bool((got[0][live_rows:] == 0).all()), (tag, "padded rows")
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
        f"{int(pa.seg_offsets[-1]):<4} empty segments={empty}: pac max|err| "
        f"f32 KV {pac_err[torch.float32]:.3e} (tol {TOL[torch.float32]:g}), "
        f"bf16 KV {pac_err[torch.bfloat16]:.3e} (tol "
        f"{TOL[torch.bfloat16]:g}); f32 o max|err| "
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
        # phase 8's widest batch: 24 requests over its 2048-token document
        ("24 rows", lambda: tree.two_level(24, 2048, 64, block_size=PAGE),
         0, {}),
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
               ("page 64", lambda: served(64), 0, {}),
               # the fused step's form: 6 requests in a bucket of 8
               ("bucket-padded", lambda: tree.two_level(6, 4096, 64,
                                                        block_size=PAGE), 0,
                {"bucket": 8}),
               # phase 8's buckets: 12 requests in 16, 24 requests in 32
               ("bucket 16", lambda: tree.two_level(12, 2048, 64,
                                                    block_size=PAGE), 0,
                {"bucket": 16}),
               ("bucket 32", lambda: tree.two_level(24, 2048, 64,
                                                    block_size=PAGE), 0,
                {"bucket": 32}))]
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
    por_mod.mesh_merge_launches = 0


def read_launches():
    from repro_torch.kernels import pac as pac_mod, por as por_mod
    return {"pac": pac_mod.launches, "por_epilogue": por_mod.epilogue_launches,
            "por": por_mod.launches,
            "mesh_merge": por_mod.mesh_merge_launches}


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
    res = serve(engine, prompts, max_new=32, on_step=on_step,
                profile_steps=PROFILE_STEPS)
    launches = read_launches()
    n_attn = len(engine.attn_layer_idx)
    expect = n_attn * res["steps"]
    lens = sorted({len(t) for t in res["streams"].values()})
    log(f"  streams: {len(res['streams'])} requests, lengths {lens}; "
        f"decode steps {res['steps']}; plan builds {res['replans']}")
    assert lens == [32], lens
    assert finite and all(finite), "non-finite logits"
    assert launches == {"pac": expect, "por_epilogue": expect, "por": 0,
                        "mesh_merge": 0}, \
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
        {"name": "por_epilogue (tail; tail=False in the verify step)",
         "route": "cuda",
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
    # the same call on the memory-efficient backend, which takes no
    # enable_gqa: K and V expanded to the query heads outside the timed
    # region
    from torch.nn.attention import SDPBackend, sdpa_kernel
    group = cfg.num_heads // cfg.num_kv_heads
    k_e = k_s.repeat_interleave(group, dim=1)
    v_e = v_s.repeat_interleave(group, dim=1)

    def sdpa_eff():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                q_s, k_e, v_e, attn_mask=mask)

    eff_err = max_err([sdpa_eff()[:, :, 0]], [o_c])
    eff_backend = sdpa_backend(sdpa_eff)

    # the same rows over bf16 KV: flash_decode's tensor-core path beside
    # its plain version and SDPA's bf16 kernel (enable_gqa)
    kd_bf, vd_bf = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
    o_bf = fd.flash_decode(q_bf, kd_bf, vd_bf, kv_lens)
    o_bf_plain = fd.flash_decode_torch(q_bf, kd_bf, vd_bf, kv_lens)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o_bf).all()), "flash_decode bf16 KV"
    bf_err = assert_close("flash_decode bf16 KV vs plain", [o_bf],
                          [o_bf_plain], TOL[torch.bfloat16])
    bf_ulps = bf16_ulps(o_bf, o_bf_plain)
    k_sb, v_sb = kd_bf.transpose(1, 2), vd_bf.transpose(1, 2)

    def sdpa_bf16():
        return torch.nn.functional.scaled_dot_product_attention(
            q_bf[:, :, None], k_sb, v_sb, attn_mask=mask, enable_gqa=True)

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
            ("sdpa_eff", sdpa_eff),
            ("pac_flash_plain", lambda: pac_mod.pac_torch(
                q_bf[pa_f.q_gather.long()], pa_f.q_pos, k_pool, v_pool,
                pa_f.task_pages, pa_f.task_kvlen, pa_f.task_pos)),
            ("fd_plain", lambda: fd.flash_decode_torch(q_bf, kd, vd,
                                                       kv_lens)),
            ("fd_bf16", lambda: fd.flash_decode(q_bf, kd_bf, vd_bf,
                                                kv_lens)),
            ("fd_bf16_plain", lambda: fd.flash_decode_torch(
                q_bf, kd_bf, vd_bf, kv_lens)),
            ("sdpa_bf16", sdpa_bf16)):
        t[key] = timer(fn)
        med[key] = timer.median
    b_c, by_c = pac_bound(plan_c, pa_c, q_bf, k_pool)
    b_f, by_f = pac_bound(plan_f, pa_f, q_bf, k_pool)
    b_32, by_32 = pac_bound(plan_32, pa_32, q_bf, k_pool)
    b_fd, by_fd = fd_bound(q_bf, kd, kv_lens)
    b_fdb, by_fdb = fd_bound(q_bf, kd_bf, kv_lens)
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
    log(f"  SDPA ({backend}) {t['sdpa']:.4f} ms/call (median "
        f"{med['sdpa']:.4f}), max|err| vs flash_decode {sdpa_err:.3e}; SDPA "
        f"under sdpa_kernel(EFFICIENT_ATTENTION), K/V expanded to {cfg.num_heads}"
        f" heads ({eff_backend}) {t['sdpa_eff']:.4f} ms/call (median "
        f"{med['sdpa_eff']:.4f}), max|err| {eff_err:.3e}; the faster is the "
        f"library time")
    log(f"  flash plan / codec plan PAC time "
        f"{t['pac_flash'] / t['pac_codec']:.2f}x; flash_decode / "
        f"codec-plan PAC {t['fd'] / t['pac_codec']:.2f}x (medians "
        f"{med['fd'] / med['pac_codec']:.2f}x); KV bytes {io_f / io_c:.2f}x")
    log(f"  flash_decode {b_fd / t['fd']:.1%} of its bound; "
        f"flash_decode / flash-plan PAC {t['fd'] / t['pac_flash']:.2f}x")
    log(f"  flash_decode over bf16 KV {t['fd_bf16']:.4f} ms/launch, mean of "
        f"20 (median {med['fd_bf16']:.4f}; bound {b_fdb:.4f} by {by_fdb}, "
        f"{b_fdb / t['fd_bf16']:.1%} of it; plain {t['fd_bf16_plain']:.4f}; "
        f"SDPA bf16 enable_gqa ({sdpa_backend(sdpa_bf16)}) "
        f"{t['sdpa_bf16']:.4f}, median {med['sdpa_bf16']:.4f}); vs plain "
        f"within {bf_ulps} bf16 step(s), max|err| {bf_err:.3e} (tol "
        f"{TOL[torch.bfloat16]:g})")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:91",
            "launches": fd_launches, "max_abs_err": fd_err,
            "ms": t["fd"], "plain_ms": t["fd_plain"], "bound_ms": b_fd,
            "bound_by": by_fd,
            "library_ms": min(t["sdpa"], t["sdpa_eff"])}


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
    res = serve(engine, prompts, max_new=32, on_step=on_step,
                profile_steps=PROFILE_STEPS)
    launches = read_launches()
    expect = len(engine.attn_layer_idx) * res["steps"]
    assert finite and all(finite), "non-finite logits"
    assert launches == {"pac": expect, "por_epilogue": expect, "por": 0,
                        "mesh_merge": 0}, \
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
    return res


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
        # the same through the fused step: equal bits at f32, so equal
        # streams (its logits are read only after a flush: no top-2 here)
        engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                              num_lanes=LANES, max_q=MAX_Q, backend=backend,
                              fused=True, device="cuda")
        fres = serve(engine, prompts, max_new=32)
        assert engine.fused_step.replays == fres["steps"], backend
        assert engine.stats["nonfinite_rows"] == 0, backend
        if fres["streams"] != res["streams"]:
            bad = [r for r in res["streams"]
                   if fres["streams"][r] != res["streams"][r]]
            raise AssertionError(f"{backend}: fused streams differ from "
                                 f"eager for requests {bad}")
        log(f"  {backend}: fused == eager on {len(res['streams'])} streams "
            f"({fres['steps']} graph replays, {engine.fused_step.graphs} graphs)")
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
        f"{len(a)} streams x 32 tokens, eager and fused alike")


# --------------------------------------------------------------------- #
# phase 7: the fused decode step at full depth
# --------------------------------------------------------------------- #
def log_serve(backend, fused, r) -> None:
    prof = r["profile"]
    log(f"  {backend} {'fused' if fused else 'eager'}: TPOT "
        f"{r['tpot_ms']:.3f} ms over {r['steps'] - PROFILE_STEPS} "
        f"untraced steps (traced device busy over it: idle share "
        f"{1 - prof['device_busy_ms'] / r['tpot_ms']:.3f}); "
        f"traced steps 2-{PROFILE_STEPS + 1}: wall "
        f"{prof['wall_ms']:.3f} ms/step, device busy "
        f"{prof['device_busy_ms']:.3f} ms/step, idle share "
        f"{prof['idle_share']:.3f}, {prof['kernels_per_step']:.0f} "
        f"kernels/step; host launches/step: kernels "
        f"{prof['kernel_launches_per_step']:.1f}, graphs "
        f"{prof['graph_launches_per_step']:.1f}")


def phase_fused(cfg, model, eager):
    """Phase 3's workload through the fused step (one CUDA-graph replay a
    token), for ``codec-cuda`` and ``flash``, on phase 3's model, beside
    the eager serves of phases 3 and 5 (``eager``: their results, by
    backend) in the same process: replays, captures and the launches
    inside each graph are checked; a traced steady-state window must show
    one graph launch a step and no kernel launch from the host.  Returns
    the fused serves' results by backend."""
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.serving.engine import DecodeEngine

    prompts = doc_prompts(8, 4096, 64, cfg.vocab_size, seed=0)
    n_attn = cfg.num_layers
    tpot, results = {}, {}
    for backend in ("codec-cuda", "flash"):
        engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                              num_lanes=LANES, max_q=MAX_Q, backend=backend,
                              fused=True, device="cuda")
        r = serve(engine, prompts, max_new=32, profile_steps=PROFILE_STEPS)
        prof = r["profile"]
        lens = sorted({len(t) for t in r["streams"].values()})
        assert lens == [32], (backend, lens)
        assert engine.stats["nonfinite_rows"] == 0, backend
        step = engine.fused_step
        assert step.replays == r["steps"] == engine.stats["fused_calls"], \
            (step.replays, r["steps"])
        assert step.graphs == len(engine.bucket_signatures) \
            == engine.fused_cache_size, (step.graphs,
                                         engine.bucket_signatures)
        held = [slot.launches for slot in step.slots.values()]
        assert held == [(n_attn, n_attn)] * step.graphs, held
        log(f"  {backend} fused, CUDA API calls a traced step: "
            + ", ".join(f"{k} {n:g}" for k, n in sorted(
                prof["api_calls_per_step"].items())))
        assert prof["graph_launches_per_step"] == 1, prof
        assert prof["kernel_launches_per_step"] == 0, prof
        log(f"  {backend} fused: {step.replays} graph replays = decode "
            f"steps; {step.graphs} graph(s) captured for "
            f"{len(engine.bucket_signatures)} signature(s) over "
            f"{engine.stats['replans']} plan epochs in {r['capture_s']:.3f} "
            f"s; each graph holds PAC x {held[0][0]} and the epilogue x "
            f"{held[0][1]}; token flushes {engine.stats['token_flushes']}")
        e = eager[backend]
        log_serve(backend, False, e)
        log_serve(backend, True, r)
        same = sum(r["streams"][q] == e["streams"][q] for q in e["streams"])
        log(f"  {backend}: TPOT eager {e['tpot_ms']:.3f} ms, fused "
            f"{r['tpot_ms']:.3f} ms ({e['tpot_ms'] / r['tpot_ms']:.2f}x); "
            f"{same} of {len(e['streams'])} bf16 streams equal eager's")
        tpot[backend] = r["tpot_ms"]
        results[backend] = r
        del engine
        torch.cuda.empty_cache()
    log(f"  fused TPOT flash - codec-cuda: "
        f"{tpot['flash'] - tpot['codec-cuda']:.3f} ms a step")
    return results


# --------------------------------------------------------------------- #
# phase 8: serving under memory pressure, continuously batched
# --------------------------------------------------------------------- #
P8_REQUESTS, P8_DOC, P8_Q, P8_NEW = 24, 2048, 64, 64
P8_RATE, P8_CHUNK = 0.5, 512
# 224 pages hold the document (128 pages) and 12 finished private tails
# (8 pages each) of the 24; the unconstrained pool holds all of them
P8_PAGES, P8_FREE_PAGES = 224, 1024


def pressure_workload(vocab):
    """Phase 8's prompts and their Poisson arrival steps (seed 0)."""
    from repro_torch.launch.serve import build_schedule, doc_prompts
    prompts = doc_prompts(P8_REQUESTS, P8_DOC, P8_Q, vocab, seed=0)
    steps = build_schedule("poisson", P8_RATE, np.random.default_rng(0),
                           len(prompts))
    return prompts, steps


def decode_shape(forest, rows):
    """A forest of ``forest``'s shape cut to ``rows``: the nodes on their
    paths at their lengths, each row on its leaf (no pages yet)."""
    from repro_torch.core import tree
    f = tree.PrefixForest(forest.block_size)
    ids = {tree.ROOT_ID: tree.ROOT_ID}
    for r in rows:
        for node in forest.path(r):
            if node.id not in ids:
                ids[node.id] = f.add_node(ids[node.parent], node.length).id
        f.attach_request(r, ids[forest.leaf_of[r]])
    return f


def pressured_serve(cfg, model, backend, fused, pages, top2=None,
                    **engine_kw):
    """Serve phase 8's arrivals through one engine; check its launches,
    graphs and hygiene (no leaked page or node after every release, no
    non-finite logit); returns ``serve``'s result, with ``widest``: the
    forest's shape (``decode_shape``) at the first decode step of the most
    rows.  ``top2`` (eager): a dict that gets, by request and token index,
    the top-2 logits of each token a decode step sampled.  ``engine_kw``
    go to the engine (phase 9: ``temperature``)."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import DecodeEngine
    engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=pages,
                          num_lanes=LANES, max_q=MAX_Q, backend=backend,
                          fused=fused, prefill_chunk=P8_CHUNK, device="cuda",
                          **engine_kw)
    prompts, steps = pressure_workload(cfg.vocab_size)
    finite, widest = [], [None]

    def on_step(eng):
        rows = eng.step_stats[-1]["decoded"]
        if not rows or eng.spec is not None:   # verify rows are not
            return                             # the requests' rows
        if widest[0] is None or rows > len(widest[0].request_ids):
            widest[0] = decode_shape(eng.forest, eng.last_rows)
        if fused:                  # the logits are read after a flush only
            return
        finite.append(bool(torch.isfinite(eng.last_logits).all()))
        if top2 is not None:
            vals = torch.topk(eng.last_logits, 2).values.cpu().tolist()
            for r, v in zip(eng.last_rows, vals):
                # the token this step sampled is still the pending one
                top2[r, len(eng.requests[r].generated)] = v

    reset_launches()
    res = serve(engine, prompts, max_new=P8_NEW, arrival_steps=steps,
                on_step=on_step)
    res["widest"] = widest[0]
    launches = read_launches()
    n_attn = len(engine.attn_layer_idx)
    tag = f"{backend} {'fused' if fused else 'eager'} {pages} pages"
    lens = sorted({len(t) for t in res["streams"].values()})
    assert lens == [P8_NEW] and len(res["streams"]) == P8_REQUESTS, \
        (tag, lens)
    assert all(finite), (tag, "non-finite logits")
    assert engine.stats["nonfinite_rows"] == 0, tag
    n_pac = 0 if backend == "hydragen" else n_attn
    if fused:
        step = engine.fused_step or engine.spec_step
        assert step.replays == res["steps"] == engine.stats["fused_calls"], \
            (tag, step.replays, res["steps"])
        assert step.graphs == len(engine.bucket_signatures) \
            == res["graphs"] == res["signatures"], tag
        held = [slot.launches for slot in step.slots.values()]
        assert held == [(n_pac, n_attn)] * step.graphs, (tag, held)
    else:
        expect = n_attn * res["steps"]
        assert launches == {"pac": n_pac * res["steps"],
                            "por_epilogue": expect,
                            "por": 0, "mesh_merge": 0}, (tag, launches, expect)
    engine.check()
    assert not engine._drafts, tag
    for rid in list(engine.requests):
        engine.release(rid)
    engine.pool.allocator.check()
    assert engine.pool.num_free == engine.pool.num_pages, (tag, "leak")
    assert set(engine.forest.nodes) == {0}, (tag, "forest leak")
    del engine
    torch.cuda.empty_cache()
    return res


def log_pressured(tag, r) -> None:
    p = r["pressure"]
    log(f"  {tag}: {r['loop_steps']} loop steps, {r['steps']} decode "
        f"steps; row buckets {r['buckets']}; {r['signatures']} bucket "
        f"signature(s), {r['graphs']} graph(s) captured in "
        f"{r['capture_s']:.3f} s ({r['capture_s'] / r['loop_s']:.1%} of "
        f"the loop)")
    log(f"  {tag}: step {r['step_ms']:.3f} ms wall over the loop "
        f"({r['loop_s']:.3f} s), decode {r['tpot_ms']:.3f} ms a step (§2 "
        f"rule); prefill in the loop {r['prefill_loop_s']:.3f} s; "
        f"{r['tokens_per_s']:.1f} generated tokens/s; preempted "
        f"{p['preempted']}, recompute_tokens {p['recompute_tokens']}, "
        f"prefill_chunks {p['prefill_chunks']}, prefill_stalls "
        f"{p['prefill_stalls']}, reclaimed {p['reclaimed']}; peak pages "
        f"{r['peak_pages']}, {r['allocs']} handed out; plan builds "
        f"{r['replans']} in {r['plan_s']:.3f} s")


def check_pressure(tag, r, pages) -> None:
    p, b = r["pressure"], r["buckets"]
    assert p["preempted"] >= 1 and p["recompute_tokens"] >= 1 \
        and p["prefill_chunks"] >= 1, (tag, p)
    assert r["peak_pages"] == pages, (tag, r["peak_pages"])
    assert len(set(b)) >= 3 and any(x < y for x, y in zip(b, b[1:])) \
        and any(x > y for x, y in zip(b, b[1:])), (tag, b)


def check_widest(tag, r, gen):
    """PAC and the epilogue against their plain versions at the shape of
    a phase-8 run's widest decode step: its forest and rows, the plan the
    engine builds for them (f32 pool) bucketed as the fused step holds it
    (phase 2's ``check_epilogue``: NaN in dead slots, four q/KV type
    pairs)."""
    from repro_torch.core import cost_model
    from repro_torch.core.plan import bucket_pow2
    f = r["widest"]
    n = len(f.request_ids)
    cm = cost_model.CostModel(H_Q, N_KV, D, bytes_per=4, page_size=PAGE)
    check_epilogue(f"{tag}: widest, {n} rows", f, 0, gen,
                   bucket=bucket_pow2(n), cm=cm)


def bf16_witness(eager, fused, top2) -> None:
    """Where the bf16 fused streams part from the eager ones: each
    request's first differing token, and the eager run's top-2 logits
    there beside the top-2 gaps of every token the eager decode steps
    sampled."""
    gaps = sorted(a - b for a, b in top2.values())
    worst = 0.0
    for rid in sorted(eager["streams"]):
        diff = first_difference({rid: eager["streams"][rid]},
                                {rid: fused["streams"][rid]})
        if diff is None:
            continue
        _, i, x, y = diff
        v = top2.get((rid, i))
        if v is not None:
            worst = max(worst, v[0] - v[1])
        log(f"  bf16: request {rid} first differs at token {i}: eager "
            f"{x}, fused {y}; eager top-2 logits there "
            + (f"{v[0]:.4f}, {v[1]:.4f} (gap {v[0] - v[1]:.4f})"
               if v is not None else "not logged (sampled by a prefill)"))
    share = sum(g <= worst for g in gaps) / max(len(gaps), 1)
    log(f"  bf16: top-2 gaps of the {len(gaps)} tokens the eager decode "
        f"steps sampled: median {statistics.median(gaps):.4f}; "
        f"{share:.1%} are at or below the largest gap at a first "
        f"difference ({worst:.4f})")


def phase_pressure(cfg, model):
    """Phase 8 at full depth on phase 3's bf16 model, ``codec-cuda``:
    pressured eager, pressured fused, unconstrained fused; then PAC and
    the epilogue against their plain versions at each run's widest
    decode step."""
    top2 = {}
    eager = pressured_serve(cfg, model, "codec-cuda", False, P8_PAGES,
                            top2=top2)
    log_pressured(f"codec-cuda eager, {P8_PAGES} pages", eager)
    check_pressure("eager", eager, P8_PAGES)
    fused = pressured_serve(cfg, model, "codec-cuda", True, P8_PAGES)
    log_pressured(f"codec-cuda fused, {P8_PAGES} pages", fused)
    check_pressure("fused", fused, P8_PAGES)
    free = pressured_serve(cfg, model, "codec-cuda", True, P8_FREE_PAGES)
    log_pressured(f"codec-cuda fused, {P8_FREE_PAGES} pages", free)
    assert free["pressure"]["preempted"] == 0, free["pressure"]
    n = len(free["streams"])
    log(f"  bf16 streams equal to the unconstrained run's: eager "
        f"{sum(eager['streams'][r] == free['streams'][r] for r in free['streams'])}"
        f" of {n}, fused "
        f"{sum(fused['streams'][r] == free['streams'][r] for r in free['streams'])}"
        f" of {n}; fused equal to eager "
        f"{sum(fused['streams'][r] == eager['streams'][r] for r in free['streams'])}"
        f" of {n} (not asserted: recomputed KV comes from the prefill "
        f"path, and bf16 streams part after near-ties)")
    bf16_witness(eager, fused, top2)
    log(f"  fused / eager decode time a step "
        f"{fused['tpot_ms'] / eager['tpot_ms']:.3f}; step wall "
        f"{fused['step_ms'] / eager['step_ms']:.3f}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    for tag, r in (("eager", eager), ("fused", fused),
                   ("unconstrained", free)):
        check_widest(tag, r, gen)


def first_difference(a, b):
    for r in sorted(a):
        for i, (x, y) in enumerate(zip(a[r], b[r])):
            if x != y:
                return r, i, x, y
    return None


def phase_pressure_f32():
    """Phase 8's arrivals and page counts on phase 6's 4-layer f32 model:
    pressured streams equal unconstrained ones and fused equal eager, for
    ``codec-cuda`` and ``flash``."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    for backend in ("codec-cuda", "flash"):
        runs, top2 = {}, {}
        for mode, pages in (("eager", P8_FREE_PAGES), ("eager", P8_PAGES),
                            ("fused", P8_PAGES), ("fused", P8_FREE_PAGES)):
            fused = mode == "fused"
            top2[mode, pages] = {}
            runs[mode, pages] = pressured_serve(
                cfg, model, backend, fused, pages,
                top2=None if fused else top2[mode, pages])
        want = runs["eager", P8_FREE_PAGES]["streams"]
        for key, r in runs.items():
            diff = first_difference(want, r["streams"])
            if diff is not None:
                rid, i, x, y = diff
                log(f"  {backend} {key}: request {rid} first differs from "
                    f"the unconstrained eager run at token {i}: {y} vs {x}; "
                    f"top-2 logits there: unconstrained eager "
                    f"{top2['eager', P8_FREE_PAGES].get((rid, i))}, "
                    f"pressured eager "
                    f"{top2['eager', P8_PAGES].get((rid, i))} (None: "
                    f"sampled by a prefill)")
                raise AssertionError(f"{backend} {key}: streams differ")
        check_pressure(f"{backend} f32", runs["eager", P8_PAGES], P8_PAGES)
        check_pressure(f"{backend} f32 fused", runs["fused", P8_PAGES],
                       P8_PAGES)
        p = runs["fused", P8_PAGES]["pressure"]
        log(f"  {backend} {cfg.num_layers} layers f32: {P8_REQUESTS} "
            f"streams x {P8_NEW} tokens equal pressured ({P8_PAGES} pages: "
            f"preempted {p['preempted']}, recompute_tokens "
            f"{p['recompute_tokens']}) and unconstrained ({P8_FREE_PAGES}),"
            f" eager and fused")
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 9: the request lifecycle
# --------------------------------------------------------------------- #
P9_REQUESTS, P9_DOC, P9_Q, P9_NEW = 8, 2048, 64, 32
P9_TEMPERATURE = 0.8
# the fault run: requests, tokens, and which request each fault targets
P9F_DOC, P9F_NEW = 1024, 24
P9F_NAN, P9F_CANCEL, P9F_DEADLINE = 2, 5, 6
P9F_CANCEL_STEP, P9F_DEADLINE_S = 6, 10.5


class StreamLog:
    """Streaming callbacks: the tokens each request streamed, and every
    stream close."""

    def __init__(self):
        self.tokens, self.closed = {}, {}

    def on_token(self, rid, tok):
        self.tokens.setdefault(rid, []).append(int(tok))

    def on_done(self, rid, why):
        self.closed.setdefault(rid, []).append(why)


class StepClock:
    """An injected engine clock: one unit a step."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def lifecycle_engine(cfg, model, **kw):
    from repro_torch.serving.engine import DecodeEngine
    return DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                        num_lanes=LANES, max_q=MAX_Q, device="cuda", **kw)


def serve_waves(cfg, model, waves=("A", "B"), serve_kw=None, **kw):
    """Phase 9's waves through one engine (``kw``: its options), each
    served to the end before the next is added: wave A is 8 questions
    over a 2048-token document, wave B 8 new questions over the same
    document.  Checks every stream: each ``on_token`` sequence equals its
    final stream and ``on_done`` fired once, ``done``.  Then
    ``check()``, ``shutdown()`` and every page free.  Returns each wave's
    ``serve`` result with its prefill seconds (``prefill_time``: the
    engine's CUDA events), the prompt tokens the cache served and the
    pages it kept.  ``serve_kw`` go to every ``serve`` (phase 10:
    ``profile_steps``)."""
    from repro_torch.launch.serve import doc_prompts, serve
    prompts = doc_prompts(2 * P9_REQUESTS, P9_DOC, P9_Q, cfg.vocab_size,
                          seed=0)
    by_wave = {"A": prompts[:P9_REQUESTS], "B": prompts[P9_REQUESTS:]}
    engine = lifecycle_engine(cfg, model, **kw)
    streams = StreamLog()
    out = {}
    for name in waves:
        cache = engine.cache
        hits0 = cache.stats["hit_tokens"] if cache else 0
        prefill0 = engine.prefill_time()
        r = serve(engine, by_wave[name], P9_NEW, on_token=streams.on_token,
                  on_done=streams.on_done, **(serve_kw or {}))
        r["prefill_events_s"] = engine.prefill_time() - prefill0
        r["hit_tokens"] = (cache.stats["hit_tokens"] - hits0 if cache
                           else 0)
        r["kept_pages"] = cache.resident_pages() if cache else 0
        rids = sorted(r["streams"])[-P9_REQUESTS:]
        r["streams"] = {rid: list(r["streams"][rid]) for rid in rids}
        out[name] = r
    n = len(engine.requests)
    assert all(engine.requests[rid].generated == streams.tokens[rid]
               for rid in engine.requests), "on_token differs from streams"
    assert streams.closed == {rid: ["done"] for rid in engine.requests}, \
        streams.closed
    assert engine.stats["nonfinite_rows"] == 0
    fused = engine.fused_step
    if fused is not None:
        n_attn = len(engine.attn_layer_idx)
        assert fused.replays == engine.stats["fused_calls"]
        assert [s.launches for s in fused.slots.values()] \
            == [(n_attn, n_attn)] * fused.graphs == \
            [(n_attn, n_attn)] * len(engine.bucket_signatures)
    engine.check()
    summary = engine.shutdown()
    assert summary["used_pages"] == 0, summary
    assert engine.pool.num_free == engine.pool.num_pages
    out["streams_checked"] = n
    del engine
    torch.cuda.empty_cache()
    return out


def phase_lifecycle(cfg, model):
    """Phase 9 at full depth on phase 3's bf16 model: waves A and B
    without the prefix cache and with it, twice in turns (off, on, off,
    on: the first of a process's prefills run cold), streaming checked;
    then wave A sampled at temperature 0.8, fused and eager, beside the
    greedy fused TPOT."""
    runs = []
    for cache in (False, True, False, True):
        reset_launches()
        w = serve_waves(cfg, model, fused=True, cache=cache or None)
        launches = read_launches()
        assert launches["pac"] > 0 and launches["por_epilogue"] > 0, \
            launches
        b = w["B"]
        log(f"  cache {'on' if cache else 'off'}: wave B prefill "
            f"{b['prefill_events_s']:.3f} s (CUDA events; host "
            f"{b['prefill_s']:.3f} s), cache_hit_tokens {b['hit_tokens']},"
            f" pages kept after wave A {w['A']['kept_pages']}; wave A "
            f"prefill {w['A']['prefill_events_s']:.3f} s; TPOT wave A "
            f"{w['A']['tpot_ms']:.3f} ms, wave B {b['tpot_ms']:.3f} ms; "
            f"{w['streams_checked']} streams: on_token == stream, one "
            f"on_done each; check() and shutdown(): no page leaked; PAC "
            f"and epilogue launches captured {launches['pac']}, "
            f"{launches['por_epilogue']}")
        if cache:
            assert b["hit_tokens"] == P9_REQUESTS * P9_DOC, b
            assert w["A"]["kept_pages"] >= P9_DOC // PAGE, w["A"]
        runs.append(w)
    cold, warm = runs[2], runs[3]
    same = sum(warm["B"]["streams"][r] == cold["B"]["streams"][r]
               for r in cold["B"]["streams"])
    log(f"  wave B prefill with the cache / without: "
        f"{runs[1]['B']['prefill_events_s'] / runs[0]['B']['prefill_events_s']:.3f}"
        f" (first pair), "
        f"{warm['B']['prefill_events_s'] / cold['B']['prefill_events_s']:.3f}"
        f" (second pair); bf16 wave B streams equal with and without the "
        f"cache: {same} of {P9_REQUESTS} (asserted at f32 below)")
    sampled = serve_waves(cfg, model, waves=("A",), fused=True,
                          temperature=P9_TEMPERATURE)["A"]
    reset_launches()
    sampled_eager = serve_waves(cfg, model, waves=("A",),
                                temperature=P9_TEMPERATURE)["A"]
    launches = read_launches()
    expect = cfg.num_layers * sampled_eager["steps"]
    assert launches == {"pac": expect, "por_epilogue": expect, "por": 0,
                        "mesh_merge": 0}, \
        (launches, expect)
    same = sum(sampled["streams"][r] == sampled_eager["streams"][r]
               for r in sampled["streams"])
    greedy = cold["A"]["tpot_ms"]
    log(f"  temperature {P9_TEMPERATURE}: fused TPOT "
        f"{sampled['tpot_ms']:.3f} ms against greedy fused {greedy:.3f} ms "
        f"({sampled['tpot_ms'] - greedy:+.3f} ms a step of {P9_REQUESTS} "
        f"rows); eager {sampled_eager['tpot_ms']:.3f} ms; bf16 sampled "
        f"streams fused == eager: {same} of {P9_REQUESTS} (asserted at f32"
        f" below)")


def fault_plan():
    """The first seeded schedule (``FaultPlan.seeded``) with exactly one
    ``nan_logits`` fault (on request ``P9F_NAN``, from step 4), ``alloc``
    faults only at steps 0-1 (where every request allocates its first
    decode page) and one or two ``dispatch`` faults, none at the
    ``nan_logits`` step: a recovery that preempts the NaN's target then
    would move the NaN to another row."""
    from repro_torch.serving.faults import FaultPlan
    for seed in range(1000):
        plan = FaultPlan.seeded(seed, steps=12, rate=0.12,
                                kinds=("alloc", "dispatch", "nan_logits"),
                                rids=[P9F_NAN])
        steps = {k: [s.step for s in plan if s.kind == k]
                 for k in ("alloc", "dispatch", "nan_logits")}
        if (len(steps["nan_logits"]) == 1 and steps["nan_logits"][0] >= 4
                and steps["alloc"] and max(steps["alloc"]) <= 1
                and 1 <= len(steps["dispatch"]) <= 2
                and steps["nan_logits"][0] not in steps["dispatch"]):
            return seed, plan
    raise AssertionError("no seeded fault plan fits")


def phase_lifecycle_f32():
    """Phase 9 on phase 6's 4-layer f32 model, where streams are held
    equal: waves A and B with and without the cache; wave A sampled at
    temperature 0.8 fused and eager, and phase 8's pressured arrivals
    sampled, fused and eager; a seeded fault plan with a cancel and a
    deadline, whose survivors' streams equal a fault-free run's."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    warm = serve_waves(cfg, model, fused=True, cache=True)
    cold = serve_waves(cfg, model, fused=True)
    for w in ("A", "B"):
        assert warm[w]["streams"] == cold[w]["streams"], w
    log(f"  {cfg.num_layers} layers f32: waves A and B equal with and "
        f"without the cache ({2 * P9_REQUESTS} streams; wave B prefill "
        f"{warm['B']['prefill_events_s']:.3f} s against "
        f"{cold['B']['prefill_events_s']:.3f} s)")
    t = P9_TEMPERATURE
    fused = serve_waves(cfg, model, waves=("A",), fused=True,
                        temperature=t)["A"]["streams"]
    eager = serve_waves(cfg, model, waves=("A",), temperature=t)["A"][
        "streams"]
    assert fused == eager, first_difference(eager, fused)
    greedy = cold["A"]["streams"]
    assert fused != greedy
    runs = {mode: pressured_serve(cfg, model, "codec-cuda", mode == "fused",
                                  P8_PAGES, temperature=t)
            for mode in ("eager", "fused")}
    diff = first_difference(runs["eager"]["streams"],
                            runs["fused"]["streams"])
    assert diff is None, diff
    p = runs["fused"]["pressure"]
    assert p["preempted"] >= 1 and p["recompute_tokens"] >= 1, p
    log(f"  temperature {t}: wave A fused == eager ({P9_REQUESTS} "
        f"streams, {sum(fused[r] != greedy[r] for r in fused)} differ from "
        f"greedy); phase 8's arrivals on {P8_PAGES} pages fused == eager "
        f"({P8_REQUESTS} streams; preempted {p['preempted']}, "
        f"recompute_tokens {p['recompute_tokens']})")

    # the fault plan, fused, against a fault-free run of the same prompts
    prompts = doc_prompts(8, P9F_DOC, P9_Q, cfg.vocab_size, seed=3)
    ref = lifecycle_engine(cfg, model, fused=True)
    for q in prompts:
        ref.add_request(q, max_new=P9F_NEW)
    want = {r: list(g) for r, g in ref.run(200).items()}
    del ref
    seed, plan = fault_plan()
    clock, streams = StepClock(), StreamLog()
    engine = lifecycle_engine(cfg, model, fused=True, faults=plan,
                              nan_guard=True, clock=clock, check_every=4)
    for i, q in enumerate(prompts):
        engine.add_request(q, max_new=P9F_NEW, on_token=streams.on_token,
                           on_done=streams.on_done,
                           deadline_s=(P9F_DEADLINE_S if i == P9F_DEADLINE
                                       else None))
    for step in range(200):
        if not engine.has_work():
            break
        if step == P9F_CANCEL_STEP:
            assert engine.cancel(P9F_CANCEL)
        engine.step()
        clock.t += 1.0
    got = engine.run(0)
    reasons = {r: (q.state, q.finish_reason)
               for r, q in engine.requests.items()}
    expect = {r: ("done", "done") for r in reasons}
    expect.update({P9F_NAN: ("failed", "nan_logits"),
                   P9F_CANCEL: ("cancelled", "cancelled"),
                   P9F_DEADLINE: ("timed_out", "deadline")})
    assert reasons == expect, reasons
    for r, g in got.items():
        if reasons[r][0] == "done":
            assert g == want[r], (r, first_difference({r: want[r]},
                                                      {r: g}))
        else:
            assert g == want[r][:len(g)] and len(g) < P9F_NEW, (r, g)
        assert streams.tokens.get(r, []) == g, r
        assert streams.closed[r] == [reasons[r][1]], (r, streams.closed)
    fired, st = engine.injector.fired, engine.stats
    assert fired["alloc"] >= 1 and fired["dispatch"] >= 1 \
        and fired["nan_logits"] == 1, fired
    assert st["dispatch_recoveries"] == fired["dispatch"] \
        and st["nan_rows"] == 1, st
    engine.check()
    summary = engine.shutdown()
    assert summary["used_pages"] == 0, summary
    log(f"  faults (seeded plan {seed}: "
        + ", ".join(f"{s.kind}@{s.step}" + (f":{s.rid}" if s.rid is not None
                                             else "") for s in plan)
        + f"), fused: fired {dict(fired)}; dispatch failures "
        f"{st['dispatch_failures']} / recovered "
        f"{st['dispatch_recoveries']}; preempted {st['preempted']}; "
        f"outcomes: request {P9F_NAN} failed nan_logits after "
        f"{len(got[P9F_NAN])} tokens, {P9F_CANCEL} cancelled after "
        f"{len(got[P9F_CANCEL])}, {P9F_DEADLINE} timed out after "
        f"{len(got[P9F_DEADLINE])}; the other "
        f"{sum(v[0] == 'done' for v in reasons.values())} streams equal "
        f"the fault-free run; {st['invariant_checks']} self-checks passed,"
        f" no page leaked")
    del engine, model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 10: cascade prefill and telemetry
# --------------------------------------------------------------------- #
P10_REQUESTS, P10_DOC, P10_Q, P10_NEW = 8, 2048, 64, 32
# a budget of 640 tokens a step (40 pages): the 2048-token document ends
# 128 tokens into its fourth budget, which leaves 512 for the eight
# 64-token questions in one batch (cascade regroups members by their
# first unfilled node, so suffixes batch only in the call where the
# shared span completes); the decoy takes one budget for each question
# added after it, so all eight queue behind it (each add_request runs
# admission with a fresh budget)
P10_CHUNK = 640
P10_DECOY = P10_REQUESTS * P10_CHUNK
P10_PROFILE_EVERY = 4
TRACE_OUT = Path("chiprun_out") / "phase10_trace.json"


def burst_prompts(vocab):
    """Phase 10's decoy and its burst: 8 questions over one uncached
    2048-token document (seed 10)."""
    rng = np.random.default_rng(10)
    decoy = rng.integers(1, vocab, P10_DECOY).tolist()
    doc = rng.integers(1, vocab, P10_DOC).tolist()
    return decoy, [doc + rng.integers(1, vocab, P10_Q).tolist()
                   for _ in range(P10_REQUESTS)]


def hold_graphs(tag, engine):
    """Fused: one replay a decode step, one graph a signature, each
    holding PAC and the epilogue once a layer."""
    step = engine.fused_step
    if step is None:
        return
    n_attn = len(engine.attn_layer_idx)
    assert step.replays == engine.stats["fused_calls"], tag
    held = [slot.launches for slot in step.slots.values()]
    assert step.graphs == len(engine.bucket_signatures) \
        and held == [(n_attn, n_attn)] * step.graphs, (tag, held)


def release_all(tag, engine) -> None:
    engine.check()
    for rid in list(engine.requests):
        engine.release(rid)
    if engine.cache is not None:
        engine._evict_cached(engine.pool.num_pages)
    engine.pool.allocator.check()
    assert engine.pool.num_free == engine.pool.num_pages, (tag, "leak")
    assert set(engine.forest.nodes) == {0}, (tag, "forest leak")


def cascade_burst(cfg, model, cascade, fused=True, **kw):
    """The burst through one engine: the decoy and the first 7 questions
    are added by hand (the decoy's 8 budgets run meanwhile), the 8th by
    ``serve``, which runs the engine to the end.  Returns ``serve``'s
    result with the burst's prefill seconds (``prefill_time`` after the
    decoy: the engine's CUDA events), the cascade counters and the
    streams of all nine requests; checks the launches, the graphs and
    that no page or node is left."""
    from repro_torch.launch.serve import CASCADE_COUNTERS, serve
    from repro_torch.serving.engine import DecodeEngine
    engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                          num_lanes=LANES, max_q=MAX_Q, fused=fused,
                          prefill_chunk=P10_CHUNK, cascade=cascade,
                          device="cuda", **kw)
    decoy, qs = burst_prompts(cfg.vocab_size)
    tag = (f"{cfg.num_layers} layers {'fused' if fused else 'eager'} "
           f"cascade {'on' if cascade else 'off'}")
    reset_launches()
    for p in [decoy] + qs[:-1]:
        engine.add_request(p, max_new=P10_NEW)
    torch.cuda.synchronize()
    assert engine.stats["prefill_tokens"] == P10_DECOY, tag
    p0 = engine.prefill_time()
    res = serve(engine, qs[-1:], P10_NEW)
    launches = read_launches()
    n_attn = len(engine.attn_layer_idx)
    assert (launches["pac"] > 0 and launches["por_epilogue"] > 0) \
        == (n_attn > 0), (tag, launches)
    res["burst_prefill_s"] = engine.prefill_time() - p0
    res["cascade"] = {k: engine.stats[k] for k in CASCADE_COUNTERS}
    res["prefill_tokens"] = engine.stats["prefill_tokens"]
    res["streams"] = {r: list(g) for r, g in res["streams"].items()}
    assert sorted({len(g) for g in res["streams"].values()}) == [P10_NEW]
    assert engine.stats["nonfinite_rows"] == 0, tag
    hold_graphs(tag, engine)
    release_all(tag, engine)
    del engine
    torch.cuda.empty_cache()
    return res


def check_trace(path):
    """The exported Chrome trace parses, and no span partially overlaps
    another on its track."""
    doc = json.loads(Path(path).read_text())
    spans = {}
    for ev in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(ev), ev
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0, ev
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
    for track, ss in spans.items():
        ss.sort()
        for (s0, e0, n0), (s1, e1, n1) in zip(ss, ss[1:]):
            assert not (s1 < e0 < e1), (track, n0, n1)
    return len(doc["traceEvents"]), len(spans)


def phase_cascade_telemetry(cfg, model):
    """Phase 10a-b at full depth on phase 3's bf16 model, fused: the burst
    with cascade off and on in turns (prefill seconds, counters, TPOT,
    streams equal); phase 9's wave A with telemetry off and with
    ``Telemetry(profile_every=4)`` in turns (TPOT, the sampled steps'
    medians beside a traced step's device busy, the request p50s), the
    last trace exported and checked."""
    from repro_torch.launch.serve import telemetry_summary
    from repro_torch.serving.telemetry import Telemetry
    log("  10a. the burst: a decoy of "
        f"{P10_DECOY} tokens, then {P10_REQUESTS} questions of {P10_Q} "
        f"over one uncached {P10_DOC}-token document, {P10_NEW} tokens "
        f"each, prefill budget {P10_CHUNK} a step, fused")
    runs = {}
    for cascade in (False, True, False, True):
        r = cascade_burst(cfg, model, cascade)
        c = r["cascade"]
        log(f"  cascade {'on ' if cascade else 'off'}: burst prefill "
            f"{r['burst_prefill_s']:.4f} s (CUDA events; decoy excluded), "
            f"loop prefill {r['prefill_loop_s']:.4f} s; "
            + ", ".join(f"{k} {v}" for k, v in c.items())
            + f"; fused TPOT {r['tpot_ms']:.3f} ms over {r['steps']} "
            f"steps; PAC and epilogue launches captured into "
            f"{r['graphs']} graph(s)")
        if cascade:
            assert c["cascade_groups"] >= 1 and c["cascade_batches"] >= 1, c
        runs.setdefault(cascade, []).append(r)
    for i in range(2):
        off, on = runs[False][i]["streams"], runs[True][i]["streams"]
        same = sum(on[q] == off[q] for q in off)
        log(f"  pair {i + 1}: burst prefill on/off "
            f"{runs[True][i]['burst_prefill_s'] / runs[False][i]['burst_prefill_s']:.3f};"
            f" bf16 streams equal with cascade on and off: {same} of "
            f"{len(off)} (asserted at f32 in 10c)")

    log(f"  10b. phase 9's wave A ({P9_REQUESTS} questions over a "
        f"{P9_DOC}-token document, {P9_NEW} tokens), fused, telemetry off "
        f"and Telemetry(profile_every={P10_PROFILE_EVERY}), in turns; "
        f"decode steps 2-{PROFILE_STEPS + 1} traced with telemetry off (a "
        f"trace's wall time would enter the request latencies)")
    tpot = {False: [], True: []}
    for on in (False, True, False, True):
        reset_launches()
        tm = Telemetry(profile_every=P10_PROFILE_EVERY) if on else None
        w = serve_waves(cfg, model, waves=("A",), fused=True, telemetry=tm,
                        serve_kw={"profile_steps": 0 if on
                                  else PROFILE_STEPS})["A"]
        launches = read_launches()
        assert launches["pac"] > 0 and launches["por_epilogue"] > 0, \
            launches
        tpot[on].append(w["tpot_ms"])
        line = (f"  telemetry {'on ' if on else 'off'}: TPOT "
                f"{w['tpot_ms']:.3f} ms over {w['steps']} steps")
        if not on:
            prof = w["profile"]
            line += (f"; traced step: wall {prof['wall_ms']:.3f} ms, "
                     f"device busy {prof['device_busy_ms']:.3f} ms")
        else:
            s = telemetry_summary(tm)
            assert s["profiled_steps"] >= 1 \
                and s["requests_done"] == P9_REQUESTS, s
            line += (f"; {s['profiled_steps']} sampled steps, p50 host "
                     f"prep {s['profile_host_p50_ms']:.3f} ms, launch "
                     f"{s['profile_dispatch_p50_ms']:.3f} ms, device wait "
                     f"{s['profile_device_p50_ms']:.3f} ms (the wait "
                     f"drains every step queued since the last sync); p50 "
                     f"ttft {s['ttft_p50_ms']:.1f} ms, tpot "
                     f"{s['tpot_p50_ms']:.3f} ms, e2e {s['e2e_p50_ms']:.1f}"
                     f" ms, queue wait {s['queue_wait_p50_ms']:.3f} ms, "
                     f"step {s['step_p50_ms']:.3f} ms; "
                     f"{s['trace_events']} trace events")
            TRACE_OUT.parent.mkdir(parents=True, exist_ok=True)
            tm.export_trace(str(TRACE_OUT))
            n_ev, n_tracks = check_trace(TRACE_OUT)
            line += (f"; trace {TRACE_OUT} parses ({n_ev} events, "
                     f"{n_tracks} tracks, no partial overlap)")
        log(line)
    log(f"  TPOT telemetry on - off: "
        f"{tpot[True][0] - tpot[False][0]:+.3f} ms (first pair), "
        f"{tpot[True][1] - tpot[False][1]:+.3f} ms (second pair)")


def phase_cascade_telemetry_f32():
    """Phase 10c on phase 6's 4-layer f32 model: the burst's streams are
    equal with cascade on and off and with telemetry on and off, eager
    and fused, and with the prefix cache; phase 8's pressured arrivals
    give equal streams with cascade on and off, eager and fused; the
    cascade runs group and batch; no page leaks and ``check()`` passes
    (``cascade_burst``)."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.telemetry import Telemetry
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    want = cascade_burst(cfg, model, False, fused=False)["streams"]
    runs = {}
    for fused in (False, True):
        for cascade in (False, True):
            for tm in (False, True):
                if (fused, cascade, tm) == (False, False, False):
                    continue
                runs[fused, cascade, tm] = cascade_burst(
                    cfg, model, cascade, fused=fused,
                    telemetry=(Telemetry(profile_every=P10_PROFILE_EVERY)
                               if tm else None))
    runs["cache"] = cascade_burst(cfg, model, True, cache=True)
    for key, r in runs.items():
        diff = first_difference(want, r["streams"])
        assert diff is None, (key, diff)
        if key == "cache" or key[1]:
            c = r["cascade"]
            assert c["cascade_groups"] >= 1 \
                and c["cascade_batches"] >= 1, (key, c)
    c = runs[True, True, True]["cascade"]
    log(f"  {cfg.num_layers} layers f32: the burst's {len(want)} streams "
        f"equal with cascade on and off, telemetry on and off, eager and "
        f"fused, and with the cache ({len(runs) + 1} runs; "
        + ", ".join(f"{k} {v}" for k, v in c.items())
        + "); check() passed and no page or node was left in each")
    pres = {key: pressured_serve(cfg, model, "codec-cuda", key[0],
                                 P8_PAGES, cascade=key[1])
            for key in ((False, False), (False, True), (True, True))}
    ref = pres[False, False]["streams"]
    for key, r in pres.items():
        diff = first_difference(ref, r["streams"])
        assert diff is None, (key, diff)
    p = pres[True, True]["pressure"]
    log(f"  phase 8's arrivals on {P8_PAGES} pages: {len(ref)} streams "
        f"equal with cascade off (eager) and on (eager, fused); "
        f"preempted {p['preempted']}, recompute_tokens "
        f"{p['recompute_tokens']} (fused, cascade on)")
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 11: tree-speculative decoding
# --------------------------------------------------------------------- #
P11_REQUESTS, P11_BLOCK, P11_DOC, P11_Q, P11_NEW = 8, 64, 2048, 64, 64
# phase 11b's document runs: tokens a request (its pressured runs take
# phase 8's P8_NEW)
P11F_NEW = 32


def spec_prompts(vocab):
    """8 questions (64 tokens each, seed 11) over one shared 2048-token
    document built by repeating a seeded 64-token block: text with the
    repetition a self-drafting proposer feeds on."""
    rng = np.random.default_rng(11)
    block = rng.integers(1, vocab, P11_BLOCK).tolist()
    doc = block * (P11_DOC // P11_BLOCK)
    return [doc + rng.integers(1, vocab, P11_Q).tolist()
            for _ in range(P11_REQUESTS)]


def spec_serve(cfg, model, backend, mode, prompts, max_new, widest=None):
    """Serve ``prompts`` through one engine in ``mode`` (``spec-fused``,
    ``spec-eager``, ``fused`` or ``eager``; ``spec`` is ``SpecConfig()``);
    checks the launches (PAC and the epilogue once a layer and verify
    step eager, or once a layer in every captured graph), ``check()`` and
    that no page, node or draft is left.  Returns ``serve``'s result with
    the engine's stats, the graphs' capture seconds and, for
    ``spec-fused``, each verify replay's device milliseconds (CUDA
    events).  ``widest``: a dict that gets the verify plan (window 0) and
    row count of the step with the most rows."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.speculation import SpecConfig
    spec = mode.startswith("spec")
    fused = mode.endswith("fused")
    engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                          num_lanes=LANES, max_q=MAX_Q, backend=backend,
                          fused=fused,
                          speculative=SpecConfig() if spec else None,
                          device="cuda")
    rows = []                   # verify rows a step
    if spec:
        name = "_spec_verify_fused" if fused else "_spec_verify_eager"
        verify = getattr(engine, name)

        def record(tokens, q_pos, w_page, w_off, plans):
            rows.append(len(tokens))
            if widest is not None and len(tokens) > widest.get("rows", 0):
                widest.update(rows=len(tokens), plan=plans[0],
                              pages=engine.pool.num_pages + 1)
            return verify(tokens, q_pos, w_page, w_off, plans)
        setattr(engine, name, record)
    if spec and fused:
        engine.spec_step.replay_events = []
    reset_launches()
    res = serve(engine, prompts, max_new)
    launches = read_launches()
    tag = f"{backend} {mode} {cfg.num_layers} layers"
    st = engine.stats
    res["stats"] = dict(st)
    lens = sorted({len(t) for t in res["streams"].values()})
    assert lens == [max_new], (tag, lens)
    n_attn = len(engine.attn_layer_idx)
    n_pac = 0 if backend == "hydragen" else n_attn
    step = engine.fused_step or engine.spec_step
    assert launches["por_epilogue"] > 0 and (launches["pac"] > 0
                                             or n_pac == 0), (tag, launches)
    if fused:
        held = [slot.launches for slot in step.slots.values()]
        assert held == [(n_pac, n_attn)] * step.graphs, (tag, held)
        assert step.replays == res["steps"] == st["fused_calls"], tag
        assert 1 <= step.graphs == len(engine.bucket_signatures), tag
    else:
        assert launches == {"pac": n_pac * res["steps"],
                            "por_epilogue": n_attn * res["steps"],
                            "por": 0, "mesh_merge": 0}, (tag, launches)
    res["launches"] = launches
    res["rows"] = rows
    if spec:
        assert st["spec_steps"] == res["steps"] and st["spec_proposed"] > 0, \
            (tag, st)
    if spec and fused:
        torch.cuda.synchronize()
        res["replay_ms"] = [a.elapsed_time(b)
                            for a, b in step.replay_events]
    release_all(tag, engine)
    assert not engine._drafts, tag
    del engine
    torch.cuda.empty_cache()
    return res


def check_verify(tag, widest, gen, timer=None):
    """PAC and the no-tail epilogue against their plain versions at the
    widest verify step's plan, bucketed as the fused step holds it: a
    fresh pool of the engine's page count with NaN at every position no
    valid plan step covers, PAC's outputs pre-filled with NaN, the
    epilogue's output too; q and KV in each pair of types; padded rows
    come out zero.  With ``timer``: PAC and the epilogue timed at f32 KV
    and bf16 q (the engine's types).  Returns (PAC max|err| f32 KV,
    epilogue max|err| f32 q, bf16 steps, timings)."""
    from repro_torch.core.plan import bucket_plan, bucket_pow2
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    rows = widest["rows"]
    plan = bucket_plan(widest["plan"], bucket_pow2(rows))
    pa = ops.upload(ops.PlanArrays, ops.plan_host_arrays(plan, padded=True),
                    "cuda")
    B = plan.num_queries
    covered = torch.zeros(widest["pages"], PAGE, dtype=torch.bool,
                          device="cuda")
    valid = plan.step_valid.astype(bool)
    for pg, n in zip(plan.step_page[valid], plan.step_kvlen[valid]):
        covered[int(pg), :int(n)] = True
    k = torch.randn(widest["pages"], PAGE, N_KV, D, generator=gen,
                    device="cuda")
    v = torch.randn(widest["pages"], PAGE, N_KV, D, generator=gen,
                    device="cuda")
    q = torch.randn(B, H_Q, D, generator=gen, device="cuda")
    nan = float("nan")
    k_nan = k.masked_fill(~covered[..., None, None], nan)
    v_nan = v.masked_fill(~covered[..., None, None], nan)
    live = live_slots(pa)
    pac_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    o_err, ulps, timing = 0.0, 0, {}
    for qdt, kvdt in EPI_TYPES:
        qc, kc, vc = q.to(qdt), k_nan.to(kvdt), v_nan.to(kvdt)
        Tp1, max_q = pa.q_gather.shape
        raw = (torch.full((Tp1, max_q, H_Q, D), nan, device="cuda"),
               torch.full((Tp1, max_q, H_Q), nan, device="cuda"),
               torch.full((Tp1, max_q, H_Q), nan, device="cuda"))
        o, m, l = pac_mod.pac(qc, pa, kc, vc, out=raw)
        plain = pac_mod.pac_torch(qc[pa.q_gather.long()], pa.q_pos,
                                  k.to(kvdt), v.to(kvdt), pa.task_pages,
                                  pa.task_kvlen, pa.task_pos)
        pac_err[kvdt] = max(pac_err[kvdt], assert_close(
            f"pac {tag} q {qdt} kv {kvdt}", [x[live] for x in (o, m, l)],
            [x[live] for x in plain], TOL[kvdt]))
        parts = ops.Parts(o.view(-1, H_Q, D), m.view(-1, H_Q),
                          l.view(-1, H_Q), pa.seg_offsets, pa.seg_rows)
        out = torch.full_like(qc, nan)
        got = por_mod.por_epilogue(qc, *parts, kc, None, None, None, None,
                                   stats=True, out=out, tail=False)
        want = por_mod.por_epilogue_torch(qc, *parts, None, None, None,
                                          None, None, tail=False)
        torch.cuda.synchronize()
        etag = f"no-tail epilogue {tag} q {qdt} kv {kvdt}"
        assert all(bool(torch.isfinite(g).all()) for g in got), etag
        assert bool((got[0][rows:] == 0).all()), (etag, "padded rows")
        assert_close(etag, got[1:], want[1:], EPI_TOL)
        if qdt == torch.bfloat16:
            ulps = max(ulps, bf16_ulps(got[0], want[0]))
            assert ulps <= EPI_ULPS, (etag, ulps)
        else:
            o_err = max(o_err, assert_close(etag, got[:1], want[:1],
                                            EPI_TOL))
        if timer is not None and (qdt, kvdt) == (torch.bfloat16,
                                                 torch.float32):
            timing["pac"] = timer(lambda: pac_mod.pac(qc, pa, kc, vc))
            timing["pac_med"] = timer.median
            timing["pac_plain"] = timer(lambda: pac_mod.pac_torch(
                qc[pa.q_gather.long()], pa.q_pos, kc, vc, pa.task_pages,
                pa.task_kvlen, pa.task_pos))
            timing["epi"] = timer(lambda: por_mod.por_epilogue(
                qc, *parts, kc, None, None, None, None, tail=False))
            timing["epi_med"] = timer.median
            timing["epi_plain"] = timer(lambda: por_mod.por_epilogue_torch(
                qc, *parts, None, None, None, None, None, tail=False))
            timing["pac_bound"] = pac_bound(plan, pa, qc, kc)
            no_tail = [torch.zeros(B, dtype=torch.long, device="cuda"),
                       torch.zeros(B, dtype=torch.long, device="cuda"),
                       torch.full((B,), -1, dtype=torch.long,
                                  device="cuda")]
            timing["epi_bound"] = epilogue_bound(qc, parts, kc, no_tail)
    log(f"  {tag}: {rows} rows in bucket {B}, {plan.num_tasks} tasks, "
        f"{int(valid.sum())} page steps ({int((plan.step_kvlen[valid] == 1).sum())}"
        f" of one token), {int(pa.seg_offsets[-1])} live partial rows: PAC "
        f"max|err| f32 KV {pac_err[torch.float32]:.3e}, bf16 KV "
        f"{pac_err[torch.bfloat16]:.3e}; no-tail epilogue f32 o max|err| "
        f"{o_err:.3e}, bf16 o within {ulps} step(s); padded rows zero")
    return pac_err[torch.float32], o_err, ulps, timing


def phase_speculation(cfg, model, timer):
    """Phase 11a at full depth on phase 3's bf16 model: ``SpecConfig()``
    fused, speculative eager and non-speculative fused in turns, twice,
    over 8 questions on a repeated-block document; then PAC and the
    no-tail epilogue against their plain versions at the widest verify
    step's plan."""
    prompts = spec_prompts(cfg.vocab_size)
    log(f"  11a. {P11_REQUESTS} questions of {P11_Q} tokens over a "
        f"{P11_DOC}-token document ({P11_DOC // P11_BLOCK} copies of a "
        f"seeded {P11_BLOCK}-token block), {P11_NEW} greedy tokens each, "
        f"SpecConfig() (depth 4, branch 2, 6 nodes)")
    runs = {"spec-fused": [], "spec-eager": [], "fused": []}
    widest = {}
    for _ in range(2):
        for mode in runs:
            r = spec_serve(cfg, model, "codec-cuda", mode, prompts, P11_NEW,
                           widest=widest if mode == "spec-fused" else None)
            runs[mode].append(r)
            st = r["stats"]
            tokens = sum(len(t) for t in r["streams"].values())
            decode_s = r["loop_s"] - r["capture_s"] - r["prefill_loop_s"]
            per_tok = 1e3 * decode_s * P11_REQUESTS / tokens
            with_cap = 1e3 * (r["loop_s"] - r["prefill_loop_s"]) \
                * P11_REQUESTS / tokens
            r["tpot_tok_ms"], r["tpot_tok_cap_ms"] = per_tok, with_cap
            held = (f"{r['launches']['pac']} PAC and "
                    f"{r['launches']['por_epilogue']} epilogue launches"
                    if not mode.endswith("fused") else
                    f"{cfg.num_layers} PAC and {cfg.num_layers} epilogue "
                    f"launches in each graph")
            line = (f"  {mode:<10}: {r['steps']} decode steps for {tokens} "
                    f"tokens, {held}; TPOT per committed token {per_tok:.3f} ms "
                    f"({with_cap:.3f} ms with the {r['capture_s']:.3f} s of "
                    f"captures); {r['graphs']} graph(s) for "
                    f"{r['signatures']} signature(s)")
            if mode.startswith("spec"):
                line += (f"; spec_steps {st['spec_steps']}, proposed "
                         f"{st['spec_proposed']}, accepted "
                         f"{st['spec_accepted']} "
                         f"({st['spec_accepted'] / max(st['spec_proposed'], 1):.1%}),"
                         f" draft stalls {st['spec_draft_stalls']}; "
                         f"{tokens / st['spec_steps']:.2f} committed tokens "
                         f"per verify dispatch "
                         f"({tokens / st['spec_steps'] / P11_REQUESTS:.3f} a "
                         f"request); rows per verify step "
                         f"{statistics.mean(r['rows']):.1f} mean, "
                         f"{max(r['rows'])} max")
            if mode == "spec-fused":
                ms = r["replay_ms"]
                line += (f"; verify replay on the device {statistics.mean(ms):.3f}"
                         f" ms mean (median {statistics.median(ms):.3f}, max "
                         f"{max(ms):.3f}) over {len(ms)} replays; capture "
                         f"{r['capture_s'] / max(r['graphs'], 1):.3f} s a "
                         f"graph")
            log(line)
    base = runs["fused"]
    for i in range(2):
        sf, se = runs["spec-fused"][i], runs["spec-eager"][i]
        n = len(base[i]["streams"])
        eq_f = sum(sf["streams"][r] == base[i]["streams"][r]
                   for r in base[i]["streams"])
        eq_e = sum(se["streams"][r] == base[i]["streams"][r]
                   for r in base[i]["streams"])
        eq_fe = sum(sf["streams"][r] == se["streams"][r] for r in se["streams"])
        log(f"  pair {i + 1}: TPOT per committed token spec-fused / fused "
            f"{sf['tpot_tok_ms'] / base[i]['tpot_tok_ms']:.3f} "
            f"(with captures {sf['tpot_tok_cap_ms'] / base[i]['tpot_tok_cap_ms']:.3f}),"
            f" spec-eager / fused "
            f"{se['tpot_tok_ms'] / base[i]['tpot_tok_ms']:.3f}; bf16 streams "
            f"equal to non-speculative fused: spec-fused {eq_f} of {n}, "
            f"spec-eager {eq_e} of {n}; spec-fused equal to spec-eager "
            f"{eq_fe} of {n} (asserted at f32 in 11b)")
    gen = torch.Generator(device="cuda").manual_seed(11)
    pac_err, epi_err, ulps, t = check_verify("widest verify step", widest,
                                             gen, timer)
    pb, pby = t["pac_bound"]
    eb, eby = t["epi_bound"]
    log(f"  at the widest verify step: PAC {t['pac']:.4f} ms (median "
        f"{t['pac_med']:.4f}; plain {t['pac_plain']:.4f}; bound {pb:.4f} by "
        f"{pby}); no-tail epilogue {t['epi']:.4f} ms (median "
        f"{t['epi_med']:.4f}; plain {t['epi_plain']:.4f}; bound {eb:.5f} "
        f"by {eby}); means of 20")
    return runs


def phase_speculation_f32():
    """Phase 11b on phase 6's 4-layer f32 model: speculative streams
    equal non-speculative ones for ``codec-cuda``, ``flash`` and
    ``hydragen``, eager and fused, on 11a's prompts and under phase 8's
    pressured arrivals with ``SpecConfig(max_nodes=1)``; no page, node or
    draft is left and ``check()`` passes in every run."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.speculation import SpecConfig
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    prompts = spec_prompts(cfg.vocab_size)
    for backend in ("codec-cuda", "flash", "hydragen"):
        want = spec_serve(cfg, model, backend, "eager", prompts,
                          P11F_NEW)["streams"]
        acc = []
        for mode in ("spec-eager", "spec-fused"):
            r = spec_serve(cfg, model, backend, mode, prompts, P11F_NEW)
            diff = first_difference(want, r["streams"])
            assert diff is None, (backend, mode, diff)
            acc.append(r["stats"]["spec_accepted"])
        ref = pressured_serve(cfg, model, backend, False, P8_FREE_PAGES)
        for fused in (False, True):
            r = pressured_serve(cfg, model, backend, fused, P8_PAGES,
                                speculative=SpecConfig(max_nodes=1))
            diff = first_difference(ref["streams"], r["streams"])
            assert diff is None, (backend, fused, diff)
            assert r["pressure"]["preempted"] >= 1, (backend, r["pressure"])
        log(f"  {backend} {cfg.num_layers} layers f32: speculative streams "
            f"equal non-speculative ones, eager and fused ({P11_REQUESTS} x "
            f"{P11F_NEW} tokens, accepted {acc[0]} / {acc[1]}), and under "
            f"phase 8's arrivals on {P8_PAGES} pages with max_nodes=1 "
            f"({P8_REQUESTS} x {P8_NEW} tokens, preempted "
            f"{r['pressure']['preempted']}); check() passed, nothing left")
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 12: the model families beyond the dense subset
# --------------------------------------------------------------------- #
P12_REQUESTS, P12_DOC, P12_Q, P12_NEW = 8, 4096, 64, 32
# llama4-scout's depth cut to 4 of its 48 layers (~10.4 B parameters at
# full width, ~21 GB of bf16 weights), its document to 2048 tokens
P12B_LAYERS, P12B_DOC = 4, 2048
# 12c: one whole gemma3 period (five 512-token windows, one global layer)
# and two llama4-scout layers, f32 weights; a document of two windows
P12C_GEMMA_LAYERS, P12C_SCOUT_LAYERS = 6, 2
P12C_REQUESTS, P12C_DOC, P12C_Q, P12C_NEW = 4, 1024, 16, 16


class WindowTally:
    """While entered, counts the calls of PAC's and the epilogue's
    wrappers by attention window (each wrapper still counts its own
    launches); restores both on exit."""

    def __enter__(self):
        from repro_torch.kernels import pac as pac_mod, por as por_mod
        self.pac, self.epi = {}, {}
        self._orig = (pac_mod.pac, por_mod.por_epilogue)

        def tally(counts, fn):
            def call(*a, window=0, **kw):
                counts[window] = counts.get(window, 0) + 1
                return fn(*a, window=window, **kw)
            return call
        pac_mod.pac = tally(self.pac, self._orig[0])
        por_mod.por_epilogue = tally(self.epi, self._orig[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import pac as pac_mod, por as por_mod
        pac_mod.pac, por_mod.por_epilogue = self._orig


def layers_by_window(engine):
    """Attention layers of each window: ``{window: [layer, ...]}``."""
    out = {}
    for j in engine.attn_layer_idx:
        out.setdefault(engine.layers[j].window, []).append(j)
    return out


def family_serve(cfg, model, backend, fused, prompts, max_new,
                 profile=True):
    """``prompts`` served through one engine; checks every stream's length,
    finite logits (eager: each step's; fused: the step's flag), the
    launches (PAC, for the codec backends, and the epilogue once a layer
    and decode step eager, once a layer in each captured graph fused) and
    one replay a decode step.  Returns the engine (its requests kept, for
    the last decode state) and ``serve``'s result with the launches."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import DecodeEngine
    engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                          num_lanes=LANES, max_q=MAX_Q, backend=backend,
                          fused=fused, device="cuda")
    finite = []

    def on_step(eng):
        finite.append(bool(torch.isfinite(eng.last_logits).all()))

    reset_launches()
    res = serve(engine, prompts, max_new=max_new,
                on_step=None if fused else on_step,
                profile_steps=PROFILE_STEPS if profile else 0)
    res["launches"] = launches = read_launches()
    tag = f"{cfg.name} x{cfg.num_layers} {backend} " \
          f"{'fused' if fused else 'eager'}"
    lens = sorted({len(t) for t in res["streams"].values()})
    assert lens == [max_new], (tag, lens)
    n_attn = len(engine.attn_layer_idx)
    n_pac = n_attn if backend in ("codec-cuda", "flash") else 0
    if fused:
        step = engine.fused_step
        assert engine.stats["nonfinite_rows"] == 0, tag
        assert step.replays == res["steps"] == engine.stats["fused_calls"], \
            (tag, step.replays, res["steps"])
        assert step.graphs == len(engine.bucket_signatures), tag
        held = [slot.launches for slot in step.slots.values()]
        assert held == [(n_pac, n_attn)] * step.graphs, (tag, held)
    else:
        assert finite and all(finite), (tag, "non-finite logits")
        assert launches == {"pac": n_pac * res["steps"],
                            "por_epilogue": n_attn * res["steps"],
                            "por": 0, "mesh_merge": 0}, (tag, launches)
    return engine, res


def log_family(tag, engine, r) -> None:
    prof = r["profile"]
    fused = engine.fused_step is not None
    extra = ""
    if fused:
        extra = (f"; {engine.fused_step.graphs} graph(s) for "
                 f"{r['signatures']} signature(s) in {r['capture_s']:.3f} "
                 f"s, {engine.fused_step.replays} replays")
    log(f"  {tag}: TPOT {r['tpot_ms']:.3f} ms per step of "
        f"{P12_REQUESTS} tokens over {r['steps'] - PROFILE_STEPS} untraced "
        f"steps; traced steps 2-{PROFILE_STEPS + 1}: device busy "
        f"{prof['device_busy_ms']:.3f} ms/step of {prof['wall_ms']:.3f} "
        f"(idle share {prof['idle_share']:.3f}), "
        f"{prof['kernels_per_step']:.0f} kernels/step, host launches/step: "
        f"kernels {prof['kernel_launches_per_step']:.1f}, graphs "
        f"{prof['graph_launches_per_step']:.1f}; prefill "
        f"{r['prefill_s'] * 1e3:.1f} ms{extra}")
    if fused:
        log("    top kernels by device time a step: " + "; ".join(
            f"{name} {ms:.3f} ms x{n:g}" for name, ms, n in prof["top"][:6]))


def kv_bytes_by_window(engine):
    """KV bytes PAC reads a decode step at the engine's last state, by
    window: the valid page steps of the engine's codec plan and of the
    flash plan of the same forest, rows and leaf cut, times the window's
    layers.  Returns ``{window: (layers, codec bytes, flash bytes)}``."""
    from repro_torch.core import plan as plan_mod
    cfg = engine.cfg
    rows, truncate, _ = last_state(engine)
    per_token = 2 * cfg.num_kv_heads * cfg.head_dim * \
        engine.pool.k.element_size()
    out = {}
    for w, layers in layers_by_window(engine).items():
        plan_f = plan_mod.flash_plan(
            engine.forest, engine.cost_model, engine.num_lanes, engine.max_q,
            engine.max_kv_per_task, req_rows={r: i for i, r in
                                              enumerate(rows)},
            window=w, truncate=truncate)
        toks = [int(p.step_kvlen[p.step_valid.astype(bool)].sum())
                for p in (engine._plans[w][0], plan_f)]
        out[w] = (len(layers), *(n * per_token * len(layers) for n in toks))
    return out


def window_kernels(engine, window, name, timer, launches, gen):
    """PAC and the epilogue at the engine's last decode state for one
    window (the plan the engine built, the pool of the window's first
    layer, the last step's tails, bf16 queries of the step's shape):
    against their plain versions, timed, with their bounds.  Returns two
    entries of the ``kernels`` line; ``launches``: (PAC, epilogue) calls
    of this window in the serve."""
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    cfg = engine.cfg
    hq, d = cfg.num_heads, cfg.head_dim
    plan, pa = engine._plans[window]
    layer = layers_by_window(engine)[window][0]
    k_pool, v_pool = engine.pool.layer_pools(engine.attn_layer_idx[layer])
    _, _, tails = last_state(engine)
    B = plan.num_queries
    q = torch.randn(B, hq, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    live = live_slots(pa)
    raw = pac_mod.pac(q, pa, k_pool, v_pool, window=window)
    plain = pac_mod.pac_torch(q[pa.q_gather.long()], pa.q_pos, k_pool,
                              v_pool, pa.task_pages, pa.task_kvlen,
                              pa.task_pos, window=window)
    torch.cuda.synchronize()
    pac_err = assert_close(f"pac {name}", [x[live] for x in raw],
                           [x[live] for x in plain], TOL[k_pool.dtype])
    parts = ops.Parts(raw[0].view(-1, hq, d), raw[1].view(-1, hq),
                      raw[2].view(-1, hq), pa.seg_offsets, pa.seg_rows)
    epi = por_mod.por_epilogue(q, *parts, k_pool, v_pool, *tails,
                               window=window, stats=True)
    epi_plain = por_mod.por_epilogue_torch(q, *parts, k_pool, v_pool, *tails,
                                           window=window)
    torch.cuda.synchronize()
    ulps = bf16_ulps(epi[0], epi_plain[0])
    assert ulps <= EPI_ULPS, (f"epilogue {name}", ulps)
    ml_err = assert_close(f"epilogue {name} m, l", epi[1:], epi_plain[1:],
                          EPI_TOL)
    epi_err = max_err([epi[0]], [epi_plain[0]])
    t, med = {}, {}
    for key, fn in (
            ("pac", lambda: pac_mod.pac(q, pa, k_pool, v_pool,
                                        window=window)),
            ("pac_plain", lambda: pac_mod.pac_torch(
                q[pa.q_gather.long()], pa.q_pos, k_pool, v_pool,
                pa.task_pages, pa.task_kvlen, pa.task_pos, window=window)),
            ("epi", lambda: por_mod.por_epilogue(
                q, *parts, k_pool, v_pool, *tails, window=window)),
            ("epi_plain", lambda: por_mod.por_epilogue_torch(
                q, *parts, k_pool, v_pool, *tails, window=window))):
        t[key] = timer(fn)
        med[key] = timer.median
    pac_b, pac_by = pac_bound(plan, pa, q, k_pool)
    epi_b, epi_by = epilogue_bound(q, parts, k_pool, tails, window)
    log(f"  {name}: plan {plan.num_tasks} tasks on {plan.num_lanes} lanes, "
        f"{int(plan.step_valid.sum())} valid page steps, "
        f"{parts.seg_rows.numel()} live partial rows; PAC grid "
        f"{plan.num_lanes} lanes x {cfg.num_kv_heads} KV heads")
    log(f"    PAC {t['pac']:.4f} ms/launch, mean of 20 (median "
        f"{med['pac']:.4f}; plain {t['pac_plain']:.4f}; bound {pac_b:.4f} by "
        f"{pac_by}, {pac_b / t['pac']:.1%} of it), max|err| {pac_err:.3e}; "
        f"epilogue {t['epi']:.4f} ms/launch (median {med['epi']:.4f}; plain "
        f"{t['epi_plain']:.4f}; bound {epi_b:.5f} by {epi_by}), bf16 output "
        f"within {ulps} step(s), max|err| {epi_err:.3e} (m, l "
        f"{ml_err:.3e}); launches in the serve: PAC {launches[0]}, "
        f"epilogue {launches[1]}")
    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": f"pac ({name})", **common,
         "source": "src/repro_torch/kernels/csrc/pac.cu",
         "replaces": "src/repro/kernels/pac.py:138",
         "launches": launches[0], "max_abs_err": pac_err, "ms": t["pac"],
         "plain_ms": t["pac_plain"], "bound_ms": pac_b, "bound_by": pac_by},
        {"name": f"por_epilogue ({name})", **common,
         "source": "src/repro_torch/kernels/csrc/por.cu",
         "replaces": "src/repro/kernels/por.py:44, "
                     "src/repro/kernels/ops.py:80, "
                     "src/repro/kernels/ops.py:91",
         "launches": launches[1], "max_abs_err": epi_err, "ms": t["epi"],
         "plain_ms": t["epi_plain"], "bound_ms": epi_b, "bound_by": epi_by}]


def phase_gemma3(timer):
    """12a: gemma3-1b at full width and depth, bf16 weights from seed 0:
    8 questions over one 4096-token document (8 windows), 32 greedy
    tokens each, through ``codec-cuda`` eager (PAC and the epilogue
    tallied by window) and fused, then ``flash`` fused; KV bytes a step by
    window; PAC and the epilogue at the last decode state, per window."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models.transformer import build_model
    cfg = get_config("gemma3-1b")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  model {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} query heads over "
        f"{cfg.num_kv_heads} KV head, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.mlp_act}, embed scale, "
        f"window {cfg.sliding_window} on 5 of every 6 layers; "
        f"{cfg.param_count() / 1e9:.2f} B params, bf16, seed 0, built in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = doc_prompts(P12_REQUESTS, P12_DOC, P12_Q, cfg.vocab_size,
                          seed=0)
    with WindowTally() as tally:
        eng, r_e = family_serve(cfg, model, "codec-cuda", False, prompts,
                                P12_NEW)
    by_win = layers_by_window(eng)
    assert sorted(by_win) == [0, cfg.sliding_window], sorted(by_win)
    for w, layers in by_win.items():
        want = len(layers) * r_e["steps"]
        assert tally.pac[w] == tally.epi[w] == want, (w, tally.pac,
                                                      tally.epi, want)
    log(f"  windows: {len(by_win[0])} global layers, "
        f"{len(by_win[cfg.sliding_window])} layers of window "
        f"{cfg.sliding_window}; eager launches by window: PAC {tally.pac}, "
        f"epilogue {tally.epi} ({r_e['steps']} decode steps)")
    log_family("gemma3-1b codec-cuda eager", eng, r_e)
    kv = kv_bytes_by_window(eng)
    esize = eng.pool.k.element_size()
    io_c = eng.forest.codec_io_bytes(cfg.num_kv_heads, cfg.head_dim, esize)
    io_f = eng.forest.flash_io_bytes(cfg.num_kv_heads, cfg.head_dim, esize)
    tot_c = sum(c for _, c, _ in kv.values())
    tot_f = sum(f for _, _, f in kv.values())
    for w, (n, c, f) in sorted(kv.items()):
        log(f"  KV bytes PAC reads a step, window {w:<4} ({n:>2} layers): "
            f"codec {c / 1e6:.2f} MB, flash {f / 1e6:.2f} MB "
            f"({f / max(c, 1):.2f}x)")
    log(f"  KV bytes a step, all layers: codec {tot_c / 1e6:.2f} MB, flash "
        f"{tot_f / 1e6:.2f} MB ({tot_f / tot_c:.2f}x); the window-free "
        f"count (codec_io_bytes / flash_io_bytes, tails included) per "
        f"layer {io_c / 1e6:.2f} / {io_f / 1e6:.2f} MB, x{cfg.num_layers} "
        f"layers {io_f / io_c:.2f}x")
    gen = torch.Generator(device="cuda").manual_seed(12)
    kernels = []
    for w in sorted(by_win):
        kernels += window_kernels(
            eng, w, f"gemma3-1b, window {w}, d {cfg.head_dim}, group "
            f"{cfg.group}", timer, (tally.pac[w], tally.epi[w]), gen)
    eager = r_e
    del eng
    torch.cuda.empty_cache()
    tpot = {}
    for backend in ("codec-cuda", "flash"):
        eng, r = family_serve(cfg, model, backend, True, prompts, P12_NEW)
        sigs = eng.bucket_signatures
        assert all([w for w, *_ in sig[1:]] == [0, cfg.sliding_window]
                   for sig in sigs), sigs
        log_family(f"gemma3-1b {backend} fused", eng, r)
        log(f"    signatures (bucket, then one plan slot a window): "
            + "; ".join(str((s[0],) + tuple(x[:2] for x in s[1:]))
                        for s in sorted(sigs)))
        same = sum(r["streams"][q] == eager["streams"][q]
                   for q in eager["streams"])
        log(f"    {same} of {len(eager['streams'])} bf16 streams equal "
            f"codec-cuda eager's")
        tpot[backend] = r["tpot_ms"]
        release_all(f"gemma3 {backend} fused", eng)
        del eng
        torch.cuda.empty_cache()
    log(f"  gemma3-1b TPOT: codec-cuda eager {eager['tpot_ms']:.3f} ms, "
        f"fused {tpot['codec-cuda']:.3f} ms "
        f"({eager['tpot_ms'] / tpot['codec-cuda']:.2f}x), flash fused "
        f"{tpot['flash']:.3f} ms (flash - codec-cuda "
        f"{tpot['flash'] - tpot['codec-cuda']:.3f} ms a step)")
    del model
    torch.cuda.empty_cache()
    return kernels


class MoEDrops:
    """While entered, counts the token-choices ``apply_moe`` drops by
    capacity, decode calls (one token a row) apart from prefill calls, on
    the device (no host sync until read); restores it on exit."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.acc = {"decode": [], "prefill": []}
        self.choices = {"decode": 0, "prefill": 0}
        self._orig = L.apply_moe

        def counted(p, cfg, x):
            B, T, _ = x.shape
            _, _, _, pos, cap = L.moe_route(p, cfg, x.reshape(1, B * T, -1))
            key = "decode" if T == 1 else "prefill"
            self.acc[key].append((pos >= cap).sum())
            self.choices[key] += pos.numel()
            return self._orig(p, cfg, x)
        L.apply_moe = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.apply_moe = self._orig

    def read(self):
        return {k: (int(sum(v).item()) if v else 0, self.choices[k])
                for k, v in self.acc.items()}


def phase_scout(timer):
    """12b: llama4-scout-17b-a16e at full width, depth cut to 4 layers,
    bf16 weights from seed 0: 8 questions over a 2048-token document, 32
    greedy tokens each, ``codec-cuda`` eager (timed, then again counting
    the token-choices dropped by capacity) and fused; the MoE's device
    time a step; PAC and the epilogue at group 5."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              num_layers=P12B_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  model {cfg.name}: {cfg.num_layers} of 48 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} query heads over "
        f"{cfg.num_kv_heads} KV heads, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, untied head; {cfg.param_count() / 1e9:.2f} B "
        f"params ({nbytes / 1e9:.1f} GB, router f32), bf16, seed 0, built "
        f"in {time.perf_counter() - t0:.1f} s")
    prompts = doc_prompts(P12_REQUESTS, P12B_DOC, P12_Q, cfg.vocab_size,
                          seed=0)
    eng, r_e = family_serve(cfg, model, "codec-cuda", False, prompts,
                            P12_NEW)
    log_family("llama4-scout codec-cuda eager", eng, r_e)
    gen = torch.Generator(device="cuda").manual_seed(13)
    n_attn = len(eng.attn_layer_idx)
    kernels = window_kernels(
        eng, 0, f"llama4-scout, d {cfg.head_dim}, group {cfg.group}", timer,
        (r_e["launches"]["pac"], r_e["launches"]["por_epilogue"]), gen)
    # the MoE of one decode step: a layer's apply_moe on the step's shape
    # (8 rows of one token), times the MoE layers
    ffn = model.layers[0].ffn
    x = torch.randn(P12_REQUESTS, 1, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    moe_ms = timer(lambda: L.apply_moe(ffn, cfg, x))
    moe_med = timer.median
    w_bytes = sum(t.numel() * t.element_size() for t in (ffn.wi, ffn.wo,
                                                         ffn.router))
    log(f"  MoE: apply_moe {moe_ms:.4f} ms a layer at {P12_REQUESTS} rows "
        f"(median {moe_med:.4f}; cap {L.moe_capacity(cfg, P12_REQUESTS)} a "
        f"expert), {moe_ms * n_attn:.3f} ms a decode step of "
        f"{n_attn} layers; it streams every expert's weights, "
        f"{w_bytes / 1e9:.2f} GB a layer: bound {1e3 * w_bytes / HBM_BW:.4f}"
        f" ms by bytes")
    release_all("llama4-scout eager", eng)
    del eng
    with MoEDrops() as drops:
        eng, r_d = family_serve(cfg, model, "codec-cuda", False, prompts,
                                P12_NEW, profile=False)
    assert r_d["streams"] == r_e["streams"], "a counted run differs"
    (dd, dn), (pd, pn) = drops.read()["decode"], drops.read()["prefill"]
    log(f"  token-choices dropped by capacity (capacity_factor "
        f"{cfg.capacity_factor}): decode {dd} of {dn} ({dd / dn:.1%}), "
        f"prefill {pd} of {pn} ({pd / max(pn, 1):.1%}); the counted run's "
        f"streams equal the timed one's")
    release_all("llama4-scout counted", eng)
    del eng
    eng, r_f = family_serve(cfg, model, "codec-cuda", True, prompts, P12_NEW)
    log_family("llama4-scout codec-cuda fused", eng, r_f)
    same = sum(r_f["streams"][q] == r_e["streams"][q] for q in r_e["streams"])
    log(f"  llama4-scout TPOT: eager {r_e['tpot_ms']:.3f} ms, fused "
        f"{r_f['tpot_ms']:.3f} ms ({r_e['tpot_ms'] / r_f['tpot_ms']:.2f}x); "
        f"MoE {moe_ms * n_attn:.3f} ms of it by CUDA events; {same} of "
        f"{len(r_e['streams'])} bf16 streams equal eager's")
    release_all("llama4-scout fused", eng)
    del eng, model
    torch.cuda.empty_cache()
    return kernels


def phase_families_f32():
    """12c at f32 weights: gemma3 at full width, one whole period (6
    layers), streams equal through ``codec-cuda``, ``codec-torch``,
    ``flash`` and ``hydragen``, eager and fused, and speculative streams
    (``SpecConfig()``) equal plain greedy, eager and fused;
    llama4-scout at full width, 2 layers: fused equals eager with 8 rows
    in bucket 8."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config("gemma3-1b"),
                              num_layers=P12C_GEMMA_LAYERS)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    prompts = doc_prompts(P12C_REQUESTS, P12C_DOC, P12C_Q, cfg.vocab_size,
                          seed=3)
    want = None
    for backend in BACKENDS:
        for fused in (False, True):
            eng, r = family_serve(cfg, model, backend, fused, prompts,
                                  P12C_NEW, profile=False)
            if want is None:
                want = r["streams"]
            diff = first_difference(want, r["streams"])
            assert diff is None, (backend, fused, diff)
            release_all(f"gemma3 f32 {backend}", eng)
            del eng
    log(f"  gemma3-1b x{cfg.num_layers} f32: {' == '.join(BACKENDS)}, eager "
        f"and fused, on {len(want)} streams x {P12C_NEW} tokens over a "
        f"{P12C_DOC}-token document")
    rng = np.random.default_rng(12)
    block = rng.integers(1, cfg.vocab_size, P11_BLOCK).tolist()
    rep = [block * (P12C_DOC // P11_BLOCK)
           + rng.integers(1, cfg.vocab_size, P12C_Q).tolist()
           for _ in range(P12C_REQUESTS)]
    base = spec_serve(cfg, model, "codec-cuda", "eager", rep, P12C_NEW)
    acc = []
    for mode in ("spec-eager", "spec-fused"):
        r = spec_serve(cfg, model, "codec-cuda", mode, rep, P12C_NEW)
        diff = first_difference(base["streams"], r["streams"])
        assert diff is None, (mode, diff)
        acc.append(r["stats"]["spec_accepted"])
    log(f"  gemma3-1b x{cfg.num_layers} f32: speculative streams equal plain "
        f"greedy, eager and fused ({P12C_REQUESTS} x {P12C_NEW} tokens over "
        f"a repeated-block document; drafts accepted {acc[0]} / {acc[1]})")
    del model
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              num_layers=P12C_SCOUT_LAYERS)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    prompts = doc_prompts(P12_REQUESTS, P12C_DOC, P12C_Q, cfg.vocab_size,
                          seed=4)
    streams = {}
    for fused in (False, True):
        eng, r = family_serve(cfg, model, "codec-cuda", fused, prompts,
                              P12C_NEW, profile=False)
        streams[fused] = r["streams"]
        if fused:
            assert {s[0] for s in eng.bucket_signatures} == {8}, \
                eng.bucket_signatures
        release_all(f"llama4-scout f32 fused={fused}", eng)
        del eng
    diff = first_difference(streams[False], streams[True])
    assert diff is None, diff
    log(f"  llama4-scout x{cfg.num_layers} f32: fused == eager on "
        f"{len(streams[True])} streams x {P12C_NEW} tokens, {P12_REQUESTS} "
        f"rows in bucket 8 (cap {cfg.capacity_factor} x 8 / "
        f"{cfg.num_experts} -> 1 a expert, both modes)")
    del model
    torch.cuda.empty_cache()

# --------------------------------------------------------------------- #
# phase 13: Mamba-2 and the hybrid jamba
# --------------------------------------------------------------------- #
P13_REQUESTS, P13_DOC, P13_Q, P13_NEW = 8, 4096, 64, 32
P13B_LAYERS, P13B_DOC = 8, 2048
# 13c: the narrow f32 models
P13C_MAMBA_LAYERS = 4
P13C_REQUESTS, P13C_DOC, P13C_Q, P13C_NEW = 4, 1024, 16, 16
P13C_WIDTH = dict(d_model=1024, num_heads=8, num_kv_heads=2, head_dim=128,
                  d_ff=2048, capacity_factor=0.0)
# 13d: C1's recipe at gemma3-1b's full width
P13D_LAYERS, P13D_DOC, P13D_NEW = 6, 1024, 16
P13D_TAILS = (1, 300)


def ssm_step_bytes(cfg, rows):
    """SSM state bytes a decode step reads and writes: each Mamba layer's
    float32 conv and ssm state of every row, read once and written
    once."""
    from repro_torch.models import mamba as M
    cs, ss = M.state_shapes(cfg)
    n_mamba = sum(cfg.layer_kind(i).mixer == "mamba"
                  for i in range(cfg.num_layers))
    return 2 * 4 * rows * n_mamba * (int(np.prod(cs)) + int(np.prod(ss)))


def weight_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def check_ssm_sharing(tag, engine, n_requests, doc):
    """The shared document node carries every Mamba layer's boundary
    state; returns the prefill tokens the engine computed."""
    n_mamba = sum(layer.kind.mixer == "mamba" for layer in engine.layers)
    shared = [n for n in engine.forest.real_nodes()
              if len(n.requests) == n_requests]
    assert shared and sum(n.length for n in shared) == doc, \
        (tag, [(n.length, len(n.requests)) for n in shared])
    assert len(shared[-1].meta.get("ssm", {})) == n_mamba, tag
    return engine.stats["prefill_tokens"]


def phase_mamba2(timer):
    """13a: mamba2-2.7b at full width and depth (64 Mamba-2 layers, d_model
    2560, d_inner 5120, 80 heads of 64, state 128; attention-free), bf16
    weights from seed 0: phase 3's workload through ``codec-cuda`` eager
    and fused.  No attention layer: PAC and the epilogue never launch; the
    shared document's node carries every layer's SSM state, so requests
    2-7 prefill their questions only.  Then phase 10's burst with cascade
    on: the document is prefilled once."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models.transformer import build_model
    cfg = get_config("mamba2-2.7b")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    w_bytes = weight_bytes(model)
    log(f"  model {cfg.name}: {cfg.num_layers} Mamba-2 layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv {cfg.ssm_conv}, "
        f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, tied head; "
        f"{cfg.param_count() / 1e9:.2f} B params ({w_bytes / 1e9:.2f} GB), "
        f"bf16, seed 0, built in {time.perf_counter() - t0:.1f} s")
    prompts = doc_prompts(P13_REQUESTS, P13_DOC, P13_Q, cfg.vocab_size,
                          seed=0)
    total = P13_DOC + P13_Q
    # one dense prefill of a whole prompt: its seconds and peak memory
    tok = torch.tensor([prompts[0]], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(tok, last_only=True)
    torch.cuda.synchronize()
    pf_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    assert bool(torch.isfinite(logits).all())
    del logits
    log(f"  dense prefill of one {total}-token prompt: {pf_s:.3f} s (first "
        f"call, host clock), peak memory {peak / 1e9:.3f} GB above the "
        f"weights (max_memory_allocated)")
    with WindowTally() as tally:
        eng, r_e = family_serve(cfg, model, "codec-cuda", False, prompts,
                                P13_NEW)
    assert r_e["launches"] == {"pac": 0, "por_epilogue": 0, "por": 0,
                               "mesh_merge": 0}, \
        r_e["launches"]
    assert not tally.pac and not tally.epi and not eng.attn_layer_idx
    pt = check_ssm_sharing("mamba2 eager", eng, P13_REQUESTS, P13_DOC)
    # request 0 prefills its prompt as one node; request 1's insertion
    # splits it at the document's end, where no state was kept, so it
    # recomputes the document and caches its boundary; 2-7 resume there
    assert pt == 2 * total + (P13_REQUESTS - 2) * P13_Q, pt
    log(f"  prefill tokens computed: {pt} of {P13_REQUESTS} x {total} = "
        f"{P13_REQUESTS * total} ({pt / (P13_REQUESTS * total):.1%}); the "
        f"document node carries {len(eng.layers)} layers' SSM state; "
        f"prefill {r_e['prefill_s']:.3f} s (host clock around the 8 "
        f"add_request calls)")
    log_family("mamba2-2.7b codec-cuda eager", eng, r_e)
    release_all("mamba2 eager", eng)
    del eng
    torch.cuda.empty_cache()
    eng, r_f = family_serve(cfg, model, "codec-cuda", True, prompts, P13_NEW)
    assert all(len(sig) == 1 for sig in eng.bucket_signatures), \
        eng.bucket_signatures
    check_ssm_sharing("mamba2 fused", eng, P13_REQUESTS, P13_DOC)
    log_family("mamba2-2.7b codec-cuda fused", eng, r_f)
    sigs = sorted(eng.bucket_signatures)
    release_all("mamba2 fused", eng)
    del eng
    torch.cuda.empty_cache()
    # phase 10's burst, cascade on: the shared span once through the lead,
    # its boundary state cached, every question resumes there
    r_c = cascade_burst(cfg, model, True)
    want = P10_DECOY + P10_DOC + P10_REQUESTS * P10_Q
    assert r_c["prefill_tokens"] == want, (r_c["prefill_tokens"], want)
    log(f"  cascade burst (phase 10's: {P10_REQUESTS} questions over an "
        f"uncached {P10_DOC}-token document behind a {P10_DECOY}-token "
        f"decoy, fused): prefill tokens {r_c['prefill_tokens']} = decoy + "
        f"the document once + the questions, burst prefill "
        f"{r_c['burst_prefill_s']:.3f} s (CUDA events), TPOT "
        f"{r_c['tpot_ms']:.3f} ms; {r_c['cascade']}")
    same = sum(r_f["streams"][q] == r_e["streams"][q] for q in r_e["streams"])
    sb = ssm_step_bytes(cfg, P13_REQUESTS)
    log(f"  mamba2-2.7b TPOT: eager {r_e['tpot_ms']:.3f} ms, fused "
        f"{r_f['tpot_ms']:.3f} ms ({r_e['tpot_ms'] / r_f['tpot_ms']:.2f}x); "
        f"{same} of {len(r_e['streams'])} bf16 streams equal eager's; "
        f"signatures {sigs}")
    log(f"  bytes a decode step: SSM state read + written {sb / 1e9:.3f} GB "
        f"({sb / 2 / P13_REQUESTS / 1e6:.1f} MB a request each way), "
        f"weights {w_bytes / 1e9:.3f} GB; bound "
        f"{1e3 * (sb + w_bytes) / HBM_BW:.3f} ms a step by bytes")
    del model
    torch.cuda.empty_cache()


class MoEDropCounter:
    """While entered, counts on the device the token-choices
    ``apply_moe`` drops by capacity in decode calls (one token a row),
    inside captured graphs too; the fused step's warm-ups before capture
    are left out.  Restores everything on exit."""

    def __enter__(self):
        from repro_torch.models import layers as L
        from repro_torch.serving import step_fn
        self.dropped = torch.zeros((), dtype=torch.int64, device="cuda")
        self.choices = torch.zeros((), dtype=torch.int64, device="cuda")
        self._orig = (L.apply_moe, step_fn.FusedStep._capture)
        orig_moe, orig_cap = self._orig
        me = self

        def counted(p, cfg, x):
            B, T, _ = x.shape
            if T == 1:
                _, _, _, pos, cap = L.moe_route(p, cfg,
                                                x.reshape(1, B * T, -1))
                me.dropped.add_((pos >= cap).sum())
                me.choices.add_(pos.numel())
            return orig_moe(p, cfg, x)

        def capture(step, slot):
            d0, c0 = me.dropped.clone(), me.choices.clone()
            orig_cap(step, slot)
            # the warm-up ran once eagerly; the capture ran nothing
            me.dropped.copy_(d0)
            me.choices.copy_(c0)
        L.apply_moe = counted
        step_fn.FusedStep._capture = capture
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        from repro_torch.serving import step_fn
        L.apply_moe, step_fn.FusedStep._capture = self._orig

    def read(self):
        return int(self.dropped.item()), int(self.choices.item())


def phase_jamba(timer):
    """13b: jamba-v0.1-52b at full width (d_model 4096; Mamba-2 mixers of
    64 heads of 64, state 16; 32 query heads over 8 KV heads, head_dim
    128; 16 experts top-2 at capacity 1.25, d_ff 14336; untied head),
    depth cut to one period of its 32 layers (8: 7 Mamba + 1 attention, 4
    MoE + 4 MLP), bf16 weights from seed 0: 8 questions over a 2048-token
    document, 32 tokens each, ``codec-cuda`` eager and fused; PAC and the
    epilogue once a decode step, held to their plain versions at the last
    decode state."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              num_layers=P13B_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    w_bytes = weight_bytes(model)
    log(f"  model {cfg.name}: {cfg.num_layers} of 32 layers (one period: "
        f"attention at slot 4, MoE on odd slots), d_model {cfg.d_model}, "
        f"{cfg.num_heads} query heads over {cfg.num_kv_heads} KV heads, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} at "
        f"capacity {cfg.capacity_factor}, d_ff {cfg.d_ff}, Mamba {cfg.ssm_heads}"
        f" heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}; "
        f"{cfg.param_count() / 1e9:.2f} B params ({w_bytes / 1e9:.1f} GB), "
        f"bf16, seed 0, built in {time.perf_counter() - t0:.1f} s")
    prompts = doc_prompts(P13_REQUESTS, P13B_DOC, P13_Q, cfg.vocab_size,
                          seed=0)
    eng, r_e = family_serve(cfg, model, "codec-cuda", False, prompts,
                            P13_NEW)
    assert len(eng.attn_layer_idx) == 1
    assert r_e["launches"]["pac"] == r_e["launches"]["por_epilogue"] \
        == r_e["steps"], r_e["launches"]
    check_ssm_sharing("jamba eager", eng, P13_REQUESTS, P13B_DOC)
    log_family("jamba codec-cuda eager", eng, r_e)
    gen = torch.Generator(device="cuda").manual_seed(14)
    kernels = window_kernels(
        eng, 0, f"jamba, d {cfg.head_dim}, group {cfg.group}", timer,
        (r_e["launches"]["pac"], r_e["launches"]["por_epilogue"]), gen)
    (n, c, f), = kv_bytes_by_window(eng).values()
    log(f"  KV bytes PAC reads a step ({n} attention layer): codec "
        f"{c / 1e6:.2f} MB, flash {f / 1e6:.2f} MB ({f / max(c, 1):.2f}x)")
    moe_js = [j for j, layer in enumerate(model.layers)
              if layer.kind.ffn == "moe"]
    ffn = model.layers[moe_js[0]].ffn
    x = torch.randn(P13_REQUESTS, 1, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    moe_ms = timer(lambda: L.apply_moe(ffn, cfg, x))
    moe_med = timer.median
    log(f"  MoE: apply_moe {moe_ms:.4f} ms a layer at {P13_REQUESTS} rows "
        f"(median {moe_med:.4f}), {moe_ms * len(moe_js):.3f} ms a decode "
        f"step of {len(moe_js)} MoE layers (CUDA events)")
    sb = ssm_step_bytes(cfg, P13_REQUESTS)
    log(f"  bytes a decode step: SSM state read + written {sb / 1e6:.1f} MB,"
        f" weights {w_bytes / 1e9:.2f} GB (every expert's: 8 rows x top-2 "
        f"touch most of 16)")
    release_all("jamba eager", eng)
    del eng
    torch.cuda.empty_cache()
    eng, r_f = family_serve(cfg, model, "codec-cuda", True, prompts, P13_NEW)
    log_family("jamba codec-cuda fused", eng, r_f)
    release_all("jamba fused", eng)
    del eng
    drops = {}
    for fused in (False, True):
        with MoEDropCounter() as cnt:
            eng, r = family_serve(cfg, model, "codec-cuda", fused, prompts,
                                  P13_NEW, profile=False)
            torch.cuda.synchronize()
            drops[fused] = cnt.read()
        ref = r_f if fused else r_e
        assert r["streams"] == ref["streams"], ("a counted run differs",
                                                fused)
        release_all("jamba counted", eng)
        del eng
    (de, ne), (df, nf) = drops[False], drops[True]
    same = sum(r_f["streams"][q] == r_e["streams"][q] for q in r_e["streams"])
    log(f"  token-choices dropped by capacity in decode: eager {de} of {ne} "
        f"({de / max(ne, 1):.1%}), fused {df} of {nf} ({df / max(nf, 1):.1%};"
        f" padded rows route too); the counted runs' streams equal the "
        f"timed ones'")
    log(f"  jamba TPOT: eager {r_e['tpot_ms']:.3f} ms, fused "
        f"{r_f['tpot_ms']:.3f} ms ({r_e['tpot_ms'] / r_f['tpot_ms']:.2f}x); "
        f"{same} of {len(r_e['streams'])} bf16 streams equal eager's (MoE "
        f"capacity follows each mode's token count)")
    del model
    torch.cuda.empty_cache()
    return kernels


def narrow_models():
    """13c's f32 models: jamba at 1024 wide (8 query heads over 2 KV heads
    of 128), one period, capacity 0; mamba2 at full width, 4 layers."""
    from repro_torch.configs import get_config
    return [dataclasses.replace(get_config("jamba-v0.1-52b"),
                                num_layers=P13B_LAYERS, **P13C_WIDTH),
            dataclasses.replace(get_config("mamba2-2.7b"),
                                num_layers=P13C_MAMBA_LAYERS)]


def phase_mamba_f32():
    """13c at f32: for the narrow jamba and mamba2, streams equal through
    ``codec-cuda``, ``flash`` and ``hydragen``, eager and fused; phase 8's
    pressured arrivals (preemption, recompute from ``meta["ssm"]``) equal
    unconstrained, eager and fused; phase 10's burst equal with cascade on
    and off; phase 9's waves equal with and without the prefix cache; no
    page left and ``check()`` passing after each."""
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models.transformer import build_model
    for cfg in narrow_models():
        model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
        tag = f"{cfg.name} x{cfg.num_layers} d{cfg.d_model} f32"
        prompts = doc_prompts(P13C_REQUESTS, P13C_DOC, P13C_Q,
                              cfg.vocab_size, seed=5)
        want = None
        for backend in ("codec-cuda", "flash", "hydragen"):
            for fused in (False, True):
                eng, r = family_serve(cfg, model, backend, fused, prompts,
                                      P13C_NEW, profile=False)
                if want is None:
                    want = r["streams"]
                diff = first_difference(want, r["streams"])
                assert diff is None, (tag, backend, fused, diff)
                release_all(f"{tag} {backend}", eng)
                del eng
        log(f"  {tag}: codec-cuda == flash == hydragen, eager and fused, "
            f"{len(want)} streams x {P13C_NEW} tokens")
        runs = {}
        for mode, pages in (("eager", P8_FREE_PAGES), ("eager", P8_PAGES),
                            ("fused", P8_PAGES)):
            runs[mode, pages] = pressured_serve(cfg, model, "codec-cuda",
                                                mode == "fused", pages)
        base = runs["eager", P8_FREE_PAGES]["streams"]
        for key, r in runs.items():
            diff = first_difference(base, r["streams"])
            assert diff is None, (tag, key, diff)
        check_pressure(f"{tag} pressured", runs["eager", P8_PAGES], P8_PAGES)
        p = runs["fused", P8_PAGES]["pressure"]
        log(f"  {tag}: phase 8's {P8_REQUESTS} arrivals equal pressured "
            f"({P8_PAGES} pages: preempted {p['preempted']}, "
            f"recompute_tokens {p['recompute_tokens']}) and unconstrained, "
            f"eager and fused")
        cas = {c: cascade_burst(cfg, model, c) for c in (False, True)}
        diff = first_difference(cas[False]["streams"], cas[True]["streams"])
        assert diff is None, (tag, "cascade", diff)
        assert cas[True]["cascade"]["cascade_groups"] >= 1, cas[True]
        log(f"  {tag}: phase 10's burst equal with cascade on and off "
            f"(fused; cascade {cas[True]['cascade']})")
        waves = {c: serve_waves(cfg, model, cache=c or None, fused=True)
                 for c in (False, True)}
        for w in ("A", "B"):
            diff = first_difference(waves[False][w]["streams"],
                                    waves[True][w]["streams"])
            assert diff is None, (tag, "cache", w, diff)
        hit = waves[True]["B"]["hit_tokens"]
        assert hit > 0, waves[True]["B"]
        log(f"  {tag}: phase 9's waves equal with and without the prefix "
            f"cache (fused; wave B took {hit} prompt tokens from it)")
        del model
        torch.cuda.empty_cache()


def phase_window_c1():
    """13d: ROADMAP C1 on the card: gemma3-1b at full width, one period
    (6 layers: 5 of window 512, 1 global), f32, two requests over one
    1024-token document at unequal positions (a 1-token and a 300-token
    tail), 16 greedy tokens each: ``codec-cuda`` eager and fused equal
    the dense ``prefill`` + ``decode_step`` decode."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (build_model, decode_step,
                                                prefill)
    from repro_torch.serving.engine import DecodeEngine
    cfg = dataclasses.replace(get_config("gemma3-1b"),
                              num_layers=P13D_LAYERS)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(13)
    doc = rng.integers(1, cfg.vocab_size, P13D_DOC).tolist()
    prompts = [doc + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in P13D_TAILS]
    dense = {}
    for i, p in enumerate(prompts):
        logits, cache, clen = prefill(model, torch.tensor([p], device="cuda"),
                                      len(p) + P13D_NEW)
        out = []
        for _ in range(P13D_NEW):
            nxt = int(torch.argmax(logits[0]))
            out.append(nxt)
            logits, cache = decode_step(
                model, torch.tensor([[nxt]], device="cuda"), cache, clen)
            clen = clen + 1
        dense[i] = out
        del cache
    for fused in (False, True):
        eng = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                           num_lanes=LANES, max_q=MAX_Q, fused=fused,
                           device="cuda")
        reset_launches()
        for p in prompts:
            eng.add_request(p, max_new=P13D_NEW)
        got = eng.run(P13D_NEW + 4)
        launches = read_launches()
        assert launches["pac"] > 0 and launches["por_epilogue"] > 0, \
            launches
        diff = first_difference(dense, {i: got[i] for i in dense})
        assert diff is None, ("C1", fused, diff)
        release_all(f"C1 fused={fused}", eng)
        del eng
    log(f"  gemma3-1b x{cfg.num_layers} f32, window {cfg.sliding_window}: "
        f"two requests at positions {[len(p) for p in prompts]} over one "
        f"{P13D_DOC}-token document; codec-cuda eager and fused equal the "
        f"dense decode ({P13D_NEW} tokens each)")
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 14: the mesh on one card
# --------------------------------------------------------------------- #
P14_DOC, P14_Q = 4096, 64
P14_MESHES = ((1, 1), (2, 1), (2, 2))
# pages a node keeps on one data shard: half of the 4096-token document,
# so it spans both data shards
P14_SPLIT = 128
P14F_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))
P14F_TEMPERATURE = 0.7
# the JAX package's TPU priors, set on a 4-layer engine's cost model to
# make replication pay (the H100's priors do not, at these shapes)
P14_REPLICATE_HW = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
                        grid_step_overhead=1e-6, launch_overhead=5e-6)
P14D_NEW = [8 + 3 * i for i in range(8)]
# 14b's pressured pool: one request's 262 pages fit, the batch's 304 do
# not
P14_PAGES, P14_CHUNK = 288, 512
# 14a's fused TPOT (ms) before the merge kernel, when the butterfly ran on
# codec_por amid 35 other small kernels a layer (tools/chip_phase14.py on
# an NVIDIA H100 80GB HBM3 at 700.00 W)
P14_TPOT_BEFORE = {"1x1": 11.86, "2x1": 14.29, "2x2": 18.86}


def mesh_engine(cfg, model, d, m, mesh=None, **kw):
    """A fused mesh engine on ``mesh`` (by default a ``d`` x ``m``
    single-controller mesh on the card)."""
    from repro_torch.distributed import decode_mesh
    from repro_torch.serving.engine import DecodeEngine
    kw.setdefault("num_pages", 1024)
    mesh = mesh or decode_mesh(d, m)
    return DecodeEngine(cfg, model, page_size=PAGE, num_lanes=LANES,
                        max_q=MAX_Q, fused=True, mesh=mesh,
                        seq_split_pages=P14_SPLIT, device=mesh.device, **kw)


def check_mesh_graphs(tag, engine, res, d, m):
    """Replays equal steps, one graph a signature, and in each graph D x M
    PAC and epilogue launches a layer, one ``codec_mesh_merge`` launch a
    layer where rows span shards and no ``codec_por``; returns the merge
    widths Bm by signature."""
    n_attn = len(engine.attn_layer_idx)
    step = engine.fused_step
    assert step.replays == res["steps"] == engine.stats["fused_calls"], \
        (tag, step.replays, res["steps"])
    assert step.graphs == len(engine.bucket_signatures) \
        == engine.fused_cache_size, (tag, step.graphs)
    widths = []
    for sig, slot in step.slots.items():
        bm = sig[-1][1]
        widths.append(bm)
        assert slot.launches == (n_attn * d * m,) * 2, (tag, sig,
                                                        slot.launches)
        assert slot.por_launches == 0, (tag, sig, slot.por_launches)
        merges = n_attn if d > 1 and bm else 0
        assert slot.merge_launches == merges, (tag, sig,
                                               slot.merge_launches)
    return widths


def mesh_kv_bytes(engine):
    """Plan-covered KV bytes each shard ``(d, m)`` reads a step in the
    last epoch (K and V of its pages and heads, over the attention
    layers), by data shard."""
    cfg = engine.cfg
    per_head = 2 * cfg.head_dim * engine.pool.k.element_size() \
        * (cfg.num_kv_heads // engine.mesh.shape["model"])
    n_attn_w = {}
    for j in engine.attn_layer_idx:
        w = engine.layers[j].window
        n_attn_w[w] = n_attn_w.get(w, 0) + 1
    out = [0] * engine.pool.num_shards
    for w, sp in engine._sharded_plans.items():
        for d, p in enumerate(sp.shards):
            out[d] += n_attn_w[w] * per_head * sum(s.n for s in p.subtasks)
    return out


def top2_recorder(store):
    """An ``on_step`` that keeps, on the device, the top-2 logits of every
    token a fused step sampled, by request and token index (read after
    the run: no synchronize in the loop)."""
    def on_step(eng):
        if not eng.step_stats[-1]["decoded"]:
            return
        idx = [(r, len(eng.requests[r].generated)) for r in eng.last_rows]
        store.append((idx, torch.topk(eng.last_logits, 2).values))
    return on_step


def bf16_steps(x: float) -> float:
    """One bf16 step (ulp) at the magnitude of ``x``."""
    return 2.0 ** (int(np.floor(np.log2(max(abs(x), 1e-30)))) - 7)


def check_near_ties(tag, ref, ref_top2, got):
    """Where ``got``'s bf16 streams part from ``ref``'s: the reference's
    top-2 logits at the first differing token must lie within 2 bf16
    steps of each other (the ROADMAP's near-tie trap).  Returns the
    equal streams and the largest gap in bf16 steps."""
    same, worst = 0, 0.0
    for rid in sorted(ref):
        diff = first_difference({rid: ref[rid]}, {rid: got[rid]})
        if diff is None:
            same += 1
            continue
        _, i, x, y = diff
        v = ref_top2.get((rid, i))
        assert v is not None, (tag, "parted at a prefill token", rid, i)
        gap = (v[0] - v[1]) / bf16_steps(v[0])
        worst = max(worst, gap)
        log(f"  {tag}: request {rid} first differs at token {i}: {x} vs "
            f"{y}; reference top-2 {v[0]:.4f}, {v[1]:.4f} ({gap:.2f} bf16 "
            f"steps apart)")
        assert gap <= 2.0, (tag, rid, i, v)
    return same, worst


def mesh_epilogue_bound(q, parts, k_pool, tails, owner, window=0):
    """Least time for the mesh's epilogue on these inputs: as
    ``epilogue_bound``, with the tail tokens of the owned rows only (a
    non-owner reads none), q in its type, ``o`` written in float32 and
    ``m``, ``l`` and the owner flags counted."""
    B, h_q, d = q.shape
    _, page, n_kv, _ = k_pool.shape
    tail_pages, tail_base, q_pos = tails
    hi = torch.clamp(q_pos - tail_base, max=page - 1)
    lo = (torch.clamp(q_pos - window + 1 - tail_base, min=0) if window > 0
          else torch.zeros_like(hi))
    tokens = int((torch.clamp(hi - lo + 1, min=0) * (owner != 0)).sum())
    nnz = parts.seg_rows.numel()
    nbytes = (nnz * h_q * (d + 2) * 4
              + 2 * tokens * n_kv * d * k_pool.element_size()
              + q.numel() * q.element_size() + B * h_q * (d + 2) * 4
              + (B + 1 + nnz) * 4 + 4 * B * 8)
    flops = 4.0 * tokens * h_q * d + 3.0 * nnz * h_q * d
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def merge_bound(o, scatter, out_dtype):
    """Least time for ``mesh_merge`` on these inputs: the D shards'
    partials (o, m, l) of the rows merged here, shard 0's ``o`` of every
    other row, the indices and ``contrib`` read once, the layer's output
    written once; D - 1 merges of ~(4 hd + 8) FLOPs a merged row and head
    over the f32 peak."""
    D, M, B, h, hd = o.shape
    n = int((scatter < B).sum())
    nbytes = (D * M * n * h * (hd + 2) * 4 + M * (B - n) * h * hd * 4
              + M * B * h * hd * torch.finfo(out_dtype).bits // 8
              + (2 * scatter.numel() + D) * 8)
    flops = (D - 1) * M * n * h * (4.0 * hd + 8)
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mesh_merge_kernel(tag, engine, timer, launches):
    """14c: ``codec_mesh_merge`` at the last step's shapes of a mesh run,
    timed with CUDA events beside its plain version and its bound: the
    step's merge indices and ``contrib``, the last layer's ``m`` and
    ``l`` as the epilogues left them in the slot's buffers, ``o`` from a
    seed (zero where a shard holds the identity).  Its rows must equal
    its plain version's within 1e-6 (``m`` bitwise) and shard 0's rows
    of the stacked butterfly on ``codec_por`` bitwise."""
    from repro_torch.kernels import por as por_mod
    cfg = engine.cfg
    slot = engine.fused_step._cur
    base = slot.base.arrays
    m, l = slot.stats_m.clone(), slot.stats_l.clone()
    D, M, B, h_loc = m.shape
    gen = torch.Generator(device="cuda").manual_seed(25)
    o = torch.randn((D, M, B, h_loc, cfg.head_dim), generator=gen,
                    device="cuda")
    o[l == 0] = 0.0
    args = (o, m, l, base.merge_gather, base.merge_scatter, base.contrib)
    out_dtype = torch.bfloat16
    got = por_mod.mesh_merge(*args, torch.float32, stats=True)
    want = por_mod.mesh_merge_torch(*args, torch.float32, stats=True)
    gi, si = base.merge_gather, base.merge_scatter
    Bm = gi.shape[0]
    n = int((si < B).sum())
    rows = si[:n]
    stacked = por_mod.por_subgroup_merge(o[:, :, gi], m[:, :, gi],
                                         l[:, :, gi], base.contrib)
    torch.cuda.synchronize()
    err = assert_close(f"{tag} mesh_merge", got, want, POR_TOL)
    assert torch.equal(got[1], want[1]), (tag, "m differs from plain")
    for g, st in zip(got, stacked):
        assert torch.equal(g[:, rows], st[0][:, :n]), \
            (tag, "mesh_merge differs from the butterfly on codec_por")
    cast = por_mod.mesh_merge(*args, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(cast, got[0].to(out_dtype)), (tag, "cast")
    ms = timer(lambda: por_mod.mesh_merge(*args, out_dtype))
    med = timer.median
    plain = timer(lambda: por_mod.mesh_merge_torch(*args, out_dtype))
    bound, by = merge_bound(o, si, out_dtype)
    log(f"  14c. codec_mesh_merge at {tag}'s last step ({D} x {M} shards, "
        f"{B} rows in the bucket, {n} merged (Bm {Bm}), {h_loc} heads x d "
        f"{cfg.head_dim}, bf16 out): {ms:.4f} ms/launch, mean of 20 "
        f"(median {med:.4f}; plain {plain:.4f}; bound {bound:.5f} by "
        f"{by}), max|err| {err:.3e}; bitwise equal to the stacked "
        f"butterfly on codec_por; {launches['mesh_merge']} launches in the "
        f"run")
    return {"name": f"mesh_merge ({tag})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mesh_merge.cu",
            "replaces": "src/repro/kernels/por.py:44 (in "
                        "por_subgroup_merge, src/repro/kernels/por.py:121)",
            "launches": launches["mesh_merge"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def mesh_kernels(engine, timer, launches):
    """14c: the epilogue's mesh mode and the butterfly's ``codec_por`` at
    the last 2x2 epoch's shapes, each against its plain version, timed
    with CUDA events.  Shard (0, 0) of layer 0: its plan, its slab of the
    pool, its query head block (bf16, from a seed), its tail pages and
    owner flags; the butterfly's partials (D, M, Bm rows, h/M heads) from
    a seed in the value ranges a merge sees."""
    from repro_torch.kernels import por as por_mod
    from repro_torch.kernels.ref import MASK_VALUE
    cfg = engine.cfg
    D, M = engine.mesh.shape["data"], engine.mesh.shape["model"]
    slot = engine.fused_step._cur
    base = slot.base.arrays
    B = base.tokens.shape[0]
    Bm = base.merge_gather.shape[0]
    h_loc = cfg.num_heads // M
    pa = slot.plans[0][0].arrays
    k_pool, v_pool = engine.pool.shard_pools(0, 0, 0)
    q_pos = base.q_pos0 + base.delta * base.row_valid
    tails = (base.tail_page[0], base.tail_base, q_pos)
    owner = base.tail_owner[0]
    gen = torch.Generator(device="cuda").manual_seed(14)
    q = torch.randn(B, h_loc, cfg.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    parts = engine._backend.parts_arrays(q, k_pool, v_pool, pa,
                                         num_queries=B)
    kw = dict(stats=True, owner=owner, o_f32=True)
    got = por_mod.por_epilogue(q, *parts, k_pool, v_pool, *tails, **kw)
    want = por_mod.por_epilogue_torch(q, *parts, k_pool, v_pool, *tails,
                                      owner=owner, o_f32=True)
    torch.cuda.synchronize()
    epi_err = assert_close("mesh epilogue", got, want, EPI_TOL)
    epi_ms = timer(lambda: por_mod.por_epilogue(q, *parts, k_pool, v_pool,
                                                *tails, **kw))
    epi_med = timer.median
    epi_plain = timer(lambda: por_mod.por_epilogue_torch(
        q, *parts, k_pool, v_pool, *tails, owner=owner, o_f32=True))
    epi_b, epi_by = mesh_epilogue_bound(q, parts, k_pool, tails, owner)
    rows = max(Bm, 1)
    shape = (D, M, rows, h_loc, cfg.head_dim)
    o = torch.randn(shape, generator=gen, device="cuda")
    m = 3 * torch.randn(shape[:-1], generator=gen, device="cuda")
    l = 0.5 + 3.5 * torch.rand(shape[:-1], generator=gen, device="cuda")
    o[1:, :, ::2], m[1:, :, ::2], l[1:, :, ::2] = 0.0, MASK_VALUE, 0.0
    half = [t.reshape(-1, *t.shape[3:]).contiguous() for t in (o, m, l)]
    other = [t.flip(0).reshape(-1, *t.shape[3:]).contiguous()
             for t in (o, m, l)]
    merged = por_mod.por(*half, *other)
    plain = por_mod.por_torch(*half, *other)
    torch.cuda.synchronize()
    por_err = assert_close("butterfly por", merged, plain, POR_TOL)
    por_ms = timer(lambda: por_mod.por(*half, *other))
    por_med = timer.median
    por_plain = timer(lambda: por_mod.por_torch(*half, *other))
    por_b, por_by = por_bound(half[0])
    log(f"  14c. the epilogue's mesh mode at shard (0, 0) of layer 0 "
        f"({B} rows in the bucket, {h_loc} query heads over "
        f"{cfg.num_kv_heads // M} KV heads, {int((owner != 0).sum())} rows "
        f"own their tail here, f32 o): {epi_ms:.4f} ms/launch, mean of 20 "
        f"(median {epi_med:.4f}; plain {epi_plain:.4f}; bound "
        f"{epi_b:.5f} by {epi_by}), max|err| {epi_err:.3e}")
    log(f"  14c. codec_por on the butterfly ({D} x {M} x {rows} rows x "
        f"{h_loc} heads x d {cfg.head_dim}, f32): {por_ms:.4f} ms/launch, "
        f"mean of 20 (median {por_med:.4f}; plain {por_plain:.4f}; bound "
        f"{por_b:.5f} by {por_by}), max|err| {por_err:.3e}")
    return [
        {"name": "por_epilogue (mesh: tail owner, f32 o)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/por.cu",
         "replaces": "src/repro/kernels/por.py:44, "
                     "src/repro/kernels/ops.py:80, "
                     "src/repro/kernels/ops.py:91",
         "launches": launches["por_epilogue"], "max_abs_err": epi_err,
         "ms": epi_ms, "plain_ms": epi_plain, "bound_ms": epi_b,
         "bound_by": epi_by, "library_ms": None},
        {"name": "por (mesh butterfly)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/por.cu",
         "replaces": "src/repro/kernels/por.py:44",
         "launches": launches["por"], "max_abs_err": por_err,
         "ms": por_ms, "plain_ms": por_plain, "bound_ms": por_b,
         "bound_by": por_by, "library_ms": None},
    ]


def phase_mesh(timer, fused7):
    """14a-c on qwen3-4b at full width and depth (phase 3's model, rebuilt
    from seed 0) and phase 3's traffic: a single-device fused reference
    that records its top-2 logits, then 1x1, 2x1 and 2x2 meshes (the
    document split across the data shards) and 2x1 with ``replicate``,
    each fused and traced; beside phase 7's fused numbers (``fused7``).
    Returns the ``kernels`` entries of 14c and, for 14e, the model, the
    prompts, the reference's streams and top-2 logits, and each mesh's
    TPOT and streams by tag."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine

    cfg = get_config(PAPER_ARCH)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    prompts = doc_prompts(8, P14_DOC, P14_Q, cfg.vocab_size, seed=0)
    n_attn = cfg.num_layers
    engine = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                          num_lanes=LANES, max_q=MAX_Q, fused=True,
                          device="cuda")
    store = []
    ref = serve(engine, prompts, max_new=32, on_step=top2_recorder(store))
    ref_top2 = {}
    for idx, vals in store:
        for key, v in zip(idx, vals.cpu().tolist()):
            ref_top2[key] = v
    del engine, store
    torch.cuda.empty_cache()
    r7 = fused7["codec-cuda"]
    p7 = r7["profile"]
    log(f"  single device, fused (phase 7): TPOT {r7['tpot_ms']:.3f} ms, "
        f"device busy {p7['device_busy_ms']:.3f} ms a traced step, "
        f"{p7['kernels_per_step']:.0f} kernels a step; reference run "
        f"(top-2 logits kept on the device): {ref['steps']} steps")
    kernels = []
    runs14 = {"cfg": cfg, "model": model, "prompts": prompts,
              "ref": ref["streams"], "ref_top2": ref_top2, "tpot": {},
              "streams": {}}
    runs = [(d, m, False) for d, m in P14_MESHES] + [(2, 1, True)]
    for d, m, replicate in runs:
        tag = f"{d}x{m}" + (" replicate" if replicate else "")
        engine = mesh_engine(cfg, model, d, m, replicate=replicate)
        reset_launches()
        r = serve(engine, prompts, max_new=32, profile_steps=PROFILE_STEPS)
        launches = read_launches()
        lens = sorted({len(t) for t in r["streams"].values()})
        assert lens == [32], (tag, lens)
        assert launches["pac"] > 0 and launches["por_epilogue"] > 0, \
            (tag, launches)
        assert launches["por"] == 0, (tag, launches)
        assert (launches["mesh_merge"] > 0) == (d > 1), (tag, launches)
        widths = check_mesh_graphs(tag, engine, r, d, m)
        prof = r["profile"]
        splits = max(sp.seq_splits for sp in engine._sharded_plans.values())
        nbytes = mesh_kv_bytes(engine)
        same, worst = check_near_ties(tag, ref["streams"], ref_top2,
                                      r["streams"])
        before = P14_TPOT_BEFORE.get(tag)
        runs14["tpot"][tag] = r["tpot_ms"]
        runs14["streams"][tag] = r["streams"]
        log(f"  {tag}: TPOT {r['tpot_ms']:.3f} ms "
            f"({r['tpot_ms'] / r7['tpot_ms']:.2f}x phase 7's"
            + (f"; {before} before the merge kernel" if before else "")
            + f"), device busy "
            f"{prof['device_busy_ms']:.3f} ms a traced step (idle share "
            f"{prof['idle_share']:.3f}), {prof['kernels_per_step']:.0f} "
            f"kernels a traced step; a graph holds PAC x {n_attn * d * m}, "
            f"epilogue x {n_attn * d * m}, codec_mesh_merge x "
            f"{n_attn if d > 1 else 0} (where Bm > 0), codec_por x 0; Bm by "
            f"signature {widths}; {splits} seq-split node(s); replica "
            f"promotions {engine.stats['replica_promotions']}; plan KV a "
            f"step by data shard (each of {m} model shard(s)) "
            f"{[round(b / 1e6, 2) for b in nbytes]} MB; {r['steps']} "
            f"replays, {engine.fused_step.graphs} graph(s) for "
            f"{len(engine.bucket_signatures)} signature(s), capture "
            f"{r['capture_s']:.3f} s; launches in the run: {launches}; "
            f"{same} of {len(r['streams'])} bf16 streams equal the "
            f"reference's (largest top-2 gap at a first difference "
            f"{worst:.2f} bf16 steps)")
        if d > 1 and not replicate:
            kernels.append(mesh_merge_kernel(tag, engine, timer, launches))
        if (d, m) == (2, 2):
            kernels += mesh_kernels(engine, timer, launches)
        engine.check()
        for rid in list(engine.requests):
            engine.release(rid)
        engine.pool.allocator.check()
        assert engine.pool.num_free == engine.pool.num_pages, (tag, "leak")
        del engine
        torch.cuda.empty_cache()
    return kernels, runs14


def phase_mesh_f32():
    """14b on phase 6's 4-layer f32 model: every mesh's streams, greedy
    and at temperature 0.7, equal the single-device eager engine's
    byte for byte; replication at 2x1 and 2x2 (under the TPU priors, so
    nodes are promoted: the document's leaves with phase 6's prompts,
    every node with a one-page document); the 2x2 mesh under pressure; no
    page leaked on any shard.  Returns the single-device references and
    the meshes' streams by ``(d, m, temperature)``, for 14e."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.core.cost_model import HardwareSpec
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine

    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    long_doc = doc_prompts(8, P14_DOC, P14_Q, cfg.vocab_size, seed=1)
    short_doc = doc_prompts(8, 16, 8, cfg.vocab_size, seed=2)
    refs = {}
    for name, prompts in (("long", long_doc), ("short", short_doc)):
        for t in (0.0, P14F_TEMPERATURE):
            eng = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                               num_lanes=LANES, max_q=MAX_Q,
                               temperature=t, device="cuda")
            refs[name, t] = serve(eng, prompts, max_new=32)["streams"]
            del eng
    streams = {}

    def check(tag, prompts_name, d, m, temperature=0.0, replicate=False,
              **kw):
        eng = mesh_engine(cfg, model, d, m, temperature=temperature,
                          replicate=replicate, **kw)
        if replicate:
            eng.cost_model.hw = HardwareSpec(**P14_REPLICATE_HW)
        prompts = long_doc if prompts_name == "long" else short_doc
        r = serve(eng, prompts, max_new=32)
        want = refs[prompts_name, temperature]
        diff = first_difference(want, r["streams"])
        assert diff is None, (tag, diff)
        if prompts_name == "long" and not replicate and not kw:
            streams[d, m, temperature] = r["streams"]
        check_mesh_graphs(tag, eng, r, d, m)
        st = dict(eng.stats)
        eng.check()
        for rid in list(eng.requests):
            eng.release(rid)
        eng.pool.allocator.check()
        assert all(s.num_free == s.num_pages
                   for s in eng.pool.allocator.shards), (tag, "leak")
        del eng
        return st

    for d, m in P14F_MESHES:
        for t in (0.0, P14F_TEMPERATURE):
            check(f"{d}x{m} t={t}", "long", d, m, t)
    promoted = {}
    for d, m in ((2, 1), (2, 2)):
        for name in ("long", "short"):
            st = check(f"{d}x{m} replicate {name}", name, d, m,
                       replicate=True)
            assert st["replica_promotions"] >= 1, (d, m, name, st)
            promoted[d, m, name] = st["replica_promotions"]
    st = check("2x2 pressured", "long", 2, 2, num_pages=P14_PAGES,
               prefill_chunk=P14_CHUNK)
    assert st["preempted"] >= 1, st
    log(f"  14b. {cfg.num_layers} layers f32: meshes "
        f"{['%dx%d' % x for x in P14F_MESHES]}, greedy and at temperature "
        f"{P14F_TEMPERATURE}, give the single-device eager streams byte "
        f"for byte ({len(long_doc)} requests x 32 tokens over a "
        f"{P14_DOC}-token document); replication (TPU priors) promoted "
        f"{promoted} nodes with equal streams; 2x2 on {P14_PAGES} pages "
        f"with {P14_CHUNK}-token chunks: {st['preempted']} preemption(s), "
        f"equal streams; no page leaked on any shard")
    del model
    torch.cuda.empty_cache()
    return {"refs": refs, "streams": streams}


def phase_calibrate():
    """14d: a calibrating 2x2 mesh on phase 6's 4-layer f32 model (every
    step waits for the card and is timed; the requests stop at 8..29
    tokens, so the batch and the merged rows shrink and the features
    vary); prints what ``recalibrate`` fitted."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    prompts = doc_prompts(8, P14_DOC, P14_Q, cfg.vocab_size, seed=1)
    eng = mesh_engine(cfg, model, 2, 2, calibrate=True)
    prior = dataclasses.asdict(eng.cost_model.hw)
    for p, n in zip(prompts, P14D_NEW):
        eng.add_request(p, max_new=n)
    eng.run(64)
    fitted = eng.recalibrate()
    hw = eng.cost_model.hw
    rows = [s for s in eng.step_stats if s.get("hbm_bytes")]
    log(f"  14d. calibrate=True at 2x2 ({len(rows)} timed mesh steps, "
        f"{eng.stats['calibrations']} fits installed): fitted {fitted}; "
        f"hbm {hw.hbm_bw / 1e9:.6g} GB/s (prior "
        f"{prior['hbm_bw'] / 1e9:.6g}), ici {hw.ici_bw / 1e9:.6g} GB/s "
        f"(prior {prior['ici_bw'] / 1e9:.6g}), page step "
        f"{hw.grid_step_overhead * 1e6:.6g} us, merge round "
        f"{hw.launch_overhead * 1e6:.6g} us.  Fitted to a mesh whose "
        f"shards run one after another on one card while the features "
        f"charge the heaviest shard: not the H100's coefficients")
    eng.pool.allocator.check()
    del eng, model
    torch.cuda.empty_cache()


# 14e: the mesh over processes.  (ii) runs phase 6's 4-layer f32 model on
# gloo ranks that share the one card, each mesh spawned once with both
# temperatures; (iii) phase 3's model at 2x2
P14E_MESHES = ((2, 1), (1, 2), (2, 2))
P14E_TIMEOUT = 300


def p14e_rank(mesh, full: bool, temperatures):
    """One gloo rank of 14e (ii)/(iii) on ``cuda:0``: phase 14b's model
    and long document (``full``: phase 3's model and traffic), fused
    through the rank step; per temperature its streams, the launches it
    made, its pool bytes and whether a step was captured."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.distributed import mesh as mesh_mod
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = get_config(PAPER_ARCH)
    if not full:
        cfg = dataclasses.replace(cfg, num_layers=4)
    model = build_model(cfg, seed=0, device=mesh.device,
                        dtype=torch.bfloat16 if full else torch.float32)
    prompts = doc_prompts(8, P14_DOC, P14_Q, cfg.vocab_size,
                          seed=0 if full else 1)
    out = {}
    for t in temperatures:
        eng = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                           num_lanes=LANES, max_q=MAX_Q, fused=True,
                           mesh=mesh, seq_split_pages=P14_SPLIT,
                           temperature=t, device=mesh.device)
        reset_launches()
        c0 = mesh_mod.collectives
        r = serve(eng, prompts, max_new=32)
        torch.cuda.synchronize()
        bms = sorted({sig[-1][1] for sig in eng.bucket_signatures})
        eng.check()
        for rid in list(eng.requests):
            eng.release(rid)
        eng.pool.allocator.check()
        out[t] = {"streams": r["streams"], "launches": read_launches(),
                  "collectives": mesh_mod.collectives - c0,
                  "pool_bytes": eng.pool.bytes_used(), "bm": bms,
                  "captured": eng.fused_step.graphs,
                  "leak": eng.pool.num_free != eng.pool.num_pages}
        del eng
    return out


def check_rank_runs(tag, ranks, wants, d):
    """Every rank's streams equal each of ``wants`` (streams by
    temperature); PAC, the epilogue and (where a signature merged rows)
    ``codec_mesh_merge`` launched in every rank; nothing captured under
    gloo, no page leaked."""
    for rank, runs in enumerate(ranks):
        for t, r in runs.items():
            for want in wants:
                diff = first_difference(want[t], r["streams"])
                assert diff is None, (tag, rank, t, diff)
            la = r["launches"]
            assert la["pac"] > 0 and la["por_epilogue"] > 0, (tag, rank, la)
            merged = d > 1 and max(r["bm"]) > 0
            assert (la["mesh_merge"] > 0) == merged, (tag, rank, la, r["bm"])
            assert la["por"] == 0 and r["collectives"] > 0, (tag, rank, la)
            assert r["captured"] == 0 and not r["leak"], (tag, rank, r)


def phase_process_mesh(runs14, f32_14):
    """14e: the mesh over processes, one rank a shard.  (i) phase 3's
    model and traffic as a 1x1 process mesh under NCCL in this process,
    collectives captured in the graphs, beside 14a's 1x1 TPOT; (ii) phase
    14b's f32 model at 2x1, 1x2 and 2x2 on gloo ranks sharing the card,
    greedy and at 0.7: streams equal to the single-controller mesh's and
    the single-device eager engine's; (iii) phase 3's model at 2x2 on
    gloo ranks: streams equal to 14a's 2x2 run or parting at near-ties by
    14a's rule.  No time of (ii) or (iii) is a mesh's TPOT: their ranks
    share one card and gloo goes through the host."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from repro_torch.distributed import mesh as mesh_mod
    from repro_torch.distributed.launch import spawn_ranks
    from repro_torch.launch.serve import serve

    cfg, model, prompts = runs14["cfg"], runs14["model"], runs14["prompts"]
    n_attn = cfg.num_layers
    store = tempfile.mkdtemp(prefix="p14e-")
    # (i) NCCL, one rank, in this process
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "nccl"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_mod.process_mesh(1, 1)
        engine = mesh_engine(cfg, model, 1, 1, mesh=mesh)
        reset_launches()
        r = serve(engine, prompts, max_new=32, profile_steps=PROFILE_STEPS)
        launches = read_launches()
        step = engine.fused_step
        assert step.captures and step.graphs == len(
            engine.bucket_signatures), (step.graphs,)
        for sig, slot in step.slots.items():
            assert slot.launches == (n_attn, n_attn), (sig, slot.launches)
            assert slot.collectives == n_attn, (sig, slot.collectives)
            assert slot.merge_launches == 0 and slot.por_launches == 0
        same, worst = check_near_ties("14e 1x1 nccl", runs14["ref"],
                                      runs14["ref_top2"], r["streams"])
        eq_1x1 = sum(r["streams"][k] == v
                     for k, v in runs14["streams"]["1x1"].items())
        prof = r["profile"]
        log(f"  14e (i) 1x1 process mesh, NCCL, qwen3-4b x{n_attn} bf16: "
            f"TPOT {r['tpot_ms']:.3f} ms beside 14a's single-controller "
            f"1x1 {runs14['tpot']['1x1']:.3f} ms (same process); device "
            f"busy {prof['device_busy_ms']:.3f} ms a traced step (idle "
            f"share {prof['idle_share']:.3f}), "
            f"{prof['kernels_per_step']:.0f} kernels a step; "
            f"{step.graphs} graph(s), each PAC x {n_attn}, epilogue x "
            f"{n_attn}, NCCL all-reduce (the model sum's slot gather) x "
            f"{n_attn} captured; {r['steps']} replays; launches "
            f"{launches}; {eq_1x1} of {len(r['streams'])} streams equal "
            f"14a's 1x1, {same} the reference's (largest top-2 gap at a "
            f"first difference {worst:.2f} bf16 steps)")
        engine.check()
        for rid in list(engine.requests):
            engine.release(rid)
        engine.pool.allocator.check()
        del engine, mesh
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) gloo ranks on the one card, the three meshes side by side
    temps = (0.0, P14F_TEMPERATURE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(P14E_MESHES)) as ex:
        futs = {(d, m): ex.submit(
            spawn_ranks, p14e_rank, d, m, "gloo",
            os.path.join(store, f"gloo{d}x{m}"), "cuda:0",
            (False, temps), P14E_TIMEOUT) for d, m in P14E_MESHES}
        ranks = {k: f.result() for k, f in futs.items()}
    t_ii = time.perf_counter() - t0
    refs, single = f32_14["refs"], f32_14["streams"]
    for (d, m), rr in ranks.items():
        tag = f"14e (ii) {d}x{m} gloo"
        check_rank_runs(tag, rr, [{t: single[d, m, t] for t in temps},
                                  {t: refs["long", t] for t in temps}], d)
        pool = [r[0.0]["pool_bytes"] for r in rr]
        log(f"  {tag}: {d * m} ranks on cuda:0, greedy and t="
            f"{P14F_TEMPERATURE}: every rank's streams equal the "
            f"single-controller mesh's and the single-device eager "
            f"engine's byte for byte; launches by rank "
            f"{[r[0.0]['launches'] for r in rr]} (greedy run), slot "
            f"gathers by rank {[r[0.0]['collectives'] for r in rr]}, Bm "
            f"{rr[0][0.0]['bm']}; pool bytes by rank "
            f"{[round(b / 2**20, 1) for b in pool]} MiB "
            f"(1/{d * m} of the mesh's); uncaptured")
    log(f"  14e (ii) wall {t_ii:.1f} s for the three meshes together (not "
        f"a mesh time: the ranks share one card, gloo goes through the "
        f"host)")

    # (iii) phase 3's model at 2x2 over gloo
    del model, runs14["model"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rr = spawn_ranks(p14e_rank, 2, 2, "gloo", os.path.join(store, "full"),
                     "cuda:0", (True, (0.0,)), P14E_TIMEOUT)
    check_rank_runs("14e (iii) 2x2 gloo", rr, [], 2)
    got = rr[0][0.0]["streams"]
    for rank, r in enumerate(rr):
        assert r[0.0]["streams"] == got, ("14e (iii) ranks differ", rank)
    parted = [k for k, v in runs14["streams"]["2x2"].items() if got[k] != v]
    # a stream that parts from 14a's 2x2 may do so only at a near-tie of
    # the reference (14a's rule)
    same, worst = check_near_ties(
        "14e (iii) 2x2 gloo", {k: runs14["ref"][k] for k in parted},
        runs14["ref_top2"], got)
    eq_2x2 = len(got) - len(parted)
    log(f"  14e (iii) 2x2 gloo, qwen3-4b x{n_attn} bf16, 4 ranks on "
        f"cuda:0: every rank's streams alike; {eq_2x2} of {len(got)} equal "
        f"14a's 2x2 run; of the others, {same} equal the reference's "
        f"(largest top-2 gap at a first difference {worst:.2f} bf16 "
        f"steps); launches by rank "
        f"{[r[0.0]['launches'] for r in rr]}; pool bytes by rank "
        f"{[round(r[0.0]['pool_bytes'] / 2**20, 1) for r in rr]} MiB; "
        f"wall {time.perf_counter() - t0:.1f} s (not a mesh time)")
    shutil.rmtree(store, ignore_errors=True)


# 14e (iv): deadlines, a queue timeout and phase 9's fault plan on the
# process mesh (ROADMAP C5).  Seven running slots: the eighth request
# waits and times out in the queue, request P9F_DEADLINE ends on its
# deadline mid-decode
P14E4_RUNNING, P14E4_QUEUE = 7, 7
P14E4_QUEUE_S = 1.5


class RankClock(StepClock):
    """Phase 9's step clock at a rank's own rate and origin: ranks that
    acted on their own readings would time out apart."""

    def __init__(self, rank: int = 0):
        super().__init__()
        self.rate, self.origin = 1.0 + 0.37 * rank, 5.0 * rank

    def __call__(self):
        return self.origin + self.rate * self.t


def p14e_c5_run(cfg, model, mesh, rank: int = 0):
    """The deadline, queue-timeout and fault workload on ``mesh`` (a
    process mesh, or a ``decode_mesh`` fed rank 0's clock): streams,
    terminal states, counters, the launches, and whether a page leaked."""
    from repro_torch.launch.serve import doc_prompts
    from repro_torch.serving.engine import DecodeEngine
    _, plan = fault_plan()
    clock = RankClock(rank)
    eng = DecodeEngine(cfg, model, page_size=PAGE, num_pages=1024,
                       num_lanes=LANES, max_q=MAX_Q, fused=True, mesh=mesh,
                       seq_split_pages=P14_SPLIT, faults=plan, clock=clock,
                       max_running=P14E4_RUNNING, device=mesh.device)
    reset_launches()
    for i, q in enumerate(doc_prompts(8, P9F_DOC, P9_Q, cfg.vocab_size,
                                      seed=3)):
        eng.add_request(q, max_new=P9F_NEW, deadline_s=(
            P9F_DEADLINE_S if i == P9F_DEADLINE else None),
            max_queue_s=P14E4_QUEUE_S if i == P14E4_QUEUE else None)
    for _ in range(200):
        if not eng.has_work():
            break
        eng.step()
        clock.t += 1.0
    eng.run(0)
    out = {"streams": {r: list(q.generated) for r, q in eng.requests.items()},
           "states": {r: (q.state, q.finish_reason)
                      for r, q in eng.requests.items()},
           "stats": {k: eng.stats[k] for k in (
               "timed_out", "faults_injected", "dispatch_failures",
               "dispatch_recoveries", "nan_rows", "nonfinite_rows",
               "preempted")},
           "fired": dict(eng.injector.fired), "launches": read_launches()}
    eng.check()
    for rid in list(eng.requests):
        eng.release(rid)
    out["leak"] = not all(s.num_free == s.num_pages
                          for s in eng.pool.allocator.shards)
    del eng
    return out


def p14e_c5_rank(mesh):
    """One gloo rank of 14e (iv) on ``cuda:0``: phase 14b's model."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device=mesh.device, dtype=torch.float32)
    return p14e_c5_run(cfg, model, mesh, mesh.rank)


def phase_process_mesh_c5():
    """14e (iv), C5 repaired: phase 9's seeded fault plan with a deadline
    and a queue timeout, on phase 14b's 4-layer f32 model, as a 1x1 NCCL
    process mesh in this process and as 2x1 gloo ranks sharing the card,
    each rank's clock at its own rate (rank 0's reading decides): the
    streams, terminal states and fault counters equal the single
    controller's ``decode_mesh`` fed rank 0's clock."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.distributed import decode_mesh
    from repro_torch.distributed import mesh as mesh_mod
    from repro_torch.distributed.launch import spawn_ranks
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    want = {(d, 1): p14e_c5_run(cfg, model, decode_mesh(d, 1, "cuda"))
            for d in (1, 2)}
    for w in want.values():
        reasons = {why for _, why in w["states"].values()}
        assert {"deadline", "queue_timeout", "done"} <= reasons, w["states"]
        assert w["fired"]["nan_logits"] == 1 and w["fired"]["alloc"] >= 1 \
            and w["fired"]["dispatch"] >= 1 and not w["leak"], w
    store = tempfile.mkdtemp(prefix="p14e4-")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "nccl"), 1), rank=0, world_size=1)
    try:
        got = {(1, 1): [p14e_c5_run(cfg, model,
                                    mesh_mod.process_mesh(1, 1))]}
    finally:
        dist.destroy_process_group()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    got[2, 1] = spawn_ranks(p14e_c5_rank, 2, 1, "gloo",
                            os.path.join(store, "gloo"), "cuda:0", (),
                            P14E_TIMEOUT)
    for mesh, ranks in got.items():
        w = want[mesh]
        for rank, r in enumerate(ranks):
            for k in ("streams", "states", "stats", "fired"):
                assert r[k] == w[k], ("14e (iv)", mesh, rank, k, r[k], w[k])
            la = r["launches"]
            assert la["pac"] > 0 and la["por_epilogue"] > 0 and \
                not r["leak"], (mesh, rank, la)
        log(f"  14e (iv) {mesh[0]}x{mesh[1]} "
            f"{'NCCL' if mesh == (1, 1) else 'gloo'} process mesh, "
            f"{cfg.num_layers} layers f32, each rank's clock at its own "
            f"rate: phase 9's fault plan (fired {w['fired']}), a deadline "
            f"and a queue timeout give the single controller's streams, "
            f"terminal states {sorted(set(w['states'].values()))} and "
            f"counters {w['stats']} on every rank; launches by rank "
            f"{[r['launches'] for r in ranks]}")
    shutil.rmtree(store, ignore_errors=True)


# --------------------------------------------------------------------- #
# phase 15: training on the card
# --------------------------------------------------------------------- #
P15_BATCH, P15_SEQ, P15_STEPS, P15_LR, P15_WARMUP = 4, 512, 8, 1e-3, 5
P15B_LAYERS, P15B_BATCH, P15B_SEQ = 2, 2, 64
P15C_STEPS = 8
# device kernels of a training step by kind, by name
P15_KINDS = (
    ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_",
              "ampere_")),
    ("softmax (mha's materialised scores, the CE)", ("softmax",)),
    ("embedding scatter / gather backward", ("embedding", "index_put",
                                             "indexing_backward",
                                             "scatter", "gather")),
    ("reductions", ("reduce", "norm", "sum_", "logsumexp")),
    ("elementwise (norms, RoPE, SwiGLU, optimizer, casts)",
     ("elementwise", "vectorized", "unrolled", "fill", "copy", "cat")),
)


def kernel_kinds(top):
    """Device ms a step by kind, from ``profile_summary``'s full list."""
    out = {name: [0.0, 0.0] for name, _ in P15_KINDS}
    out["other"] = [0.0, 0.0]
    for key, ms, count in top:
        low = key.lower()
        kind = next((name for name, pats in P15_KINDS
                     if any(p in low for p in pats)), "other")
        out[kind][0] += ms
        out[kind][1] += count
    return out


def train_state_on(cfg, params, opt, device):
    """A training state on ``device`` from a copy of CPU ``params``."""
    from repro_torch.training import trainer
    moved = {k: v.to(device, copy=True) for k, v in params.items()}
    return trainer.make_state(cfg, moved, opt.init(moved))


def loss_and_grads(state, loss_fn, batch):
    names = list(state.params)
    loss, _ = loss_fn(state.model, *batch)
    grads = torch.autograd.grad(loss, [state.params[k] for k in names])
    return float(loss.detach()), dict(zip(names, grads))


def assert_grads_close(tag, got, want, tol=1e-5):
    """``|got - want| <= tol * max|want| + 1e-7``, max over the whole
    gradient; returns the largest error over max|want|."""
    gmax = max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for k, g in want.items():
        err = float((got[k].float().cpu() - g.float().cpu()).abs().max())
        assert err <= tol * gmax + 1e-7, (tag, k, err, gmax)
        worst = max(worst, err / gmax)
    return worst


def phase_train_full():
    """15a: qwen3-4b at full width and depth, bf16 weights from seed 0,
    AdamW with float32 moments, remat, 4 x 512 tokens a step: the memory
    reckoning from ``abstract_state``, eight steps over two cycled
    batches (finite loss that falls), step time, tokens/s, peak memory,
    MFU, a traced step's device busy and idle share by kernel kind, and a
    step timed by phase with CUDA events."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.launch.serve import profile_summary
    from repro_torch.models.transformer import param_shapes
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer
    from repro_torch.training.data import DataConfig, SyntheticLM

    cfg = get_config(PAPER_ARCH)
    opt = O.adamw(O.cosine_schedule(P15_LR, P15_WARMUP,
                                    max(P15_STEPS, 10)))
    nb = trainer.state_bytes(trainer.abstract_state(cfg, opt))
    tokens = P15_BATCH * P15_SEQ
    n = nb["n_params"]
    carries = cfg.num_layers * tokens * cfg.d_model * 2
    logits = tokens * cfg.vocab_size * 4
    biggest = max(int(np.prod(shape)) for shape, _ in
                  param_shapes(cfg).values())
    resident = nb["params"] * 2 + nb["opt_state"]
    log(f"  15a. {cfg.name} x{cfg.num_layers} bf16, AdamW f32 moments, "
        f"remat, {P15_BATCH} x {P15_SEQ} tokens a step; reckoning "
        f"(abstract_state, meta device): {n / 1e9:.3f} B params, weights "
        f"{nb['params'] / 1e9:.2f} GB, bf16 gradients "
        f"{nb['params'] / 1e9:.2f} GB, Adam moments "
        f"{nb['opt_state'] / 1e9:.2f} GB: {resident / 1e9:.2f} GB "
        f"resident; + remat carries {carries / 1e9:.3f} GB, f32 logits "
        f"{logits / 1e9:.2f} GB (x2-3 with their gradient and the CE), "
        f"the clipped gradient and the updates {nb['params'] / 1e9:.2f} "
        f"GB each, the optimizer's f32 temporaries {biggest * 4 / 1e9:.2f}"
        f" GB each on the largest leaf; memory in use before: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = trainer.init_state(cfg, opt, gen, device="cuda")
    step = trainer.make_train_step(cfg, opt, remat=True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, P15_SEQ, P15_BATCH))
    batches = [tuple(torch.from_numpy(a).cuda() for a in data.batch(i))
               for i in range(2)]
    losses, gnorms, times = [], [], []
    for i in range(P15_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batches[i % 2])
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-2:]) < losses[0], losses
    step_s = statistics.median(times[1:])
    mfu = 6 * n * tokens / (step_s * PEAK_FLOPS[torch.bfloat16])
    log(f"  losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(t, 4) for t in times]}: first {times[0]:.3f} s, median "
        f"of steps 2-{P15_STEPS} {1e3 * step_s:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (6 N tokens / "
        f"(step s x 989e12), N = {n / 1e9:.3f} B); peak memory "
        f"(max_memory_allocated) {peak / 1e9:.2f} GB")
    # one traced step: device busy, idle share, kernels by kind
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, met = step(state, batches[0])
        float(met["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    p = profile_summary(prof, wall, 1, top=0)
    busy = p["device_busy_ms"]
    log(f"  traced step: wall {p['wall_ms']:.1f} ms (profiler on), device "
        f"busy {busy:.1f} ms, {p['kernels_per_step']:.0f} kernels; idle "
        f"share against the untraced median step "
        f"{1 - busy / (1e3 * step_s):.3f} (against the traced wall "
        f"{p['idle_share']:.3f})")
    kinds = kernel_kinds(p["top"])
    for kind, (ms, count) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"    {kind}: {ms:.1f} ms in {count:.0f} kernels")
    for key, ms, count in p["top"][:16]:
        log(f"    {ms:8.2f} ms {count:5.0f}x  {key}")
    others = [t for t in p["top"] if not any(
        pat in t[0].lower() for _, pats in P15_KINDS for pat in pats)]
    for key, ms, count in others[:6]:
        log(f"    other: {ms:8.2f} ms {count:5.0f}x  {key}")
    # one step by phase (the train step's own pieces, CUDA events)
    loss_fn = trainer.make_loss_fn(cfg, remat=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    loss, _ = loss_fn(state.model, *batches[1])
    ev[1].record()
    grads = dict(zip(state.params, torch.autograd.grad(
        loss, list(state.params.values()))))
    ev[2].record()
    grads, _ = O.clip_by_global_norm(grads, 1.0)
    ev[3].record()
    updates, state.opt_state = opt.update(grads, state.opt_state,
                                          state.params)
    del grads
    with torch.no_grad():
        for k, w in state.params.items():
            w.add_(updates.pop(k))
    ev[4].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    log(f"  a step by phase (CUDA events): forward {ms[0]:.1f} ms, "
        f"backward (with the remat recompute) {ms[1]:.1f} ms, clip "
        f"{ms[2]:.1f} ms, optimizer + apply {ms[3]:.1f} ms")
    del state, step, updates, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": 1e3 * step_s, "mfu": mfu, "peak_gb": peak / 1e9,
            "busy_ms": busy, "phases_ms": ms, "losses": losses,
            "gnorms": gnorms}


def phase_train_parity():
    """15b: qwen3-4b at full width, 2 layers, f32, 2 x 64 tokens: a step
    on the card equals the same port code on the CPU from the same
    weights (loss, grad norm, every gradient, the weights after it);
    remat equals no remat and 2 microbatches equal 1 in loss, on the
    card.  Returns the card's trained state (its weights require
    gradients) for 15d."""
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer
    from repro_torch.training.data import DataConfig, SyntheticLM

    cfg = dataclasses.replace(get_config(PAPER_ARCH),
                              num_layers=P15B_LAYERS, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    sched = O.cosine_schedule(P15_LR, P15_WARMUP, 10)
    data = SyntheticLM(DataConfig(cfg.vocab_size, P15B_SEQ, P15B_BATCH))
    batch = [torch.from_numpy(a) for a in data.batch(0)]
    t0 = time.perf_counter()
    out = {}
    for dev in ("cpu", "cuda"):
        opt = O.adamw(sched)
        st = train_state_on(cfg, params, opt, dev)
        b = tuple(x.to(dev) for x in batch)
        loss, grads = loss_and_grads(
            st, trainer.make_loss_fn(cfg, remat=False), b)
        st, met = trainer.make_train_step(cfg, opt, remat=False)(st, b)
        out[dev] = (loss, grads, st, met)
    cpu_s = time.perf_counter() - t0
    (l_c, g_c, s_c, m_c), (l_g, g_g, s_g, m_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c), (l_g, l_c)
    for k in ("loss", "grad_norm"):
        a, b = float(m_g[k]), float(m_c[k])
        assert abs(a - b) <= 1e-5 * abs(b), (k, a, b)
    worst = assert_grads_close("card vs cpu", g_g, g_c)
    # weights after Adam's first step: each moves by ~lr sign(g); where a
    # gradient is within its tolerance of zero the sign is noise (2 lr)
    lr1 = float(sched(1))
    off = n_el = 0
    for k, w in s_c.params.items():
        d = (s_g.params[k].detach().cpu() - w.detach()).abs()
        assert float(d.max()) <= 2 * lr1 * (1 + 1e-5), (k, float(d.max()))
        off += int((d > 1e-5 * w.detach().abs() + 1e-6 * lr1).sum())
        n_el += d.numel()
    assert off <= 1e-3 * n_el, (off, n_el)
    # on the card: remat == no remat, microbatches 2 == 1 in loss
    opt = O.adamw(sched)
    st = train_state_on(cfg, params, opt, "cuda")
    b = tuple(x.cuda() for x in batch)
    l_r, g_r = loss_and_grads(st, trainer.make_loss_fn(cfg, remat=True), b)
    assert abs(l_r - l_g) <= 1e-6 * abs(l_g), (l_r, l_g)
    worst_r = assert_grads_close("remat", g_r, g_g, tol=1e-6)
    del g_r
    _, m2 = trainer.make_train_step(cfg, opt, microbatches=2,
                                    remat=False)(st, b)
    assert abs(float(m2["loss"]) - l_g) <= 1e-5 * abs(l_g)
    log(f"  15b. {cfg.name} x{cfg.num_layers} f32 at full width "
        f"({sum(v.numel() for v in params.values()) / 1e9:.3f} B params), "
        f"{P15B_BATCH} x {P15B_SEQ} tokens: card == CPU: loss {l_g:.7f} / "
        f"{l_c:.7f}, grad norm {float(m_g['grad_norm']):.6f} / "
        f"{float(m_c['grad_norm']):.6f}, gradients within "
        f"{worst:.2e} of max|g| (tol 1e-5), weights after the step: "
        f"{off} of {n_el} elements beyond f32 rounding (all within 2 lr); "
        f"remat == no remat ({worst_r:.1e} of max|g|), 2 microbatches "
        f"loss {float(m2['loss']):.7f}; both sides {cpu_s:.1f} s")
    del out, g_c, g_g, s_c, st, params
    torch.cuda.empty_cache()
    return cfg, s_g


def phase_train_cli():
    """15c: ``launch.train.main`` in-process on the card (``--smoke``): a
    straight run; a run stopped at half way and resumed from its
    checkpoint, whose loss trace equals the straight run's; and a data
    axis of 2 that loses half of itself at step 3 and completes."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import train as train_cli

    def run(argv):
        hist, buf = [], io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv + ["--smoke", "--device", "cuda",
                                        "--global-batch", "8",
                                        "--seq-len", "64"], history=hist)
        assert rc == 0, buf.getvalue()
        return hist, buf.getvalue()

    with tempfile.TemporaryDirectory() as d:
        straight, out = run(["--steps", str(P15C_STEPS), "--ckpt-dir",
                             f"{d}/a", "--ckpt-every", "4"])
        assert "done: 8 steps" in out, out
        first, _ = run(["--steps", "4", "--ckpt-dir", f"{d}/b"])
        resumed, out_r = run(["--steps", str(P15C_STEPS), "--ckpt-dir",
                              f"{d}/b"])
        assert "[resume] step 4" in out_r, out_r
        trace = first + resumed
        assert [s for s, _, _ in trace] == [s for s, _, _ in straight]
        for (s, a, _), (_, b, _) in zip(trace, straight):
            assert abs(a - b) <= 1e-5 * abs(b), (s, a, b)
        elastic, out_e = run(["--steps", "6", "--ckpt-dir", f"{d}/c",
                              "--data", "2", "--fail-at-step", "3"])
        assert "[elastic] step 3" in out_e and "done: 6 steps" in out_e, \
            out_e
        assert all(np.isfinite(x) for _, x, _ in elastic)
    log(f"  15c. launch.train on the card (--smoke): straight losses "
        f"{[round(x, 5) for _, x, _ in straight]}; stopped at 4 and "
        f"resumed: max rel diff "
        f"{max(abs(a - b) / abs(b) for (_, a, _), (_, b, _) in zip(trace, straight)):.1e}"
        f"; --data 2 --fail-at-step 3: [elastic] then done, losses "
        f"{[round(x, 5) for _, x, _ in elastic]}")
    for line in out_e.splitlines():
        if line.startswith(("[elastic]", "[ckpt]", "done")):
            log(f"    {line}")


def phase_train_serve(cfg, state):
    """15d: 15b's trained weights (still requiring gradients) served
    through ``codec-cuda``, eager and fused: greedy streams equal the
    dense ``prefill`` + ``decode_step`` decode of the same weights, PAC
    and the epilogue launch, and no engine path records an autograd
    graph (no tensor saved for a backward, no pool requiring grad)."""
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serving.engine import DecodeEngine
    model = state.model
    assert all(p.requires_grad for p in model.parameters())
    rng = np.random.default_rng(15)
    doc = rng.integers(1, cfg.vocab_size, 512).tolist()
    prompts = [doc + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (8, 40, 72)]
    new = 16
    dense = {}
    for i, p in enumerate(prompts):
        logits, cache, clen = prefill(model, torch.tensor([p],
                                                          device="cuda"),
                                      len(p) + new)
        out = []
        for _ in range(new):
            nxt = int(torch.argmax(logits[0]))
            out.append(nxt)
            logits, cache = decode_step(
                model, torch.tensor([[nxt]], device="cuda"), cache, clen)
            clen = clen + 1
        assert logits.grad_fn is None
        dense[i] = out
        del cache
    for fused in (False, True):
        saved = []
        eng = DecodeEngine(cfg, model, page_size=PAGE, num_pages=512,
                           num_lanes=LANES, max_q=MAX_Q, fused=fused,
                           device="cuda")
        reset_launches()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            for p in prompts:
                eng.add_request(p, max_new=new)
            got = eng.run(new + 4)
        launches = read_launches()
        assert not saved, saved[:4]
        assert launches["pac"] > 0 and launches["por_epilogue"] > 0, \
            launches
        pools = [t for t in vars(eng.pool).values() if torch.is_tensor(t)]
        assert pools and not any(t.requires_grad for t in pools)
        diff = first_difference(dense, {i: got[i] for i in dense})
        assert diff is None, ("15d", fused, diff)
        release_all(f"15d fused={fused}", eng)
        log(f"  15d. trained weights served {'fused' if fused else 'eager'}"
            f" through codec-cuda: streams equal the dense decode "
            f"({len(prompts)} requests x {new} tokens), launches "
            f"{launches}, no tensor saved for a backward, pools without "
            f"grad")
        del eng
    torch.cuda.empty_cache()


# 15e: training over processes.  (ii) runs 15b's model on gloo ranks that
# share the card, one row a rank; (iii) the launcher under torchrun
P15E_MESHES = ((2, 1), (2, 2))
P15E_STEPS = 2
P15E_TIMEOUT = 300
P15E_CLI = ["--smoke", "--global-batch", "8", "--seq-len", "64"]
# 15e (i): steps of 15a's and of the rank's, taken in turn
P15E_AB = 3


def state_digest(state) -> int:
    """A 64-bit digest of a training state's weights, bit for bit."""
    from repro_torch.distributed.mesh import digest
    return digest(*(p.detach().contiguous().view(torch.uint8).cpu()
                    .numpy().tobytes() for p in state.params.values()))


def p15e_cfg(layers: int):
    from repro_torch.configs import PAPER_ARCH, get_config
    return dataclasses.replace(get_config(PAPER_ARCH), num_layers=layers,
                               dtype="float32")


def p15e_steps(step, state, data, device):
    """``P15E_STEPS`` steps: (loss, grad norm) each, and the weights'
    digest after them."""
    hist = []
    for i in range(P15E_STEPS):
        b = tuple(torch.from_numpy(a).to(device) for a in data.batch(i))
        state, met = step(state, b)
        hist.append((float(met["loss"]), float(met["grad_norm"])))
    return hist, state_digest(state)


def p15e_fresh(cfg, device):
    """15b's weights and a fresh AdamW state on ``device`` (the card's
    own generator, so every process draws the same weights)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer
    opt = O.adamw(O.cosine_schedule(P15_LR, P15_WARMUP, 10))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    return opt, trainer.make_state(cfg, params, opt.init(params))


def p15e_rank(mesh, layers: int):
    """One gloo rank of 15e (ii) on ``cuda:0``: its data shard's row of
    each global batch through the rank step."""
    from repro_torch.distributed.train_step import make_rank_train_step
    from repro_torch.training.data import DataConfig, SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = p15e_cfg(layers)
    opt, state = p15e_fresh(cfg, mesh.device)
    step = make_rank_train_step(cfg, opt, mesh, remat=False)
    data = SyntheticLM(DataConfig(cfg.vocab_size, P15B_SEQ, mesh.data),
                       dp_rank=mesh.coords[0], dp_world=mesh.data)
    return p15e_steps(step, state, data, mesh.device)


def p15e_cli_rank(mesh, argv):
    """One gloo rank of 15e (ii)'s elastic restart: the launcher."""
    import contextlib
    import io
    from repro_torch.launch import train as train_cli
    hist, buf = [], io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv, history=hist, mesh=mesh)
    return rc, hist, buf.getvalue()


def phase_train_processes(full):
    """15e: training over processes, one rank a ``(data, model)`` shard.
    (i) 15a's settings as one NCCL rank in this process: the same eight
    steps through the rank step (gradients through the bucketed slot
    gathers), losses and grad norms against 15a's, step time, tokens/s,
    MFU and peak memory beside 15a's, then steps of both taken in turn
    on one state and the gather alone; (ii) 15b's model on gloo ranks
    sharing the card at 2x1 and 2x2, one row a rank: losses, grad norms
    and the weights' digest equal the single controller's ``--data 2``
    on the card, and the launcher's elastic restart 2 -> 1 (``--smoke``)
    gives the single controller's history; (iii) ``torchrun
    --nproc-per-node 1 -m repro_torch.launch.train --dist-backend nccl``
    runs to its end, and a second call resumes from its checkpoint (in a
    thread, beside (ii)).  No time of (ii) is a mesh's: its ranks share
    one card and gloo copies through the host."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.distributed import mesh as mesh_mod
    from repro_torch.distributed.launch import spawn_ranks
    from repro_torch.distributed.train_step import (BUCKET_BYTES,
                                                     _gather_grads, buckets,
                                                     make_rank_train_step)
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer
    from repro_torch.training.data import DataConfig, SyntheticLM

    store = tempfile.mkdtemp(prefix="p15e-")
    # (i) one NCCL rank, 15a's model, optimizer, batches and steps
    cfg = get_config(PAPER_ARCH)
    opt = O.adamw(O.cosine_schedule(P15_LR, P15_WARMUP,
                                    max(P15_STEPS, 10)))
    tokens = P15_BATCH * P15_SEQ
    n = trainer.state_bytes(trainer.abstract_state(cfg, opt))["n_params"]
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "nccl"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_mod.process_mesh(1, 1)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = trainer.init_state(cfg, opt, gen, device="cuda")
        step = make_rank_train_step(cfg, opt, mesh, remat=True)
        data = SyntheticLM(DataConfig(cfg.vocab_size, P15_SEQ, P15_BATCH))
        batches = [tuple(torch.from_numpy(a).cuda() for a in data.batch(i))
                   for i in range(2)]
        c0 = mesh_mod.collectives
        losses, gnorms, times = [], [], []
        for i in range(P15_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batches[i % 2])
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        gathers = (mesh_mod.collectives - c0) // P15_STEPS
        # A/B in turn on the same state: 15a's step, then the rank's
        plain = trainer.make_train_step(cfg, opt, remat=True)
        ab = {"15a": [], "rank": []}
        for i in range(2 * P15E_AB):
            name, fn = (("15a", plain), ("rank", step))[i % 2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = fn(state, batches[i // 2 % 2])
            float(met["loss"])
            torch.cuda.synchronize()
            ab[name].append(time.perf_counter() - t0)
        # the gather alone, on a gradient-shaped copy of the weights
        grads = {k: p.detach().clone() for k, p in state.params.items()}
        t_g = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _gather_grads(mesh, [grads], grads, True, BUCKET_BYTES)
            torch.cuda.synchronize()
            t_g.append(time.perf_counter() - t0)
        n_buckets = len(buckets(grads, 1))
        del state, step, plain, batches, grads
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    step_s = statistics.median(times[1:])
    mfu = 6 * n * tokens / (step_s * PEAK_FLOPS[torch.bfloat16])
    same = losses == full["losses"] and gnorms == full["gnorms"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, full["losses"]))
    log(f"  15e (i) one NCCL rank, {cfg.name} x{cfg.num_layers} bf16, "
        f"AdamW, remat, {P15_BATCH} x {P15_SEQ} tokens: losses and grad "
        f"norms {'equal' if same else 'DIFFER FROM'} 15a's bit for bit "
        f"(max rel diff {worst:.1e}; losses {losses}, 15a's "
        f"{full['losses']}); step "
        f"times (s) {[round(t, 4) for t in times]}: median of steps "
        f"2-{P15_STEPS} {1e3 * step_s:.1f} ms beside 15a's "
        f"{full['step_ms']:.1f} ms (same process, "
        f"{1e3 * step_s - full['step_ms']:+.1f} ms), {tokens / step_s:.0f} "
        f"tokens/s, MFU {mfu:.4f}; peak memory {peak / 1e9:.2f} GB beside "
        f"15a's {full['peak_gb']:.2f} GB; {gathers} slot gathers a step "
        f"(the metrics and {n_buckets} buckets of at most "
        f"{BUCKET_BYTES >> 20} MiB; the step's agree is one more "
        f"all-reduce); in turn on one state, 15a's step "
        f"{[round(1e3 * t, 1) for t in ab['15a']]} ms, the rank's "
        f"{[round(1e3 * t, 1) for t in ab['rank']]} ms (medians "
        f"{1e3 * statistics.median(ab['15a']):.1f} / "
        f"{1e3 * statistics.median(ab['rank']):.1f}); the gather alone "
        f"{[round(1e3 * t, 1) for t in t_g]} ms")

    # (iii), the launcher under torchrun, runs beside (ii): its time is
    # the processes' start
    pool = ThreadPoolExecutor(1)
    torchrun = pool.submit(p15e_torchrun)
    pool.shutdown(wait=False)

    # (ii) gloo ranks on the one card at 15b's model
    layers = P15B_LAYERS
    cfg = p15e_cfg(layers)
    opt = O.adamw(O.cosine_schedule(P15_LR, P15_WARMUP, 10))
    nb = trainer.state_bytes(trainer.abstract_state(cfg, opt,
                                                    torch.float32))
    # a rank: weights, the gradient, its float32 sum, the clipped copy,
    # Adam's two moments, one bucket and ~0.6 GB of CUDA context
    rank_gb = (4 * nb["params"] + nb["opt_state"]
               + BUCKET_BYTES) / 1e9 + 0.6
    free = torch.cuda.mem_get_info()[0] / 1e9
    if 4 * rank_gb > 0.9 * free:
        layers = 1
    opt, state = p15e_fresh(cfg, "cuda")
    ref = p15e_steps(trainer.make_train_step(
        cfg, opt, microbatches=2, remat=False), state, SyntheticLM(
        DataConfig(cfg.vocab_size, P15B_SEQ, 2)), "cuda")
    del state, opt
    gc.collect()
    torch.cuda.empty_cache()
    refs = {2: ref}
    if layers != P15B_LAYERS:
        cfg1 = p15e_cfg(layers)
        opt, state = p15e_fresh(cfg1, "cuda")
        refs[1] = p15e_steps(trainer.make_train_step(
            cfg1, opt, microbatches=2, remat=False), state, SyntheticLM(
            DataConfig(cfg1.vocab_size, P15B_SEQ, 2)), "cuda")
        del state, opt
        gc.collect()
        torch.cuda.empty_cache()
    for d, m in P15E_MESHES:
        nl = P15B_LAYERS if d * m <= 2 else layers
        t0 = time.perf_counter()
        got = spawn_ranks(p15e_rank, d, m, "gloo",
                          os.path.join(store, f"gloo{d}x{m}"), "cuda:0",
                          (nl,), P15E_TIMEOUT)
        want = refs[2 if nl == P15B_LAYERS else 1]
        for rank, r in enumerate(got):
            assert r == want, ("15e (ii)", d, m, rank, r, want)
        log(f"  15e (ii) {d}x{m} gloo, {cfg.name} x{nl} f32 at full width, "
            f"one row a rank, {d * m} ranks on cuda:0: every rank's losses "
            f"{[round(x, 6) for x, _ in want[0]]}, grad norms and weights' "
            f"digest equal the single controller's --data 2 on the card; "
            f"wall {time.perf_counter() - t0:.1f} s (not a mesh time)"
            + (f"; 4 ranks x {rank_gb:.1f} GB reckoned against "
               f"{free:.1f} GB free, so {nl} layer(s)"
               if d * m > 2 else ""))
    with tempfile.TemporaryDirectory() as tmp:
        argv = P15E_CLI + ["--device", "cuda", "--data", "2", "--steps",
                           "6", "--fail-at-step", "3"]
        single = p15e_cli_rank(None, argv + ["--ckpt-dir", f"{tmp}/s"])
        got = spawn_ranks(p15e_cli_rank, 2, 1, "gloo",
                          os.path.join(store, "elastic"), "cuda:0",
                          (argv + ["--ckpt-dir", f"{tmp}/m"],), P15E_TIMEOUT)
    (rc0, h0, out0), (rc1, h1, _) = got
    assert single[0] == rc0 == rc1 == 0, (single[2], out0)
    assert h0 == single[1] and h1 == single[1][:3], (h0, h1, single[1])
    assert "[elastic] step 3" in out0 and "done: 6 steps" in out0, out0
    log(f"  15e (ii) elastic restart over 2 gloo ranks (--smoke, --data 2 "
        f"--fail-at-step 3): rank 1 left after the pre-failure save, rank "
        f"0 went on as a 1x1 mesh; its losses "
        f"{[round(x, 5) for _, x, _ in h0]} equal the single "
        f"controller's on the card bit for bit")

    outs = torchrun.result()
    assert "done: 6 steps" in outs[0][0], outs[0][0]
    assert "[resume] step 6" in outs[1][0] and "done: 2 steps" in \
        outs[1][0], outs[1][0]
    log(f"  15e (iii) torchrun --nproc-per-node 1 -m repro_torch.launch."
        f"train --smoke --dist-backend nccl: 6 steps to done "
        f"({outs[0][1]:.1f} s of command), then a second call resumed at "
        f"step 6 and ran 2 ({outs[1][1]:.1f} s); both beside (ii)")
    shutil.rmtree(store, ignore_errors=True)
    # one card, the same kernels at the same shapes: the rank's step is
    # 15a's to the bit (the gathers copy)
    assert same, ("15e (i) losses", losses, full["losses"], gnorms,
                  full["gnorms"])


def p15e_torchrun():
    """15e (iii): ``torchrun --nproc-per-node 1 -m
    repro_torch.launch.train --smoke --dist-backend nccl`` to its end,
    then again with more steps (a resume); each call's output and
    seconds."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for steps in (6, 8):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--nproc-per-node", "1", "--master-addr", "localhost",
                 "--master-port", str(free_port()), "-m",
                 "repro_torch.launch.train", *P15E_CLI, "--dist-backend",
                 "nccl", "--steps", str(steps), "--ckpt-dir", tmp],
                capture_output=True, text=True, timeout=P15E_TIMEOUT,
                env=env)
            assert res.returncode == 0, res.stdout + res.stderr[-4000:]
            outs.append((res.stdout, time.perf_counter() - t0))
    return outs


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# --------------------------------------------------------------------- #
# phase 16: the serving examples, and the launch layer's dry run held
# against the card
# --------------------------------------------------------------------- #
P16_EXAMPLES = {
    "quickstart.py": ("reduction", "codec-cuda    vs ref max |err|",
                      "hydragen      vs ref max |err|"),
    "serve_docqa.py": ("codec == hydragen == flash outputs: OK",
                       "preemption + chunked prefill) outputs: OK",
                       "SPMD mesh engine outputs: OK"),
    "tree_speculation.py": ("match the dense oracle", "streams identical"),
}
# codec-cuda runs each example prints a launch line for
P16_RUNS = {"quickstart.py": 1, "serve_docqa.py": 3,
            "tree_speculation.py": 3}
P16_TIMEOUT = 300
# 16b: qwen3-4b x36 at full width, bf16, on make_host_mesh() (1x1)
P16_CELLS = (("decode", "decode", 4096, 8), ("prefill", "prefill", 4096, 1),
             ("train", "train", 512, 4))
P16_STEPS = 5
# 16b's model-split cells: the same model on a 1x2 (data, model) mesh and
# on a (pod, data, model) = 2x1x2 mesh at twice the batch (one pod's block
# is the 1x2 cell), the local program of rank 0 run on the card under the
# dry run's fake world
P16_SPLIT_MESHES = ((1, 2), (2, 1, 2))
P16_SPLIT_CELLS = (("decode", "decode", 4096, 8), ("train", "train", 512, 4))
# 16c: the dry run's loop on both production meshes for these archs (the
# full --all is ``python -m repro_torch.launch.dryrun --all`` on a CPU host)
P16_ALL_ARCHS = ("qwen3-4b", "llama4-scout-17b-a16e")
DRYRUN_OUT = Path("chiprun_out") / "dryrun_torch"


def phase_examples(root):
    """16a: the three serving examples of ``examples/torch_port`` as
    subprocesses on the card, side by side: each exits 0 and prints its
    OK lines, and every ``codec-cuda`` run launched PAC and the epilogue
    (its ``codec-cuda launches: pac=N epilogue=M`` line, N and M > 0)."""
    import re
    pat = re.compile(r"codec-cuda launches: pac=(\d+) epilogue=(\d+)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(root / "examples" / "torch_port" / name)],
        cwd=str(root), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in P16_EXAMPLES}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=P16_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, (name, proc.returncode, out[-2000:],
                                      err[-4000:])
        for want in P16_EXAMPLES[name]:
            assert want in out, (name, want, out[-2000:])
        runs = [(int(p), int(e)) for p, e in pat.findall(out)]
        assert len(runs) == P16_RUNS[name], (name, runs)
        assert all(p > 0 and e > 0 for p, e in runs), (name, runs)
        log(f"  16a. examples/torch_port/{name}: OK lines present, "
            f"codec-cuda launches (pac, epilogue) per run {runs}")
        for line in out.splitlines():
            if "vs ref max |err|" in line or "saved" in line \
                    or "identical" in line:
                log(f"       {line.strip()}")
    log(f"  16a: {time.perf_counter() - t0:.1f} s for the three examples "
        f"(side by side)")


def materialise(cell, gen):
    """The cell's arguments on the card, from ``gen``: random bf16 weights
    (and AdamW's zero moments), zero caches, random token ids; the same
    structure, shapes and dtypes as the meta arguments."""
    from repro_torch.launch.specs import flatten_args, make_optimizer_for
    from repro_torch.models import transformer as T
    from repro_torch.training import trainer
    cfg, shape = cell.cfg, cell.shape
    B, S = shape.global_batch, shape.seq_len

    def ids(*size):
        return torch.randint(0, cfg.vocab_size, size, generator=gen,
                             device="cuda")
    if cell.kind == "train":
        opt, _ = make_optimizer_for(cell.arch, cfg)
        args = (trainer.init_state(cfg, opt, gen, device="cuda"),
                (ids(B, S), ids(B, S)))
    else:
        model = T.Transformer.from_state_dict(
            cfg, T.init_params(cfg, gen, device="cuda"))
        if cell.kind == "prefill":
            args = (model, ids(B, S))
        else:
            cache = T.init_cache(model, B, S)
            args = (model, ids(B, 1), cache,
                    torch.full((B,), S - 1, dtype=torch.int64,
                               device="cuda"))
    want = {k: (tuple(t.shape), t.dtype) for k, t in cell.flat_args().items()}
    got = {k: (tuple(t.shape), t.dtype)
           for k, t in flatten_args(cell.kind, args).items()}
    assert got == want, sorted(set(got.items()) ^ set(want.items()))[:6]
    return args


def requested_bytes():
    """The bytes the caching allocator was asked for and still holds
    (``None`` where this torch does not report them)."""
    return torch.cuda.memory_stats().get("requested_bytes.all.current")


def dryrun_check():
    """16b (run in a process of its own, with expandable segments, so the
    caching allocator rounds each block to 512 bytes and no more): for
    qwen3-4b x36 at full width, bf16, on ``make_host_mesh()`` (1x1), the
    dry run's decode (8 rows against a dense 4096-token cache), prefill
    (1 x 4096) and train cells (4 x 512 tokens, AdamW, remat) against the
    card.  Asserted: the argument bytes the dry run reckons equal the
    allocator's delta when the same arguments are made on the card
    (``memory_allocated``, within 512 bytes a tensor; the requested bytes
    exactly), and the FLOPs ``FlopCounterMode`` counts over one real step
    equal the meta count, op for op.  Printed: the temp estimate against
    the step's peak less its arguments, and ``bound_s`` against the
    step's median time (CUDA events)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import PAPER_ARCH
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import input_specs

    mesh = make_host_mesh()
    assert mesh.name == "1x1", mesh
    log(f"  16b. the dry run against the card: {PAPER_ARCH} at full width, "
        f"bf16, on "
        f"make_host_mesh() = {mesh.name}; allocator "
        f"{torch.cuda.get_allocator_backend()}, PYTORCH_CUDA_ALLOC_CONF="
        f"expandable_segments:True")
    for name, kind, seq, batch in P16_CELLS:
        t0 = time.perf_counter()
        shape = InputShape(f"{name}_h100", kind, seq, batch)
        counts = {}
        rec = dryrun.run_cell(PAPER_ARCH, shape, mesh=mesh, counts=counts)
        assert rec["status"] == "ok", rec
        (count,) = counts.values()
        cell = input_specs(PAPER_ARCH, shape, mesh)
        t_meta = time.perf_counter() - t0
        mem = rec["memory"]
        n = len(cell.flat_args())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        r0 = requested_bytes()
        gen = torch.Generator(device="cuda").manual_seed(0)
        args = materialise(cell, gen)
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - a0
        requested = None if r0 is None else requested_bytes() - r0
        arg = int(mem["argument_size_in_bytes"])
        assert requested in (None, arg), (name, requested, arg)
        assert arg <= alloc <= arg + 512 * n, (name, alloc, arg, n)
        # one real step under the counter: the same ops give the same count
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            cell.step_fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - a0 - alloc
        card = {str(op): float(v) for op, v in
                fc.get_flop_counts().get("Global", {}).items()}
        diff = {op: (count.by_op.get(op), card.get(op))
                for op in set(card) | set(count.by_op)
                if count.by_op.get(op) != card.get(op)}
        assert not diff and float(fc.get_total_flops()) == count.flops, \
            (name, diff)
        times = []
        for _ in range(P16_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            cell.step_fn(*args)
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]) / 1e3)
        step_s = statistics.median(times)
        r = rec["roofline"]
        log(f"  16b {name} ({batch} x {seq}): arguments reckoned {arg} B, "
            f"allocator delta {alloc} B (+{alloc - arg} over {n} tensors, "
            f"requested {requested} B); FLOPs meta {count.flops:.6e} == "
            f"card {fc.get_total_flops():.6e} "
            f"({', '.join(f'{k} {v:.4e}' for k, v in sorted(card.items()))})"
            f"; temp estimate {mem['temp_size_in_bytes'] / 1e9:.3f} GB vs "
            f"card peak less arguments {peak / 1e9:.3f} GB; bound "
            f"{r['bound_s'] * 1e3:.3f} ms ({r['dominant']}: compute "
            f"{r['t_compute_s'] * 1e3:.3f}, memory "
            f"{r['t_memory_s'] * 1e3:.3f}) vs step median "
            f"{step_s * 1e3:.3f} ms of {P16_STEPS} "
            f"({[round(t * 1e3, 2) for t in times]}); min bytes "
            f"{rec['cost']['bytes_min'] / 1e9:.3f} GB, unfused bytes "
            f"{rec['cost']['bytes_unfused'] / 1e9:.1f} GB; useful "
            f"{rec['useful_flops_ratio']:.3f}; per device "
            f"{rec['per_device_bytes'] / 1e9:.3f} GB, fits_hbm "
            f"{rec['fits_hbm']}; meta {t_meta:.1f} s, total "
            f"{time.perf_counter() - t0:.1f} s")
        del args, fc
        gc.collect()
        torch.cuda.empty_cache()
    dryrun_check_split()


def dryrun_check_split():
    """16b's model-split half: qwen3-4b x36 bf16 on a 1x2 (data, model)
    mesh, and on a 2x1x2 (pod, data, model) mesh at twice the batch,
    partitioned as one pod's block (``specs.pod_local``) with the
    all-reduces that merge the pods.  The dry run partitions each cell on
    the meta device; then the same cell is made again under the same fake
    world (the block's) with its local shards zeros on the card
    (``input_specs(partitioned=True, device="cuda")``), and rank 0's
    local program runs there, its collectives the fake backend's no-ops,
    counted by the same ``OpStats``.  Both runs use a ``cuda``
    ``DeviceMesh`` (DTensor moves a local shard to its mesh's device
    type; the dry run's default ``cpu`` mesh would bring the shards back
    to the host), so both partition alike.  Asserted: the local FLOPs of
    the card's run equal the meta count op for op, the same collectives
    (the pod's too), and the allocator's argument bytes equal the
    reckoned local shards (within 512 bytes a tensor).  Printed:
    ``per_device_bytes`` against the card's peak
    (``max_memory_allocated``), and the collectives by kind, the pod
    group's apart."""
    from repro_torch.configs import PAPER_ARCH
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import pod_block

    for sizes in P16_SPLIT_MESHES:
        mesh = dryrun.parse_mesh("x".join(map(str, sizes)))
        block = pod_block(mesh)
        log(f"  16b. the model-split mesh {mesh.name}: {PAPER_ARCH} x36 "
            f"bf16, rank 0's local program of the fake world "
            f"({block.size} ranks of the {block.name} block, no-op "
            f"collectives) on the card")
        for name, kind, seq, batch in P16_SPLIT_CELLS:
            dryrun_check_cell(mesh, name, kind, seq,
                              batch * (mesh.size // block.size))


def dryrun_check_cell(mesh, name, kind, seq, batch):
    """One cell of ``dryrun_check_split`` on ``mesh``."""
    from repro_torch.configs import PAPER_ARCH
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, op_stats
    from repro_torch.launch.mesh import device_mesh, pod_block
    from repro_torch.launch.specs import input_specs

    t0 = time.perf_counter()
    shape = InputShape(f"{name}_h100", kind, seq, batch)
    meta = dryrun.count_local(PAPER_ARCH, shape, mesh, {},
                              device_type="cuda")
    rec = dryrun.run_cell(PAPER_ARCH, shape, mesh=mesh, local=meta)
    assert rec["status"] == "ok", rec
    t_meta = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    with device_mesh(pod_block(mesh), "cuda") as dm:
        cell = input_specs(PAPER_ARCH, shape, mesh, partitioned=True,
                           device_mesh=dm, device="cuda")
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - a0
        n = len(cell.flat_args())
        arg = int(rec["memory"]["argument_size_in_bytes"])
        assert arg <= alloc <= arg + 512 * n, (name, alloc, arg, n)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        card = op_stats.count_cell(cell)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - a0
        del cell
    diff = {op: (meta.by_op.get(op), card.by_op.get(op))
            for op in set(card.by_op) | set(meta.by_op)
            if meta.by_op.get(op) != card.by_op.get(op)}
    assert not diff and card.flops == meta.flops, (name, diff)
    kinds = [(c.kind, c.in_bytes, c.out_bytes, c.ranks)
             for c in card.collectives]
    assert kinds == [(c.kind, c.in_bytes, c.out_bytes, c.ranks)
                     for c in meta.collectives], name
    per_dev = rec["per_device_bytes"]
    c = rec["collectives"]
    pod = c.get("pod")
    across = "" if pod is None else (
        f" ({pod['count']} all-reduces over the pod group, "
        f"{pod['link_bytes'] / 1e9:.4f} GB on {pod['link']})")
    log(f"  16b {name} ({batch} x {seq}) at {mesh.name}: local FLOPs "
        f"meta {meta.flops:.6e} == card {card.flops:.6e} (total "
        f"{rec['cost']['flops_total']:.6e}); arguments reckoned {arg} "
        f"B, allocator {alloc} B over {n} shards; per_device_bytes "
        f"{per_dev / 1e9:.3f} GB (state {rec['state_bytes'] / 1e9:.3f}"
        f" + temp {rec['memory']['temp_size_in_bytes'] / 1e9:.3f}) vs "
        f"card peak {peak / 1e9:.3f} GB ({peak / per_dev:.3f}x), "
        f"fits_hbm {rec['fits_hbm']}; collectives "
        f"{ {k: v for k, v in c['count'].items() if v} } "
        f"{c['total_link_bytes'] / 1e9:.3f} GB on links{across}, "
        f"t_collective {rec['roofline']['t_collective_s'] * 1e3:.3f} "
        f"ms; rules {rec['partition_rules']}; meta {t_meta:.1f} s, "
        f"card run {t_card:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()


def phase_dryrun_card(root):
    """16b in a child process (``chip_smoke.py --dryrun-check``) whose
    allocator uses expandable segments; its lines are echoed."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    proc = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                           "--dryrun-check"], cwd=str(root), env=env,
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(line)
    assert proc.returncode == 0, proc.stderr[-4000:]
    log(f"  16b: {time.perf_counter() - t0:.1f} s (child process)")


def phase_dryrun_all():
    """16c: the dry run's loop (``dryrun.run_all``, its meta runs a pool
    of one process a CPU) for ``P16_ALL_ARCHS`` on both production
    meshes: every cell ``ok`` or ``skip`` with the config's reason, and
    partitioned (its collectives counted and priced, a per-device total
    and a boolean fit; on 2x16x16 as one pod's block, with the pod
    group's all-reduces on the network); no process group left behind,
    and nothing on the card; one line a cell."""
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, get_config, skip_reason
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    lines = []
    meshes = [dryrun.mesh_for(False), dryrun.mesh_for(True)]
    recs = dryrun.run_all(str(DRYRUN_OUT), archs=list(P16_ALL_ARCHS),
                          meshes=meshes, log=lines.append)
    (DRYRUN_OUT / "run_all.log").write_text("\n".join(lines) + "\n")
    assert torch.cuda.memory_allocated() == a0
    assert not dist.is_initialized()
    assert len(recs) == len(P16_ALL_ARCHS) * len(SHAPES) * 2, len(recs)
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    n_ok = n_skip = 0
    for arch in P16_ALL_ARCHS:
        for shape in SHAPES:
            for mesh in meshes:
                r = by[(arch, shape, mesh.name)]
                reason = skip_reason(get_config(arch), shape)
                if reason:
                    assert r["status"] == "skip" and \
                        r["reason"] == reason, r
                    n_skip += 1
                    log(f"  16c {arch} {shape} {mesh.name}: skip "
                        f"({r['reason']})")
                    continue
                assert r["status"] == "ok", (r.get("op"),
                                             r.get("error", r))
                n_ok += 1
                rf = r["roofline"]
                assert r["partitioned"], r
                assert sum(r["collectives"]["count"].values()) > 0
                assert isinstance(r["fits_hbm"], bool)
                c = r["collectives"]
                pod = c.get("pod")
                if "pod" in mesh.axis_names:
                    assert pod["link"] == "network", pod
                    assert (pod["count"] > 0) == (
                        SHAPES[shape].kind == "train"), pod
                share = r["cost"]["flops"] * r["chips"] / \
                    r["cost"]["flops_total"]
                log(f"  16c {arch} {shape} {mesh.name}: state "
                    f"{r['state_bytes'] / 1e9:.2f} GB + temp "
                    f"{r['memory']['temp_size_in_bytes'] / 1e9:.2f} GB = "
                    f"{r['per_device_bytes'] / 1e9:.2f} GB a device, "
                    f"fits_hbm {r['fits_hbm']}; collectives "
                    f"{ {k: v for k, v in c['count'].items() if v} }, "
                    f"{c['by_link']['network'] / 1e9:.2f} GB network + "
                    f"{c['by_link']['nvlink'] / 1e9:.2f} GB NVLink = "
                    f"{rf['t_collective_s']:.4g} s"
                    + ("" if pod is None else
                       f" (the pod group's {pod['count']} all-reduces: "
                       f"{pod['link_bytes'] / 1e9:.4f} GB network)")
                    + f"; compute "
                    f"{rf['t_compute_s']:.4g} s, memory "
                    f"{rf['t_memory_s']:.4g} s: {rf['dominant']}-bound; "
                    f"local FLOPs {share:.3f}x an even share; torch "
                    f"{r['torch_version']}; "
                    f"{r['cell_s']:.1f} s")
    log(f"  16c: {n_ok} cells ok, {n_skip} skipped, records in "
        f"{DRYRUN_OUT}; {time.perf_counter() - t0:.1f} s on "
        f"{len(os.sched_getaffinity(0))} CPUs, no byte allocated on the "
        f"card")


# --------------------------------------------------------------------- #
# phase 17: the three kernels over every shape their TPU kernels take
# --------------------------------------------------------------------- #
# flash_decode: phase 4's row lengths (8 rows up to 4192 positions, NaN
# past each), the configs' head dims and the smoke configs' 16 and 96 (the
# next instance's columns past d masked) x the groups of fig13's sweep and
# the real head layouts, each also under a window
P17_FD_LENS = (4192, 1, 2007, 3000, 4100, 777, 4192, 64)
P17_FD_DIMS = (64, 128, 256, 16, 96)
P17_GROUPS = (1, 4, 5, 7, 8, 16, 32)
P17_FD_WINDOW = 512
# gemma3-1b's layout beside the sweep, and the (h_q, n_kv, d) shapes that
# get a row of the kernels JSON line
P17_FD_EXTRA = ((4, 1, 256),)
P17_FD_ROWS = {(4, 1, 256): "gemma3-1b", (40, 8, 128): "llama4-scout",
               (56, 8, 128): "llava-next-34b", (32, 2, 128): "fig13",
               (32, 1, 128): "fig13", (8, 8, 64): "MHA"}
# the epilogue: pages x groups at d 128 in codec and mesh mode, then
# gemma3-1b's layout at page 128 with f32 KV (staged 64 tokens at a time)
# and group 32 at d 256; C8's shapes: pages 256 and 1024 (the tail in
# passes of 128 tokens), the smoke config's 4 over 2 heads at d 16, and d
# 48 and 96; (page, h_q, n_kv, d, the timed type)
P17_PAGES = (8, 24, 32, 128)
P17_EPI_GROUPS = (1, 4, 8, 32)
P17_EPI_EXTRA = ((128, 4, 1, 256, torch.float32),
                 (32, 32, 1, 256, torch.bfloat16),
                 (256, 32, 8, 128, torch.float32),
                 (1024, 32, 8, 128, torch.bfloat16),
                 (16, 4, 2, 16, torch.float32),
                 (32, 24, 8, 48, torch.bfloat16),
                 (32, 32, 4, 96, torch.bfloat16))
P17_MERGE_D = (32, 64)
# 17b's fused codec-cuda serves: (model, page, data shards or 0)
P17_SERVES = (("qwen3-4b", 32, 0), ("qwen3-4b", 8, 0), ("qwen3-4b", 128, 0),
              ("qwen3-4b", 256, 0),
              ("qwen3-4b 32 over 1", 32, 0), ("qwen3-4b 32 over 1", 32, 2),
              ("gemma3-1b", 128, 0), ("qwen3-4b smoke", 16, 0))
P17_DOC = 2048
P17_REPS = 5
C2_DOC = [3 + (7 * i) % 240 for i in range(320)]     # 40 pages of 8


def p17_heads(group):
    """(h_q, n_kv) at ``group``: 8 KV heads up to group 8 (qwen3-4b's and
    llama4-scout's count), past it 32 query heads (fig13's sweep)."""
    n_kv = 8 if group <= 8 else 32 // group
    return n_kv * group, n_kv


def p17_flash_decode(timer):
    """17a: ``flash_decode`` against its plain version at every (d,
    group) and gemma3-1b's layout, f32 and bf16 q and KV, with and without
    a window; bf16 without one timed beside the plain version and SDPA
    over the same rows (``enable_gqa``, K and V zero where NaN).  Returns
    {(h_q, n_kv, d): row}."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(17)
    lens = torch.tensor(P17_FD_LENS, dtype=torch.int32, device="cuda")
    B, L = lens.numel(), max(P17_FD_LENS)
    mask = (torch.arange(L, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    rows = {}
    shapes = [p17_heads(g) + (d,) for d in P17_FD_DIMS for g in P17_GROUPS]
    for h_q, n_kv, d in shapes + list(P17_FD_EXTRA):
        group = h_q // n_kv
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, h_q, d, generator=gen, device="cuda"
                            ).to(dtype)
            k, v = (torch.randn(B, L, n_kv, d, generator=gen,
                                device="cuda").to(dtype)
                    for _ in range(2))
            for b, n in enumerate(P17_FD_LENS):
                k[b, n:] = float("nan")
                v[b, n:] = float("nan")
            for window in (P17_FD_WINDOW, 0):
                n0 = fd.launches
                got = fd.flash_decode(q, k, v, lens, window=window)
                launches = fd.launches - n0
                want = fd.flash_decode_torch(q, k, v, lens, window=window)
                torch.cuda.synchronize()
                tag = (f"17a flash_decode d={d} group={group} window="
                       f"{window} {dtype}")
                assert bool(torch.isfinite(got).all()), tag
                if dtype == torch.float32:
                    err = assert_close(tag, [got], [want], EPI_TOL)
                    log(f"  {tag}: {h_q} over {n_kv} heads, max|err| "
                        f"{err:.3e} (tol {EPI_TOL:g})")
                    continue
                # both sum in f32 and round once to bf16
                err = assert_close(tag, [got], [want], TOL[dtype])
                ulps = bf16_ulps(got, want)
                assert ulps <= EPI_ULPS, (tag, ulps)
                if window:
                    log(f"  {tag}: {h_q} over {n_kv} heads, within {ulps} "
                        f"bf16 step(s), max|err| {err:.3e} (tol "
                        f"{TOL[dtype]:g})")
            if dtype == torch.float32:
                continue
            kz, vz = (torch.nan_to_num(x, nan=0.0).transpose(1, 2)
                      for x in (k, v))
            qs = q[:, :, None]

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, kz, vz, attn_mask=mask, enable_gqa=True)
            ms = timer(lambda: fd.flash_decode(q, k, v, lens), P17_REPS)
            plain = timer(lambda: fd.flash_decode_torch(q, k, v, lens),
                          P17_REPS)
            lib = timer(sdpa, P17_REPS)
            bound, by = fd_bound(q, k, lens)
            log(f"  {tag}: {h_q} over {n_kv} heads, within {ulps} bf16 "
                f"step(s), max|err| {err:.3e}; {ms:.4f} ms/launch, mean of "
                f"{P17_REPS} (bound {bound:.4f} by {by}, "
                f"{bound / ms:.1%} of it; plain {plain:.4f}; SDPA "
                f"{lib:.4f})")
            rows[(h_q, n_kv, d)] = {
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": lib}
            del kz, vz
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def p17_epilogue(page, h_q, n_kv, d, mesh, gen, timer, time_dtype):
    """17a: PAC's raw partials (NaN in dead slots) of an engine-shaped
    plan at ``page`` (8 requests over a 2048-token document), then the
    epilogue against its plain version, f32 and bf16 q and KV; in mesh
    mode with every other row's tail on another shard (owner 0) and
    float32 ``o``.  ``time_dtype``'s pair is timed.  Returns its row."""
    from repro_torch.core import cost_model, plan as plan_mod, tree
    from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
    forest = tree.two_level(8, P17_DOC, 64, block_size=page)
    pages = plan_mod.assign_dense_pages(forest)
    cm = cost_model.CostModel(h_q, n_kv, d, page_size=page)
    plan, tails = engine_state(forest, cm, LANES, MAX_Q, 2048)
    pa = ops.plan_arrays(plan, "cuda")
    B = plan.num_queries
    k = torch.randn(pages, page, n_kv, d, generator=gen, device="cuda")
    v = torch.randn(pages, page, n_kv, d, generator=gen, device="cuda")
    q = torch.randn(B, h_q, d, generator=gen, device="cuda")
    kw = {}
    if mesh:
        kw = {"owner": (torch.arange(B, device="cuda") % 2 == 0).long(),
              "o_f32": True}
    nan = float("nan")
    row = None
    for dt in (torch.float32, torch.bfloat16):
        qc, kc, vc = q.to(dt), k.to(dt), v.to(dt)
        Tp1, max_q = pa.q_gather.shape
        raw = (torch.full((Tp1, max_q, h_q, d), nan, device="cuda"),
               torch.full((Tp1, max_q, h_q), nan, device="cuda"),
               torch.full((Tp1, max_q, h_q), nan, device="cuda"))
        o, m, l = pac_mod.pac(qc, pa, kc, vc, out=raw)
        parts = ops.Parts(o.reshape(-1, h_q, d), m.reshape(-1, h_q),
                          l.reshape(-1, h_q), pa.seg_offsets, pa.seg_rows)
        n0 = por_mod.epilogue_launches
        got = por_mod.por_epilogue(qc, *parts, kc, vc, *tails, stats=True,
                                   **kw)
        launches = por_mod.epilogue_launches - n0
        want = por_mod.por_epilogue_torch(qc, *parts, kc, vc, *tails, **kw)
        torch.cuda.synchronize()
        tag = (f"17a epilogue page={page} {h_q} over {n_kv} d={d} "
               f"{'mesh' if mesh else 'codec'} {dt}")
        assert all(bool(torch.isfinite(g).all()) for g in got), tag
        ml_err = assert_close(tag, got[1:], want[1:], EPI_TOL)
        if got[0].dtype == torch.bfloat16:
            ulps = bf16_ulps(got[0], want[0])
            assert ulps <= EPI_ULPS, (tag, ulps)
            err = max_err(got[:1], want[:1])
            what = f"bf16 o within {ulps} step(s), max|err| {err:.3e}"
        else:
            err = assert_close(tag, got[:1], want[:1], EPI_TOL)
            what = f"f32 o max|err| {err:.3e}"
        line = (f"  {tag}: {B} queries, {int(pa.seg_offsets[-1])} live "
                f"rows; {what}; m, l max|err| {ml_err:.3e}")
        if dt == time_dtype:
            def kernel():
                return por_mod.por_epilogue(qc, *parts, kc, vc, *tails, **kw)

            def plain():
                return por_mod.por_epilogue_torch(qc, *parts, kc, vc, *tails,
                                                  **kw)
            ms = timer(kernel, P17_REPS)
            plain_ms = timer(plain, P17_REPS)
            bound, by = (mesh_epilogue_bound(qc, parts, kc, tails,
                                             kw["owner"]) if mesh else
                         epilogue_bound(qc, parts, kc, tails))
            line += (f"; {ms:.4f} ms/launch, mean of {P17_REPS} (bound "
                     f"{bound:.5f} by {by}; plain {plain_ms:.4f})")
            row = {"launches": launches, "max_abs_err": max(err, ml_err),
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "library_ms": None}
        log(line)
    return row


def p17_merge(D, gen, timer):
    """17a: ``codec_mesh_merge`` at ``D`` shards (1 model shard, 8 rows
    all merged, 32 heads, hd 128) under every contributor pattern of a
    few kinds: within 1e-6 of its plain version (``m`` bitwise) and
    bitwise shard 0's rows of the stacked butterfly on ``codec_por``;
    timed with every shard contributing.  Returns its row."""
    from repro_torch.kernels import por as por_mod
    M, B, h, hd = 1, 8, 32, 128
    gi = torch.arange(B, device="cuda")
    si = gi.clone()
    rng = np.random.default_rng(D)
    pats = [np.ones(D, bool), np.eye(D, dtype=bool)[D - 1],
            np.arange(D) < D // 2, np.arange(D) % 17 == 3,
            rng.integers(0, 2, D).astype(bool)]
    row, args = None, None
    for c in pats:
        o = torch.randn(D, M, B, h, hd, generator=gen, device="cuda")
        m = 3 * torch.randn(D, M, B, h, generator=gen, device="cuda")
        l = 0.5 + 3.5 * torch.rand(D, M, B, h, generator=gen, device="cuda")
        off = torch.from_numpy(~c).cuda()
        o[off], m[off], l[off] = 0.0, -1e30, 0.0
        ct = torch.from_numpy(c.astype(np.int64)).cuda()
        args = (o, m, l, gi, si, ct)
        n0 = por_mod.mesh_merge_launches
        got = por_mod.mesh_merge(*args, torch.float32, stats=True)
        launches = por_mod.mesh_merge_launches - n0
        want = por_mod.mesh_merge_torch(*args, torch.float32, stats=True)
        stacked = por_mod.por_subgroup_merge(o[:, :, gi], m[:, :, gi],
                                             l[:, :, gi], ct)
        torch.cuda.synchronize()
        tag = f"17a mesh_merge D={D} contributors={int(c.sum())}"
        err = assert_close(tag, got, want, POR_TOL)
        assert torch.equal(got[1], want[1]), (tag, "m")
        for g, st in zip(got, stacked):
            assert torch.equal(g, st[0]), (tag, "not the stacked butterfly")
        if row is None:         # every shard contributes: timed
            ms = timer(lambda: por_mod.mesh_merge(*args, torch.bfloat16),
                       P17_REPS)
            plain = timer(lambda: por_mod.mesh_merge_torch(*args,
                                                           torch.bfloat16),
                          P17_REPS)
            bound, by = merge_bound(o, si, torch.bfloat16)
            row = {"launches": launches, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                   "library_ms": None}
            log(f"  {tag}: max|err| {err:.3e} (tol {POR_TOL:g}), bitwise "
                f"the stacked butterfly on codec_por; {ms:.4f} ms/launch, "
                f"mean of {P17_REPS} (bound {bound:.5f} by {by}; plain "
                f"{plain:.4f})")
        else:
            log(f"  {tag}: max|err| {err:.3e}, bitwise the stacked "
                f"butterfly on codec_por")
    return row


def phase_pages_f32():
    """17b: fused ``codec-cuda`` serves at the new shapes, each beside
    ``codec-torch`` (plain PAC, the same epilogue kernel) on one device;
    the streams must be equal.  Phase 6's 4-layer f32 qwen3-4b at pages of
    32, 8, 128 and 256 (C8: the tail in two passes of 128 tokens); the same
    with one KV head (32 over 1: group 32) at page 32, on one device and on
    a ``decode_mesh(2, 1)`` (the epilogue's mesh mode); gemma3-1b's layout
    (4 over 1, d 256; 12c's 6 layers, f32 KV staged 64 tokens at a time) at
    page 128; the qwen3-4b smoke config (C8: d 16, 4 over 2 heads, 2
    layers, which the engine refused on the card before) at page 16.  8
    questions over a
    2048-token document, 32 greedy tokens each.  Returns the launch counts
    of each ``codec-cuda`` serve, read just after it with every count
    reset just before, by (model, page, data shards)."""
    from repro_torch.configs import PAPER_ARCH, get_config, smoke_config
    from repro_torch.distributed import decode_mesh
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine
    qwen = dataclasses.replace(get_config(PAPER_ARCH), num_layers=4)
    models = {"qwen3-4b": qwen,
              "qwen3-4b 32 over 1": dataclasses.replace(qwen,
                                                        num_kv_heads=1),
              "gemma3-1b": dataclasses.replace(get_config("gemma3-1b"),
                                               num_layers=P12C_GEMMA_LAYERS),
              "qwen3-4b smoke": smoke_config(PAPER_ARCH)}
    out = {}
    for name, cfg in models.items():
        model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
        prompts = doc_prompts(8, P17_DOC, 64, cfg.vocab_size, seed=1)
        for page in sorted({pg for nm, pg, _ in P17_SERVES if nm == name}):
            pages = 4 * (P17_DOC + 8 * 96) // page
            want = None
            for backend, D in [("codec-torch", 0)] + [
                    ("codec-cuda", D) for nm, pg, D in P17_SERVES
                    if (nm, pg) == (name, page)]:
                tag = (f"17b {name} page {page} {backend}"
                       + (f" decode_mesh({D}, 1)" if D else ""))
                reset_launches()
                engine = DecodeEngine(
                    cfg, model, page_size=page,
                    num_pages=pages * (4 if D else 1), num_lanes=LANES,
                    max_q=MAX_Q, backend=backend, fused=True,
                    mesh=decode_mesh(D, 1) if D else None,
                    seq_split_pages=1 if D else 0, device="cuda")
                res = serve(engine, prompts, max_new=32)
                n = read_launches()
                assert n["por_epilogue"] > 0, (tag, n)
                assert (n["pac"] > 0) == (backend == "codec-cuda"), (tag, n)
                assert (n["mesh_merge"] > 0) == bool(D), (tag, n)
                assert engine.fused_step.replays == res["steps"], tag
                if want is None:
                    want = res["streams"]
                else:
                    out[(name, page, D)] = n
                    bad = [r for r in want if want[r] != res["streams"][r]]
                    if bad:
                        raise AssertionError(f"{tag}: streams differ from "
                                             f"codec-torch's for {bad}")
                log(f"  {tag} fused: {res['steps']} steps, "
                    f"{engine.fused_step.graphs} graphs, launches {n}"
                    + ("" if backend == "codec-torch" else
                       f"; == codec-torch on {len(want)} streams x 32 "
                       f"tokens, {cfg.num_layers} layers f32"))
                del engine
                torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
    return out


def phase_c2_mesh():
    """17c: ROADMAP C2's reproduction on the card: the qwen2.5-14b smoke
    model (head dim widened to 64, the epilogue's smallest), f32, four
    questions over a 320-token document at page 8, fused ``codec-cuda``:
    at 32 and 64 data shards (the document over 32 and 40 of them) the
    streams equal the single-device engine's.  Returns the merge's
    launches by axis."""
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import decode_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine
    cfg = dataclasses.replace(smoke_config("qwen2.5-14b"), head_dim=64)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)

    def streams(mesh):
        reset_launches()
        eng = DecodeEngine(cfg, model, page_size=8, num_pages=512,
                           backend="codec-cuda", max_q=8, fused=True,
                           mesh=mesh, seq_split_pages=1 if mesh else 0,
                           device="cuda")
        rids = [eng.add_request(C2_DOC + [245 + i], max_new=8)
                for i in range(4)]
        eng.run(64)
        eng.check()
        return [list(eng.requests[r].generated) for r in rids], \
            read_launches()
    one, n1 = streams(None)
    assert all(len(s) == 8 for s in one) and n1["por_epilogue"] > 0, n1
    out = {}
    for D in P17_MERGE_D:
        got, n = streams(decode_mesh(D, 1))
        assert got == one, (D, got, one)
        assert n["mesh_merge"] > 0 and n["por"] == 0, (D, n)
        out[D] = n
        log(f"  17c decode_mesh({D}, 1): streams equal the single-device "
            f"engine's ({len(one)} x 8 tokens); launches {n}")
    return out


def phase_shapes(timer):
    """17: (b) and (c) serve first, then (a) holds every kernel against
    its plain version at the new shapes; returns the kernels JSON rows."""
    t = [time.perf_counter()]
    pages = phase_pages_f32()
    t.append(time.perf_counter())
    merges = phase_c2_mesh()
    t.append(time.perf_counter())
    gen = torch.Generator(device="cuda").manual_seed(170)
    fd_rows = p17_flash_decode(timer)
    t.append(time.perf_counter())
    epi = {}
    for page in P17_PAGES:
        for group in P17_EPI_GROUPS:
            h_q, n_kv = p17_heads(group)
            for mesh in (False, True):
                epi[(page, group, 128, mesh)] = p17_epilogue(
                    page, h_q, n_kv, 128, mesh, gen, timer, torch.bfloat16)
    for page, h_q, n_kv, d, dt in P17_EPI_EXTRA:
        for mesh in (False, True):
            epi[(page, h_q // n_kv, d, mesh)] = p17_epilogue(
                page, h_q, n_kv, d, mesh, gen, timer, dt)
    t.append(time.perf_counter())
    merge_rows = {D: p17_merge(D, gen, timer) for D in P17_MERGE_D}
    t.append(time.perf_counter())
    log("  phase 17: " + ", ".join(
        f"{c} {b - a:.1f} s" for c, a, b in zip(
            ("17b", "17c", "17a flash_decode", "17a epilogue",
             "17a mesh_merge"), t, t[1:])))

    def entry(name, source, replaces, row, **over):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces}
        e.update({k: row[k] for k in ("launches", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")})
        e.update(over)
        return e
    fd_src = "src/repro_torch/kernels/csrc/flash_decode.cu"
    por_src = "src/repro_torch/kernels/csrc/por.cu"
    kernels = []
    for (h_q, n_kv, d), what in P17_FD_ROWS.items():
        kernels.append(entry(
            f"flash_decode ({what}: {h_q} over {n_kv} heads, d {d}, bf16)",
            fd_src, "src/repro/kernels/flash_decode.py:91",
            fd_rows[(h_q, n_kv, d)]))
    epi_src = "src/repro/kernels/por.py:44"
    # launches: the 17b serve that runs the row's shape
    for key, name, serve_key in (
            ((32, 4, 128, False), "page 32, 32 over 8 heads, d 128",
             ("qwen3-4b", 32, 0)),
            ((8, 4, 128, False), "page 8, 32 over 8 heads, d 128",
             ("qwen3-4b", 8, 0)),
            ((128, 4, 128, False), "page 128, 32 over 8 heads, d 128",
             ("qwen3-4b", 128, 0)),
            ((32, 32, 128, False), "group 32, page 32, d 128",
             ("qwen3-4b 32 over 1", 32, 0)),
            ((32, 32, 128, True), "group 32, page 32, d 128, mesh mode",
             ("qwen3-4b 32 over 1", 32, 2)),
            ((128, 4, 256, False), "page 128, gemma3-1b's 4 over 1 heads, "
             "d 256, f32 KV staged 64 tokens at a time",
             ("gemma3-1b", 128, 0)),
            ((256, 4, 128, False), "page 256, 32 over 8 heads, d 128, the "
             "tail in two 128-token passes", ("qwen3-4b", 256, 0)),
            ((16, 2, 16, False), "the smoke config's 4 over 2 heads, d 16 "
             "in the 256-column instance, page 16",
             ("qwen3-4b smoke", 16, 0))):
        kernels.append(entry(f"por_epilogue ({name})", por_src, epi_src,
                             epi[key], launches=pages[serve_key][
                                 "por_epilogue"]))
    for D in P17_MERGE_D:
        kernels.append(entry(
            f"mesh_merge (D = {D}, 8 rows x 32 heads, d 128, bf16 out)",
            "src/repro_torch/kernels/csrc/mesh_merge.cu",
            "src/repro/kernels/por.py:44 (in por_subgroup_merge, "
            "src/repro/kernels/por.py:121)", merge_rows[D],
            launches=merges[D]["mesh_merge"]))
    return kernels


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
    if sys.argv[1:] == ["--dryrun-check"]:      # phase 16b's own process
        dryrun_check()
        return 0
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
    flash_res = phase_serve_flash(cfg, model, codec_res)

    log("== 6. backend streams agree, eager and fused")
    phase_backends()

    log("== 7. the fused decode step at full depth, beside eager")
    fused7 = phase_fused(cfg, model, {"codec-cuda": codec_res,
                                      "flash": flash_res})

    log("== 8. serving under memory pressure: Poisson arrivals, chunked "
        "prefill, preempt-and-recompute")
    phase_pressure(cfg, model)

    log("== 9. the request lifecycle: prefix cache, streaming, sampling "
        "at temperature 0.8, faults")
    phase_lifecycle(cfg, model)

    log("== 10. cascade prefill and telemetry")
    phase_cascade_telemetry(cfg, model)

    log("== 11. tree-speculative decoding: self-drafted trees verified in "
        "one dispatch, eager and fused")
    t11 = time.perf_counter()
    phase_speculation(cfg, model, timer)
    t11a = time.perf_counter() - t11
    del model
    torch.cuda.empty_cache()
    phase_pressure_f32()
    phase_lifecycle_f32()
    phase_cascade_telemetry_f32()
    t11 = time.perf_counter()
    phase_speculation_f32()
    log(f"  phase 11: 11a {t11a:.1f} s, 11b {time.perf_counter() - t11:.1f}"
        f" s")

    log("== 12. the model families beyond the dense subset: gemma3-1b's "
        "sliding-window decoder, llama4-scout's top-1 MoE")
    t12 = [time.perf_counter()]
    kernels += phase_gemma3(timer)
    t12.append(time.perf_counter())
    kernels += phase_scout(timer)
    t12.append(time.perf_counter())
    phase_families_f32()
    t12.append(time.perf_counter())
    log(f"  phase 12: 12a {t12[1] - t12[0]:.1f} s, 12b "
        f"{t12[2] - t12[1]:.1f} s, 12c {t12[3] - t12[2]:.1f} s")

    log("== 13. Mamba-2 and the hybrid jamba: the SSD mixer, per-request "
        "SSM state with node-boundary caching, eager and fused")
    t13 = [time.perf_counter()]
    phase_mamba2(timer)
    t13.append(time.perf_counter())
    kernels += phase_jamba(timer)
    t13.append(time.perf_counter())
    phase_mamba_f32()
    t13.append(time.perf_counter())
    phase_window_c1()
    t13.append(time.perf_counter())
    log("  phase 13: " + ", ".join(
        f"13{c} {b - a:.1f} s" for c, a, b in zip("abcd", t13, t13[1:])))

    log("== 14. the mesh on one card: sharded KV pool, per-shard plans, "
        "the cross-shard POR butterfly, head-parallel attention")
    t14 = [time.perf_counter()]
    k14, runs14 = phase_mesh(timer, fused7)
    kernels += k14
    t14.append(time.perf_counter())
    f32_14 = phase_mesh_f32()
    t14.append(time.perf_counter())
    phase_calibrate()
    t14.append(time.perf_counter())
    phase_process_mesh(runs14, f32_14)
    del runs14, f32_14
    t14.append(time.perf_counter())
    phase_process_mesh_c5()
    t14.append(time.perf_counter())
    log(f"  phase 14: 14a-c {t14[1] - t14[0]:.1f} s, 14b "
        f"{t14[2] - t14[1]:.1f} s, 14d {t14[3] - t14[2]:.1f} s, 14e "
        f"(i-iii) {t14[4] - t14[3]:.1f} s, 14e (iv) "
        f"{t14[5] - t14[4]:.1f} s")

    log("== 15. training on the card: qwen3-4b at full width and depth, "
        "the step against the CPU, the launcher, train then serve, "
        "training over processes")
    del fused7, codec_res, flash_res
    gc.collect()            # engines and their graphs' pools sit in cycles
    torch.cuda.empty_cache()
    t15 = [time.perf_counter()]
    full15 = phase_train_full()
    t15.append(time.perf_counter())
    cfg15, state15 = phase_train_parity()
    t15.append(time.perf_counter())
    phase_train_cli()
    t15.append(time.perf_counter())
    phase_train_serve(cfg15, state15)
    del state15
    gc.collect()
    torch.cuda.empty_cache()
    t15.append(time.perf_counter())
    phase_train_processes(full15)
    t15.append(time.perf_counter())
    log("  phase 15: " + ", ".join(
        f"15{c} {b - a:.1f} s" for c, a, b in zip("abcde", t15, t15[1:])))

    log("== 16. the serving examples on the card; the launch layer's dry "
        "run on the meta device against the H100")
    gc.collect()
    torch.cuda.empty_cache()
    t16 = [time.perf_counter()]
    phase_examples(root)
    t16.append(time.perf_counter())
    phase_dryrun_card(root)
    t16.append(time.perf_counter())
    phase_dryrun_all()
    t16.append(time.perf_counter())
    log("  phase 16: " + ", ".join(
        f"16{c} {b - a:.1f} s" for c, a, b in zip("abc", t16, t16[1:])))

    log("== 17. the three kernels over every shape their TPU kernels "
        "take: flash_decode at d 64/128/256 and groups to 32, the "
        "epilogue at pages 8-128 and group 32, the merge past 16 shards")
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    kernels += phase_shapes(timer)
    log(f"  phase 17: {time.perf_counter() - t17:.1f} s")

    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
