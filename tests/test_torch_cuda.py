"""The CUDA kernels (PAC, POR, the POR epilogue, flash_decode) against
their plain torch versions, on the card.

PAC is held on the plans that stress its ring and its row chunks: the
codec and flash plans at full width, lanes with nothing but padding, last
pages shorter than the page, a window crossing page edges, groups 1, 4,
5, 7, 8, 16 and 32, pages 8, 16, 24, 32, 64 and 128, head dims 64 to 256,
and more rows in a task than one block holds.  The kernel reads a pool whose every position no plan
step covers is NaN, and writes into outputs filled with NaN: live slots
must match the plain version (which reads zeros there), dead slots must
still hold NaN, and the combined output must stay finite.  The epilogue
takes the same plans, PAC's raw partials with NaN in every dead slot, and
each request's last page as its tail (NaN past the request's position),
writes into an output filled with NaN, and gives the same bits twice:
every shape it takes is among them (groups up to 32, at d 256 too, where
8 warps take 4 heads each; pages of 8 and 24, which end in a partial
32-token round; page 128 at d 256 with f32 KV, staged 64 tokens at a
time).  ``flash_decode`` is held at d 16-256 and groups 1 to 128.  The
epilogue's refusals: d 20, 8, 272 and 512; pages 8 to 1024, group 9,
group 32 at page 128 and d 16, 32, 48 and 96 launch (C8: pages of 256
and 1024 and head dims 16, 48 and 96 also over the plans).

Needs an NVIDIA GPU and ``nvcc`` (the kernels are built on first use);
skips elsewhere.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Imports only
torch and the port, so it runs where ``jax`` is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import (build, flash_decode as fd, ops,
                                 pac as pac_mod, por as por_mod)


def _pool(forest, n_kv, d, seed):
    pages = plan_mod.assign_dense_pages(forest)
    rng = np.random.default_rng(seed)
    ps = forest.block_size
    k = rng.standard_normal((pages, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((pages, ps, n_kv, d)).astype(np.float32)
    return k, v


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    """On an H100: both CUDA kernels against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    page, hq, hkv, d = 16, 32, 8, 128
    f = tree.full_kary(3, 3, 40, block_size=page)
    k, v = _pool(f, hkv, d, seed=17)
    p = plan_mod.pad_plan(plan_mod.build_plan(
        f, cost_model.CostModel(hq, hkv, d, page_size=page), num_lanes=16,
        max_q=32))
    B = len(f.request_ids)
    q = torch.randn(B, hq, d, generator=torch.Generator().manual_seed(0))
    # bf16 KV: PAC's tensor-core path, held as in test_pac_plans_on_card
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
        kc, vc = (torch.from_numpy(x).to("cuda", dt) for x in (k, v))
        qc = q.to("cuda", dt)
        pa = ops.plan_arrays(p, "cuda")
        got = ops.codec_partials_arrays(qc, kc, vc, pa, p.num_queries,
                                        impl="cuda")
        want = ops.codec_partials_arrays(qc, kc, vc, pa, p.num_queries,
                                         impl="torch")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        merged = por_mod.por(*got, *want)
        plain = por_mod.por_torch(*got, *want)
        torch.cuda.synchronize()
        for g, w in zip(merged, plain):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100])
def test_flash_decode_matches_plain_on_card(window):
    """On an H100: uneven kv_lens (L, 1, mid-range, 0) with NaN past every
    kv_len, q and KV types mixed, at d 128 with groups 4 and 1, and at
    every head layout the kernel's head chunks reach: d 64 and 256,
    groups 5 and 7 (heads past the group idle in the chunk), 16 and 32
    (several chunks a KV head), and d 256 at groups 4, 8 and 32.  Since
    the redesign (tensor cores over the group for bf16 KV, f32 KV on
    FFMA): also d 16, 48 and 96 (the next instance's columns past d
    masked), groups 64 (two teams a block over one staged tile) and 128
    (two blocks a KV head), and 700 positions against 64-token tiles and
    splits of a multiple of 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    rng = np.random.default_rng(23 + window)
    L = 700
    lens = torch.tensor([L, 1, 333, 0], dtype=torch.int32, device="cuda")
    for hq, hkv, d in ((32, 8, 128), (8, 8, 128), (8, 8, 64), (32, 4, 64),
                       (40, 8, 128), (56, 8, 128), (32, 2, 128),
                       (32, 1, 128), (4, 1, 256), (8, 1, 256),
                       (40, 8, 256), (32, 1, 256), (16, 4, 16),
                       (10, 2, 16), (32, 2, 48), (32, 4, 96), (64, 1, 96),
                       (128, 1, 64), (40, 2, 256)):
        q = torch.from_numpy(rng.standard_normal((4, hq, d)).astype(
            np.float32)).cuda()
        k, v = (torch.from_numpy(rng.standard_normal((4, L, hkv, d)).astype(
            np.float32)).cuda() for _ in range(2))
        for b, n in enumerate(lens.tolist()):
            k[b, n:] = float("nan")
            v[b, n:] = float("nan")
        for qdt, kvdt, tol in ((torch.float32, torch.float32, 1e-5),
                               (torch.bfloat16, torch.float32, 3e-2),
                               (torch.bfloat16, torch.bfloat16, 3e-2),
                               (torch.float32, torch.bfloat16, 1e-5)):
            args = (q.to(qdt), k.to(kvdt), v.to(kvdt), lens)
            got = fd.flash_decode(*args, window=window)
            want = fd.flash_decode_torch(*args, window=window)
            torch.cuda.synchronize()
            assert got.dtype == qdt
            assert torch.isfinite(got).all()
            assert (got[3] == 0).all()
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _plan_pools(forest, plan, n_kv, d, seed):
    """(pools for the kernel, pools for the plain version): NaN, resp.
    zero, at every position no valid plan step covers and in two pages
    past the forest's; random elsewhere."""
    k, v = _pool(forest, n_kv, d, seed)
    ps = forest.block_size
    covered = np.zeros(k.shape[:2], bool)
    valid = plan.step_valid.astype(bool)
    for pg, n in zip(plan.step_page[valid], plan.step_kvlen[valid]):
        covered[pg, :n] = True
    extra = np.zeros((2, ps, n_kv, d), np.float32)
    out = []
    for fill in (np.nan, 0.0):
        pair = []
        for x in (k, v):
            y = x.copy()
            y[~covered] = fill
            pair.append(np.concatenate([y, extra + fill]))
        out.append(pair)
    return out


def _nan_outputs(pa, h_q, d):
    Tp1, max_q = pa.q_gather.shape
    return tuple(torch.full(sh, float("nan"), device="cuda") for sh in
                 ((Tp1, max_q, h_q, d), (Tp1, max_q, h_q), (Tp1, max_q, h_q)))


def _forest_plan(case):
    page = {"page64": 64, "page8": 8, "page24": 24, "page32": 32,
            "page128": 128, "page128-d256": 128, "g32-page32": 32,
            "page256": 256, "page1024": 1024}.get(case, 16)
    hq, hkv, d = {"g1": (8, 8, 128), "g8": (32, 4, 128), "d64": (8, 8, 64),
                  "d16": (16, 4, 16), "d48": (24, 8, 48), "d96": (32, 4, 96),
                  "d256": (8, 1, 256), "gemma3-global": (4, 1, 256),
                  "gemma3-local": (4, 1, 256),
                  "g5": (40, 8, 128), "g7": (56, 8, 128),
                  "g16": (32, 2, 128), "g32": (32, 1, 128),
                  "g32-page32": (32, 1, 256),
                  "page128-d256": (8, 1, 256)}.get(case, (32, 8, 128))
    forest = {
        "padding-lanes": lambda: tree.two_level(2, 40, 9, block_size=page),
        "window24": lambda: tree.two_level(4, 100, 30, block_size=page),
        # gemma3's layers: a shared document past the 512-token window
        "gemma3-global": lambda: tree.two_level(6, 1200, 70,
                                                block_size=page),
        "gemma3-local": lambda: tree.two_level(6, 1200, 70,
                                               block_size=page),
        "rows-over-chunks": lambda: tree.two_level(24, 100, 20,
                                                   block_size=page),
        "page64": lambda: tree.two_level(8, 300, 70, block_size=page),
        "page128": lambda: tree.two_level(8, 600, 150, block_size=page),
        "page128-d256": lambda: tree.two_level(8, 600, 150,
                                               block_size=page),
        "page256": lambda: tree.two_level(8, 600, 300, block_size=page),
        "page1024": lambda: tree.two_level(4, 2200, 1100, block_size=page),
        "kary": lambda: tree.full_kary(3, 3, 40, block_size=page),
    }.get(case, lambda: tree.two_level(8, 200, 37, block_size=page))()
    plan_mod.assign_dense_pages(forest)
    cm = cost_model.CostModel(hq, hkv, d, page_size=page)
    lanes = 64 if case == "padding-lanes" else 16
    window = {"window24": 24, "gemma3-local": 512}.get(case, 0)
    make = plan_mod.flash_plan if case == "flash" else plan_mod.build_plan
    plan = plan_mod.pad_plan(make(forest, cm, num_lanes=lanes, max_q=32,
                                  window=window))
    return forest, plan, hq, hkv, d, window


PAC_CASES = ("codec", "flash", "padding-lanes", "window24", "g1", "g8",
             "page64", "rows-over-chunks", "d64", "d256", "kary",
             # gemma3-1b (4 query heads over 1 KV head, d 256, global and
             # 512-token window) and llama4-scout (40 over 8: group 5)
             "gemma3-global", "gemma3-local", "g5",
             # and the epilogue's wider shapes: llava-next's
             # group 7, fig13's groups 16 and 32 (also at d 256, page 32),
             # pages of 8, 24 (partial 32-token rounds), 32 and 128 (f32 KV
             # at d 256 staged 64 tokens at a time)
             "g7", "g16", "g32", "g32-page32", "page8", "page24", "page32",
             "page128", "page128-d256",
             # C8: pages past 128 (the epilogue's tail in passes of 128
             # tokens) and head dims 16, 48 and 96 (the next instance's
             # columns past d masked)
             "page256", "page1024", "d16", "d48", "d96")
PAC_TYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAC_CASES)
def test_pac_plans_on_card(case, monkeypatch):
    """On an H100: PAC against pac_torch per plan, q and KV types mixed;
    dead slots untouched; NaN from them or from unread positions never
    reaches the combined output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    forest, plan, hq, hkv, d, window = _forest_plan(case)
    if case == "padding-lanes":
        assert (plan.step_valid.sum(1) == 0).sum() > plan.num_lanes // 2
    (k_nan, v_nan), (k0, v0) = _plan_pools(forest, plan, hkv, d, seed=5)
    B = plan.num_queries
    q = np.random.default_rng(6).standard_normal((B, hq, d)).astype(
        np.float32)
    pa = ops.plan_arrays(plan, "cuda")
    live = (torch.arange(plan.max_q, device="cuda")[None, :]
            < pa.task_qnum[:, None])
    orig = pac_mod.pac
    for qdt, kvdt in PAC_TYPES:
        # bf16 KV runs on tensor cores with q and P split into hi + lo
        # bf16 terms: ~3.4e-4 measured, so 2e-3 would catch a P rounded
        # to plain bf16
        tol = 2e-3 if kvdt == torch.bfloat16 else 1e-5
        qc = torch.from_numpy(q).to("cuda", qdt)
        kn, vn, kz, vz = (torch.from_numpy(x).to("cuda", kvdt)
                          for x in (k_nan, v_nan, k0, v0))
        got = orig(qc, pa, kn, vn, window=window,
                   out=_nan_outputs(pa, hq, d))
        want = pac_mod.pac_torch(qc[pa.q_gather.long()], pa.q_pos, kz, vz,
                                 pa.task_pages, pa.task_kvlen, pa.task_pos,
                                 window=window)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g[live], w[live], rtol=tol, atol=tol)
            assert torch.isnan(g[~live]).all(), "a dead slot was written"
        monkeypatch.setattr(pac_mod, "pac", lambda q_, pa_, k_, v_, *,
                            window=0: orig(q_, pa_, k_, v_, window=window,
                                           out=_nan_outputs(pa_, hq, d)))
        comb = ops.codec_partials_arrays(qc, kn, vn, pa, B, window=window,
                                         impl="cuda")
        monkeypatch.undo()
        plain = ops.codec_partials_arrays(qc, kz, vz, pa, B, window=window,
                                          impl="torch")
        torch.cuda.synchronize()
        for g, w in zip(comb, plain):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_pac_fits_two_blocks_per_sm():
    """On an H100: at qwen3-4b's head dim PAC fits at least two blocks on
    an SM, as the library's own occupancy query reports, for both KV
    types; head dims the kernel does not take are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    lib = build.load()
    for kv_bf16 in (0, 1):
        assert lib.codec_pac_blocks_per_sm(128, kv_bf16) >= 2, kv_bf16
        for d in (16, 64, 256, 512):
            assert lib.codec_pac_smem_bytes(d, kv_bf16) > 0, (d, kv_bf16)
            assert lib.codec_pac_blocks_per_sm(d, kv_bf16) >= 1, (d, kv_bf16)
        assert lib.codec_pac_smem_bytes(1024, kv_bf16) == 0
    forest, plan, hq, hkv, _, _ = _forest_plan("codec")
    pa = ops.plan_arrays(plan, "cuda")
    for d in (130, 1024):
        q = torch.zeros(plan.num_queries, hq, d, device="cuda")
        pool = torch.zeros(4, forest.block_size, hkv, d, device="cuda")
        with pytest.raises(ValueError, match="d % 4 == 0"):
            pac_mod.pac(q, pa, pool, pool)


def _bf16_steps(got: torch.Tensor, want: torch.Tensor,
                atol: float = 1e-5) -> int:
    """Largest distance, in bf16 steps, between two bf16 tensors, over the
    elements that differ by more than ``atol``: near zero a bf16 step is
    finer than the f32 rounding both sides carry (at 1e-5 it is 6e-8)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    far = (got.float() - want.float()).abs() > atol
    steps = (ordered(got) - ordered(want)).abs()[far]
    return int(steps.max()) if steps.numel() else 0


def _tails(forest, plan):
    """Each query's tail arrays: its leaf's last page, that page's first
    position and the query's position, in the plan's row order."""
    ps = forest.block_size
    tail = np.zeros((3, plan.num_queries), np.int64)
    for i, r in enumerate(sorted(forest.request_ids)):
        leaf = forest.nodes[forest.leaf_of[r]]
        tp = (leaf.length - 1) // ps
        tail[:, i] = (leaf.page_ids[tp], leaf.start_pos + tp * ps,
                      forest.context_len(r) - 1)
    return [torch.from_numpy(x).cuda() for x in tail]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAC_CASES)
def test_por_epilogue_plans_on_card(case):
    """On an H100: the epilogue against por_epilogue_torch on PAC's raw
    partials of every PAC test plan, q and KV types mixed; NaN in dead
    slots, in the pool past each query and in the output it writes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    forest, plan, hq, hkv, d, window = _forest_plan(case)
    (k_nan, v_nan), (k0, v0) = _plan_pools(forest, plan, hkv, d, seed=7)
    B = plan.num_queries
    q = np.random.default_rng(8).standard_normal((B, hq, d)).astype(
        np.float32)
    pa = ops.plan_arrays(plan, "cuda")
    tails = _tails(forest, plan)
    for qdt, kvdt in PAC_TYPES:
        qc = torch.from_numpy(q).to("cuda", qdt)
        kn, vn, kz, vz = (torch.from_numpy(x).to("cuda", kvdt)
                          for x in (k_nan, v_nan, k0, v0))
        o, m, l = pac_mod.pac(qc, pa, kn, vn, window=window,
                              out=_nan_outputs(pa, hq, d))
        parts = ops.Parts(o.view(-1, hq, d), m.view(-1, hq), l.view(-1, hq),
                          pa.seg_offsets, pa.seg_rows)
        out = torch.full_like(qc, float("nan"))
        got = por_mod.por_epilogue(qc, *parts, kn, vn, *tails,
                                   window=window, stats=True, out=out)
        want = por_mod.por_epilogue_torch(qc, *parts, kz, vz, *tails,
                                          window=window)
        again = por_mod.por_epilogue(qc, *parts, kn, vn, *tails,
                                     window=window, stats=True)
        torch.cuda.synchronize()
        assert got[0] is out and out.dtype == qdt
        for g, w, a in zip(got, want, again):
            assert torch.isfinite(g).all()
            assert torch.equal(g, a), "two launches differ"
        if qdt == torch.bfloat16:
            # one bf16 step (or 1e-5 where a step is finer): the kernel
            # and the plain version round f32 values that differ in their
            # last bits
            assert _bf16_steps(got[0], want[0]) <= 1
        else:
            torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                       atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_por_epilogue_refuses_shapes_it_does_not_take():
    """On an H100: head dims outside the kernel's set (multiples of 16
    from 16 to 256) raise before any launch, as do wrong types; every
    such head dim, pages past 128 and other groups launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")

    def args(B=2, hq=8, hkv=2, d=128, page=16, qdt=torch.float32):
        q = torch.zeros(B, hq, d, device="cuda", dtype=qdt)
        o = torch.zeros(3, hq, d, device="cuda")
        ml = torch.zeros(3, hq, device="cuda")
        offs = torch.tensor([0, 1, 2], dtype=torch.int32, device="cuda")
        rows = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
        pool = torch.zeros(4, page, hkv, d, device="cuda")
        t = torch.zeros(B, dtype=torch.int64, device="cuda")
        return (q, o, ml, ml, offs, rows, pool, pool, t, t, t)

    lo = por_mod.epilogue_launches
    por_mod.por_epilogue(*args())
    torch.cuda.synchronize()
    assert por_mod.epilogue_launches == lo + 1
    # taken: any page, any group, every multiple of 16 up to 256
    taken = ({"page": 32}, {"page": 8}, {"hq": 18, "hkv": 2},
             {"hq": 32, "hkv": 1, "page": 128}, {"page": 256},
             {"page": 1024}, {"d": 96}, {"d": 32}, {"d": 16}, {"d": 48},
             {"d": 256, "page": 512})
    for kw in taken:
        por_mod.por_epilogue(*args(**kw))
    torch.cuda.synchronize()
    assert por_mod.epilogue_launches == lo + 1 + len(taken)
    lo += len(taken)
    for kw in ({"d": 20}, {"d": 8}, {"d": 512}, {"d": 272}):
        with pytest.raises(ValueError, match="the kernel takes"):
            por_mod.por_epilogue(*args(**kw))
    a = list(args())
    a[9] = a[9].int()   # tail_base as int32
    with pytest.raises(TypeError, match="tail_base"):
        por_mod.por_epilogue(*a)
    a = list(args())
    a[1] = a[1].half()
    with pytest.raises(TypeError, match="o_parts"):
        por_mod.por_epilogue(*a)
    assert por_mod.epilogue_launches == lo + 1


# --------------------------------------------------------------------- #
# the fused decode step (one CUDA-graph replay a token)
# --------------------------------------------------------------------- #
def _fused_model():
    """qwen3-4b at smoke widths but the epilogue kernel's smallest head
    dim (64; the smoke config's 16 is not a shape it takes), two layers,
    f32 weights from seed 0."""
    import dataclasses
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=2,
                              d_model=128, num_heads=4, num_kv_heads=2,
                              head_dim=64, d_ff=192, vocab_size=509)
    return build_model(cfg, seed=0, device="cuda", dtype=torch.float32)


def _fused_engine(model, backend, fused):
    from repro_torch.serving.engine import DecodeEngine
    return DecodeEngine(model.cfg, model, page_size=16, num_pages=256,
                        max_q=8, backend=backend, fused=fused, device="cuda")


def _crossing(eng):
    """Rows 2 -> 3 -> 5 (row buckets 2 -> 4 -> 8), then completions."""
    doc = list(range(10, 58))
    rids = [eng.add_request(doc + [100 + i], max_new=12) for i in range(2)]
    eng.step(); eng.step()
    rids.append(eng.add_request(doc + [200], max_new=9))
    eng.step(); eng.step()
    rids += [eng.add_request(doc + [210 + i], max_new=7) for i in range(2)]
    eng.run(40)
    return [list(eng.requests[r].generated) for r in rids]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["codec-cuda", "codec-torch", "flash",
                                     "hydragen"])
def test_fused_streams_equal_eager_on_card(backend):
    """On an H100: the fused engine's streams equal the eager engine's at
    f32 weights; one replay a step; one graph a bucket signature, each
    holding one PAC (codec backends) and one epilogue launch a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _fused_model()
    want = _crossing(_fused_engine(model, backend, fused=False))
    eng = _fused_engine(model, backend, fused=True)
    got = _crossing(eng)
    assert got == want
    step = eng.fused_step
    assert step.replays == eng.stats["steps"] == eng.stats["fused_calls"]
    assert step.graphs == len(eng.bucket_signatures) == eng.fused_cache_size
    assert sorted({s[0] for s in eng.bucket_signatures}) == [2, 4, 8]
    layers = model.cfg.num_layers
    pac = layers if backend != "hydragen" and backend != "codec-torch" else 0
    assert all(slot.launches == (pac, layers)
               for slot in step.slots.values())
    assert eng.stats["nonfinite_rows"] == 0
    for rid in list(eng.requests):
        eng.release(rid)
    eng.pool.allocator.check()
    assert eng.pool.num_free == eng.pool.num_pages


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 24, 32, 128, 256])
def test_engine_serves_any_page_on_card(page):
    """On an H100 (ROADMAP C7): the engine serves through fused
    ``codec-cuda`` at pages other than 16 and 64, and its
    streams equal ``codec-torch``'s (plain PAC) and the eager engine's.
    Before, ``DecodeEngine(page_size=32, backend="codec-cuda")`` admitted
    and prefilled, then raised at the first decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _fused_model()
    streams = {}
    for backend, fused in (("codec-cuda", True), ("codec-torch", True),
                           ("codec-cuda", False)):
        eng = DecodeEngine(model.cfg, model, page_size=page,
                           num_pages=4096 // page, max_q=8, backend=backend,
                           fused=fused, device="cuda")
        streams[(backend, fused)] = _crossing(eng)
        assert eng.stats["nonfinite_rows"] == 0
    assert len(set(map(str, streams.values()))) == 1, streams


@pytest.mark.cuda
def test_engine_serves_smoke_config_on_card():
    """On an H100 (ROADMAP C8): the smoke config's head dim 16, which the
    engine refused on the card before, serves through fused
    ``codec-cuda`` (PAC at d 16, the epilogue in its 32-column instance),
    its streams equal to ``codec-torch``'s (plain PAC) and the eager
    engine's at f32 weights; every decode step launched the epilogue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("qwen3-4b")
    assert cfg.head_dim == 16
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    streams = {}
    for backend, fused in (("codec-cuda", True), ("codec-torch", True),
                           ("codec-cuda", False)):
        lo = por_mod.epilogue_launches
        eng = DecodeEngine(cfg, model, page_size=16, num_pages=256, max_q=8,
                           backend=backend, fused=fused, device="cuda")
        streams[(backend, fused)] = _crossing(eng)
        assert eng.stats["nonfinite_rows"] == 0
        assert por_mod.epilogue_launches > lo
    assert len(set(map(str, streams.values()))) == 1, streams


@pytest.mark.cuda
def test_fused_epochs_of_one_signature_share_a_graph():
    """On an H100: four rows lose one to completion, gain an arrival and
    lose one again; every plan epoch keeps bucket 4 and the plan's shapes,
    so later epochs refresh the fixed buffers and replay the one graph
    captured first, with no new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    model = _fused_model()
    doc = list(range(10, 58))
    streams = {}
    for fused in (False, True):
        eng = _fused_engine(model, "codec-cuda", fused)
        for i, n in enumerate([3, 12, 12, 12]):
            eng.add_request(doc + [100 + i, 7], max_new=n)
        for _ in range(5):
            eng.step()
        eng.add_request(doc + [200, 7], max_new=4)
        streams[fused] = eng.run(32)
    assert streams[True] == streams[False]
    assert eng.stats["replans"] >= 4
    assert eng.fused_step.graphs == len(eng.bucket_signatures) == 1
    assert eng.fused_step.replays == eng.stats["steps"]


@pytest.mark.cuda
def test_por_epilogue_bucket_padded_rows_on_card():
    """On an H100: the epilogue in the fused step's form (the plan
    bucketed to 8 rows for 6 requests, the CSR padded to the plan's
    capacity, padded rows with empty segments, the trash page as tail and
    ``q_pos = -1``) equals its plain version; padded rows are zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    hq, hkv, d, page = 32, 8, 128, 16
    forest = tree.two_level(6, 300, 21, block_size=page)
    pages = plan_mod.assign_dense_pages(forest)
    rows = sorted(forest.request_ids)
    truncate = {}
    for r in rows:
        leaf = forest.nodes[forest.leaf_of[r]]
        truncate[leaf.id] = ((leaf.length - 1) // page) * page
    plan = plan_mod.bucket_plan(plan_mod.build_plan(
        forest, cost_model.CostModel(hq, hkv, d, page_size=page),
        num_lanes=16, max_q=32, req_rows={r: i for i, r in enumerate(rows)},
        truncate=truncate), 8)
    pa = ops.upload(ops.PlanArrays, ops.plan_host_arrays(plan, padded=True),
                    "cuda")
    assert pa.seg_rows.numel() > int(pa.seg_offsets[-1])
    tails = _tails(forest, plan)          # rows 6 and 7 are padding:
    tails[0][6:] = pages                  # the trash page,
    tails[2][6:] = -1                     # q_pos = -1 (tail_base 0)
    rng = np.random.default_rng(9)
    k, v = (torch.from_numpy(rng.standard_normal(
        (pages + 1, page, hkv, d)).astype(np.float32)).cuda()
        for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((8, hq, d)).astype(
        np.float32)).cuda()
    o, m, l = pac_mod.pac(q, pa, k, v, out=_nan_outputs(pa, hq, d))
    parts = ops.Parts(o.view(-1, hq, d), m.view(-1, hq), l.view(-1, hq),
                      pa.seg_offsets, pa.seg_rows)
    got = por_mod.por_epilogue(q, *parts, k, v, *tails, stats=True,
                               out=torch.full_like(q, float("nan")))
    want = por_mod.por_epilogue_torch(q, *parts, k, v, *tails)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0][6:], torch.zeros_like(got[0][6:]))


# --------------------------------------------------------------------- #
# serving under memory pressure (chunked prefill, preempt-and-recompute)
# --------------------------------------------------------------------- #
def _nan_on_free(eng):
    """Fill every page the engine frees with NaN, in stream order: a
    replay or a plan that still read a freed page would turn its logits
    non-finite or its stream away from the eager one."""
    alloc, pool = eng.pool.allocator, eng.pool
    release = alloc.release

    def release_nan(pages):
        before = alloc.num_free
        release(pages)
        freed = alloc._free[before:]
        if freed:
            idx = torch.as_tensor(freed, device=pool.k.device)
            pool.k[:, idx] = float("nan")
            pool.v[:, idx] = float("nan")
    alloc.release = release_nan


def _pressured_serve(model, backend, fused, num_pages):
    """Ten requests over a 64-token document, Poisson arrivals at 0.5 a
    step, 16-token prefill chunks, 20 tokens each."""
    from repro_torch.launch.serve import build_schedule, serve
    from repro_torch.serving.engine import DecodeEngine
    eng = DecodeEngine(model.cfg, model, page_size=16, num_pages=num_pages,
                       max_q=8, backend=backend, fused=fused,
                       prefill_chunk=16, device="cuda")
    _nan_on_free(eng)
    doc = list(range(10, 74))
    prompts = [doc + [100 + 3 * i + j for j in range(3)] for i in range(10)]
    steps = build_schedule("poisson", 0.5, np.random.default_rng(0),
                           len(prompts))
    finite = []

    def on_step(e):
        if e.step_stats[-1]["decoded"]:
            finite.append(bool(torch.isfinite(e.last_logits).all()))
    res = serve(eng, prompts, max_new=20, arrival_steps=steps,
                on_step=None if fused else on_step)
    assert finite or fused
    assert all(finite)
    assert eng.stats["nonfinite_rows"] == 0
    if fused:
        assert eng.fused_step.replays == res["steps"]
        assert eng.fused_step.graphs == len(eng.bucket_signatures) \
            == res["graphs"] == res["signatures"]
    for rid in list(eng.requests):
        eng.release(rid)
    eng.pool.allocator.check()
    assert eng.pool.num_free == eng.pool.num_pages
    assert set(eng.forest.nodes) == {0}
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["codec-cuda", "flash"])
def test_pressured_fused_equals_eager_and_unconstrained_on_card(backend):
    """On an H100: under an undersized pool whose freed pages turn NaN,
    the fused streams equal the eager ones and an unconstrained run's at
    f32 weights, preemption, chunked prefill and recomputation all fire,
    the row bucket grows and shrinks, no logit is non-finite, one graph
    is captured a signature and no page leaks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _fused_model()
    eager = _pressured_serve(model, backend, False, 12)
    fused = _pressured_serve(model, backend, True, 12)
    free = _pressured_serve(model, backend, True, 256)
    assert fused["streams"] == eager["streams"] == free["streams"]
    assert all(len(t) == 20 for t in fused["streams"].values())
    for r in (eager, fused):
        assert r["peak_pages"] == 12
        for k in ("preempted", "prefill_chunks", "recompute_tokens"):
            assert r["pressure"][k] >= 1, r["pressure"]
    assert free["pressure"]["preempted"] == 0
    b = fused["buckets"]
    assert len(set(b)) >= 3 and any(x < y for x, y in zip(b, b[1:])) \
        and any(x > y for x, y in zip(b, b[1:])), b


# --------------------------------------------------------------------- #
# the request lifecycle: the threefry sampler, the NaN guard, the cache
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_sampler_bits_and_draws_on_card_equal_the_cpu():
    """On an H100: the threefry bits, keys and uniforms on the card equal
    the CPU's bit for bit, and so do the draws at temperature 0.8, eager
    and in the compiled form (the fused step's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.serving import sampler
    key = sampler.prng_key(11)
    kc = key.to("cuda")
    assert torch.equal(sampler.split(kc, 5).cpu(), sampler.split(key, 5))
    rows = torch.arange(6)
    assert torch.equal(sampler.fold_in(kc, rows.cuda()).cpu(),
                       sampler.fold_in(key, rows))
    assert torch.equal(sampler.random_bits(kc, (4, 999)).cpu(),
                       sampler.random_bits(key, (4, 999)))
    assert torch.equal(sampler.uniform(kc, (4096,), 1e-3, 2.0).cpu(),
                       sampler.uniform(key, (4096,), 1e-3, 2.0))
    logits = torch.randn(8, 151936,
                         generator=torch.Generator().manual_seed(0)) * 4
    for compiled in (False, True):
        got = sampler.sample(logits.cuda(), kc, 0.8, compiled=compiled)
        want = sampler.sample(logits, key, 0.8, compiled=compiled)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_fused_sampled_streams_equal_eager_on_card():
    """On an H100: at temperature 0.8 the fused engine's streams equal
    the eager engine's at f32 weights (the graph splits the engine's key
    on the device, the prefills split it on the host's order), across a
    bucket crossing; they differ from the greedy streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _fused_model()
    streams = {}
    for fused, t in ((False, 0.8), (True, 0.8), (True, 0.0)):
        eng = DecodeEngine(model.cfg, model, page_size=16, num_pages=256,
                           max_q=8, fused=fused, temperature=t, seed=5,
                           device="cuda")
        streams[fused, t] = _crossing(eng)
        assert eng.stats["nonfinite_rows"] == 0
    assert streams[True, 0.8] == streams[False, 0.8]
    assert streams[True, 0.8] != streams[True, 0.0]


def _nan_run(model, at=None):
    """Three requests over a 48-token document, each with 14 private
    tokens, 10 new tokens each, fused; ``at``: the step of a
    ``nan_logits`` fault on request 1, under the NaN guard."""
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    plan = (None if at is None
            else FaultPlan([FaultSpec("nan_logits", at, rid=1)]))
    eng = DecodeEngine(model.cfg, model, page_size=16, num_pages=256,
                       max_q=8, fused=True, nan_guard=at is not None,
                       faults=plan, device="cuda")
    doc = list(range(10, 58))
    for i in range(3):
        eng.add_request(doc + list(range(300 + 20 * i, 314 + 20 * i)),
                        max_new=10)
    return eng, eng.run(40)


@pytest.mark.cuda
def test_fused_nan_guard_quarantines_one_row_on_card():
    """On an H100: a NaN written into one live K slot of one request's
    private leaf reaches its logits, the graph's finite flag quarantines
    it as ``nan_logits``, and the other rows' streams equal a fault-free
    run's.  At step 2 the slot (the leaf's 16th) lies in a full page,
    which PAC reads; at step 5 in the tail page, which the epilogue
    reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _fused_model()
    _, want = _nan_run(model)
    for at in (2, 5):
        eng, got = _nan_run(model, at)
        assert eng.requests[1].finish_reason == "nan_logits", at
        assert got[1] == want[1][:len(got[1])] and len(got[1]) < 10
        assert got[0] == want[0] and got[2] == want[2], at
        assert eng.stats["nan_rows"] == 1
        eng.check()
        assert eng.shutdown()["used_pages"] == 0


# --------------------------------------------------------------------- #
# telemetry's sampled profiling and cascade prefill
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_profiled_fused_step_captures_the_same_graphs_on_card():
    """On an H100: with ``Telemetry(profile_every=2)`` the fused engine
    captures as many graphs, each with the same PAC and epilogue
    launches, and replays once a step as with telemetry off; the streams
    are equal at f32, and only the sampled steps carry a device wait."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.telemetry import Telemetry
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _fused_model()
    runs = {}
    for tm in (None, Telemetry(profile_every=2)):
        eng = DecodeEngine(model.cfg, model, page_size=16, num_pages=256,
                           max_q=8, fused=True, telemetry=tm, device="cuda")
        streams = _crossing(eng)
        step = eng.fused_step
        runs[tm is None] = (streams, step.graphs, step.replays,
                            [s.launches for s in step.slots.values()],
                            sorted(eng.bucket_signatures, key=str))
        if tm is not None:
            decode = [s for s in eng.step_stats if "dispatch_time" in s]
            sampled = [s for s in decode if s.get("profiled")]
            assert sampled and len(sampled) < len(decode)
            assert all(s["compute_time"] > 0 for s in sampled)
            assert all("compute_time" not in s for s in decode
                       if not s.get("profiled"))
    assert runs[True] == runs[False]
    assert runs[True][1] == len(runs[True][4]) >= 3


@pytest.mark.cuda
def test_batched_suffix_prefill_writes_the_sequential_slots_on_card():
    """On an H100: cascade prefill's padded batch writes the same K/V into
    the same pool slots as per-request prefill (f32, within 1e-5), and
    the streams are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _fused_model()
    # the decoy takes the first four 32-token budgets while the questions
    # queue; the 80-token document ends mid budget, so the suffixes batch
    doc = list(range(10, 10 + 80))
    decoy = list(range(300, 300 + 128))
    prompts = [decoy] + [doc + [110 + 7 * i + j for j in range(3 + i)]
                         for i in range(4)]
    out = {}
    for cascade in (False, True):
        eng = DecodeEngine(model.cfg, model, page_size=16, num_pages=256,
                           max_q=8, prefill_chunk=32, cascade=cascade,
                           device="cuda")
        rids = [eng.add_request(p, max_new=4) for p in prompts]
        while any(eng.requests[r].state in ("waiting", "prefill")
                  for r in rids):
            eng.step()
        # every prompt's K/V, read back through its forest path
        kv = {}
        for r in rids:
            n = len(prompts[rids.index(r)])
            path = eng.forest.path(r)
            ks, vs = zip(*(eng._gather_prefix_upto(la, path, n)
                           for la in range(model.cfg.num_layers)))
            kv[r] = (torch.stack(ks), torch.stack(vs))
        streams = eng.run(32)
        out[cascade] = (kv, {r: list(streams[r]) for r in rids}, eng.stats)
    (kv0, s0, _), (kv1, s1, st) = out[False], out[True]
    assert st["cascade_batches"] >= 1 and st["cascade_groups"] >= 1, st
    assert s1 == s0
    for r in kv0:
        for a, b in zip(kv0[r], kv1[r]):
            assert torch.isfinite(b).all()
            assert (a - b).abs().max().item() <= 1e-5, r


# --------------------------------------------------------------------- #
# tree-speculative decoding: the verify plan and the fused verify step
# --------------------------------------------------------------------- #
def _verify_forest(page=16, requests=8, doc=300, tail=37):
    """A verify step's forest: ``requests`` requests over a shared
    document, each with a partial private tail and a draft tree of six
    one-token nodes (a chain of four and a sibling chain of two, so two
    siblings share each of the first two positions), each draft node with
    its virtual query; 8 x 7 = 56 query rows.  Returns (forest, rows)."""
    f = tree.PrefixForest(page)
    trunk = f.add_node(tree.ROOT_ID, doc)
    rows, virt = {}, -2
    for r in range(requests):
        leaf = f.add_node(trunk.id, tail + r)
        f.attach_request(r, leaf.id)
        rows[r] = len(rows)
        for chain in ([11, 12, 13, 14], [21, 22]):
            parent = leaf.id
            for tok in chain:
                node = f.add_draft(parent, tok + r)
                f.attach_request(virt, node.id)
                rows[virt] = len(rows)
                virt -= 1
                parent = node.id
    plan_mod.assign_dense_pages(f)
    return f, rows


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["codec", "flash"])
def test_pac_and_epilogue_over_verify_plan_on_card(kind):
    """On an H100: PAC over a verify plan (a shared-document task of 56
    rows split into 32-row slices, partial tail pages read by the base
    query and every draft query of their request, one-token draft pages
    whose siblings share a position) against pac_torch, then the epilogue
    with no tail against its plain version, in the fused step's form
    (bucket 64: padded rows with empty segments and ``q_pos = -1`` come
    out zero); q and KV types mixed, NaN in every dead slot of the pool
    and of PAC's outputs and in the output the epilogue writes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    hq, hkv, d = 32, 8, 128
    forest, rows = _verify_forest()
    cm = cost_model.CostModel(hq, hkv, d, page_size=16)
    plan = plan_mod.bucket_plan(plan_mod.build_verify_plan(
        forest, cm, rows, num_lanes=16, max_q=32, kind=kind), 64)
    assert len(rows) == 56 and plan.num_queries == 64
    valid = plan.step_valid.astype(bool)
    assert 1 in plan.step_kvlen[valid]           # one-token draft pages
    if kind == "codec":     # the document's 56 rows, in slices of <= 32
        assert 7 < plan.task_qnum.max() <= 32
    pa = ops.upload(ops.PlanArrays, ops.plan_host_arrays(plan, padded=True),
                    "cuda")
    (k_nan, v_nan), (k0, v0) = _plan_pools(forest, plan, hkv, d, seed=31)
    q = np.random.default_rng(32).standard_normal((64, hq, d)).astype(
        np.float32)
    live = (torch.arange(plan.max_q, device="cuda")[None, :]
            < pa.task_qnum[:, None])
    for qdt, kvdt in PAC_TYPES:
        tol = 2e-3 if kvdt == torch.bfloat16 else 1e-5
        qc = torch.from_numpy(q).to("cuda", qdt)
        kn, vn, kz, vz = (torch.from_numpy(x).to("cuda", kvdt)
                          for x in (k_nan, v_nan, k0, v0))
        o, m, l = pac_mod.pac(qc, pa, kn, vn, out=_nan_outputs(pa, hq, d))
        want = pac_mod.pac_torch(qc[pa.q_gather.long()], pa.q_pos, kz, vz,
                                 pa.task_pages, pa.task_kvlen, pa.task_pos)
        torch.cuda.synchronize()
        for g, w in zip((o, m, l), want):
            torch.testing.assert_close(g[live], w[live], rtol=tol, atol=tol)
            assert torch.isnan(g[~live]).all(), "a dead slot was written"
        parts = ops.Parts(o.view(-1, hq, d), m.view(-1, hq), l.view(-1, hq),
                          pa.seg_offsets, pa.seg_rows)
        out = torch.full_like(qc, float("nan"))
        got = por_mod.por_epilogue(qc, *parts, kn, None, None, None, None,
                                   stats=True, out=out, tail=False)
        plain = por_mod.por_epilogue_torch(qc, *parts, None, None, None,
                                           None, None, tail=False)
        again = por_mod.por_epilogue(qc, *parts, kn, None, None, None, None,
                                     stats=True, tail=False)
        torch.cuda.synchronize()
        assert got[0] is out and out.dtype == qdt
        for g, w, a in zip(got, plain, again):
            assert torch.isfinite(g).all()
            assert torch.equal(g, a), "two launches differ"
        assert torch.equal(got[0][56:], torch.zeros_like(got[0][56:]))
        if qdt == torch.bfloat16:
            assert _bf16_steps(got[0], plain[0]) <= 1
        else:
            torch.testing.assert_close(got[0], plain[0], rtol=1e-5,
                                       atol=1e-5)
        for g, w in zip(got[1:], plain[1:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # the no-tail mode still refuses a head dim it does not take (d 20:
    # not a multiple of 16)
    q20 = torch.zeros(4, 4, 20, device="cuda")
    idx = torch.arange(5, dtype=torch.int32, device="cuda")
    p20 = ops.Parts(torch.zeros(4, 4, 20, device="cuda"),
                    torch.zeros(4, 4, device="cuda"),
                    torch.zeros(4, 4, device="cuda"), idx, idx[:4])
    with pytest.raises(ValueError, match="the kernel takes"):
        por_mod.por_epilogue(q20, *p20, None, None, None, None, None,
                             tail=False)


def _spec_model(layers):
    """Phase 6's f32 qwen3-4b at the fused tests' small widths (head dim
    64), ``layers`` deep."""
    import dataclasses
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=layers,
                              d_model=128, num_heads=4, num_kv_heads=2,
                              head_dim=64, d_ff=192, vocab_size=509)
    return build_model(cfg, seed=0, device="cuda", dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["codec-cuda", "flash", "hydragen"])
def test_spec_streams_and_verify_graphs_on_card(backend):
    """On an H100, at full depth (36 layers, small widths, f32): greedy
    streams of the speculative engine, eager and fused, equal plain
    greedy decode; drafts are accepted; the fused engine replays one graph
    a verify step and captures one a verify signature, each holding 36
    PAC launches (codec backends) and 36 no-tail epilogue launches; no
    page, node or draft is left."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _spec_model(36)
    doc = ([5, 7, 11, 13] * 16)[:60]
    prompts = [doc + [100 + i, 7 + i] for i in range(4)]
    streams, engines = {}, {}
    for mode in ("plain", "eager", "fused"):
        eng = DecodeEngine(model.cfg, model, page_size=16, num_pages=256,
                           max_q=8, backend=backend, fused=mode == "fused",
                           speculative=mode != "plain", device="cuda")
        rids = [eng.add_request(p, max_new=24) for p in prompts]
        eng.run(80)
        streams[mode] = [list(eng.requests[r].generated) for r in rids]
        engines[mode] = eng
        eng.check()
        assert not eng._drafts
    assert streams["eager"] == streams["plain"]
    assert streams["fused"] == streams["plain"]
    eng = engines["fused"]
    st, step = eng.stats, eng.spec_step
    assert st["spec_accepted"] >= 1 and st["spec_steps"] < 24
    assert step.replays == st["spec_steps"] == st["fused_calls"]
    assert step.graphs == len(eng.bucket_signatures) == eng.fused_cache_size
    pac = 36 if backend != "hydragen" else 0
    assert all(slot.launches == (pac, 36) for slot in step.slots.values())
    for eng in engines.values():
        for rid in list(eng.requests):
            eng.release(rid)
        eng.pool.allocator.check()
        assert eng.pool.num_free == eng.pool.num_pages
        assert set(eng.forest.nodes) == {0}


# --------------------------------------------------------------------- #
# the model families beyond the dense subset
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_gemma3_full_width_fused_equals_eager_on_card():
    """On an H100: gemma3-1b at full width (4 query heads over 1 KV head,
    head dim 256, GeGLU, embed scale), 6 layers (five 512-token windows
    and one global layer), f32 weights: fused streams equal eager ones
    over a document past the window; each graph holds 6 PAC and 6
    epilogue launches and one plan slot a window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=6)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(0)
    doc = rng.integers(0, cfg.vocab_size, 700).tolist()
    prompts = [doc + rng.integers(0, cfg.vocab_size, 9).tolist()
               for _ in range(3)]
    streams = {}
    for fused in (False, True):
        eng = DecodeEngine(cfg, model, page_size=16, num_pages=256,
                           max_q=8, backend="codec-cuda", fused=fused,
                           device="cuda")
        rids = [eng.add_request(p, max_new=20) for p in prompts]
        eng.run(40)
        streams[fused] = [list(eng.requests[r].generated) for r in rids]
    assert streams[True] == streams[False]
    assert all(len(s) == 20 for s in streams[True])
    assert eng._windows() == [0, 512]
    assert all(slot.launches == (6, 6)
               for slot in eng.fused_step.slots.values())
    assert all([w for w, *_ in sig[1:]] == [0, 512]
               for sig in eng.bucket_signatures)


@pytest.mark.cuda
def test_apply_moe_replays_in_a_cuda_graph_on_card():
    """On an H100: ``apply_moe`` (16 experts, top-1, capacity 1.25, bf16
    weights) captured in a CUDA graph and replayed on new inputs equals
    the eager call bit for bit, drops included: nothing in it syncs the
    host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              d_model=512, d_ff=1024)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ffn = L.MoE(cfg, device="cuda", dtype=torch.bfloat16)
    for name, p in ffn.named_parameters():
        p.data = (torch.randn(p.shape, generator=gen, device="cuda")
                  * p.shape[0] ** -0.5).to(p.dtype)
    x = torch.randn(8, 1, cfg.d_model, generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        L.apply_moe(ffn, cfg, x)                      # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, aux = L.apply_moe(ffn, cfg, x)
    dropped = 0
    for seed in (1, 2, 3):
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        graph.replay()
        want, want_aux = L.apply_moe(ffn, cfg, x)
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16 and torch.equal(y, want), seed
        assert torch.equal(aux, want_aux), seed
        _, _, _, pos, cap = L.moe_route(ffn, cfg, x.reshape(1, 8, -1))
        assert cap == 1, cap
        dropped += int((pos >= cap).sum())
    assert dropped > 0     # 8 tokens over 16 one-slot queues collide


@pytest.mark.cuda
def test_window_pruning_keeps_shorter_querys_pages_on_card():
    """On an H100: gemma3-1b at full width, 6 layers, f32 weights; two
    requests over one 700-token document at unequal positions (a 1-token
    and a 300-token tail) share the document's tasks under the 512-token
    window.  ``codec-cuda`` eager and fused give the dense ``prefill`` +
    ``decode_step`` streams (a plan pruned against the larger position
    drops pages the shorter request still sees)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (build_model, decode_step,
                                                prefill)
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3-1b"), num_layers=6)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(21)
    doc = rng.integers(1, cfg.vocab_size, 700).tolist()
    prompts = [doc + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (1, 300)]
    new = 12
    dense = []
    for p in prompts:
        logits, cache, clen = prefill(model, torch.tensor([p], device="cuda"),
                                      len(p) + new)
        out = []
        for _ in range(new):
            out.append(int(torch.argmax(logits[0])))
            logits, cache = decode_step(
                model, torch.tensor([[out[-1]]], device="cuda"), cache, clen)
            clen = clen + 1
        dense.append(out)
    for fused in (False, True):
        eng = DecodeEngine(cfg, model, page_size=16, num_pages=256,
                           max_q=8, num_lanes=4, backend="codec-cuda",
                           fused=fused, device="cuda")
        rids = [eng.add_request(p, max_new=new) for p in prompts]
        eng.run(new + 4)
        assert [list(eng.requests[r].generated) for r in rids] == dense, \
            fused


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_mamba_fused_carry_equals_eager_on_card(arch):
    """On an H100, f32 weights, 2 Mamba-2 layers at mamba2's width (or one
    jamba period at 1024 wide): five requests over a shared document,
    finishing apart so the fused step crosses buckets 8 -> 4 -> 2 -> 1;
    the graphs step the SSM carry in place and give eager's streams; the
    shared node carries the SSM state; jamba's graphs hold one PAC and
    one epilogue launch, mamba2's none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if arch == "mamba2-2.7b":
        cfg, n_attn = dataclasses.replace(cfg, num_layers=2), 0
    else:
        cfg, n_attn = dataclasses.replace(
            cfg, num_layers=8, d_model=1024, num_heads=8, num_kv_heads=2,
            d_ff=2048, capacity_factor=0.0), 1
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(3)
    doc = rng.integers(1, cfg.vocab_size, 300).tolist()
    prompts = [doc + rng.integers(1, cfg.vocab_size, 5).tolist()
               for _ in range(5)]
    streams = {}
    for fused in (False, True):
        eng = DecodeEngine(cfg, model, page_size=16, num_pages=256,
                           max_q=8, backend="codec-cuda", fused=fused,
                           device="cuda")
        rids = [eng.add_request(p, max_new=6 + 3 * i)
                for i, p in enumerate(prompts)]
        eng.run(40)
        streams[fused] = [list(eng.requests[r].generated) for r in rids]
        assert any("ssm" in n.meta for n in eng.forest.real_nodes()
                   if len(n.requests) == len(prompts))
    assert streams[True] == streams[False]
    step = eng.fused_step
    assert step.graphs == len(eng.bucket_signatures) >= 3
    assert all(slot.launches == (n_attn, n_attn)
               for slot in step.slots.values())
