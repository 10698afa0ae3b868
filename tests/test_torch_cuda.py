"""The CUDA kernels (PAC, POR, the POR epilogue, flash_decode) against
their plain torch versions, on the card.

PAC is held on the plans that stress its ring and its row chunks: the
codec and flash plans at full width, lanes with nothing but padding, last
pages shorter than the page, a window crossing page edges, groups 1, 4
and 8, pages 16 and 64, head dims 64 to 256, and more rows in a task than
one block holds.  The kernel reads a pool whose every position no plan
step covers is NaN, and writes into outputs filled with NaN: live slots
must match the plain version (which reads zeros there), dead slots must
still hold NaN, and the combined output must stay finite.  The epilogue
takes the same plans, PAC's raw partials with NaN in every dead slot, and
each request's last page as its tail (NaN past the request's position),
writes into an output filled with NaN, and gives the same bits twice.

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
    kv_len, GQA 4 and 1, q and KV types mixed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    rng = np.random.default_rng(23 + window)
    L, d = 700, 128
    lens = torch.tensor([L, 1, 333, 0], dtype=torch.int32, device="cuda")
    for hq, hkv in ((32, 8), (8, 8)):
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
    page = 64 if case == "page64" else 16
    hq, hkv, d = {"g1": (8, 8, 128), "g8": (32, 4, 128), "d64": (8, 8, 64),
                  "d256": (8, 1, 256)}.get(case, (32, 8, 128))
    forest = {
        "padding-lanes": lambda: tree.two_level(2, 40, 9, block_size=page),
        "window24": lambda: tree.two_level(4, 100, 30, block_size=page),
        "rows-over-chunks": lambda: tree.two_level(24, 100, 20,
                                                   block_size=page),
        "page64": lambda: tree.two_level(8, 300, 70, block_size=page),
        "kary": lambda: tree.full_kary(3, 3, 40, block_size=page),
    }.get(case, lambda: tree.two_level(8, 200, 37, block_size=page))()
    plan_mod.assign_dense_pages(forest)
    cm = cost_model.CostModel(hq, hkv, d, page_size=page)
    lanes = 64 if case == "padding-lanes" else 16
    window = 24 if case == "window24" else 0
    make = plan_mod.flash_plan if case == "flash" else plan_mod.build_plan
    plan = plan_mod.pad_plan(make(forest, cm, num_lanes=lanes, max_q=32,
                                  window=window))
    return forest, plan, hq, hkv, d, window


PAC_CASES = ("codec", "flash", "padding-lanes", "window24", "g1", "g8",
             "page64", "rows-over-chunks", "d64", "d256", "kary")
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
    """On an H100: head dims, pages and groups outside the kernel's set
    raise before any launch, as do wrong types."""
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
    for kw in ({"d": 96}, {"d": 32}, {"d": 512}, {"page": 32},
               {"hq": 18, "hkv": 2}):
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
