"""The mesh's kernels and step on the card: the epilogue's tail-owner flag
and float32 output against the plain version, the cross-shard POR merge
on ``codec_por`` against its CPU twin, the layer's merge kernel
``codec_mesh_merge`` against its plain version and against the stacked
butterfly on ``codec_por`` (D = 2, 4, 8, 32 and 64: past 16 shards in
blocks of 16), and mesh engines against the single-device
fused engine.

Needs an NVIDIA GPU and ``nvcc`` (the kernels are built on first use);
skips elsewhere.  Run on the card with
``python -m pytest --noconftest -q -m cuda tests/test_torch_mesh_cuda.py``.
Imports only torch and the port, so it runs where ``jax`` is not
installed.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import ops, pac as pac_mod, por as por_mod
from repro_torch.kernels.ref import MASK_VALUE

TYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
         (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 24])
def test_epilogue_owner_and_f32_on_card(window):
    """On an H100, at one model shard of qwen3-4b on a 2x2 mesh (16 query
    heads over 4 KV heads, d 128): rows whose owner flag is 0 take the POR
    identity as their tail and never read it (their tail pages are NaN),
    ``o`` comes out in float32 for every q type, equal to the plain
    version at 1e-5, and two launches give the same bits."""
    _need_card()
    page, hq, hkv, d = 16, 16, 4, 128
    forest = tree.two_level(6, 100, 30, block_size=page)
    plan_mod.assign_dense_pages(forest)
    rows = sorted(forest.request_ids)
    truncate = {}
    for r in rows:
        leaf = forest.nodes[forest.leaf_of[r]]
        truncate[leaf.id] = ((leaf.length - 1) // page) * page
    plan = plan_mod.bucket_plan(plan_mod.build_plan(
        forest, cost_model.CostModel(hq, hkv, d, page_size=page),
        num_lanes=16, max_q=32, window=window, truncate=truncate), 8)
    npages = 1 + max(p for n in forest.real_nodes() for p in n.page_ids)
    rng = np.random.default_rng(4)
    k = rng.standard_normal((npages + 1, page, hkv, d)).astype(np.float32)
    v = rng.standard_normal((npages + 1, page, hkv, d)).astype(np.float32)
    tail = np.zeros((3, 8), np.int64)
    tail[0] = npages                      # padded rows: a trash page
    tail[2] = -1
    for i, r in enumerate(rows):
        leaf = forest.nodes[forest.leaf_of[r]]
        tp = (leaf.length - 1) // page
        tail[:, i] = (leaf.page_ids[tp], leaf.start_pos + tp * page,
                      forest.context_len(r) - 1)
    owner = np.array([1, 0, 1, 1, 0, 1, 0, 0], np.int64)
    k_nan, v_nan = k.copy(), v.copy()
    for i in np.nonzero(owner[:len(rows)] == 0)[0]:
        k_nan[tail[0, i]] = np.nan
        v_nan[tail[0, i]] = np.nan
    tails = [torch.from_numpy(x).cuda() for x in tail]
    own = torch.from_numpy(owner).cuda()
    q = np.random.default_rng(5).standard_normal((8, hq, d)).astype(
        np.float32)
    pa = ops.plan_arrays(plan, "cuda")
    for qdt, kvdt in TYPES:
        qc = torch.from_numpy(q).to("cuda", qdt)
        kn, vn, kz, vz = (torch.from_numpy(x).to("cuda", kvdt)
                          for x in (k_nan, v_nan, k, v))
        o, m, l = pac_mod.pac(qc, pa, kz, vz, window=window)
        parts = ops.Parts(o.view(-1, hq, d), m.view(-1, hq), l.view(-1, hq),
                          pa.seg_offsets, pa.seg_rows)
        out = torch.full(qc.shape, float("nan"), device="cuda")
        got = por_mod.por_epilogue(qc, *parts, kn, vn, *tails, window=window,
                                   stats=True, owner=own, o_f32=True,
                                   out=out)
        again = por_mod.por_epilogue(qc, *parts, kn, vn, *tails,
                                     window=window, stats=True, owner=own,
                                     o_f32=True)
        want = por_mod.por_epilogue_torch(qc, *parts, kz, vz, *tails,
                                          window=window, owner=own,
                                          o_f32=True)
        torch.cuda.synchronize()
        assert got[0] is out and out.dtype == torch.float32
        for g, w, a in zip(got, want, again):
            assert torch.isfinite(g).all()
            assert torch.equal(g, a), "two launches differ"
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        # a non-owner's result is its segment's alone
        seg = por_mod.por_epilogue_torch(qc, *parts, None, None, None, None,
                                         None, tail=False, o_f32=True)
        for i in np.nonzero(owner[:len(rows)] == 0)[0]:
            torch.testing.assert_close(got[0][i], seg[0][i], rtol=1e-5,
                                       atol=1e-5)
            assert torch.equal(got[1][i], seg[1][i])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_por_subgroup_merge_on_card(D):
    """On an H100: the stacked subgroup merge (merge rounds on the CUDA
    ``codec_por``, copy rounds as selects) against the same function on
    the CPU for every contributor pattern: 1e-6, the same ``m`` bits, and
    a single contributor's partials bitwise on every shard; one
    ``codec_por`` launch a merge round."""
    _need_card()
    rng = np.random.default_rng(D)
    for mask in itertools.product([False, True], repeat=D):
        if not any(mask):
            continue
        o = rng.standard_normal((D, 2, 8, 3, 128)).astype(np.float32)
        m = (3 * rng.standard_normal((D, 2, 8, 3))).astype(np.float32)
        l = rng.uniform(0.5, 4.0, (D, 2, 8, 3)).astype(np.float32)
        for s in range(D):
            if not mask[s]:
                o[s], m[s], l[s] = 0.0, MASK_VALUE, 0.0
        c = np.asarray(mask, np.int64)
        cpu = por_mod.por_subgroup_merge(
            *(torch.from_numpy(x) for x in (o, m, l)), torch.from_numpy(c))
        n0 = por_mod.launches
        got = por_mod.por_subgroup_merge(
            *(torch.from_numpy(x).cuda() for x in (o, m, l)),
            torch.from_numpy(c).cuda())
        torch.cuda.synchronize()
        assert por_mod.launches - n0 == (D - 1).bit_length()
        for g, w in zip(got, cpu):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)
        assert torch.equal(got[1].cpu(), cpu[1])
        if sum(mask) == 1:
            src = mask.index(True)
            for g, x in zip(got, (o, m, l)):
                for s in range(D):
                    assert torch.equal(g[s].cpu(), torch.from_numpy(x[src]))


def _merge_patterns(D, rng):
    """Every contributor pattern for D <= 4; for D = 8 each lone
    contributor, every shard, aligned blocks and a few drawn at random;
    past 16 shards (blocks of 16 combined in the tree's order) lone
    contributors in the first, a middle and the last block, the first and
    last aligned blocks of 2, 16 and D / 2 shards, every shard, a pair
    across the middle and a few drawn at random."""
    if D <= 4:
        return [m for m in itertools.product([False, True], repeat=D)
                if any(m)]
    if D > 16:
        pats = [tuple(s == i for s in range(D))
                for i in (0, 1, D // 2 + 3, D - 1)]
        pats += [tuple(s // k == j for s in range(D))
                 for k in (2, 16, D // 2) for j in (0, D // k - 1)]
        pats += [(True,) * D,
                 tuple(s in (D // 2 - 1, D // 2) for s in range(D))]
        while len(pats) < 20:
            m = tuple(bool(x) for x in rng.integers(0, 2, D))
            if any(m):
                pats.append(m)
        return pats
    pats = [tuple(s == i for s in range(D)) for i in range(D)]
    pats += [tuple(s // k == j for s in range(D))
             for k in (2, 4) for j in range(D // k)]
    pats.append((True,) * D)
    while len(pats) < 2 * D + 12:
        m = tuple(bool(x) for x in rng.integers(0, 2, D))
        if any(m):
            pats.append(m)
    return pats


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256, 16, 48, 96])
@pytest.mark.parametrize("D", [2, 4, 8, 32, 64])
def test_mesh_merge_on_card(D, hd):
    """On an H100: ``codec_mesh_merge`` over M = 1, 2 model shards, 12
    heads (two head blocks), bf16 and f32 output, 1, 2, 3 and 7 merged
    rows of 8 (Bm = 1, 2, 4 and 8 = B, the last two padded): one launch a
    call and no ``codec_por``; against its plain version on the card at
    1e-6 with ``m`` bitwise; bitwise equal to shard 0's rows of the
    stacked butterfly on ``codec_por``; a lone contributor's partials
    verbatim; rows not merged are shard 0's, cast; bf16 is the f32
    result cast; two launches give the same bits.  hd 16, 48 and 96 (C8)
    run in the next instance, the lanes past hd reading and writing
    nothing."""
    _need_card()
    from repro_torch.distributed.step_fn import sharded_step_base
    rng = np.random.default_rng(100 * D + hd)
    B, h = 8, 12
    for M in (1, 2):
        for n in (1, 2, 3, 7):
            rows = sorted(rng.choice(B, n, replace=False).tolist())
            keep = [r for r in range(B) if r not in rows]
            for mask in _merge_patterns(D, rng):
                c = np.asarray(mask, np.int64)
                base = sharded_step_base(
                    [0] * B, [0] * B, np.zeros((D, B), np.int64), [0] * B,
                    [0] * B, np.ones((D, B), np.int64), rows, c, B, 0)
                gi, si, ct = (torch.from_numpy(x).cuda()
                              for x in base[7:10])
                o = rng.standard_normal((D, M, B, h, hd)).astype(np.float32)
                m = (3 * rng.standard_normal((D, M, B, h))).astype(
                    np.float32)
                l = rng.uniform(0.5, 4.0, (D, M, B, h)).astype(np.float32)
                for s in range(D):
                    if not mask[s]:
                        o[s], m[s], l[s] = 0.0, MASK_VALUE, 0.0
                o, m, l = (torch.from_numpy(x).cuda() for x in (o, m, l))
                n0, p0 = por_mod.mesh_merge_launches, por_mod.launches
                got = por_mod.mesh_merge(o, m, l, gi, si, ct, torch.float32,
                                         stats=True)
                bf = por_mod.mesh_merge(o, m, l, gi, si, ct, torch.bfloat16)
                again = por_mod.mesh_merge(o, m, l, gi, si, ct,
                                           torch.float32, stats=True)
                assert por_mod.mesh_merge_launches - n0 == 3
                assert por_mod.launches == p0
                plain = por_mod.mesh_merge_torch(o, m, l, gi, si, ct,
                                                 torch.float32, stats=True)
                stacked = por_mod.por_subgroup_merge(
                    o[:, :, gi], m[:, :, gi], l[:, :, gi], ct)
                torch.cuda.synchronize()
                key = (M, n, mask)
                assert bf.dtype == torch.bfloat16
                assert torch.equal(bf, got[0].to(torch.bfloat16)), key
                for g, a, p, st, x in zip(got, again, plain, stacked,
                                          (o, m, l)):
                    assert torch.equal(g, a), key
                    torch.testing.assert_close(g, p, rtol=1e-6, atol=1e-6)
                    assert torch.equal(g[:, rows], st[0][:, :n]), key
                    assert torch.equal(g[:, keep], x[0][:, keep]), key
                    if sum(mask) == 1:
                        src = mask.index(True)
                        assert torch.equal(g[:, rows], x[src][:, rows])
                assert torch.equal(got[1], plain[1]), key


def _mesh_model():
    """qwen3-4b at small widths with the epilogue's smallest head dim,
    4 query heads over 2 KV heads (a 2-way model axis leaves 2 over 1),
    two layers, f32 weights from seed 0."""
    import dataclasses
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.models.transformer import build_model
    cfg = dataclasses.replace(get_config(PAPER_ARCH), num_layers=2,
                              d_model=128, num_heads=4, num_kv_heads=2,
                              head_dim=64, d_ff=192, vocab_size=509)
    return build_model(cfg, seed=0, device="cuda", dtype=torch.float32)


def _serve(model, mesh=None, temperature=0.0):
    from repro_torch.serving.engine import DecodeEngine
    eng = DecodeEngine(model.cfg, model, page_size=16, num_pages=128,
                       max_q=8, backend="codec-cuda", fused=True, mesh=mesh,
                       seq_split_pages=1 if mesh is not None else 0,
                       temperature=temperature, device="cuda")
    doc = list(range(10, 90))
    rids = [eng.add_request(doc + [100 + i], max_new=12) for i in range(3)]
    eng.step(); eng.step()
    rids.append(eng.add_request(doc + [200], max_new=9))
    eng.run(40)
    return eng, [list(eng.requests[r].generated) for r in rids]


@pytest.mark.cuda
def test_mesh_streams_equal_fused_on_card():
    """On an H100: at f32 weights every mesh's streams (greedy and at
    temperature 0.7) equal the single-device fused engine's; one graph a
    signature, each holding D x M PAC and epilogue launches a layer and,
    where rows span shards, one ``codec_mesh_merge`` launch a layer and
    no ``codec_por``; no page leaks on any shard."""
    _need_card()
    from repro_torch.distributed import decode_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _mesh_model()
    layers = model.cfg.num_layers
    for temperature in (0.0, 0.7):
        _, want = _serve(model, temperature=temperature)
        for d, m in ((1, 1), (2, 1), (1, 2), (2, 2)):
            eng, got = _serve(model, decode_mesh(d, m), temperature)
            assert got == want, (d, m, temperature)
            step = eng.fused_step
            assert step.replays == eng.stats["steps"]
            assert step.graphs == len(eng.bucket_signatures)
            merged = False
            for sig, slot in step.slots.items():
                assert slot.launches == (layers * d * m,) * 2, sig
                bm = sig[-1][1]
                assert slot.por_launches == 0, sig
                assert slot.merge_launches == (layers if bm else 0), sig
                merged |= bm > 0
            assert merged == (d > 1)
            for r in list(eng.requests):
                eng.release(r)
            eng.pool.allocator.check()
            assert eng.pool.num_free == eng.pool.num_pages
