"""The port's PAC / POR / segment combine against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The
port's kernel wrappers take their plain torch path here (CPU tensors);
``repro``'s Pallas kernels run in interpret mode.  The CUDA kernels
themselves are held against their plain versions on the card in
``test_torch_cuda.py``.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import por as jpor
from repro.kernels import ref as jref
from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import ops, pac as pac_mod, por as por_mod, ref


def _pool(forest, n_kv, d, seed, dtype=np.float32):
    pages = plan_mod.assign_dense_pages(forest)
    rng = np.random.default_rng(seed)
    ps = forest.block_size
    k = rng.standard_normal((pages, ps, n_kv, d)).astype(dtype)
    v = rng.standard_normal((pages, ps, n_kv, d)).astype(dtype)
    return k, v


def _both(q, k, v, plan, window=0, bf16=False):
    """(port codec-cuda CPU path, repro Pallas interpret) outputs, f32."""
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    o_j = jops.codec_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), plan, impl="pallas",
                               window=window)
    o_t = ops.codec_attention(torch.from_numpy(q).to(tdt),
                              torch.from_numpy(k).to(tdt),
                              torch.from_numpy(v).to(tdt), plan,
                              impl="cuda", window=window)
    return o_t.float().numpy(), np.asarray(o_j, np.float32)


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 16), (8, 1, 32), (6, 6, 8)])
@pytest.mark.parametrize("page", [16, 64])
def test_pac_matches_pallas(hq, hkv, d, page):
    f = tree.two_level(4, 3 * page, page + 3, block_size=page)
    k, v = _pool(f, hkv, d, seed=page + hq)
    p = plan_mod.build_plan(f, cost_model.CostModel(hq, hkv, d,
                                                    page_size=page),
                            num_lanes=2, max_q=8)
    q = np.random.default_rng(3).standard_normal((4, hq, d)).astype(
        np.float32)
    got, want = _both(q, k, v, p)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pac_bf16_matches_pallas():
    page, hq, hkv, d = 32, 4, 2, 16
    f = tree.two_level(3, 2 * page, page, block_size=page)
    k, v = _pool(f, hkv, d, seed=5)
    p = plan_mod.build_plan(f, cost_model.CostModel(hq, hkv, d,
                                                    page_size=page),
                            num_lanes=2, max_q=4)
    q = np.random.default_rng(5).standard_normal((3, hq, d)).astype(
        np.float32)
    got, want = _both(q, k, v, p, bf16=True)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_pac_window_matches_pallas():
    page, hq, hkv, d, win = 16, 4, 2, 16, 24
    f = tree.two_level(3, 4 * page, 2 * page, block_size=page)
    k, v = _pool(f, hkv, d, seed=7)
    p = plan_mod.build_plan(f, cost_model.CostModel(hq, hkv, d,
                                                    page_size=page),
                            num_lanes=2, max_q=4, window=win)
    q = np.random.default_rng(7).standard_normal((3, hq, d)).astype(
        np.float32)
    got, want = _both(q, k, v, p, window=win)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the oracle backend agrees too
    o_ref = ops.codec_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), p, impl="ref",
                                window=win)
    np.testing.assert_allclose(o_ref.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 4, 16), (5, 8, 32)])
def test_por_matches_pallas(shape):
    nq, h, d = shape
    rng = np.random.default_rng(sum(shape))
    o1, o2 = (rng.standard_normal((nq, h, d)).astype(np.float32)
              for _ in range(2))
    m1, m2 = ((rng.standard_normal((nq, h)) * 3).astype(np.float32)
              for _ in range(2))
    l1, l2 = ((np.abs(rng.standard_normal((nq, h))) + 0.1).astype(np.float32)
              for _ in range(2))
    args = (o1, m1, l1, o2, m2, l2)
    want = jpor.por(*map(jnp.asarray, args), interpret=True)
    got = por_mod.por(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_combine_partials_stats_matches_repro():
    """Segment LSE with a trash segment, an empty segment and masked
    (m = MASK, l = 0) partials."""
    rng = np.random.default_rng(11)
    P, h, d, nq = 12, 4, 8, 5
    o = rng.standard_normal((P, h, d)).astype(np.float32)
    m = (rng.standard_normal((P, h)) * 2).astype(np.float32)
    l = (np.abs(rng.standard_normal((P, h))) + 0.1).astype(np.float32)
    m[3], l[3] = ref.MASK_VALUE, 0.0
    seg = np.array([0, 0, 1, 1, 2, 5, 5, 0, 2, 1, 5, 2], np.int32)  # 3,4 empty
    want = jref.combine_partials_stats_ref(
        jnp.asarray(o), jnp.asarray(m), jnp.asarray(l), jnp.asarray(seg), nq)
    got = ref.combine_partials_stats_ref(
        torch.from_numpy(o), torch.from_numpy(m), torch.from_numpy(l),
        torch.from_numpy(seg), nq)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_single_page_attention_matches_repro():
    rng = np.random.default_rng(13)
    B, hq, hkv, d, page = 3, 4, 2, 16, 16
    q = rng.standard_normal((B, hq, d)).astype(np.float32)
    k = rng.standard_normal((B, page, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, page, hkv, d)).astype(np.float32)
    base = np.array([0, 16, 48], np.int32)
    qpos = np.array([5, 31, 50], np.int32)
    for window in (0, 8):
        want = jops.single_page_attention(*map(jnp.asarray,
                                               (q, k, v, base, qpos)),
                                          window=window)
        got = ops.single_page_attention(*map(torch.from_numpy,
                                             (q, k, v, base, qpos)),
                                        window=window)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_wrappers_refuse_devices_without_kernel():
    """No silent fallback: a tensor neither on the CPU nor on the card
    raises instead of taking the plain path."""
    q = torch.empty(2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        por_mod.por(q, q[..., 0], q[..., 0], q, q[..., 0], q[..., 0])
    f = tree.two_level(2, 32, 8, block_size=16)
    plan_mod.assign_dense_pages(f)
    p = plan_mod.build_plan(f, cost_model.CostModel(4, 2, 16, page_size=16))
    pa = ops.plan_arrays(p, "cpu")
    pool = torch.empty(4, 16, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pac_mod.pac(q, pa, pool, pool)


@pytest.mark.parametrize("edit", ["pac.cu", "por.cu", "flash_decode.cu",
                                  "hopper.cuh", "new header", "flags"])
def test_library_path_covers_every_csrc_file(edit, tmp_path, monkeypatch):
    """The kernel library is named by every file under csrc/ (sources and
    the headers they include) and the flags: an unchanged tree keeps its
    name, and any one edit gives a new one, so the build cache is never
    stale."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = build.library_path(csrc)
    assert build.library_path(csrc) == before
    assert before == build.library_path(build.CSRC)
    if edit == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif edit == "flags":
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    else:
        path = csrc / edit
        path.write_text(path.read_text() + "\n// edited\n")
    assert build.library_path(csrc) != before
    assert build.library_path(csrc).parent == build.BUILD_DIR
