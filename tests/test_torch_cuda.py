"""The CUDA kernels (PAC, POR, flash_decode) against their plain torch
versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernels are built on first use);
skips elsewhere.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Imports only
torch and the port, so it runs where ``jax`` is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import flash_decode as fd, ops, por as por_mod


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
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
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
