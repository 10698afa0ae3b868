"""The CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernels are built on first use);
skips elsewhere.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Imports only
torch and the port, so it runs where ``jax`` is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import ops, por as por_mod


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
