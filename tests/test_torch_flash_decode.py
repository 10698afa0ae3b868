"""The port's FlashDecoding baseline against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The
port's ``flash_decode`` takes its plain torch path here (CPU tensors);
``repro``'s Pallas kernel runs in interpret mode.  The CUDA kernel itself
is held against ``flash_decode_torch`` on the card in
``test_torch_cuda.py``.  Tolerances: 1e-5 in float32 (summation order),
3e-2 in bfloat16 (one bf16 rounding of the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref

B, D, L = 3, 16, 200
LENS = [L, 77, 1]


def _inputs(hq, hkv, seed, nan_pad=False, d=D, lens=LENS):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(lens), hq, d)).astype(np.float32)
    k = rng.standard_normal((len(lens), L, hkv, d)).astype(np.float32)
    v = rng.standard_normal((len(lens), L, hkv, d)).astype(np.float32)
    if nan_pad:
        for b, n in enumerate(lens):
            k[b, n:] = np.nan
            v[b, n:] = np.nan
    return q, k, v, np.asarray(lens, np.int32)


def _port(q, k, v, lens, dtype=torch.float32, **kw):
    out = fd.flash_decode(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                          torch.from_numpy(lens), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


def _repro(q, k, v, lens, dtype=jnp.float32, **kw):
    out = jfd.flash_decode(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                           jnp.asarray(lens), interpret=True, **kw)
    return np.asarray(out, np.float32)


# (h_q, n_kv, d): the small GQA and MHA shapes, then the configs' and the
# figures' head layouts: d 64 MHA, groups 5 and 7 (llama4-scout's 40/8,
# llava-next-34b's 56/8), 16 and 32 (fig13's GQA sweep at 32 query heads
# over 2 and 1 KV heads) and d 256 at groups 8 and 4 (gemma-2b,
# gemma3-1b)
HEAD_LAYOUTS = [pytest.param(4, 4, D, id="4-4"),
                pytest.param(8, 2, D, id="8-2"),
                pytest.param(8, 8, 64, id="8-8-64"),
                pytest.param(10, 2, 128, id="10-2-128"),
                pytest.param(14, 2, 128, id="14-2-128"),
                pytest.param(32, 2, 64, id="32-2-64"),
                pytest.param(32, 1, 128, id="32-1-128"),
                pytest.param(8, 1, 256, id="8-1-256"),
                pytest.param(4, 1, 256, id="4-1-256")]


@pytest.mark.parametrize("hq,hkv,d", HEAD_LAYOUTS)
@pytest.mark.parametrize("chunk", [64, 256])
def test_flash_decode_matches_pallas(hq, hkv, d, chunk):
    """Uneven kv_lens [L, 77, 1] with NaN written past every kv_len."""
    q, k, v, lens = _inputs(hq, hkv, seed=hq + chunk, nan_pad=True, d=d)
    got = _port(q, k, v, lens, chunk=chunk)
    want = _repro(q, k, v, lens, chunk=chunk)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the same rows on clean padding: positions past kv_len do not matter
    clean = _inputs(hq, hkv, seed=hq + chunk, d=d)
    np.testing.assert_allclose(_port(*clean, chunk=chunk), got, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("nan_pad", [False, True])
def test_flash_decode_window_matches_pallas(nan_pad):
    q, k, v, lens = _inputs(8, 2, seed=21, nan_pad=nan_pad)
    if nan_pad:   # NaN before the window too: never read
        for b, n in enumerate(lens):
            k[b, :max(0, n - 32)] = np.nan
            v[b, :max(0, n - 32)] = np.nan
    got = _port(q, k, v, lens, chunk=64, window=32)
    want = _repro(np.nan_to_num(q), np.nan_to_num(k), np.nan_to_num(v),
                  lens, chunk=64, window=32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flash_decode_bf16_matches_pallas():
    q, k, v, lens = _inputs(8, 2, seed=5, nan_pad=True)
    got = _port(q, k, v, lens, dtype=torch.bfloat16)
    want = _repro(q, k, v, lens, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("hq,hkv,d", [(10, 2, 128), (32, 1, 128),
                                      (4, 1, 256)])
def test_flash_decode_bf16_head_layouts_match_pallas(hq, hkv, d):
    """bf16 at group 5, group 32 and gemma3-1b's d 256."""
    q, k, v, lens = _inputs(hq, hkv, seed=6 + hq, nan_pad=True, d=d)
    got = _port(q, k, v, lens, dtype=torch.bfloat16)
    want = _repro(q, k, v, lens, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_flash_decode_empty_row_is_zero():
    """A row with no visible position ends 0 / max(l, 1e-30) = 0."""
    q, k, v, lens = _inputs(4, 2, seed=9, lens=[0, 5])
    got = _port(q, k, v, lens)
    want = _repro(q, k, v, lens)
    assert (got[0] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention_ref_matches_repro(hq, hkv, window):
    q, k, v, lens = _inputs(hq, hkv, seed=31 + hq + window)
    got = ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, lens)),
                                   window=window)
    want = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, lens)),
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and the kernel's plain path computes the oracle's function
    np.testing.assert_allclose(_port(q, k, v, lens, window=window),
                               got.numpy(), rtol=1e-5, atol=1e-5)


def test_num_splits_fills_the_card_and_keeps_a_tile():
    # 8 rows x 8 KV heads over 4192 positions on 132 SMs: 8 splits
    assert fd.num_splits(64, 4192, 132) == 8
    assert fd.num_splits(256, 4192, 132) == 2
    assert fd.num_splits(512, 4192, 132) == 1
    # capped so every split keeps SPLIT_TILE positions
    assert fd.num_splits(1, 200, 132) == 2
    assert fd.num_splits(1, 10, 132) == 1


def test_flash_decode_refuses_devices_without_kernel():
    """No silent fallback: neither CPU nor CUDA raises, as does a bad
    chunk."""
    q = torch.empty(2, 4, 128, device="meta")
    k = torch.empty(2, 64, 2, 128, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fd.flash_decode(q, k, k, lens)
    with pytest.raises(ValueError, match="chunk"):
        fd.flash_decode(q, k, k, lens, chunk=0)
