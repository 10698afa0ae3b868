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
    """A block's positions T (``split_tokens``): a multiple of the tile,
    at which rows at L give about BLOCKS_PER_SM blocks an SM."""
    # 8 rows x 8 KV heads over 4192 positions on 132 SMs: 17 splits of 256
    assert fd.split_tokens(64, 4192, 132) == 256
    assert -(-4192 // fd.split_tokens(64, 4192, 132)) == 17
    assert fd.split_tokens(256, 4192, 132) == 896
    assert fd.split_tokens(8 * 4, 4192, 132) == 128
    # a KV head of 8 rows (fig13's 32 over 1) takes the tile
    assert fd.split_tokens(8, 4192, 132) == fd.SPLIT_TILE
    # one row, a short span: one tile at least
    assert fd.split_tokens(1, 200, 132) == fd.SPLIT_TILE
    assert fd.split_tokens(1, 10, 132) == fd.SPLIT_TILE
    assert fd.split_tokens(1, 0, 132) == fd.SPLIT_TILE
    # a block of 32 query heads takes 8 tiles while the grid keeps a block
    # an SM (16 rows x 1 KV head), only 4 over 8 rows
    assert fd.split_tokens(16, 4192, 132, heads=32) == 8 * fd.SPLIT_TILE
    assert fd.split_tokens(64, 4192, 132, heads=32) == 8 * fd.SPLIT_TILE
    assert fd.split_tokens(8, 4192, 132, heads=32) == 4 * fd.SPLIT_TILE
    assert fd.split_tokens(8, 4192, 132, heads=4) == fd.SPLIT_TILE
    assert fd.split_tokens(64, 4192, 132, heads=5) == 256
    for rh, span in ((1, 1), (3, 700), (64, 4192), (4096, 100000)):
        T = fd.split_tokens(rh, span, 132)
        assert T % fd.SPLIT_TILE == 0 and T >= fd.SPLIT_TILE
        assert rh * -(-span // T) <= fd.BLOCKS_PER_SM * 132 + rh


# groups 5, 16, 32 and 64 and head dims 16, 48 and 96 (padded to the
# kernel's 32, 64 and 128 instances), as the redesigned kernel takes them,
# three of them under a window of 24
NEW_LAYOUTS = [pytest.param(10, 2, 16, 24, id="g5-d16-w24"),
               pytest.param(32, 2, 48, 0, id="g16-d48"),
               pytest.param(32, 1, 96, 24, id="g32-d96-w24"),
               pytest.param(64, 1, 16, 0, id="g64-d16"),
               pytest.param(128, 2, 48, 24, id="g64-d48-w24")]


@pytest.mark.parametrize("hq,hkv,d,window", NEW_LAYOUTS)
def test_flash_decode_groups_and_head_dims_match_pallas(hq, hkv, d, window):
    """f32 and bf16, NaN past every kv_len (and before the window), rows
    at L, mid-range and 1."""
    q, k, v, lens = _inputs(hq, hkv, seed=hq + d + window, nan_pad=True,
                            d=d, lens=[L, 41, 1])
    if window:
        for b, n in enumerate(lens):
            k[b, :max(0, n - window)] = np.nan
            v[b, :max(0, n - window)] = np.nan
    got = _port(q, k, v, lens, window=window)
    want = _repro(q, np.nan_to_num(k), np.nan_to_num(v), lens, chunk=64,
                  window=window)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got = _port(q, k, v, lens, dtype=torch.bfloat16, window=window)
    want = _repro(q, np.nan_to_num(k), np.nan_to_num(v), lens,
                  dtype=jnp.bfloat16, chunk=64, window=window)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("d", [16, 48, 96, 144, 256])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (10, 2), (64, 1), (96, 1)])
def test_flash_decode_takes_every_head_dim_and_group(hq, hkv, d):
    """What the wrapper of the CUDA kernel lets through (its checks run
    before any launch, on a CUDA tensor): every multiple of 16 up to 256
    and any whole group."""
    assert fd.kernel_refusal(d, hq, hkv) is None


@pytest.mark.parametrize("d,hq,hkv", [(20, 8, 2), (8, 8, 2), (272, 8, 2),
                                      (288, 8, 2), (0, 8, 2), (64, 6, 4),
                                      (64, 2, 4), (64, 8, 0)])
def test_flash_decode_refuses_shapes_it_does_not_take(d, hq, hkv):
    """A head dim outside the kernels' set, or a group that is not whole,
    is refused, naming the limit."""
    assert fd.HEAD_DIMS == tuple(range(16, 257, 16))
    why = fd.kernel_refusal(d, hq, hkv)
    assert why is not None and "d a multiple of 16 from 16 to 256" in why


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
