"""The port's Mamba-2 mixer (``repro_torch.models.mamba``) and the Mamba
models against ``repro``'s on shared weights and numpy inputs.

* Every function of ``repro.models.mamba`` (and the engine's prefill from
  a carried state) at float32 within 1e-5 and bfloat16 within 3e-2.
* ``repro``'s numerics, each checked on the port: the conv's SiLU in
  float32 cast back, a carried conv state rounded to ``xBC``'s dtype, the
  ``D`` skip through float32, the gated norm in float32, the conv state
  left-padded when T < K-1, ``dt`` through softplus in float32 with
  ``dt_bias`` and ``A = -exp(A_log)``.
* The chunked scan against the port's own recurrence (2e-3) and its
  chunk-size invariance (``tests/test_models.py:97-115``); decode from a
  carried state; a long scan in blocks of chunks.
* jamba's and mamba2's smoke models: logits (and ``last_only``) against
  ``repro``'s ``forward``, the dense ``prefill`` + ``decode_step`` against
  ``repro``'s, ``init_params`` against the converted tree.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch import configs
from repro_torch.models import mamba as M
from repro_torch.models.transformer import (Transformer, decode_step,
                                            init_params, prefill)
from repro_torch.weights import _flatten, from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CFG = configs.smoke_config("mamba2-2.7b")
ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _make_mixer(dtype):
    """``(dtype, repro params, port Mamba2)`` on one random init, with
    non-trivial ``A_log``/``D``/``dt_bias``/``conv_b``/``norm`` so every
    parameter shows."""
    p = JM.mamba_init(jax.random.PRNGKey(0), CFG, JDT[dtype])
    rng = np.random.default_rng(1)
    H, C = CFG.ssm_heads, CFG.d_inner + 2 * CFG.ssm_state
    p = dict(p, A_log=jnp.asarray(rng.uniform(-1, 1, H), jnp.float32),
             D=jnp.asarray(rng.uniform(0.5, 1.5, H), jnp.float32),
             dt_bias=jnp.asarray(rng.uniform(-1, 0.5, H), jnp.float32),
             conv_b=_j(0.1 * rng.standard_normal(C), dtype),
             norm=_j(rng.uniform(0.5, 1.5, CFG.d_inner), dtype))
    state = {}
    _flatten(jax.tree.map(np.asarray, p), "", state)
    mod = M.Mamba2(CFG, device="meta")
    mod.load_state_dict(state, assign=True)
    return dtype, p, mod


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mixer(request):
    return _make_mixer(request.param)


@pytest.fixture(scope="module")
def mixer32():
    return _make_mixer("float32")


def _inputs(dtype, B=2, T=35, seed=2, scale=0.3):
    x = scale * np.random.default_rng(seed).standard_normal(
        (B, T, CFG.d_model)).astype(np.float32)
    return _j(x, dtype), _t(x, dtype)


def _states(seed=3, B=2):
    rng = np.random.default_rng(seed)
    cs, ss = M.state_shapes(CFG)
    return (0.5 * rng.standard_normal((B,) + cs).astype(np.float32),
            0.1 * rng.standard_normal((B,) + ss).astype(np.float32))


# --------------------------------------------------------------------- #
# every function against repro's
# --------------------------------------------------------------------- #
def test_split_proj_and_conv_match_repro(mixer):
    dtype, p, mod = mixer
    jx, tx = _inputs(dtype)
    jz = jx @ p["in_proj"]["w"]
    tz = tx @ mod.in_proj.w
    _close(tz, jz, dtype)
    for a, b in zip(M._split_proj(CFG, tz), JM._split_proj(CFG, jz)):
        assert a.shape == b.shape
        _close(a, b, dtype)
    xbc_j, xbc_t = JM._split_proj(CFG, jz)[1], M._split_proj(CFG, tz)[1]
    conv0, _ = _states()
    for init in (None, conv0):
        want = JM._causal_conv(xbc_j, p["conv_w"], p["conv_b"],
                               None if init is None else jnp.asarray(init))
        got = M._causal_conv(xbc_t, mod.conv_w, mod.conv_b,
                             None if init is None else torch.from_numpy(init))
        assert got.dtype == TDT[dtype]
        _close(got, want, dtype)


def test_gated_norm_matches_repro(mixer):
    dtype, p, mod = mixer
    rng = np.random.default_rng(4)
    y = rng.standard_normal((2, 5, CFG.d_inner)).astype(np.float32)
    z = rng.standard_normal((2, 5, CFG.d_inner)).astype(np.float32)
    want = JM._gated_norm(_j(y, dtype), _j(z, dtype), p["norm"],
                          CFG.norm_eps)
    got = M._gated_norm(_t(y, dtype), _t(z, dtype), mod.norm, CFG.norm_eps)
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("T,chunk", [(35, 16), (16, 16), (5, 16), (40, 8)])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_matches_repro(mixer, T, chunk, carried):
    dtype = mixer[0]
    rng = np.random.default_rng(5)
    B, H, P, S = 2, CFG.ssm_heads, CFG.ssm_head_dim, CFG.ssm_state
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, T, S)).astype(np.float32)
    Cm = rng.standard_normal((B, T, S)).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((B, H, P, S)).astype(np.float32)
          if carried else None)
    y_j, f_j = JM.ssd_chunked(_j(x, dtype), jnp.asarray(dt), jnp.asarray(A),
                              _j(Bm, dtype), _j(Cm, dtype), chunk,
                              None if s0 is None else jnp.asarray(s0))
    y_t, f_t = M.ssd_chunked(_t(x, dtype), torch.from_numpy(dt),
                             torch.from_numpy(A), _t(Bm, dtype),
                             _t(Cm, dtype), chunk,
                             None if s0 is None else torch.from_numpy(s0))
    assert y_t.dtype == TDT[dtype] and f_t.dtype == torch.float32
    _close(y_t, y_j, dtype)
    _close(f_t, f_j, "float32")


def test_ssd_blocks_of_chunks_equal_one_block(monkeypatch):
    """The intra-chunk term in blocks of chunks (a long prefill) equals
    it in one block, and ``repro``'s scan."""
    rng = np.random.default_rng(6)
    B, T, H, P, S = 1, 70, CFG.ssm_heads, CFG.ssm_head_dim, CFG.ssm_state
    args = [rng.standard_normal((B, T, H, P)), rng.uniform(0.01, 0.5,
            (B, T, H)), -rng.uniform(0.5, 2, H),
            rng.standard_normal((B, T, S)), rng.standard_normal((B, T, S))]
    args = [torch.from_numpy(a.astype(np.float32)) for a in args]
    whole = M.ssd_chunked(*args, 8)
    monkeypatch.setattr(M, "_BLOCK_ELEMS", H * 8 * 8 * 2)   # 2 chunks
    blocks = M.ssd_chunked(*args, 8)
    for a, b in zip(whole, blocks):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    want = JM.ssd_chunked(*[jnp.asarray(a.numpy()) for a in args], 8)
    for a, b in zip(blocks, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [35, 2])
def test_mamba_forward_matches_repro(mixer, T):
    """T=2 < K-1: the conv state comes out left-padded with zeros."""
    dtype, p, mod = mixer
    jx, tx = _inputs(dtype, T=T)
    y_j, (c_j, s_j) = JM.mamba_forward(p, CFG, jx)
    y_t, (c_t, s_t) = M.mamba_forward(mod, CFG, tx)
    assert c_t.shape == (2, CFG.ssm_conv - 1,
                         CFG.d_inner + 2 * CFG.ssm_state)
    assert c_t.dtype == s_t.dtype == torch.float32
    _close(y_t, y_j, dtype)
    _close(c_t, c_j, dtype)
    _close(s_t, s_j, dtype)
    if T < CFG.ssm_conv - 1:
        assert not c_t[:, :CFG.ssm_conv - 1 - T].any()


def test_mamba_decode_matches_repro(mixer):
    dtype, p, mod = mixer
    jx, tx = _inputs(dtype, T=1)
    conv0, ssm0 = _states()
    y_j, (c_j, s_j) = JM.mamba_decode(p, CFG, jx, jnp.asarray(conv0),
                                      jnp.asarray(ssm0))
    y_t, (c_t, s_t) = M.mamba_decode(mod, CFG, tx, torch.from_numpy(conv0),
                                     torch.from_numpy(ssm0))
    _close(y_t, y_j, dtype)
    _close(c_t, c_j, dtype)
    _close(s_t, s_j, dtype)


def test_mamba_recurrent_ref_matches_repro(mixer):
    dtype, p, mod = mixer
    jx, tx = _inputs(dtype, T=12)
    _close(M.mamba_recurrent_ref(mod, CFG, tx),
           JM.mamba_recurrent_ref(p, CFG, jx), dtype)


@pytest.mark.parametrize("T", [7, 21])
def test_mamba_prefill_from_carried_state_matches_repro(mixer, T):
    """The engine's chunk from a carried state (``repro``'s
    ``DecodeEngine._mamba_prefill``), and from none."""
    dtype, p, mod = mixer
    jx, tx = _inputs(dtype, T=T)
    conv0, ssm0 = _states()
    holder = types.SimpleNamespace(cfg=CFG)
    for init in (None, (conv0, ssm0)):
        y_j, (c_j, s_j) = JaxEngine._mamba_prefill(
            holder, p, jx,
            None if init is None else tuple(map(jnp.asarray, init)))
        y_t, (c_t, s_t) = M.mamba_prefill(
            mod, CFG, tx,
            None if init is None else tuple(map(torch.from_numpy, init)))
        _close(y_t, y_j, dtype)
        _close(c_t, c_j, dtype)
        _close(s_t, s_j, dtype)


# --------------------------------------------------------------------- #
# repro's numerics, each on the port
# --------------------------------------------------------------------- #
def test_quirk_carried_conv_state_rounds_to_xbc_dtype():
    rng = np.random.default_rng(7)
    C = CFG.d_inner + 2 * CFG.ssm_state
    xbc = torch.from_numpy(rng.standard_normal((1, 3, C)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((CFG.ssm_conv, C)).astype(
        np.float32)).bfloat16()
    b = torch.zeros(C, dtype=torch.bfloat16)
    st = torch.from_numpy(rng.standard_normal((1, CFG.ssm_conv - 1, C))
                          .astype(np.float32) + 1e-3)
    got = M._causal_conv(xbc, w, b, st)
    assert torch.equal(got, M._causal_conv(xbc, w, b, st.bfloat16()))
    assert got.dtype == torch.bfloat16
    # the SiLU in float32, cast back once
    pad = torch.cat([st.bfloat16(), xbc], 1)
    pre = sum(pad[:, i:i + 3] * w[i] for i in range(CFG.ssm_conv))
    assert torch.equal(got, torch.nn.functional.silu(pre.float()).bfloat16())


def test_quirk_d_skip_gated_norm_and_dt_in_float32(mixer):
    dtype, _, mod = mixer
    _, tx = _inputs(dtype, T=6)
    y, _ = M.mamba_forward(mod, CFG, tx)
    assert y.dtype == TDT[dtype]
    # dt: softplus in float32 of dt + dt_bias, with no threshold
    big = torch.tensor([30.0, -30.0, 0.0])
    assert torch.equal(M._softplus(big), torch.logaddexp(
        big, torch.zeros(3)))
    # A = -exp(A_log), float32 whatever the weights' dtype
    assert mod.A_log.dtype == mod.D.dtype == mod.dt_bias.dtype \
        == torch.float32
    # the gated norm's statistics in float32: a bf16 mean would differ
    z = torch.full((1, 1, CFG.d_inner), 3.0, dtype=TDT[dtype])
    yy = torch.linspace(-4, 4, CFG.d_inner, dtype=TDT[dtype])[None, None]
    want = (yy.float() * torch.nn.functional.silu(z.float()))
    want = want / torch.sqrt((want * want).mean(-1, keepdim=True)
                             + CFG.norm_eps) * mod.norm.float()
    assert torch.equal(M._gated_norm(yy, z, mod.norm, CFG.norm_eps),
                       want.to(TDT[dtype]))


# --------------------------------------------------------------------- #
# the port against itself
# --------------------------------------------------------------------- #
def test_ssd_chunked_matches_recurrence(mixer32):
    """``tests/test_models.py::test_ssd_chunked_matches_recurrence``."""
    _, _, mod = mixer32
    _, tx = _inputs("float32", T=35, seed=1)
    y_par, _ = M.mamba_forward(mod, CFG, tx)
    y_seq = M.mamba_recurrent_ref(mod, CFG, tx)
    np.testing.assert_allclose(y_par.numpy(), y_seq.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_ssd_chunk_size_invariance(mixer32):
    """``tests/test_models.py::test_ssd_chunk_size_invariance``."""
    _, _, mod = mixer32
    _, tx = _inputs("float32", B=1, T=40, seed=2)
    outs = [M.mamba_forward(mod, dataclasses.replace(CFG, ssm_chunk=c),
                            tx)[0].numpy() for c in (8, 16, 40)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-4, atol=1e-4)


def test_decode_from_carried_state_continues_forward(mixer32):
    """Forward over a prompt, then decode steps from its states, equal
    one forward over the whole sequence; a prefill resumed mid-way
    equals it too."""
    _, _, mod = mixer32
    _, tx = _inputs("float32", T=24, seed=8)
    full, _ = M.mamba_forward(mod, CFG, tx)
    y, (conv, ssm) = M.mamba_forward(mod, CFG, tx[:, :20])
    steps = []
    for t in range(20, 24):
        yt, (conv, ssm) = M.mamba_decode(mod, CFG, tx[:, t:t + 1], conv, ssm)
        steps.append(yt)
    got = torch.cat([y] + steps, 1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)
    y1, st = M.mamba_prefill(mod, CFG, tx[:, :9], None)
    y2, _ = M.mamba_prefill(mod, CFG, tx[:, 9:], st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# the Mamba models
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = configs.smoke_config(arch)
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
        model = Transformer.from_state_dict(
            cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
        out[arch] = (cfg, params, model, tokens)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_repro(models, arch):
    cfg, params, model, tokens = models[arch]
    assert any(k.mixer == "mamba" for k in cfg.layer_pattern)
    want, _, _ = JT.forward(params, cfg, jnp.asarray(tokens))
    got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    want_last, _, _ = JT.forward(params, cfg, jnp.asarray(tokens),
                                 last_only=True)
    last = model(torch.from_numpy(tokens), last_only=True)
    assert last.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), _np(want_last), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_decode_matches_repro(models, arch):
    """``prefill`` + three greedy ``decode_step``s (SSM ``conv``/``ssm``
    states beside the KV cache) give ``repro``'s logits."""
    cfg, params, model, tokens = models[arch]
    want, cache, clen = JT.prefill(params, cfg, jnp.asarray(tokens), 32)
    got, tcache, tlen = prefill(model, torch.from_numpy(tokens), 32)
    js = [j for j in range(cfg.num_layers)
          if cfg.layer_kind(j).mixer == "mamba"]
    assert set(tcache[js[0]]) == {"conv", "ssm"}
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(want, -1))[:, None]
        want, cache = JT.decode_step(params, cfg, jnp.asarray(nxt), cache,
                                     clen)
        clen = clen + 1
        got, tcache = decode_step(model, torch.from_numpy(nxt.copy()),
                                  tcache, tlen)
        tlen = tlen + 1
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_converted_tree(models, arch):
    cfg, params, model, _ = models[arch]
    conv = from_jax_params(cfg, jax.tree.map(np.asarray, params))
    mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.bfloat16)
    jbf = from_jax_params(cfg, jax.tree.map(
        np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0),
                                   jnp.bfloat16)))
    sig = lambda s: {k: (tuple(v.shape), v.dtype) for k, v in s.items()}
    assert sig(mine) == sig(jbf)
    assert set(conv) == set(model.state_dict())
    assert mine["layers.0.mamba.A_log"].dtype == torch.float32
    assert bool((mine["layers.0.mamba.D"] == 1).all())
