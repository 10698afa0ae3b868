"""The port's model families against ``repro``'s on shared weights.

Every config of ``repro`` loads in the port and equals ``repro``'s, full
and smoke.  For each config but the Mamba ones (``test_torch_mamba.py``), on
``repro``'s weights converted by ``weights.py``: the full-sequence logits
(f32, within 1e-4), the dense-cache ``prefill`` + ``decode_step`` logits
over three greedy steps, and the names, shapes and dtypes of
``init_params`` against the converted tree.  Then the units that the
dense subset lacked: layer norm, GELU and GeGLU (tanh approximation),
softcap, the embedding scale at bf16, and ``apply_moe`` with and without
capacity drops (output and aux loss).  Inputs are made from a seed with
numpy; each config's ``repro`` model is built once (module fixture).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Transformer, decode_step,
                                            embed_multiplier, init_params,
                                            prefill)
from repro_torch.serving.engine import DecodeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ALL = list(jconfigs._MODULES)
MAMBA = ("mamba2-2.7b", "jamba-v0.1-52b")
BUILT = [a for a in ALL if a not in MAMBA]
TOL = 1e-4



def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def built():
    """``arch -> (cfg, repro params, port model, inputs)``, made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = configs.smoke_config(arch)
            params = JT.init_params(cfg, jax.random.PRNGKey(0))
            model = Transformer.from_state_dict(
                cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
            rng = np.random.default_rng(0)
            tokens = rng.integers(0, cfg.vocab_size, (2, 21))
            enc = (rng.standard_normal((2, cfg.frontend_seq, cfg.d_model))
                   .astype(np.float32) if cfg.encoder_layers else None)
            cache[arch] = (cfg, params, model, tokens, enc)
        return cache[arch]
    return get


def _enc_kw(enc, jax_side):
    if enc is None:
        return {}
    return {"encoder_embeds": jnp.asarray(enc) if jax_side
            else torch.from_numpy(enc)}


@pytest.mark.parametrize("arch", ALL)
def test_config_matches_repro(arch):
    full = configs.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get_config(arch))
    assert dataclasses.asdict(configs.smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.smoke_config(arch))
    assert full.active_param_count() == \
        jconfigs.get_config(arch).active_param_count()
    for shape in configs.SHAPES:
        assert configs.shape_supported(full, shape) == \
            jconfigs.shape_supported(full, shape)
        assert configs.skip_reason(full, shape) == \
            jconfigs.skip_reason(full, shape)
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", BUILT)
def test_forward_logits_match_repro(built, arch):
    cfg, params, model, tokens, enc = built(arch)
    want, _, _ = JT.forward(params, cfg, jnp.asarray(tokens),
                            **_enc_kw(enc, True))
    got = model(torch.from_numpy(tokens), **_enc_kw(enc, False))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    last = model(torch.from_numpy(tokens), last_only=True,
                 **_enc_kw(enc, False))
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=TOL,
                               atol=TOL)


def test_prefix_embeds_match_repro(built):
    """llava's stubbed vision frontend: patch embeddings prepended to the
    tokens, logits over the token positions only."""
    cfg, params, model, tokens, _ = built("llava-next-34b")
    pre = np.random.default_rng(7).standard_normal(
        (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    want, _, _ = JT.forward(params, cfg, jnp.asarray(tokens),
                            prefix_embeds=jnp.asarray(pre))
    got = model(torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(pre))
    assert got.shape == (2, tokens.shape[1], cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", BUILT)
def test_dense_decode_matches_repro(built, arch):
    """``prefill`` + three greedy ``decode_step``s on the dense head-major
    cache give ``repro``'s logits at every step."""
    cfg, params, model, tokens, enc = built(arch)
    want, cache, clen = JT.prefill(params, cfg, jnp.asarray(tokens),
                                   max_len=32, **_enc_kw(enc, True))
    got, tcache, tlen = prefill(model, torch.from_numpy(tokens), 32,
                                **_enc_kw(enc, False))
    assert tcache[0]["k"].shape == (2, cfg.num_kv_heads, 32, cfg.head_dim)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(want, -1))[:, None]
        want, cache = JT.decode_step(params, cfg, jnp.asarray(nxt), cache,
                                     clen)
        clen = clen + 1
        got, tcache = decode_step(model, torch.from_numpy(nxt.copy()),
                                  tcache, tlen)
        tlen = tlen + 1
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", BUILT)
def test_init_params_match_converted_tree(built, arch):
    cfg, params, model, _, _ = built(arch)
    conv = from_jax_params(cfg, jax.tree.map(np.asarray, params))
    mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sig = lambda s: {k: (tuple(v.shape), v.dtype) for k, v in s.items()}
    assert sig(mine) == sig(conv) == sig(model.state_dict())
    # repro's _init takes fan_in from shape[0]: E for the expert weights
    for name, t in mine.items():
        if name.endswith("ffn.wi") and t.dim() == 3:
            assert abs(float(t.std()) - t.shape[0] ** -0.5) \
                < 0.1 * t.shape[0] ** -0.5
        if name.endswith(".bias") or name.endswith(".b"):
            assert not bool(t.any())
    bf = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.bfloat16)
    jbf = from_jax_params(cfg, jax.tree.map(
        np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0),
                                   jnp.bfloat16)))
    assert sig(bf) == sig(jbf)


def test_mamba_configs_load_and_are_refused():
    """The Mamba configs load, build and are served now (their parity
    tests live in ``test_torch_mamba.py`` and ``test_torch_hybrid.py``);
    the engine refuses only the encoder-decoder config."""
    for arch in MAMBA:
        cfg = configs.smoke_config(arch)
        model = Transformer(cfg, device="meta")
        assert any(hasattr(layer, "mamba") for layer in model.layers)
    assert set(configs.served_archs()) == set(ALL) - {"whisper-base"}


def test_engine_refuses_encoder_models(built):
    cfg, _, model, _, _ = built("whisper-base")
    with pytest.raises(ValueError, match="decoder-only"):
        DecodeEngine(cfg, model, device="cpu")


# --------------------------------------------------------------------- #
# units
# --------------------------------------------------------------------- #
def test_layer_norm_matches_repro(built):
    cfg, params, model, _, _ = built("whisper-base")
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((3, 5, cfg.d_model))
         ).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    bias = rng.standard_normal(cfg.d_model).astype(np.float32)
    p = L.Norm(cfg.d_model, cfg)
    p.scale.data = torch.from_numpy(scale)
    p.bias.data = torch.from_numpy(bias)
    got = L.apply_norm(p, torch.from_numpy(x), cfg)
    want = JL.apply_norm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["silu", "geglu", "gelu"])
def test_activations_match_repro(kind):
    rng = np.random.default_rng(2)
    h = (3.0 * rng.standard_normal((4, 7, 2 * 24))).astype(np.float32)
    got = L._act(torch.from_numpy(h), kind, 24)
    want = JL._act(jnp.asarray(h), kind, 24)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_softcap_in_mha_matches_repro():
    rng = np.random.default_rng(3)
    q = (4.0 * rng.standard_normal((2, 6, 4, 16))).astype(np.float32)
    k = (4.0 * rng.standard_normal((2, 9, 2, 16))).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    qp = np.array([[3, 4, 5, 6, 7, 8], [2, 3, 4, 5, -1, -1]])
    kp = np.broadcast_to(np.arange(9), (2, 9))
    kw = dict(causal=True, window=4, softcap=5.0)
    got = L.mha(*map(torch.from_numpy, (q, k, v)), q_positions=torch.
                from_numpy(qp), kv_positions=torch.from_numpy(kp.copy()),
                **kw)
    want = JL.mha(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qp),
                  kv_positions=jnp.asarray(kp), **kw)
    plain = L.mha(*map(torch.from_numpy, (q, k, v)), q_positions=torch.
                  from_numpy(qp), kv_positions=torch.from_numpy(kp.copy()),
                  causal=True, window=4)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, plain, atol=1e-3)


def test_embed_scale_rounds_to_bf16_first(built):
    """gemma3 at bf16: ``sqrt(1152)`` becomes 34.0 before the product, as
    in ``repro``; the embeddings equal ``repro``'s bit for bit."""
    cfg = dataclasses.replace(configs.smoke_config("gemma3-1b"),
                              d_model=1152, dtype="bfloat16")
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    emb_j = jnp.asarray(emb, jnp.bfloat16)
    tokens = rng.integers(0, cfg.vocab_size, (2, 5))
    pos = np.broadcast_to(np.arange(5), (2, 5))
    want = JT._embed({"embed": emb_j}, cfg, jnp.asarray(tokens),
                     jnp.asarray(pos))
    model = Transformer(cfg, device="meta")
    model.embed = torch.nn.Parameter(
        torch.from_numpy(emb).to(torch.bfloat16), requires_grad=False)
    got = model.embed_tokens(torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), _np(want))
    assert embed_multiplier(cfg, torch.bfloat16) == 34.0
    assert embed_multiplier(cfg, torch.float32) == float(
        np.float32(np.sqrt(1152)))


@pytest.mark.parametrize("capacity_factor", [0.0, 0.5])
def test_apply_moe_matches_repro(capacity_factor):
    """kimi smoke (4 experts, top-2): no drops at ``capacity_factor=0``;
    at 0.5 the queues overflow and the output and aux loss still equal
    ``repro``'s."""
    cfg = dataclasses.replace(configs.smoke_config("kimi-k2-1t-a32b"),
                              capacity_factor=capacity_factor)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
    x = np.random.default_rng(5).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    want, want_aux = JL.apply_moe(params["blocks"]["sub0"]["ffn"] | {
        k: v[0] for k, v in params["blocks"]["sub0"]["ffn"].items()}, cfg,
        jnp.asarray(x))
    ffn = model.layers[0].ffn
    got, aux = L.apply_moe(ffn, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    _, _, _, pos, cap = L.moe_route(ffn, cfg, torch.from_numpy(x).reshape(
        1, 21, cfg.d_model))
    dropped = int((pos >= cap).sum())
    assert (dropped == 0) == (capacity_factor == 0.0), (dropped, cap)


def test_attn_decode_and_cross_attention_match_repro(built):
    """``attn_decode`` against a dense (B, L, Hkv, hd) cache under
    gemma3's window, and ``cross_kv`` + ``cross_attn_full`` over an
    encoder output (whisper's layer 0), against ``repro``'s."""
    def sub0(params, key):
        return jax.tree.map(lambda a: a[0], params["blocks"]["sub0"][key])

    rng = np.random.default_rng(6)
    cfg, params, model, _, _ = built("gemma3-1b")
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((2, 48, cfg.num_kv_heads, cfg.head_dim)
                             ).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    clen = np.array([40, 13])
    kw = dict(window=cfg.sliding_window)
    got = L.attn_decode(model.layers[0].attn, cfg, torch.from_numpy(x),
                        torch.from_numpy(kc), torch.from_numpy(vc),
                        torch.from_numpy(clen), **kw)
    want = JL.attn_decode(sub0(params, "attn"), cfg, jnp.asarray(x),
                          jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(clen), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-5)
    cfg, params, model, _, _ = built("whisper-base")
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    xattn = model.layers[0].xattn
    k, v = L.cross_kv(xattn, cfg, torch.from_numpy(enc))
    jk, jv = JL.cross_kv(sub0(params, "xattn"), cfg, jnp.asarray(enc))
    got = L.cross_attn_full(xattn, cfg, torch.from_numpy(x), k, v)
    want = JL.cross_attn_full(sub0(params, "xattn"), cfg, jnp.asarray(x),
                              jk, jv)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
