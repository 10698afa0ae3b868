"""The port's qwen3-4b model against the JAX package on shared weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import PAPER_ARCH, get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module")
def shared():
    cfg = smoke_config(PAPER_ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_smoke_config(PAPER_ARCH))
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
    return cfg, params, model


def test_forward_logits_match_repro(shared):
    cfg, params, model = shared
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 37))
    want, _, _ = JT.forward(params, cfg, jnp.asarray(tokens))
    got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_rope_and_norm_match_repro(shared):
    cfg, params, model = shared
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5))
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos),
               cfg.rope_theta).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos),
                           cfg.rope_theta)), rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        L.apply_norm(model.layers[0].ln, torch.from_numpy(h), cfg).numpy(),
        np.asarray(JL.apply_norm(params["blocks"]["sub0"]["ln"] | {
            "scale": params["blocks"]["sub0"]["ln"]["scale"][0]},
            jnp.asarray(h), cfg)), rtol=1e-6, atol=1e-6)


def test_mha_padded_rows_finite():
    """Padded query rows carry position -1: fully masked, still finite,
    and equal to repro's values for them."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 6, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 6, 2, 16)).astype(np.float32)
    qp = np.array([[3, 5, -1, -1]])
    kp = np.arange(6)[None]
    got = L.mha(*map(torch.from_numpy, (q, k, v)), causal=True,
                q_positions=torch.from_numpy(qp),
                kv_positions=torch.from_numpy(kp))
    want = JL.mha(*map(jnp.asarray, (q, k, v)), causal=True,
                  q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_params_shapes_and_scales():
    cfg = smoke_config(PAPER_ARCH)
    gen = torch.Generator().manual_seed(0)
    state = init_params(cfg, gen, device="cpu")
    model = Transformer.from_state_dict(cfg, state)
    assert set(state) == set(model.state_dict())
    assert state["layers.0.ffn.wi.w"].shape == (cfg.d_model, 2 * cfg.d_ff)
    assert torch.equal(state["layers.1.ln2.scale"], torch.ones(cfg.d_model))
    # N(0, 1/fan_in) and N(0, 1/d_model) for the embedding
    assert abs(state["layers.0.ffn.wo.w"].std().item()
               - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert abs(state["embed"].std().item()
               - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    full = get_config(PAPER_ARCH)
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim) == (36, 2560, 32, 8, 128)
