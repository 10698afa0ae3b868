"""The port's engine serving the model families beyond the dense subset,
against ``repro``'s engine on shared weights.

* gemma3 (5 local : 1 global sliding-window layers, GeGLU, embed scale,
  MQA) on ``tests/test_engine.py``'s sliding-window workload: the port's
  ``codec-cuda`` (its plain path here), ``codec-torch``, ``flash`` and
  ``hydragen``, eager, each equal to one ``repro`` ``codec-xla`` run; and
  ``tests/test_fused_step.py``'s fused sliding-window workload, each
  fused backend equal to ``repro``'s fused engine.
* qwen2.5 (QKV bias, untied head): the engine's greedy stream equals the
  port's own dense ``prefill`` + ``decode_step`` (held to ``repro`` in
  ``test_torch_families.py``) on ``test_engine.py``'s prompt.
* llama4-scout (top-1 MoE over 4 smoke experts, untied head): eager and
  fused against ``repro``'s, no-drop as the smoke config has it, and at
  ``capacity_factor=1.25`` with 5 rows in a bucket of 8, where ``cap``
  follows each mode's token count (the fused step's padded rows take
  routing slots), so each mode is held to its own ``repro`` twin.

``repro``'s engine runs once per workload (module fixtures).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Transformer, decode_step,
                                            prefill)
from repro_torch.serving.engine import DecodeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

BACKENDS = ["codec-cuda", "codec-torch", "flash", "hydragen"]



def _shared(cfg):
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
    return cfg, params, model


def _doc_qa_prompts(n=3, doc_len=48, q_len=3):
    doc = list(range(10, 10 + doc_len))
    return [doc + [100 + 3 * i + j for j in range(q_len)] for i in range(n)]


def _drive(eng, prompts, max_new, steps):
    for p in prompts:
        eng.add_request(p, max_new=max_new)
    out = eng.run(steps)
    assert out, "no request finished"
    return out


# --------------------------------------------------------------------- #
# gemma3: sliding-window layers through per-window plans
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gemma3():
    return _shared(smoke_config("gemma3-1b"))


# tests/test_engine.py::test_sliding_window_arch_backends_agree
EAGER = dict(prompts=_doc_qa_prompts(2, doc_len=64, q_len=2), max_new=4,
             steps=6, kw=dict(page_size=16, num_pages=512, max_q=8,
                              temperature=0.0))
# tests/test_fused_step.py::test_fused_sliding_window_matches_eager
FUSED = dict(prompts=[list(range(10, 74)) + [100 + i, 101 + i]
                      for i in range(2)], max_new=4, steps=8,
             kw=dict(page_size=16, num_pages=256, max_q=8, temperature=0.0,
                     fused=True))


@pytest.fixture(scope="module")
def gemma3_repro(gemma3):
    cfg, params, _ = gemma3
    return {name: _drive(JaxEngine(cfg, params, backend="codec-xla",
                                   **w["kw"]), w["prompts"], w["max_new"],
                         w["steps"])
            for name, w in (("eager", EAGER), ("fused", FUSED))}


@pytest.mark.parametrize("mode", ["eager", "fused"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gemma3_streams_match_repro(gemma3, gemma3_repro, backend, mode):
    cfg, _, model = gemma3
    w = EAGER if mode == "eager" else FUSED
    eng = DecodeEngine(cfg, model, backend=backend, device="cpu", **w["kw"])
    assert eng._windows() == [0, cfg.sliding_window]
    got = _drive(eng, w["prompts"], w["max_new"], w["steps"])
    assert got == gemma3_repro[mode]
    if mode == "fused":
        # two windows: every signature holds one plan slot for each
        assert eng.fused_step.replays == eng.stats["fused_calls"] > 0
        assert all([w for w, *_ in sig[1:]] == [0, cfg.sliding_window]
                   for sig in eng.bucket_signatures), eng.bucket_signatures


# --------------------------------------------------------------------- #
# qwen2.5: QKV bias and an untied head, against the dense decode oracle
# --------------------------------------------------------------------- #
def test_qwen25_engine_matches_dense_decode():
    """``tests/test_engine.py::test_engine_matches_dense_decode`` on the
    port: its engine against its own dense-cache decode."""
    cfg = smoke_config("qwen2.5-14b")
    _, _, model = _shared(cfg)
    assert model.lm_head is not None
    prompt = list(range(10, 10 + 37))
    eng = DecodeEngine(cfg, model, page_size=16, num_pages=512, max_q=8,
                       device="cpu")
    eng.add_request(prompt, max_new=6)
    gen_engine = eng.run(8)[0]

    logits, cache, clen = prefill(model, torch.tensor([prompt]), 64)
    gen_ref = []
    nxt = int(torch.argmax(logits[0]))
    for _ in range(6):
        gen_ref.append(nxt)
        logits, cache = decode_step(model, torch.tensor([[nxt]]), cache,
                                    clen)
        clen = clen + 1
        nxt = int(torch.argmax(logits[0]))
    assert gen_engine == gen_ref


# --------------------------------------------------------------------- #
# llama4-scout: top-1 MoE on every path
# --------------------------------------------------------------------- #
# 5 rows: the fused step pads them to a bucket of 8
MOE = dict(prompts=_doc_qa_prompts(5, doc_len=40, q_len=3), max_new=5,
           steps=8, kw=dict(page_size=8, num_pages=256, max_q=8,
                            temperature=0.0))


@pytest.fixture(scope="module")
def scout():
    """``capacity_factor -> (cfg, params, model)``: the smoke config's
    no-drop 0.0 and the full config's 1.25."""
    base = smoke_config("llama4-scout-17b-a16e")
    return {cf: _shared(dataclasses.replace(base, capacity_factor=cf))
            for cf in (0.0, 1.25)}


@pytest.fixture(scope="module")
def scout_repro(scout):
    runs = {}

    def get(cf, fused):
        if (cf, fused) not in runs:
            cfg, params, _ = scout[cf]
            runs[cf, fused] = _drive(
                JaxEngine(cfg, params, backend="codec-xla", fused=fused,
                          **MOE["kw"]), MOE["prompts"], MOE["max_new"],
                MOE["steps"])
        return runs[cf, fused]
    return get


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_streams_match_repro(scout, scout_repro, cf, fused):
    cfg, _, model = scout[cf]
    eng = DecodeEngine(cfg, model, backend="codec-cuda", fused=fused,
                       device="cpu", **MOE["kw"])
    got = _drive(eng, MOE["prompts"], MOE["max_new"], MOE["steps"])
    assert got == scout_repro(cf, fused)
    if fused:
        assert {sig[0] for sig in eng.bucket_signatures} == {8}


def test_moe_drops_follow_the_token_count(scout):
    """At 1.25 a decode step of 5 rows gives each expert
    ``int(1.25 * 5 / 4) = 1`` slot, the fused bucket of 8 gives 2; the
    padded rows come last, so they never displace a live row's token."""
    cfg, _, model = scout[1.25]
    ffn = model.layers[0].ffn
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 1, cfg.d_model)).astype(np.float32))
    assert L.moe_capacity(cfg, 5) == 1 and L.moe_capacity(cfg, 8) == 2
    y5, _ = L.apply_moe(ffn, cfg, x[:5])
    y8, _ = L.apply_moe(ffn, cfg, x)
    _, _, _, pos5, cap5 = L.moe_route(ffn, cfg, x[:5].reshape(1, 5, -1))
    _, _, _, pos8, cap8 = L.moe_route(ffn, cfg, x.reshape(1, 8, -1))
    keep5, keep8 = pos5[0] < cap5, pos8[0, :5] < cap8
    assert bool((keep8 | ~keep5).all())      # a wider cap only keeps more
    assert int((~keep5).sum()) > 0           # 5 rows over 4 experts drop
    same = keep5 == keep8
    # the expert products of 1 and 2 slots sum in other orders
    torch.testing.assert_close(y5[same], y8[:5][same], rtol=1e-4,
                               atol=1e-4)
