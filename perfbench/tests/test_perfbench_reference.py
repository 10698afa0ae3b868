"""The frozen reference (``perfbench/reference/dense.py``) against the
port's plain path at float32: the full-sequence forward, and the logits
and tokens of every decode step of the paged engine (``codec-torch``) over
a document that two requests share."""

import json

import pytest
import torch

from perfbench import check, spec, weights
from perfbench.reference import dense
from perfbench.harness import PORT_KEYS
from repro_torch.configs import smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import DecodeEngine

ARCHS = {"qwen3-4b": "qwen3-4b", "qwen2.5-14b": "qwen2.5-14b"}


def file_config(arch):
    """The configuration file of ``arch`` at the port's smoke widths, in
    float32."""
    cfg = json.load(open(spec.HERE / "configs" / f"{arch}.json"))
    port = smoke_config(arch)
    for k, v in PORT_KEYS.items():
        cfg[k] = getattr(port, v)
    cfg["torch_dtype"] = "float32"
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_matches_the_port_forward(arch):
    cfg = file_config(arch)
    w = weights.make_weights(cfg, 5, "cpu")
    from perfbench.harness import port_config
    model = Transformer.from_state_dict(port_config(cfg), w)
    tokens = torch.randint(1, cfg["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(0))
    want = model.forward(tokens)[0]
    ref = dense.Dense(cfg, w)
    got = ref.logits([], [tokens[0].tolist()], [0])[0]
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), \
        (got - want).abs().max()
    # a shared prefix gives the same logits as the whole sequence
    got2 = ref.logits(tokens[0, :24].tolist(), [tokens[0, 24:].tolist()],
                      [0])[0]
    assert torch.allclose(got2, want[24:], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_matches_the_engine_decode(arch):
    cfg = file_config(arch)
    w = weights.make_weights(cfg, 6, "cpu")
    from perfbench.harness import port_config
    pcfg = port_config(cfg)
    model = Transformer.from_state_dict(pcfg, w)
    eng = DecodeEngine(pcfg, model, page_size=8, num_pages=64,
                       backend="codec-torch", device="cpu")
    g = torch.Generator().manual_seed(1)
    doc = torch.randint(1, cfg["vocab_size"], (37,), generator=g).tolist()
    qs = [torch.randint(1, cfg["vocab_size"], (n,), generator=g).tolist()
          for n in (5, 9)]
    rids = [eng.add_request(doc + q, max_new=7) for q in qs]
    steps = {r: [] for r in rids}
    while eng.has_work():
        eng.step()
        for i, r in enumerate(eng.last_rows):
            steps[r].append(eng.last_logits[i].clone())
    ref = dense.Dense(cfg, w)
    served = [eng.requests[r].generated for r in rids]
    got = ref.logits(doc, [q + s[:-1] for q, s in zip(qs, served)],
                     [len(q) - 1 for q in qs])
    for r, s, lg in zip(rids, served, got):
        assert len(s) == 7
        assert check.widest_gap(lg, s) < 1e-5
        # decode step k's logits chose token k (token 0 came from prefill)
        port = torch.stack(steps[r][:len(s) - 1])
        assert torch.allclose(lg[1:], port, atol=2e-5, rtol=1e-4), \
            (lg[1:] - port).abs().max()


def test_fp8_control_rounds_each_column():
    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(2))
    q = dense.fp8_columns(w)
    rel = ((q - w).abs() / w.abs().amax(0)).max()
    assert 0 < rel <= 2 ** -4
