"""On the card: a smoke-width cell through the fused CUDA-graph step and
the CUDA kernels, its trace read into device metrics.  Skips without a
CUDA device."""

import pytest
import torch

import perfbench_smoke as smoke
from perfbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
def test_smoke_cell_on_the_card(card):
    cell = smoke.cell("qwen3-4b.docqa")
    import time
    res = harness.run_cell(cell, 99, 3.0, True, card, time.perf_counter())
    assert harness.is_correct(res["checks"]), res["checks"]
    m = res["metrics"]
    for name in ("attn_ms", "device_idle_pct", "step_mfu_pct"):
        assert name in m, name
    assert 0 < m["device_idle_pct"]["value"] < 100
    assert res["device"]["busy_s"] > 0
    assert res["breakdown"]["device_ops"]
