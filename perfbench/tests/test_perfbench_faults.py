"""The check sees a broken timed path: each fault a served cell can have
(``perfbench/faults.py``), planted under a whole CPU run (the look for a
chip skipped), turns ``correct`` false."""

import pytest

import perfbench_smoke as smoke
from perfbench import check, faults

# longer requests than the other smoke runs: the check compares a few
# hundred served tokens, as at the cells' own sizes
TRAFFIC = dict(private_tokens=[20, 40], output_tokens=[30, 60])


@pytest.fixture
def long_sample(monkeypatch):
    monkeypatch.setattr(check, "SAMPLE_TOKENS", 200)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["qwen3-4b.docqa", "qwen3-4b.chat"])
def test_fault_is_not_correct(long_sample, fault, name):
    with faults.planted(fault):
        res = smoke.run(smoke.cell(name, **TRAFFIC), seconds=2.0)
    assert res["correct"] is False, res["checks"]
    gap = res["checks"]["logit_gap"]
    assert gap["value"] is None or gap["value"] > gap["limit"] or \
        res["checks"]["short_streams"]["value"] > 0


@pytest.mark.parametrize("name", ["qwen3-4b.docqa", "qwen3-4b.chat"])
def test_sound_run_is_correct(long_sample, name):
    res = smoke.run(smoke.cell(name, **TRAFFIC), seconds=2.0)
    assert res["correct"] is True, res["checks"]


def test_a_planted_fault_is_taken_out_again():
    from repro_torch.serving import sampler
    orig = sampler.sample
    with faults.planted("altered_token"):
        assert sampler.sample is not orig
    assert sampler.sample is orig
