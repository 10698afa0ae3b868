"""The control, at a size a test run holds: the reference computing every
product in float8 (the step below the configurations' bfloat16) puts
tokens first that the float32 reference ranks well below its best, so the
harness's own decision (``harness.checks`` / ``is_correct``) comes out
not correct for it and correct for the program on the same sample.

A cell's limit is set from readings at its own size on the card
(``perfbench/control.py``; PERF.md has them).  At smoke widths, two
layers and a 200-token sample, both readings are smaller (the program's at
most 0.023, the control's at least 0.35 over four runs of these two
mixes), so the decision is taken against a limit set by the same rule
from those: ``SMOKE_LIMIT``."""

import pytest

import perfbench_smoke as smoke
from perfbench import check, control, harness

SMOKE_LIMIT = 0.15


@pytest.mark.parametrize("name", ["qwen3-4b.docqa", "qwen3-4b.chat"])
def test_control_reads_far_above_the_program(monkeypatch, name):
    monkeypatch.setattr(check, "SAMPLE_TOKENS", 200)
    cell = smoke.cell(name, private_tokens=[20, 40], output_tokens=[30, 60])
    cell.limits["logit_gap"]["limit"] = SMOKE_LIMIT
    rec = control.readings(cell, 4321, 3.0, "cpu")
    assert rec["short_streams"] == 0 and rec["served_tokens"] >= 200
    assert rec["control"] > 3 * rec["program"], rec
    assert rec["program_correct"] is True, rec
    assert rec["control_correct"] is False, rec
    assert not harness.is_correct(rec["control_checks"])
    assert rec["control_checks"]["logit_gap"] == {
        "value": rec["control"], "limit": SMOKE_LIMIT}
