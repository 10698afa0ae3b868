"""A tiny end-to-end run on the CPU (the kernels' plain versions) prints a
well-formed result line, with every metric of its cell."""

import json

import pytest

import perfbench_smoke as smoke
from perfbench import spec

CELLS = ["qwen3-4b.docqa", "qwen2.5-14b.docqa", "qwen3-4b.chat"]


def well_formed(res, cell, trace):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for name, m in res["metrics"].items():
        assert isinstance(m["value"], float)
        assert m["unit"] == {x.name: x.unit
                             for x in cell.metrics[kind]}[name]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(res, allow_nan=False))


@pytest.mark.parametrize("name", CELLS)
def test_cpu_run_end_to_end(name):
    cell = smoke.cell(name)
    res = smoke.run(cell, seconds=1.5)
    well_formed(res, cell, False)
    assert set(res["metrics"]) == {m.name for m in
                                   cell.metrics["end_to_end"]}
    assert res["metrics"]["tokens_per_s"]["value"] > 0
    assert res["checks"]["logit_gap"]["value"] < 0.05


def test_cpu_run_traced():
    cell = smoke.cell("qwen3-4b.docqa")
    res = smoke.run(cell, seconds=3.0, trace=True)
    well_formed(res, cell, True)
    # the counters and spans; the device metrics need the card
    for name in ("running_rows", "prefix_hit_pct", "prefill_ms", "plan_ms",
                 "decode_step_ms"):
        assert name in res["metrics"], name
    assert res["metrics"]["prefix_hit_pct"]["value"] > 50
    assert res["device"]["window_s"] >= 2.0
    assert res["breakdown"]["idle_gaps"]


def test_every_metric_has_a_reader():
    bench = json.load(open(spec.BENCHMARK))
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(spec.reader(m["name"]))
