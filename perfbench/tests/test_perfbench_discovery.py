"""A configuration, a mix, a metric, a kernel class and a cell are found
by name: a temporary set of new files and entries runs without an edit."""

import json
import shutil

import perfbench_smoke as smoke
from perfbench import harness, spec


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = json.load(open(spec.BENCHMARK))
    cfg = json.load(open(spec.HERE / "configs" / "qwen3-4b.json"))
    cfg.update(smoke.SMOKE)
    (base / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (base / "traffic" / "burst.json").write_text(json.dumps(
        {"clients": 3, "private_tokens": [5, 9], "output_tokens": [4, 7]}))
    (base / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.completed()))\n")
    (base / "kernel_classes" / "gemm.json").write_text(
        json.dumps({"patterns": ["gemm"]}))
    (base / "limits" / "tiny.burst.json").write_text(json.dumps(
        {"logit_gap": {"limit": 1.0}}))
    bench["configs"].append({"name": "tiny", "source": "x",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny.burst", "config": "tiny",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny.burst"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    cell = spec.load_cell("tiny.burst", path, base)
    assert cell.config["hidden_size"] == 64 and cell.traffic["clients"] == 3
    assert "requests_done" in [m.name for m in cell.metrics["end_to_end"]]
    assert spec.kernel_class("gemm", base) == ["gemm"]
    assert spec.reader("requests_done", base).__module__.endswith(
        "requests_done")
    # an existing cell does not see the new metric
    old = spec.load_cell("qwen3-4b.chat", path, base)
    assert "requests_done" not in [m.name for m in old.metrics["end_to_end"]]

    run, peak, w = harness.execute(cell, 3, 1.0, False, "cpu", 0.0)
    assert spec.reader("requests_done", base)(run) >= 1
    checks = harness.correctness(run, w)
    assert harness.is_correct(checks), checks
