"""A cell of ``BENCHMARK.json`` and the files it names.

Everything is found by name, so a later change adds a configuration, a
mix, a metric, a kernel class or a cell as new files and new entries:

* ``configs/<config>.json``: the model as it is run, and its serving
  deployment;
* ``traffic/<traffic>.json``: the mix (``traffic.py`` reads it);
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` for
  every metric, end-to-end and per-layer alike;
* ``kernel_classes/<class>.json``: name patterns of a class of kernels;
* ``limits/<workload>.json``: the cell's correctness limits.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: Optional[tuple] = None   # None: every cell


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    metrics: Dict[str, List[Metric]]     # "end_to_end" / "per_layer"
    limits: dict


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(entry: dict) -> Metric:
    wl = entry.get("workloads")
    return Metric(entry["name"], entry["unit"],
                  tuple(wl) if wl is not None else None)


def load_cell(name: str, benchmark: Path = BENCHMARK,
              base: Path = HERE) -> Cell:
    """The workload ``name`` of ``benchmark``, with the files it names:
    the configuration's path is relative to ``benchmark``'s folder, the
    others are found by name under ``base``."""
    bench = _json(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = [m for m in map(_metric, bench[kind])
                         if m.workloads is None or name in m.workloads]
    return Cell(name=name,
                config=_json(benchmark.parent / cfg_entry["file"]),
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), metrics=metrics,
                limits=_json(base / "limits" / f"{name}.json"))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = HERE) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    mod = load_module(base / "metrics" / f"{metric}.py",
                      "perfbench_metric_" + metric.replace(".", "_")
                      .replace("-", "_"))
    return mod.read


def kernel_class(name: str, base: Path = HERE) -> List[str]:
    """Name patterns (substrings of a device operation's name) of the
    kernel class ``kernel_classes/<name>.json``."""
    return list(_json(base / "kernel_classes" / f"{name}.json")["patterns"])


def peaks(device_name: str, base: Path = HERE) -> Optional[dict]:
    """The published peaks of a device, by its name (``peaks.json``)."""
    return _json(base / "peaks.json").get(device_name)
