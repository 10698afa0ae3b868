"""Run one cell of ``BENCHMARK.json`` once, on the machine it is started on.

    python3 perfbench/run.py --workload qwen3-4b.docqa --seed 7 \\
        --seconds 45 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
its per-layer metrics with ``--trace 1``), ``device`` (and with
``--trace 1`` ``breakdown``), and last ``checks``: each number compared
with its limit, which also end standard error.  Exits 1 without a result
when there is no CUDA device, fewer than the cell's chips, or when JAX or
the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``perfbench``) and its ``src`` (the port), in
# place of this script's folder, whose module names must not shadow others
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# every cache a kernel build could use, at fixed paths inside the checkout
BUILD = ROOT / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name, mod in sys.modules.items()
                   if mod is not None and name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    checks = result.pop("checks")
    result["correct"] = harness.is_correct(checks)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
