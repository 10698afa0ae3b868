#!/usr/bin/env python3
"""``chip_smoke.py`` phase 15 (training) alone, on the card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/chip_phase15.py          # 15a-d
    python3 tools/chip_phase15.py b c d    # only the phases named

Builds the kernels (15d serves through ``codec-cuda``), then runs
``chip_smoke.phase_train_full`` (15a), ``phase_train_parity`` (15b),
``phase_train_cli`` (15c) and ``phase_train_serve`` (15d, on 15b's
trained state), and prints the seconds each took.  A quicker loop than
the whole script when only the training path changed.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase15: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(cs.nvidia_smi(), flush=True)
    build.load()
    which = set("".join(sys.argv[1:])) or set("abcd")
    t = {}
    if "a" in which:
        t0 = time.perf_counter()
        cs.phase_train_full()
        t["15a"] = time.perf_counter() - t0
    if which & set("bd"):
        t0 = time.perf_counter()
        cfg, state = cs.phase_train_parity()
        t["15b"] = time.perf_counter() - t0
    if "c" in which:
        t0 = time.perf_counter()
        cs.phase_train_cli()
        t["15c"] = time.perf_counter() - t0
    if "d" in which:
        t0 = time.perf_counter()
        cs.phase_train_serve(cfg, state)
        t["15d"] = time.perf_counter() - t0
    cs.log("  phase 15: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
