#!/usr/bin/env python3
"""``chip_smoke.py`` phase 16 (the serving examples and the dry run held
against the card) alone.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/chip_phase16.py          # 16a-c
    python3 tools/chip_phase16.py b        # only the phases named

Builds the kernels (the examples launch PAC and the epilogue), then runs
``chip_smoke.phase_examples`` (16a), ``phase_dryrun_card`` (16b, in a
child process) and ``phase_dryrun_all`` (16c), and prints the seconds
each took.  A quicker loop than the whole script when only the launch
layer or the examples changed.
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
        print("chip_phase16: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    print(cs.nvidia_smi(), flush=True)
    build.load()
    which = set("".join(sys.argv[1:])) or set("abc")
    t = {}
    for c, fn in (("a", lambda: cs.phase_examples(ROOT)),
                  ("b", lambda: cs.phase_dryrun_card(ROOT)),
                  ("c", cs.phase_dryrun_all)):
        if c in which:
            t0 = time.perf_counter()
            fn()
            t[f"16{c}"] = time.perf_counter() - t0
    cs.log("  phase 16: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
