#!/usr/bin/env python3
"""``chip_smoke.py`` phase 17 (the three kernels over every shape their
TPU kernels take) alone.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/chip_phase17.py

Builds the kernels and runs ``chip_smoke.phase_shapes`` (17b, 17c, then
17a), printing its ``kernels`` entries as JSON.  ``tools/kernel_ab.py``
times the kernels against another checkout's.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase17: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(cs.nvidia_smi(), flush=True)
    build.load()
    print(json.dumps(cs.phase_shapes(cs.Timer())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
