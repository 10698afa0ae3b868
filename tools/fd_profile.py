#!/usr/bin/env python3
"""Where ``flash_decode``'s time goes, by kernel, across checkouts.

Run from the root of a checkout on a machine with one NVIDIA H100 and
``nvcc``, giving the roots of the checkouts to compare (``.`` is this
one; another is unpacked with ``git archive`` into an ignored
directory, or is a copy of ``src/`` under ``build/`` with an edited
source):

    python3 tools/fd_profile.py . [more checkout roots]

Each checkout builds its own kernels and runs in a process of its own
over ``tools/kernel_ab.py``'s ``flash_decode`` cases (the same inputs,
made from the same seed): ``torch.profiler`` traces 20 calls of each
case, and the mean device time a call of every kernel they launch (pass
1, by instance, and pass 2) is printed beside the byte bound.  The JSON
goes to ``chiprun_out/fd_profile.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 20


def run(root: Path) -> dict:
    """One checkout's per-kernel device times of every case, in ms."""
    sys.path[:0] = [str(root / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    import kernel_ab
    from repro_torch.kernels import build
    build.load()
    fns, bounds = kernel_ab.cases(torch)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, fn in fns.items():
        if not name.startswith("fd"):
            continue
        try:
            fn()
        except ValueError as e:
            out[name] = f"refused: {e}"
            continue
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            kernels[e.key] = 1e-3 * us / CALLS
        out[name] = {"bound_ms": bounds[name][0], "kernels": kernels}
    return out


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        print(json.dumps(run(Path(argv[1]).resolve())), flush=True)
        return 0
    import torch
    if not argv or not torch.cuda.is_available():
        print("fd_profile: give checkout roots; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    print(cs.nvidia_smi(), flush=True)
    report = {"card": cs.nvidia_smi(), "roots": argv, "cases": {}}
    for arg in argv:
        res = subprocess.run([sys.executable, __file__, "--run", arg],
                             check=True, stdout=subprocess.PIPE, text=True)
        got = json.loads(res.stdout.splitlines()[-1])
        for name, row in got.items():
            report["cases"].setdefault(name, {})[arg] = row
            if isinstance(row, str):
                print(f"{name:24s} {arg:16s} {row}")
                continue
            parts = "; ".join(
                f"{k.replace('(anonymous namespace)::', '').split('(')[0]}"
                f" {v:.4f}"
                for k, v in sorted(row["kernels"].items(),
                                   key=lambda kv: -kv[1]))
            total = sum(row["kernels"].values())
            print(f"{name:24s} {arg:16s} {total:.4f} ms (bound "
                  f"{row['bound_ms']:.4f}): {parts}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "fd_profile.json").write_text(
        json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
