#!/usr/bin/env python3
"""Serve the same workload from two checkouts in one session and compare
their traced decode steps.

    python3 tools/serve_ab.py --base build/parent [--backends codec-cuda flash]

``--base`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive``, into a directory ``.gitignore``
lists); this checkout is the change.  For each backend the script runs
``python -m repro_torch.launch.serve --profile N`` four times, one process
each, in the order base, change, change, base, so that a drift of the card
or the host over the session falls on both sides alike.  Each checkout
builds its own kernels under its own ``build/``.  It prints, per run, TPOT,
device busy and idle share per traced step, kernels per step and the
top kernels by device time, then a table of every run (with arrivals,
``--arrivals`` among the serve flags after ``--``, also the step time,
prefill seconds in the loop, generated tokens per second and, fused,
capture seconds), and writes each run's full output to ``--out``.  Needs
the card (the serve CLI runs on it).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROFILE = re.compile(r"wall (?P<wall>[\d.]+) ms/step, device busy "
                     r"(?P<busy>[\d.]+) ms/step, idle share (?P<idle>[\d.]+)"
                     r", (?P<kernels>\d+) kernels/step")
TPOT = re.compile(r"TPOT (?P<tpot>[\d.]+) ms")
MIXED = re.compile(r"step (?P<step>[\d.]+) ms wall, decode [\d.]+ ms a step; "
                   r"prefill in the loop (?P<prefill>[\d.]+) s; "
                   r"(?P<tps>[\d.]+) generated tokens/s")
CAPTURE = re.compile(r"graphs captured \d+ for \d+ bucket signatures, capture "
                     r"(?P<capture>[\d.]+) s")


def _num(match, key) -> str:
    return "-" if match is None else match[key]


def run(tree: Path, backend: str, profile: int, extra) -> str:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--backend",
           backend, "--profile", str(profile), *extra]
    res = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{tree} {backend}: exit {res.returncode}\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--backends", nargs="+", default=["codec-cuda", "flash"])
    ap.add_argument("--profile", type=int, default=3)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out")
    ap.add_argument("extra", nargs="*",
                    help="further arguments for the serve CLI")
    args = ap.parse_args()
    trees = {"base": args.base.resolve(), "change": ROOT}
    args.out.mkdir(parents=True, exist_ok=True)
    rows = []
    for backend in args.backends:
        for i, side in enumerate(("base", "change", "change", "base")):
            text = run(trees[side], backend, args.profile, args.extra)
            (args.out / f"serve_ab_{backend}_{i}_{side}.log").write_text(text)
            prof, tpot = PROFILE.search(text), TPOT.search(text)
            if prof is None or tpot is None:
                raise RuntimeError(f"no profile line in:\n{text}")
            mixed, cap = MIXED.search(text), CAPTURE.search(text)
            rows.append((backend, side, float(tpot["tpot"]),
                         float(prof["busy"]), float(prof["idle"]),
                         int(prof["kernels"]), _num(mixed, "step"),
                         _num(mixed, "prefill"), _num(mixed, "tps"),
                         _num(cap, "capture")))
            print(f"== {backend} {side} (run {i + 1} of 4)", flush=True)
            start = text.find("profile over")
            print(text[start:text.find("{", start)].rstrip(), flush=True)
    print(f"{'backend':<11} {'tree':<7} {'TPOT ms':>9} {'busy ms':>9} "
          f"{'idle':>6} {'kernels':>8} {'step ms':>9} {'prefill s':>9} "
          f"{'tokens/s':>9} {'capture s':>9}")
    for b, side, tpot, busy, idle, kernels, *mixed in rows:
        print(f"{b:<11} {side:<7} {tpot:9.3f} {busy:9.3f} {idle:6.3f} "
              f"{kernels:8d} " + " ".join(f"{m:>9}" for m in mixed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
