"""The readings a cell's correctness limit is set from, and the check's
decision on each.

For each seed: one run of the cell at its own load (a short window, long
enough to finish the mix's longest requests), the same sample of finished
requests that a run checks, and two readings over it, both against the
float32 reference:

* ``program``: the widest gap of the tokens the program served (the lower
  reading comes from these);
* ``control``: the widest gap of the tokens that the reference itself puts
  first when it computes every product in float8 e4m3: the step below the
  configuration's bfloat16 (the upper reading).

Each reading goes through the harness's own decision against the cell's
limits (``harness.checks`` / ``is_correct``): the program's has to come
out correct and the control's not.  With ``--faults`` each fault of
``faults.py`` is planted in turn under one more run, checked as a run
checks itself, and has to come out not correct.

    python3 perfbench/control.py --workload qwen3-4b.docqa \\
        --seeds 11,12,13 --seconds 25 [--faults 14]

Appends one JSON line a reading to ``build/perfbench/control.jsonl`` (or
``--out``) and prints it.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def control_gap(ref_logits, ctl_logits) -> float:
    """The widest gap, under the reference, of the tokens the control puts
    first."""
    from perfbench import check
    top = ctl_logits.argmax(-1).tolist()
    return check.widest_gap(ref_logits, top)


def readings(cell, seed: int, seconds: float, device, log=sys.stderr) -> dict:
    import torch
    from perfbench import check, harness
    from perfbench.reference import dense

    run, _, w = harness.execute(cell, seed, seconds, False, device,
                                time.perf_counter(), log)
    picked = check.sample(run.completed(), seed)
    short = check.short_streams(picked)
    t0 = time.perf_counter()
    ref = check.reference_logits(dense.Dense(cell.config, w), picked,
                                 run.traffic)
    t_ref = time.perf_counter() - t0
    ctl = check.reference_logits(dense.Dense(cell.config, w,
                                             quantize="fp8"),
                                 picked, run.traffic)
    program_each = [check.widest_gap(ref[r.rid], r.tokens) for r in picked]
    control_each = [control_gap(ref[r.rid], ctl[r.rid]) for r in picked]
    program = harness.checks(run, max(program_each), short)
    control = harness.checks(run, max(control_each), short)
    out = {"workload": cell.name, "seed": seed,
           "requests": [r.rid for r in picked],
           "served_tokens": sum(len(r.tokens) for r in picked),
           "short_streams": short,
           "program": max(program_each), "program_each": program_each,
           "control": max(control_each), "control_each": control_each,
           "program_correct": harness.is_correct(program),
           "control_correct": harness.is_correct(control),
           "control_checks": control,
           "reference_s": t_ref}
    del ctl
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def fault_reading(cell, fault: str, seed: int, seconds: float, device,
                  log=sys.stderr) -> dict:
    """One run with ``fault`` planted, checked as a run checks itself."""
    from perfbench import faults, harness
    with faults.planted(fault):
        run, _, w = harness.execute(cell, seed, seconds, False, device,
                                    time.perf_counter(), log)
    checks = harness.correctness(run, w)
    return {"workload": cell.name, "seed": seed, "fault": fault,
            "correct": harness.is_correct(checks), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", type=int, default=None,
                    help="the seed of one run for each planted fault")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=str(ROOT / "build" / "perfbench"
                                         / "control.jsonl"))
    args = ap.parse_args(argv)
    import gc
    import torch
    from perfbench import faults, spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    jobs = [(None, int(s)) for s in args.seeds.split(",") if s]
    if args.faults is not None:
        jobs += [(f, args.faults) for f in sorted(faults.FAULTS)]
    for fault, seed in jobs:
        cell = spec.load_cell(args.workload)
        t0 = time.perf_counter()
        if fault is None:
            rec = readings(cell, seed, args.seconds, "cuda:0")
        else:
            rec = fault_reading(cell, fault, seed, args.seconds, "cuda:0")
        rec["seconds"] = time.perf_counter() - t0
        rec["device"] = torch.cuda.get_device_name(0)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
