#!/usr/bin/env python3
"""A/B timings of the CUDA PAC kernel built with changed constants.

Copies ``src/repro_torch/kernels/csrc/`` once per variant — a text
substitution in ``pac.cu``: the ring's depth, the exponential — into
``build/pac_variants/`` and builds each copy with ``kernels.build.build``
(the package's own sources, flags and link), all in parallel.  Then it
times every build on one decode state: 8 requests sharing a 4096-token
document with 80 private tokens each, qwen3-4b's attention width (h_q 32,
n_kv 8, d 128), page 16, f32 KV, bf16 queries, under the codec plan at 16
and 32 lanes and the flash plan at 16 lanes (max_kv_per_task 2048, the
engine's default).  Times are ``chip_smoke.Timer``'s: CUDA events with the
L2 flushed before each launch, the mean of 30 launches with their median
beside it.  The builds are timed twice, in order and then in reverse, so
a drift of the card shows as a difference between the passes.  Outputs
are held against the unchanged build.  Needs one NVIDIA H100 and
``nvcc``:

    python3 tools/pac_variants.py
"""

from __future__ import annotations

import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "as is": [],
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "6 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
    "8 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 8;")],
    "__expf": [("expf(", "__expf(")],
}


def variant_sources(name, edits, csrc, out):
    """``csrc`` as is (no edits), or a copy under ``out`` with ``pac.cu``
    edited."""
    if not edits:
        return csrc
    src = (csrc / "pac.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not in pac.cu")
        src = src.replace(old, new)
    d = out / name.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    (d / "pac.cu").write_text(src)
    return d


def main() -> int:
    if not torch.cuda.is_available():
        print("pac_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import cost_model, plan as plan_mod, tree
    from repro_torch.kernels import build, ops, pac as pac_mod

    print(chip_smoke.nvidia_smi(), flush=True)
    out = ROOT / "build" / "pac_variants"
    dirs = [variant_sources(n, e, build.CSRC, out)
            for n, e in VARIANTS.items()]
    with ThreadPoolExecutor(len(dirs)) as ex:
        libs = dict(zip(VARIANTS, map(build.open_library,
                                      ex.map(build.build, dirs))))

    h_q, n_kv, d, page = 32, 8, 128, 16
    forest = tree.two_level(8, 4096, 80, block_size=page)
    pages = plan_mod.assign_dense_pages(forest)
    cm = cost_model.CostModel(h_q, n_kv, d, page_size=page)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = torch.randn(pages, page, n_kv, d, generator=gen, device="cuda")
    v = torch.randn(pages, page, n_kv, d, generator=gen, device="cuda")
    q = torch.randn(8, h_q, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    plans = {
        "codec, 16 lanes": plan_mod.build_plan(forest, cm, 16, 32, 2048),
        "codec, 32 lanes": plan_mod.build_plan(forest, cm, 32, 32, 2048),
        "flash, 16 lanes": plan_mod.flash_plan(forest, cm, 16, 32, 2048),
    }
    arrays = {n: ops.plan_arrays(plan_mod.pad_plan(p), "cuda")
              for n, p in plans.items()}
    timer = chip_smoke.Timer()
    ref = {}
    names = list(libs)
    for pass_no, order in enumerate((names, names[::-1]), 1):
        for name in order:
            row = []
            with mock.patch.object(build, "load", return_value=libs[name]):
                for pname, pa in arrays.items():
                    live = chip_smoke.live_slots(pa)
                    got = [x[live] for x in pac_mod.pac(q, pa, k, v)]
                    ref.setdefault(pname, got)
                    err = chip_smoke.max_err(got, ref[pname])
                    ms = timer(lambda: pac_mod.pac(q, pa, k, v), reps=30)
                    row.append(f"{pname} {ms:.4f} ms (median "
                               f"{timer.median:.4f}; max|diff| {err:.1e})")
            print(f"pass {pass_no} {name:<9} " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
