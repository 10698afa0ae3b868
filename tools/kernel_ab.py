#!/usr/bin/env python3
"""A/B timings of the three CUDA kernels across checkouts, on one card.

Run from the root of a checkout on a machine with one NVIDIA H100 and
``nvcc``, giving the roots of the checkouts to compare (this one is
``.``; another is unpacked with ``git archive`` into an ignored
directory):

    python3 tools/kernel_ab.py build/parent . [more checkout roots]

Builds every checkout's kernels with its own ``kernels/build.py`` (into
its own ``build/``), all at once, then runs each checkout in a process
of its own that imports that checkout's ``repro_torch``, in the order
given and then in reverse.  Each process times, with
``chip_smoke.Timer`` (CUDA events, L2 flushed, mean of 20 with the
median beside it), on inputs made from fixed seeds:

* ``flash_decode`` over 8 rows of 4192 positions, bf16 q: phase 4's
  shape (32 query heads over 8 KV heads, d 128) over f32 and bf16 KV,
  then groups 5 and 8 at d 128, group 32, gemma3-1b's 4 over 1 at d 256,
  8 over 1 at d 256 and 8 over 8 at d 64, over bf16 KV;
* the epilogue on PAC's raw partials of an engine-shaped plan (8
  requests over a 4096-token document, each with its own 64), bf16 q
  over an f32 pool, 32 over 8 heads at d 128: pages of 16 and 64, and
  mesh mode (tail-owner flags, float32 ``o``) at a 2x2 shard's 16 over 4;
* ``codec_mesh_merge`` at 2x1 (8 rows x 32 heads), 2x2 (16 heads a model
  shard) and 16x1, d 128, bf16 out, every shard contributing.

A case a checkout's wrapper refuses is reported as refused.  Every output
is held against the first checkout's (max |err|; bf16 outputs also in
bf16 steps).  The table goes to standard output and, as JSON, to
``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FD_LEN, FD_ROWS = 4192, 8
# (name, h_q, n_kv, d, KV dtype name)
FD_CASES = (("fd phase 4 f32 KV", 32, 8, 128, "float32"),
            ("fd phase 4 bf16 KV", 32, 8, 128, "bfloat16"),
            ("fd group 5", 40, 8, 128, "bfloat16"),
            ("fd group 8", 64, 8, 128, "bfloat16"),
            ("fd group 32", 32, 1, 128, "bfloat16"),
            ("fd d 256 group 4", 4, 1, 256, "bfloat16"),
            ("fd d 256 group 8", 8, 1, 256, "bfloat16"),
            ("fd d 64 group 1", 8, 8, 64, "bfloat16"))
# (name, page, h_q, n_kv, mesh mode)
EPI_CASES = (("epilogue page 16", 16, 32, 8, False),
             ("epilogue page 64", 64, 32, 8, False),
             ("epilogue page 16 mesh", 16, 16, 4, True))
# (name, D, M, heads a model shard)
MERGE_CASES = (("merge 2x1", 2, 1, 32), ("merge 2x2", 2, 2, 16),
               ("merge 16x1", 16, 1, 32))


def cases(torch):
    """{name: a function of no arguments giving the case's outputs}."""
    import chip_smoke as cs
    from repro_torch.core import cost_model, plan as plan_mod, tree
    from repro_torch.kernels import (flash_decode as fd, ops, pac as pac_mod,
                                     por as por_mod)
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(30)
    lens = torch.full((FD_ROWS,), FD_LEN, dtype=torch.int32, device="cuda")
    for name, h_q, n_kv, d, kv in FD_CASES:
        q = torch.randn(FD_ROWS, h_q, d, generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn(FD_ROWS, FD_LEN, n_kv, d, generator=gen,
                            device="cuda").to(getattr(torch, kv))
                for _ in range(2))
        out[name] = (lambda q=q, k=k, v=v: fd.flash_decode(q, k, v, lens))
    for name, page, h_q, n_kv, mesh in EPI_CASES:
        forest = tree.two_level(8, 4096, 64, block_size=page)
        pages = plan_mod.assign_dense_pages(forest)
        cm = cost_model.CostModel(h_q, n_kv, 128, page_size=page)
        plan, tails = cs.engine_state(forest, cm, cs.LANES, cs.MAX_Q, 4096)
        pa = ops.plan_arrays(plan, "cuda")
        B = plan.num_queries
        k, v = (torch.randn(pages, page, n_kv, 128, generator=gen,
                            device="cuda") for _ in range(2))
        q = torch.randn(B, h_q, 128, generator=gen, device="cuda").bfloat16()
        o, m, l = pac_mod.pac(q, pa, k, v)
        parts = ops.Parts(o.reshape(-1, h_q, 128), m.reshape(-1, h_q),
                          l.reshape(-1, h_q), pa.seg_offsets, pa.seg_rows)
        kw = {}
        if mesh:
            kw = {"owner": (torch.arange(B, device="cuda") % 2 == 0).long(),
                  "o_f32": True}
        out[name] = (lambda q=q, parts=parts, k=k, v=v, tails=tails, kw=kw:
                     por_mod.por_epilogue(q, *parts, k, v, *tails,
                                          stats=True, **kw))
    for name, D, M, h in MERGE_CASES:
        B = 8
        o = torch.randn(D, M, B, h, 128, generator=gen, device="cuda")
        m = 3 * torch.randn(D, M, B, h, generator=gen, device="cuda")
        l = 0.5 + 3.5 * torch.rand(D, M, B, h, generator=gen, device="cuda")
        idx = torch.arange(B, device="cuda")
        ct = torch.ones(D, dtype=torch.int64, device="cuda")
        out[name] = (lambda o=o, m=m, l=l, idx=idx, ct=ct: por_mod.mesh_merge(
            o, m, l, idx, idx, ct, torch.bfloat16, stats=True))
    return out


def run(root: Path, save: Path) -> None:
    """One checkout's timings as a JSON line; its outputs to ``save``."""
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    timer = cs.Timer()
    times, outs = {}, {}
    for name, fn in cases(torch).items():
        try:
            got = fn()
        except ValueError as e:
            times[name] = f"refused: {e}"
            continue
        got = got if isinstance(got, (tuple, list)) else (got,)
        outs[name] = [t.detach().cpu() for t in got]
        ms = timer(fn)
        times[name] = [ms, timer.median]
    torch.save(outs, save)
    print(json.dumps(times), flush=True)


def compare(a, b):
    """max |err| between two cases' outputs, and the bf16 steps."""
    import torch
    import chip_smoke as cs
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(a, b))
    ulps = max((cs.bf16_ulps(x, y) for x, y in zip(a, b)
                if x.dtype == torch.bfloat16), default=0)
    return err, ulps


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        # the compiler's register and spill report beside the table
        sys.path.insert(0, str(Path(argv[1]) / "src"))
        from repro_torch.kernels import build
        print(argv[1], build.build(), flush=True)
        out = ROOT / "chiprun_out" / f"ptxas_{Path(argv[1]).name}.log"
        out.parent.mkdir(exist_ok=True)
        out.write_text(str(getattr(build, "build_info", {}).get("log", "")))
        return 0
    if argv[:1] == ["--run"]:
        run(Path(argv[1]).resolve(), Path(argv[2]))
        return 0
    import torch
    if not argv or not torch.cuda.is_available():
        print("kernel_ab: give checkout roots; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    roots = [str(Path(r).resolve()) for r in argv]
    print(cs.nvidia_smi(), flush=True)
    builds = [subprocess.Popen([sys.executable, __file__, "--build", r])
              for r in roots]
    if any([p.wait() for p in builds]):
        raise RuntimeError("a checkout's kernels did not build")
    order = list(range(len(roots))) + list(reversed(range(len(roots))))
    times = {r: [] for r in roots}
    outs = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for n, i in enumerate(order):
            save = Path(tmp) / f"{n}.pt"
            res = subprocess.run([sys.executable, __file__, "--run",
                                  roots[i], str(save)], check=True,
                                 stdout=subprocess.PIPE, text=True)
            times[roots[i]].append(json.loads(res.stdout.splitlines()[-1]))
            outs.setdefault(roots[i], torch.load(save))
    first = outs[roots[0]]
    report = {"card": cs.nvidia_smi(), "roots": argv, "cases": {}}
    for name in times[roots[0]][0]:
        row = {}
        for r, arg in zip(roots, argv):
            got = [t[name] for t in times[r]]
            if isinstance(got[0], str):
                row[arg] = got[0]
                print(f"{name:24s} {arg:24s} {got[0]}")
                continue
            err = (compare(outs[r][name], first[name])
                   if name in first else None)
            row[arg] = {"ms": [g[0] for g in got],
                        "median_ms": [g[1] for g in got],
                        "vs_first": err}
            print(f"{name:24s} {arg:24s} "
                  + " / ".join(f"{g[0]:.4f} (median {g[1]:.4f})"
                               for g in got)
                  + ("" if err is None else
                     f"; against {argv[0]} max|err| {err[0]:.3e}, "
                     f"{err[1]} bf16 step(s)"))
        report["cases"][name] = row
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_ab.json").write_text(
        json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
