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
  8 over 1 at d 256 and 8 over 8 at d 64, over bf16 KV; then every head
  layout of ``chip_smoke.py``'s 17a rows over its uneven rows (4192 down
  to 1 positions, ``P17_FD_LENS``), bf16; beside each, its byte bound and
  the SDPA call over the same rows (``sdpa ...``: bf16 with
  ``enable_gqa``; over f32 KV the memory-efficient backend with K and V
  expanded to the query heads outside the timed call, as phase 4 does),
  which every checkout times alike;
* the epilogue on PAC's raw partials of an engine-shaped plan (8
  requests over a 4096-token document, each with its own 64), bf16 q
  over an f32 pool, 32 over 8 heads at d 128: pages of 16 and 64, and
  mesh mode (tail-owner flags, float32 ``o``) at a 2x2 shard's 16 over 4;
  then the head dims and pages C8 opened (d 16 and 96 at page 16, pages
  256 and 1024 at d 128), which an older checkout refuses;
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
# (name, h_q, n_kv, d, KV dtype name, rows of P17_FD_LENS positions
# rather than FD_LEN each)
FD_CASES = (("fd phase 4 f32 KV", 32, 8, 128, "float32", False),
            ("fd phase 4 bf16 KV", 32, 8, 128, "bfloat16", False),
            ("fd group 5", 40, 8, 128, "bfloat16", False),
            ("fd group 8", 64, 8, 128, "bfloat16", False),
            ("fd group 32", 32, 1, 128, "bfloat16", False),
            ("fd d 256 group 4", 4, 1, 256, "bfloat16", False),
            ("fd d 256 group 8", 8, 1, 256, "bfloat16", False),
            ("fd d 64 group 1", 8, 8, 64, "bfloat16", False),
            ("fd 17a llama4-scout", 40, 8, 128, "bfloat16", True),
            ("fd 17a llava-next-34b", 56, 8, 128, "bfloat16", True),
            ("fd 17a fig13 32/2", 32, 2, 128, "bfloat16", True),
            ("fd 17a fig13 32/1", 32, 1, 128, "bfloat16", True),
            ("fd 17a MHA d 64", 8, 8, 64, "bfloat16", True),
            ("fd 17a gemma3-1b", 4, 1, 256, "bfloat16", True))
# (name, page, h_q, n_kv, mesh mode[, d])
EPI_CASES = (("epilogue page 16", 16, 32, 8, False),
             ("epilogue page 64", 64, 32, 8, False),
             ("epilogue page 16 mesh", 16, 16, 4, True),
             ("epilogue d 16", 16, 16, 4, False, 16),
             ("epilogue d 96", 16, 32, 4, False, 96),
             ("epilogue page 256", 256, 32, 8, False),
             ("epilogue page 1024", 1024, 32, 8, False))
# (name, D, M, heads a model shard)
MERGE_CASES = (("merge 2x1", 2, 1, 32), ("merge 2x2", 2, 2, 16),
               ("merge 16x1", 16, 1, 32))


def sdpa_case(torch, q, k, v, lens):
    """The SDPA call over flash_decode's rows (NaN-free: positions past
    each row's length are masked): bf16 KV with ``enable_gqa``, f32 KV on
    the memory-efficient backend over K and V expanded beforehand."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    L = k.shape[1]
    mask = (torch.arange(L, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qs = q.to(k.dtype)[:, :, None]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    if k.dtype == torch.bfloat16:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
    group = q.shape[1] // k.shape[2]
    ke, ve = (x.repeat_interleave(group, dim=1) for x in (ks, vs))

    def eff():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ke, ve, attn_mask=mask)
    return eff


def cases(torch):
    """{name: a function of no arguments giving the case's outputs} and
    {name: (bound ms, what bounds it)} of the flash_decode cases."""
    import chip_smoke as cs
    from repro_torch.core import cost_model, plan as plan_mod, tree
    from repro_torch.kernels import (flash_decode as fd, ops, pac as pac_mod,
                                     por as por_mod)
    out, bounds = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(30)
    for name, h_q, n_kv, d, kv, ragged in FD_CASES:
        lens = torch.tensor(cs.P17_FD_LENS if ragged else
                            (FD_LEN,) * FD_ROWS, dtype=torch.int32,
                            device="cuda")
        L = int(lens.max())
        q = torch.randn(lens.numel(), h_q, d, generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn(lens.numel(), L, n_kv, d, generator=gen,
                            device="cuda").to(getattr(torch, kv))
                for _ in range(2))
        out[name] = (lambda q=q, k=k, v=v, lens=lens:
                     fd.flash_decode(q, k, v, lens))
        out["sdpa" + name[2:]] = sdpa_case(torch, q, k, v, lens)
        bounds[name] = cs.fd_bound(q, k, lens)
    for name, page, h_q, n_kv, mesh, *dim in EPI_CASES:
        d = dim[0] if dim else 128
        forest = tree.two_level(8, 4096, 64, block_size=page)
        pages = plan_mod.assign_dense_pages(forest)
        cm = cost_model.CostModel(h_q, n_kv, d, page_size=page)
        plan, tails = cs.engine_state(forest, cm, cs.LANES, cs.MAX_Q, 4096)
        pa = ops.plan_arrays(plan, "cuda")
        B = plan.num_queries
        k, v = (torch.randn(pages, page, n_kv, d, generator=gen,
                            device="cuda") for _ in range(2))
        q = torch.randn(B, h_q, d, generator=gen, device="cuda").bfloat16()
        o, m, l = pac_mod.pac(q, pa, k, v)
        parts = ops.Parts(o.reshape(-1, h_q, d), m.reshape(-1, h_q),
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
    return out, bounds


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
    fns, bounds = cases(torch)
    times["bounds"] = bounds
    for name, fn in fns.items():
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
    bounds = times[roots[0]][0].pop("bounds")
    for r in roots:
        for t in times[r]:
            t.pop("bounds", None)
    report = {"card": cs.nvidia_smi(), "roots": argv, "bounds": bounds,
              "cases": {}}
    for name in times[roots[0]][0]:
        if name in bounds:
            print(f"{name:24s} bound {bounds[name][0]:.4f} ms by "
                  f"{bounds[name][1]}")
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
