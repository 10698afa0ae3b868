"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device
(port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell's step for a production mesh of
forced host devices and reads XLA's memory and cost analyses.  The port
has no SPMD compiler; its dry run builds the same cells as meta tensors
(``launch/specs.py``), divides them by the same sharding rules
(``launch/sharding.py``) and runs the port's own step on them once
(``launch/op_stats.py``).  By design it runs on the ``meta`` device: it
allocates no memory on any device and launches no kernel, and sets no
environment variable.

Per cell it records (``<out>/<arch>__<shape>__<mesh>.json``):

* ``memory``: argument, output and alias bytes a device holds, exact
  from the shard shapes, and temp bytes, the peak of live intermediates
  of the meta step at the per-device batch (an estimate);
* ``cost``: FLOPs counted by ``FlopCounterMode`` over the whole step
  (every layer: no scan to extrapolate), total and by op, and per chip
  the total over ``chips`` (this assumes the work splits evenly); the
  bytes the step must move per device (``min_bytes``) and the bytes its
  unfused ops move (an upper bound);
* ``roofline`` against the H100 SXM's datasheet: compute and memory
  seconds, the dominant term and the bound; no collective term (the port
  has no multi-card program, ROADMAP A17: ``collectives`` is ``null``);
* ``model_flops`` = 6 N_active tokens for train, 2 N_active tokens for
  prefill and decode, and the ratio of its per-chip share to the counted
  FLOPs a chip;
* ``state_bytes`` (argument plus output less alias bytes: exact) and
  ``state_fits_hbm``; ``per_device_bytes`` (those plus temp bytes) and
  ``fits_hbm`` only on a mesh whose ``model`` axis is 1, and ``null``
  with ``fits_hbm_reason`` elsewhere, since the temp estimate does not
  divide activations over ``model``.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all       # every cell
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

# H100 SXM datasheet (dense): the port's cost-model priors
# (core/cost_model.py), and the card's 80 GB of HBM3
from ..core.cost_model import HBM_BW, PEAK_FLOPS_BF16 as PEAK_FLOPS

HBM_BYTES = 80e9
COLLECTIVE_REASON = "the port has no multi-card program (ROADMAP A17)"
FITS_HBM_REASON = (
    "temp bytes hold the step's activations whole on every device: the "
    "port has no tensor-parallel program to divide them over 'model' "
    "(ROADMAP A17); state_bytes and state_fits_hbm are exact")


def mesh_for(multi_pod: bool):
    from .mesh import make_production_mesh
    return make_production_mesh(multi_pod=multi_pod)


def _count_key(arch, shape, opts) -> tuple:
    return (arch, dataclasses.astuple(shape),
            tuple(sorted(opts.items())))


def run_cell(arch: str, shape, multi_pod: bool = False, *,
             mesh=None, microbatches: int = 1, remat: bool = True,
             tag: str = "", ce_impl: str = "gather", fsdp: bool = True,
             moe_groups: int = 1, num_periods: Optional[int] = None,
             counts: Optional[Dict] = None,
             temp: Optional[float] = None) -> dict:
    """One cell's record.  ``shape``: a name of ``SHAPES`` or an
    ``InputShape``; ``mesh``: a ``LaunchMesh`` in place of the production
    one; ``counts``: a dict that keeps each (arch, shape, options)'s meta
    FLOP count for the next mesh (only the memory depends on the mesh);
    ``temp``: the cell's temp bytes, when already reckoned."""
    from ..configs import get_config, shape_supported, skip_reason
    from ..configs.shapes import SHAPES
    from . import op_stats
    from .specs import input_specs

    if isinstance(shape, str):
        shape = SHAPES[shape]
    mesh = mesh or mesh_for(multi_pod)
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh.name,
           "multi_pod": multi_pod, "tag": tag,
           "microbatches": microbatches, "remat": remat,
           "ce_impl": ce_impl, "fsdp": fsdp, "moe_groups": moe_groups,
           "num_periods": num_periods}
    if not shape_supported(cfg, shape.name):
        rec.update(status="skip", reason=skip_reason(cfg, shape.name))
        return rec

    chips = mesh.size
    opts = dict(microbatches=microbatches, remat=remat, ce_impl=ce_impl,
                fsdp=fsdp, moe_groups=moe_groups, num_periods=num_periods)
    t0 = time.time()
    cell = input_specs(arch, shape, mesh, **opts)
    t_specs = time.time() - t0
    key = _count_key(arch, shape, opts)
    count = None if counts is None else counts.get(key)
    t1 = time.time()
    if count is None:
        count = op_stats.count_cell(cell)
        if counts is not None:
            counts[key] = count
    t_count = time.time() - t1
    t2 = time.time()
    mem = op_stats.extract_memory(cell, mesh, count, temp=temp)
    t_memory = time.time() - t2
    bytes_min = op_stats.min_bytes(cell, mesh)

    flops_chip = count.flops / chips
    t_compute = flops_chip / PEAK_FLOPS
    t_memory_s = bytes_min / HBM_BW
    dominant = "compute" if t_compute >= t_memory_s else "memory"

    c = cell.cfg
    n_act = c.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_act * tokens
    state = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
             - mem["alias_size_in_bytes"])
    # the temp estimate is a device's only where nothing is split over
    # 'model'; elsewhere no total is published
    sharded = mesh.shape.get("model", 1) > 1
    per_dev = None if sharded else state + mem["temp_size_in_bytes"]
    rec.update(
        status="ok", kind=cell.kind, chips=chips,
        local_batch=cell.local_batch,
        specs_s=round(t_specs, 2), count_s=round(t_count, 2),
        memory_s=round(t_memory, 2),
        cost={"flops": flops_chip, "flops_total": count.flops,
              "flops_by_op": count.by_op, "bytes_min": float(bytes_min),
              "bytes_unfused": count.unfused_bytes / chips},
        memory=mem,
        collectives=None, collective_reason=COLLECTIVE_REASON,
        roofline={"t_compute_s": t_compute, "t_memory_s": t_memory_s,
                  "t_collective_s": None, "dominant": dominant,
                  "bound_s": max(t_compute, t_memory_s)},
        hardware={"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                  "hbm_bytes": HBM_BYTES,
                  "source": "NVIDIA H100 SXM datasheet (dense bf16)"},
        model_flops=model_flops,
        model_flops_per_chip=model_flops / chips,
        useful_flops_ratio=(model_flops / chips) / max(flops_chip, 1.0),
        state_bytes=state,
        state_fits_hbm=bool(state <= HBM_BYTES),
        per_device_bytes=per_dev,
        fits_hbm=None if sharded else bool(per_dev <= HBM_BYTES),
    )
    if sharded:
        rec["fits_hbm_reason"] = FITS_HBM_REASON
    return rec


def cell_filename(arch, shape, mesh_name, tag=""):
    suffix = f"__{tag}" if tag else ""
    return f"{arch}__{shape}__{mesh_name}{suffix}.json".replace("/", "_")


def summary(rec: dict) -> str:
    head = f"{rec['arch']} {rec['shape']} {rec['mesh']}:"
    if rec["status"] != "ok":
        return f"{head} {rec['status'].upper()} {rec.get('reason', '')}"
    r = rec["roofline"]
    per_dev = rec["per_device_bytes"]
    per_dev = "null" if per_dev is None else f"{per_dev / 1e9:.2f}GB"
    return (f"{head} OK compute={r['t_compute_s']:.3e}s "
            f"memory={r['t_memory_s']:.3e}s dominant={r['dominant']} "
            f"state={rec['state_bytes'] / 1e9:.2f}GB "
            f"state_fits_hbm={rec['state_fits_hbm']} "
            f"per_dev={per_dev} fits_hbm={rec['fits_hbm']} "
            f"useful={rec['useful_flops_ratio']:.3f}")


def _write(out_dir: str, rec: dict) -> str:
    path = os.path.join(out_dir, cell_filename(
        rec["arch"], rec["shape"], rec["mesh"], rec.get("tag", "")))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def _count_task(arch: str, shape: str, opts: Dict):
    """A worker's FLOP count of one (arch, shape) at its global batch."""
    import torch
    from . import op_stats
    from .specs import input_specs
    torch.set_num_threads(1)
    t0 = time.time()
    count = op_stats.count_cell(input_specs(arch, shape, mesh_for(False),
                                            **opts))
    return count, time.time() - t0


def _temp_task(arch: str, shape: str, multi_pod: bool, opts: Dict):
    """A worker's temp bytes of one cell (its per-device batch)."""
    import torch
    from . import op_stats
    from .specs import input_specs
    torch.set_num_threads(1)
    t0 = time.time()
    temp = op_stats.temp_bytes(input_specs(arch, shape, mesh_for(multi_pod),
                                           **opts))
    return temp, time.time() - t0


def run_all(out_dir: str, archs: Optional[List[str]] = None,
            shapes: Optional[List[str]] = None, tag: str = "",
            log=print, **opts) -> List[dict]:
    """Every (arch x shape x mesh) cell, written to ``out_dir``; a cell
    whose file exists is skipped (``[skip-cached]``).  The meta runs are
    host work, and each is a task of a pool of spawned processes of one
    torch thread each, one a CPU this process may use (at most one a
    task): one FLOP count a (arch, shape), shared by both meshes, and
    each cell's temp run at its per-device batch.  A cell whose task or
    record raises is recorded as ``error``.  Returns the records run."""
    import concurrent.futures as cf
    import multiprocessing as mp_mod
    from ..configs import ASSIGNED_ARCHS, PAPER_ARCH, get_config
    from ..configs import shape_supported
    from ..configs.shapes import SHAPES
    os.makedirs(out_dir, exist_ok=True)
    archs = archs or ASSIGNED_ARCHS + [PAPER_ARCH]
    shapes = shapes or list(SHAPES)
    opts = dict(dict(microbatches=1, remat=True, ce_impl="gather",
                     fsdp=True, moe_groups=1, num_periods=None), **opts)
    cells = []
    for arch in archs:
        for shape in shapes:
            for mp in (False, True):
                name = cell_filename(arch, shape, mesh_for(mp).name, tag)
                if os.path.exists(os.path.join(out_dir, name)):
                    log(f"[skip-cached] {arch} {shape} {mesh_for(mp).name}")
                else:
                    cells.append((arch, shape, mp))
    run = [c for c in cells if shape_supported(get_config(c[0]), c[1])]
    # the counts first, deepest first: they take the longest
    pairs = sorted({(a, s) for a, s, _ in run},
                   key=lambda p: (SHAPES[p[1]].kind == "decode",
                                  -get_config(p[0]).num_layers))
    tasks = [((a, s), _count_task, (a, s, opts)) for a, s in pairs] + [
        ((a, s, mp), _temp_task, (a, s, mp, opts)) for a, s, mp in run]
    counts: Dict = {}
    temps: Dict = {}
    seconds: Dict = {}
    failed: Dict = {}
    if tasks:
        with cf.ProcessPoolExecutor(
                max_workers=min(len(os.sched_getaffinity(0)), len(tasks)),
                mp_context=mp_mod.get_context("spawn")) as pool:
            futs = {pool.submit(fn, *args): key for key, fn, args in tasks}
            for fut in cf.as_completed(futs):
                key = futs[fut]
                try:
                    value, seconds[key] = fut.result()
                except Exception:
                    failed[key] = traceback.format_exc()
                    continue
                if len(key) == 2:
                    counts[_count_key(key[0], SHAPES[key[1]], opts)] = value
                else:
                    temps[key] = value
    recs: List[dict] = []
    for arch, shape, mp in cells:
        t0 = time.time()
        try:
            for key in ((arch, shape), (arch, shape, mp)):
                if key in failed:
                    raise RuntimeError(f"the task {key} failed:\n"
                                       f"{failed[key]}")
            rec = run_cell(arch, shape, mp, tag=tag, counts=counts,
                           temp=temps.get((arch, shape, mp)), **opts)
        except Exception:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_for(mp).name,
                   "tag": tag, "status": "error",
                   "error": traceback.format_exc()}
            log(rec["error"])
        secs = time.time() - t0 + seconds.get((arch, shape, mp), 0.0)
        if not mp:          # a (arch, shape)'s count is charged to 16x16
            secs += seconds.get((arch, shape), 0.0)
        rec["cell_s"] = round(secs, 2)
        _write(out_dir, rec)
        recs.append(rec)
        log(f"{summary(rec)} ({rec['cell_s']:.1f} s)")
    return recs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ce-impl", default="gather",
                    choices=["gather", "onehot"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--tag", default="")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    opts = dict(microbatches=args.microbatches, remat=not args.no_remat,
                ce_impl=args.ce_impl, fsdp=not args.no_fsdp,
                moe_groups=args.moe_groups)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        t0 = time.time()
        recs = run_all(args.out, tag=args.tag, **opts)
        failed = [(r["arch"], r["shape"], r["mesh"]) for r in recs
                  if r["status"] == "error"]
        if failed:
            print("FAILED cells:", failed)
            return 1
        print(f"all cells OK ({len(recs)} run, {time.time() - t0:.1f} s)")
        return 0

    if not (args.arch and args.shape):
        print("--arch and --shape are required without --all",
              file=sys.stderr)
        return 2
    mesh_name = mesh_for(args.multi_pod).name
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, tag=args.tag,
                       **opts)
    except Exception:
        traceback.print_exc()
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
               "tag": args.tag, "status": "error",
               "error": traceback.format_exc()}
        path = os.path.join(args.out, cell_filename(
            args.arch, args.shape, mesh_name, args.tag))
        with open(path + ".err", "w") as f:
            json.dump(rec, f, indent=1)
        return 1
    _write(args.out, rec)
    print(summary(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
