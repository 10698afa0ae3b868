"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device
(port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell's step for a production mesh of
forced host devices, SPMD-partitioned, and reads XLA's memory and cost
analyses of the per-device program.  The port builds the same cells as
meta tensors (``launch/specs.py``) under the same sharding rules
(``launch/sharding.py``), and on a mesh of more than one card
partitions its own step with DTensor over a fake world of that many ranks
(``mesh.device_mesh``): the step runs once as rank 0's local program,
under ``op_stats.OpStats``.  It runs on the ``meta`` device: it allocates
no memory on any device and launches no kernel, sets no environment
variable, and leaves no process group behind.

Per cell it records (``<out>/<arch>__<shape>__<mesh>.json``):

* ``memory``: argument, output and alias bytes a device holds, exact
  from the shard shapes, and temp bytes, the peak of live intermediates
  of rank 0's local program (an estimate: no fusion, no buffer reuse
  beyond freeing);
* ``cost``: ``flops``, rank 0's local count (every layer: no scan to
  extrapolate), by op; ``flops_total``, the unpartitioned step's count;
  the bytes the step must move per device (``bytes_min``) and the bytes
  the local program's unfused ops move (an upper bound);
* ``collectives``: ``repro``'s ``count`` and ``link_bytes`` by kind, and
  ``link_bytes`` split by the slowest link of each group
  (``by_link``: ``nvlink`` or ``network``);
* ``roofline`` against an H100 SXM's datasheet: compute, memory and
  collective seconds (each group's bytes over its link: ``NVLINK_BW``
  within a node of 8 cards, ``NETWORK_BW`` across nodes), the dominant
  term and the bound, their maximum;
* ``model_flops`` = 6 N_active tokens for train, 2 N_active tokens for
  prefill and decode, and the ratio of its per-chip share to the local
  FLOPs;
* ``state_bytes`` (argument plus output less alias bytes: exact),
  ``state_fits_hbm``, ``per_device_bytes`` (state plus temp bytes) and
  ``fits_hbm`` on every mesh;
* ``partition_rules``: how often each rule of ``op_stats`` placed an op
  (``OpStats``' products and lookups, ``PARTITION_RULES``);
* ``torch_version``: DTensor's release, whose propagation places the
  ops no rule pins.

A 1x1 mesh splits nothing: its step runs unpartitioned (no collective).
A two-pod mesh (2x16x16) is partitioned as one pod's block
(``specs.pod_local``): ``pod`` splits only the batch (and a batch-1
cache's sequence), so rank 0's program is its pod's cell, under the
three-axis specs less ``pod``, on the ``(data, model)`` block's fake
world, plus an all-reduce over its pod group (two nodes apart: the
network) for each batch reduction (each gradient, the loss and the CE)
and each split-K merge of a cache split over ``pod``
(``op_stats.run_counted``); ``collectives["pod"]`` counts those.  A cell
whose step an op cannot partition is recorded with ``status: "error"``
and the op (``op``).

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh 2x2
    python -m repro_torch.launch.dryrun --all       # every cell
    python -m repro_torch.launch.dryrun --all --mesh 16x16 --arch qwen3-4b
    python -m repro_torch.launch.dryrun --table     # the records in --out
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

# H100 SXM datasheet (dense): the port's cost-model priors
# (core/cost_model.py), and the card's 80 GB of HBM3
from ..core.cost_model import HBM_BW, PEAK_FLOPS_BF16 as PEAK_FLOPS

HBM_BYTES = 80e9
# a DGX H100's links, one direction a card (datasheet figures, not
# measurements): NVLink 4 within a node of 8 cards, and one 400 Gb/s NDR
# InfiniBand NIC a card between nodes
NVLINK_BW = 450e9
NETWORK_BW = 50e9
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def partitionable(mesh) -> bool:
    """Whether the dry run partitions a cell over ``mesh``: more than one
    card."""
    return mesh.size > 1


def mesh_for(multi_pod: bool):
    from .mesh import make_production_mesh
    return make_production_mesh(multi_pod=multi_pod)


def _count_key(arch, shape, opts) -> tuple:
    return (arch, dataclasses.astuple(shape),
            tuple(sorted(opts.items())))


def count_local(arch: str, shape, mesh, opts: Dict,
                device_type: str = "cpu"):
    """Rank 0's local program of a cell (``op_stats.StepCount``): the
    cell partitioned over a fake world of ``mesh`` (a ``DeviceMesh`` of
    ``device_type``, ``mesh.device_mesh``), torn down after; on a two-pod
    mesh its pod-local cell over the world of one pod
    (``mesh.pod_block``); on one card, the unpartitioned step."""
    from . import op_stats
    from .mesh import device_mesh, pod_block
    from .specs import input_specs
    if not partitionable(mesh):
        return op_stats.count_cell(input_specs(arch, shape, mesh, **opts))
    with device_mesh(pod_block(mesh), device_type) as dm:
        return op_stats.count_cell(input_specs(
            arch, shape, mesh, partitioned=True, device_mesh=dm, **opts))


def collective_record(ops, mesh=None) -> Dict:
    """``repro``'s ``collectives`` fields (``count``, ``link_bytes`` and
    ``result_bytes`` by kind), the link bytes by link, and the seconds
    they take: each collective's bytes over its group's slowest link.
    On a two-pod ``mesh``, ``pod``: the count, link bytes and link of
    those over rank 0's pod group (``mesh.pod_group``), already in the
    rest."""
    from . import op_stats
    from .mesh import POD_AXIS, group_link, pod_group
    st = op_stats.collect_collectives(ops)
    by_link = {"nvlink": 0.0, "network": 0.0}
    for c in ops:
        if c.n > 1 and c.out_bytes:
            by_link[group_link(c.ranks)] += c.link_bytes
    seconds = sum(b / LINK_BW[k] for k, b in by_link.items())
    rec = {"count": st.count, "link_bytes": st.link_bytes,
           "result_bytes": st.result_bytes,
           "total_link_bytes": st.total_link_bytes, "by_link": by_link,
           "seconds": seconds}
    if mesh is not None and POD_AXIS in mesh.axis_names:
        ranks = pod_group(mesh)
        pod = op_stats.collect_collectives(c for c in ops
                                           if c.ranks == ranks)
        rec["pod"] = {"count": sum(pod.count.values()),
                      "link_bytes": pod.total_link_bytes,
                      "link": group_link(ranks)}
    return rec


def run_cell(arch: str, shape, multi_pod: bool = False, *,
             mesh=None, microbatches: int = 1, remat: bool = True,
             tag: str = "", ce_impl: str = "gather", fsdp: bool = True,
             moe_groups: int = 1, num_periods: Optional[int] = None,
             counts: Optional[Dict] = None, local=None) -> dict:
    """One cell's record.  ``shape``: a name of ``SHAPES`` or an
    ``InputShape``; ``mesh``: a ``LaunchMesh`` in place of the production
    one; ``counts``: a dict that keeps each (arch, shape, options)'s
    unpartitioned FLOP count for the next mesh; ``local``: the cell's
    local program (``count_local``), when already counted.  An op the
    partition cannot place gives ``status: "error"`` with ``op``."""
    import torch
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
           "num_periods": num_periods, "torch_version": torch.__version__}
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
    split = partitionable(mesh)
    if local is None and not split:
        local = count
    if local is None:
        try:
            local = count_local(arch, shape, mesh, opts)
        except op_stats.PartitionError as e:
            rec.update(status="error", op=e.op, error=str(e))
            return rec
    t_local = time.time() - t2
    mem = op_stats.extract_memory(cell, mesh, temp=local.peak_bytes)
    bytes_min = op_stats.min_bytes(cell, mesh)
    coll = collective_record(local.collectives, mesh)
    flops = local.flops

    t_compute = flops / PEAK_FLOPS
    t_memory_s = bytes_min / HBM_BW
    t_collective = coll.pop("seconds")
    terms = {"compute": t_compute, "memory": t_memory_s,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)

    c = cell.cfg
    n_act = c.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_act * tokens
    state = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
             - mem["alias_size_in_bytes"])
    per_dev = state + mem["temp_size_in_bytes"]
    rec.update(
        status="ok", kind=cell.kind, chips=chips, partitioned=split,
        local_batch=cell.local_batch,
        specs_s=round(t_specs, 2), count_s=round(t_count, 2),
        local_s=round(t_local, 2),
        cost={"flops": flops, "flops_total": count.flops,
              "flops_by_op": local.by_op,
              "bytes_min": float(bytes_min),
              "bytes_unfused": local.unfused_bytes},
        memory=mem,
        collectives=coll,
        roofline={"t_compute_s": t_compute, "t_memory_s": t_memory_s,
                  "t_collective_s": t_collective, "dominant": dominant,
                  "bound_s": max(terms.values())},
        hardware={"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                  "hbm_bytes": HBM_BYTES, "nvlink_bw": NVLINK_BW,
                  "network_bw": NETWORK_BW,
                  "source": "NVIDIA H100 SXM and DGX H100 datasheets "
                            "(dense bf16; links one direction a card)"},
        model_flops=model_flops,
        model_flops_per_chip=model_flops / chips,
        useful_flops_ratio=(model_flops / chips) / max(flops, 1.0),
        state_bytes=state,
        state_fits_hbm=bool(state <= HBM_BYTES),
        per_device_bytes=per_dev,
        fits_hbm=bool(per_dev <= HBM_BYTES),
        partition_rules=local.rules if split else {},
    )
    return rec


def cell_filename(arch, shape, mesh_name, tag=""):
    suffix = f"__{tag}" if tag else ""
    return f"{arch}__{shape}__{mesh_name}{suffix}.json".replace("/", "_")


def _g(x, unit: float = 1.0, fmt: str = ".3e") -> str:
    return "null" if x is None else format(x / unit, fmt)


def summary(rec: dict) -> str:
    head = f"{rec['arch']} {rec['shape']} {rec['mesh']}:"
    if rec["status"] != "ok":
        return (f"{head} {rec['status'].upper()} "
                f"{rec.get('op') or rec.get('reason', '')}")
    r = rec["roofline"]
    return (f"{head} OK compute={_g(r['t_compute_s'])}s "
            f"memory={_g(r['t_memory_s'])}s "
            f"collective={_g(r['t_collective_s'])}s "
            f"dominant={r['dominant']} "
            f"state={_g(rec['state_bytes'], 1e9, '.2f')}GB "
            f"per_dev={_g(rec['per_device_bytes'], 1e9, '.2f')}GB "
            f"fits_hbm={rec['fits_hbm']} "
            f"useful={rec['useful_flops_ratio']:.3f}")


def table(out_dir: str) -> str:
    """The records in ``out_dir`` as a markdown table: per-device bytes,
    fit, collectives and their links, the bound."""
    import glob
    rows = ["| arch | shape | mesh | state GB | temp GB | per device GB "
            "| fits | collectives | network GB | NVLink GB "
            "| t_collective s | bound s | dominant |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"{r.get('status')} {r.get('op') or ''} "
                        f"| | | | | | | | | |")
            continue
        c, rf = r["collectives"], r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{_g(r['state_bytes'], 1e9, '.2f')} | "
            f"{_g(r['memory']['temp_size_in_bytes'], 1e9, '.2f')} | "
            f"{_g(r['per_device_bytes'], 1e9, '.2f')} | {r['fits_hbm']} | "
            f"{'null' if c is None else sum(c['count'].values())} | "
            f"{'null' if c is None else _g(c['by_link']['network'], 1e9, '.2f')} | "
            f"{'null' if c is None else _g(c['by_link']['nvlink'], 1e9, '.2f')} | "
            f"{_g(rf['t_collective_s'], 1, '.4g')} | "
            f"{_g(rf['bound_s'], 1, '.4g')} | {rf['dominant']} |")
    return "\n".join(rows)


def _write(out_dir: str, rec: dict) -> str:
    path = os.path.join(out_dir, cell_filename(
        rec["arch"], rec["shape"], rec["mesh"], rec.get("tag", "")))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def _count_task(arch: str, shape: str, opts: Dict):
    """A worker's unpartitioned FLOP count of one (arch, shape) at its
    global batch."""
    import torch
    from . import op_stats
    from .specs import input_specs
    torch.set_num_threads(1)
    t0 = time.time()
    count = op_stats.count_cell(input_specs(arch, shape, mesh_for(False),
                                            **opts))
    return count, time.time() - t0


def _local_task(arch: str, shape: str, mesh, opts: Dict):
    """A worker's local program of one cell (``count_local``)."""
    import torch
    torch.set_num_threads(1)
    t0 = time.time()
    return count_local(arch, shape, mesh, opts), time.time() - t0


def run_all(out_dir: str, archs: Optional[List[str]] = None,
            shapes: Optional[List[str]] = None, tag: str = "",
            log=print, meshes: Optional[Sequence] = None,
            **opts) -> List[dict]:
    """Every (arch x shape x mesh) cell, written to ``out_dir``; a cell
    whose file exists is skipped (``[skip-cached]``).  ``meshes``: the
    ``LaunchMesh``es (the two production ones by default).  The meta runs
    are host work, and each is a task of a pool of spawned processes of
    one torch thread each (one a CPU this process may use, at most one a
    task): one unpartitioned FLOP count a (arch, shape), shared by its
    meshes, and each partitioned cell's local program (its own fake
    world, torn down after).  A cell whose task or record raises is
    recorded as ``error``.  Returns the records run."""
    import concurrent.futures as cf
    import multiprocessing as mp_mod
    from ..configs import ASSIGNED_ARCHS, PAPER_ARCH, get_config
    from . import op_stats
    from ..configs import shape_supported
    from ..configs.shapes import SHAPES
    os.makedirs(out_dir, exist_ok=True)
    archs = archs or ASSIGNED_ARCHS + [PAPER_ARCH]
    shapes = shapes or list(SHAPES)
    meshes = list(meshes or (mesh_for(False), mesh_for(True)))
    opts = dict(dict(microbatches=1, remat=True, ce_impl="gather",
                     fsdp=True, moe_groups=1, num_periods=None), **opts)
    cells = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                name = cell_filename(arch, shape, mesh.name, tag)
                if os.path.exists(os.path.join(out_dir, name)):
                    log(f"[skip-cached] {arch} {shape} {mesh.name}")
                else:
                    cells.append((arch, shape, mesh))
    run = [c for c in cells if shape_supported(get_config(c[0]), c[1])]
    # the longest first: the local programs of the deepest train cells
    order = sorted(run, key=lambda c: (SHAPES[c[1]].kind == "decode",
                                       -len(c[2].sizes),
                                       -get_config(c[0]).num_layers))
    pairs = sorted({(a, s) for a, s, _ in run},
                   key=lambda p: (SHAPES[p[1]].kind == "decode",
                                  -get_config(p[0]).num_layers))
    tasks = [((a, s, m.name), _local_task, (a, s, m, opts))
             for a, s, m in order if partitionable(m)] + [
        ((a, s), _count_task, (a, s, opts)) for a, s in pairs]
    counts: Dict = {}
    locals_: Dict = {}
    seconds: Dict = {}
    failed: Dict = {}
    unplaced: Dict = {}
    if tasks:
        with cf.ProcessPoolExecutor(
                max_workers=min(len(os.sched_getaffinity(0)), len(tasks)),
                mp_context=mp_mod.get_context("spawn")) as pool:
            futs = {pool.submit(fn, *args): key for key, fn, args in tasks}
            for fut in cf.as_completed(futs):
                key = futs[fut]
                try:
                    value, seconds[key] = fut.result()
                except op_stats.PartitionError as e:
                    unplaced[key] = e
                    continue
                except Exception:
                    failed[key] = traceback.format_exc()
                    continue
                if len(key) == 2:
                    counts[_count_key(key[0], SHAPES[key[1]], opts)] = value
                else:
                    locals_[key] = value
    recs: List[dict] = []
    for arch, shape, mesh in cells:
        t0 = time.time()
        key = (arch, shape, mesh.name)
        try:
            for k in ((arch, shape), key):
                if k in failed:
                    raise RuntimeError(f"the task {k} failed:\n"
                                       f"{failed[k]}")
            if key in unplaced:
                e = unplaced[key]
                rec = {"arch": arch, "shape": shape, "mesh": mesh.name,
                       "tag": tag, "status": "error", "op": e.op,
                       "error": str(e)}
            else:
                rec = run_cell(arch, shape, "pod" in mesh.axis_names,
                               mesh=mesh, tag=tag, counts=counts,
                               local=locals_.get(key), **opts)
        except Exception:
            rec = {"arch": arch, "shape": shape, "mesh": mesh.name,
                   "tag": tag, "status": "error",
                   "error": traceback.format_exc()}
            log(rec["error"])
        secs = time.time() - t0 + seconds.get(key, 0.0)
        if mesh is meshes[0]:     # a (arch, shape)'s count is charged here
            secs += seconds.get((arch, shape), 0.0)
        rec["cell_s"] = round(secs, 2)
        _write(out_dir, rec)
        recs.append(rec)
        log(f"{summary(rec)} ({rec['cell_s']:.1f} s)")
    return recs


def parse_mesh(text: str):
    """``"2x2"`` -> a (data, model) ``LaunchMesh``; ``"2x4x2"`` -> (pod,
    data, model)."""
    from .mesh import LaunchMesh
    sizes = tuple(int(x) for x in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(sizes))
    if names is None or min(sizes) < 1:
        raise ValueError(f"--mesh {text!r}: DxM or PxDxM")
    return LaunchMesh(names, sizes)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=[],
                    help="the cell's arch; with --all, repeat to choose "
                         "several (default: every arch)")
    ap.add_argument("--shape", action="append", default=[],
                    help="as --arch, for the shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", action="append", default=[],
                    help="a DxM (data, model) or PxDxM (pod, data, model) "
                         "mesh in place of the production one; with "
                         "--all, repeat for several (default: both "
                         "production meshes)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a table")
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
    if args.table:
        print(table(args.out))
        return 0
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        t0 = time.time()
        recs = run_all(args.out, archs=args.arch or None,
                       shapes=args.shape or None, tag=args.tag,
                       meshes=[parse_mesh(m) for m in args.mesh] or None,
                       **opts)
        failed = [(r["arch"], r["shape"], r["mesh"]) for r in recs
                  if r["status"] == "error"]
        if failed:
            print("FAILED cells:", failed)
            return 1
        print(f"all cells OK ({len(recs)} run, {time.time() - t0:.1f} s)")
        return 0

    if len(args.arch) != 1 or len(args.shape) != 1 or len(args.mesh) > 1:
        print("without --all: one --arch, one --shape, at most one --mesh",
              file=sys.stderr)
        return 2
    arch, shape = args.arch[0], args.shape[0]
    mesh = parse_mesh(args.mesh[0]) if args.mesh else \
        mesh_for(args.multi_pod)
    try:
        rec = run_cell(arch, shape, "pod" in mesh.axis_names, mesh=mesh,
                       tag=args.tag, **opts)
    except Exception:
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape, "mesh": mesh.name,
               "tag": args.tag, "status": "error",
               "error": traceback.format_exc()}
    _write(args.out, rec)
    print(summary(rec))
    return 0 if rec["status"] != "error" else 1


if __name__ == "__main__":
    sys.exit(main())
