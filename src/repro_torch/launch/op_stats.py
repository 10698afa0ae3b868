"""What a cell's step costs, reckoned on the ``meta`` device (the port's
counterpart of ``repro/launch/hlo_stats.py``).

``repro`` reads XLA's ``cost_analysis()`` and ``memory_analysis()`` of a
compiled SPMD program and parses its HLO for collectives.  The port
compiles nothing, so it counts:

* ``count_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  port's own step run on meta tensors (the counter works from shapes:
  matrix products, convolutions, attention), total and by op;
* ``min_bytes``: each argument read once and each output written once,
  per device, from the shard shapes (``PERF.md``'s definition of a
  bound): the roofline's memory term;
* ``unfused_bytes``: the sum over the step's aten ops of their inputs
  and outputs (views excluded), an upper bound with no fusion at all;
  XLA's ``bytes accessed`` counts fused HLO, so nothing is compared with
  it;
* ``extract_memory``: argument, output and alias bytes exact from the
  shard shapes, and ``temp_size_in_bytes``, the peak of live
  intermediate bytes over the meta step at the per-device batch, tracked
  by a dispatch mode with weakref finalisers.  It is an estimate: the
  step's activations are not divided over ``model`` (no tensor-parallel
  program exists), and the intermediates include the outputs while they
  live.

No collective is counted: the port has no multi-card program (ROADMAP
A17), so ``CollectiveStats`` and the HLO parser have nothing to read.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from . import sharding as sh
from .mesh import LaunchMesh
from .specs import CellSpec, input_specs


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs, out: list) -> list:
    """The tensors among ``xs`` and its lists (an aten op's arguments)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


class OpStats(TorchDispatchMode):
    """Counts, over the aten ops run under it, the bytes each op reads
    and writes (``unfused_bytes``, with ``io``) and the peak of live bytes
    in storages that no tensor of ``exclude`` owns (``peak_bytes``): a
    storage counts from the op that first returns it until the last
    tensor the ops returned over it is freed (a weak reference's
    callback)."""

    def __init__(self, exclude: Iterable[torch.Tensor] = (),
                 io: bool = True):
        super().__init__()
        self.io = io
        self.unfused_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._exclude = {_key(t) for t in exclude}
        self._storages: Dict[int, list] = {}     # key -> [bytes, tensors]
        self._ids: Dict[int, weakref.ref] = {}   # id(tensor) -> its ref
        self._keys: Dict[weakref.ref, tuple] = {}  # ref -> (key, id)

    def _release(self, ref) -> None:
        key, tid = self._keys.pop(ref)
        if self._ids.get(tid) is ref:
            del self._ids[tid]
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self._exclude:
            return
        held = self._ids.get(id(t))
        if held is not None and held() is t:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
        entry[1] += 1
        ref = weakref.ref(t, self._release)
        self._ids[id(t)] = ref
        self._keys[ref] = (key, id(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,),
                        [])
        if self.io and not func.is_view:
            ins = _tensors(args, [])
            if kwargs:
                _tensors(kwargs.values(), ins)
            self.unfused_bytes += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class StepCount:
    """One meta run of a step: FLOPs (total and by op), the bytes its ops
    read and write, and the peak of its live intermediate bytes."""
    flops: float
    by_op: Dict[str, float]
    unfused_bytes: float
    peak_bytes: float


def run_counted(step_fn: Callable, args: Tuple, exclude=(),
                flops: bool = True) -> StepCount:
    """Run ``step_fn(*args)`` (meta tensors: nothing allocated, nothing
    launched) under ``OpStats`` and, with ``flops``, ``FlopCounterMode``."""
    stats = OpStats(exclude, io=flops)
    if flops:
        counter = FlopCounterMode(display=False)
        with counter, stats:
            step_fn(*args)
        total = float(counter.get_total_flops())
        by_op = {str(op): float(n) for op, n in
                 counter.get_flop_counts().get("Global", {}).items()}
    else:
        with stats:
            step_fn(*args)
        total, by_op = 0.0, {}
    return StepCount(total, by_op, float(stats.unfused_bytes),
                     float(stats.peak_bytes))


def count_flops(step_fn: Callable, args: Tuple
                ) -> Tuple[float, Dict[str, float]]:
    """``FlopCounterMode`` over one run of ``step_fn(*args)``: total FLOPs
    and FLOPs by aten op."""
    count = run_counted(step_fn, args)
    return count.flops, count.by_op


def unfused_bytes(step_fn: Callable, args: Tuple) -> float:
    """The bytes the aten ops of one run of ``step_fn(*args)`` read and
    write (views excluded): an upper bound with no fusion at all."""
    return run_counted(step_fn, args).unfused_bytes


def count_cell(cell: CellSpec) -> StepCount:
    """One counted meta run of the cell's step at its global batch."""
    return run_counted(cell.step_fn, cell.args,
                       exclude=cell.flat_args().values())


def _shard_bytes(shape, dtype: torch.dtype, spec: sh.Spec,
                 mesh: LaunchMesh) -> int:
    spec = sh.legalize(spec, shape, mesh)
    n = 1
    for d in sh.shard_shape(shape, spec, mesh):
        n *= d
    return n * dtype.itemsize


def argument_bytes(cell: CellSpec, mesh: Optional[LaunchMesh] = None
                   ) -> int:
    """Bytes of one device's shards of every argument."""
    mesh = mesh or cell.mesh
    return sum(_shard_bytes(t.shape, t.dtype, cell.arg_specs[p], mesh)
               for p, t in cell.flat_args().items())


def min_bytes(cell: CellSpec, mesh: Optional[LaunchMesh] = None) -> int:
    """Each argument read once and each output written once, per device:
    an in-place output counts only the part the step writes."""
    mesh = mesh or cell.mesh
    written = 0
    for o in cell.outputs:
        shape = o.written if o.written is not None else o.shape
        written += _shard_bytes(shape, o.dtype, o.spec, mesh)
    return argument_bytes(cell, mesh) + written


def local_cell(cell: CellSpec) -> CellSpec:
    """The cell at the batch one device holds (the tokens' shard)."""
    b = cell.local_batch
    if b == cell.shape.global_batch:
        return cell
    shape = dataclasses.replace(cell.shape, global_batch=b)
    return input_specs(cell.arch, shape, cell.mesh, **cell.opts)


def temp_bytes(cell: CellSpec, count: Optional[StepCount] = None) -> float:
    """The peak of live intermediate bytes over the step at the per-device
    batch (``count``: a run of this cell at its global batch, reused when
    that is the per-device batch)."""
    local = local_cell(cell)
    if local is cell and count is not None:
        return count.peak_bytes
    return run_counted(local.step_fn, local.args,
                       exclude=local.flat_args().values(),
                       flops=False).peak_bytes


def extract_memory(cell: CellSpec, mesh: Optional[LaunchMesh] = None,
                   count: Optional[StepCount] = None,
                   temp: Optional[float] = None) -> Dict[str, float]:
    """``repro``'s ``memory_analysis()`` fields for one device: argument,
    output and alias bytes from the shard shapes, temp bytes from a meta
    run at the per-device batch (an estimate, see the module's doc;
    ``temp``: that figure, when already reckoned)."""
    mesh = mesh or cell.mesh
    out = sum(_shard_bytes(o.shape, o.dtype, o.spec, mesh)
              for o in cell.outputs)
    alias = sum(_shard_bytes(o.shape, o.dtype, o.spec, mesh)
                for o in cell.outputs if o.alias)
    return {"argument_size_in_bytes": float(argument_bytes(cell, mesh)),
            "output_size_in_bytes": float(out),
            "alias_size_in_bytes": float(alias),
            "temp_size_in_bytes": float(
                temp_bytes(cell, count) if temp is None else temp)}
