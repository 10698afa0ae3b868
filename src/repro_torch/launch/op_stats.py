"""What a cell's step costs, reckoned on the ``meta`` device (the port's
counterpart of ``repro/launch/hlo_stats.py``).

``repro`` reads XLA's ``cost_analysis()`` and ``memory_analysis()`` of a
compiled SPMD program and parses its HLO for collectives.  The port
compiles nothing: it runs its own step once under ``OpStats``, a
dispatch mode that sees every aten op, and counts:

* FLOPs by op (``count_flops``), by the formulas of
  ``torch.utils.flop_counter`` (matrix products, convolutions,
  attention), as ``FlopCounterMode`` counts them;
* ``unfused_bytes``: the sum over the step's ops of their inputs and
  outputs (views excluded), an upper bound with no fusion at all;
  XLA's ``bytes accessed`` counts fused HLO, so nothing is compared with
  it;
* ``peak_bytes``: the peak of live intermediate bytes, tracked with
  weakref finalisers (``temp_size_in_bytes``);
* the collectives (``collect_collectives``): each ``_c10d_functional``
  op (and DTensor's ``shard_dim_alltoall``) with the group it runs over,
  priced by ``repro``'s ring rule.

On a partitioned cell (``input_specs(partitioned=True)``: DTensor
arguments over a fake world, ``launch/mesh.py``) the mode hands every
DTensor op to DTensor and sees the ops DTensor runs on the local shards:
so all of the above is rank 0's local program, the per-device figures
``repro`` reads from its SPMD-partitioned HLO.  The meta ops DTensor's
sharding propagation runs on global shapes (under a ``FakeTensorMode``)
are not counted.

The partition follows the specs, not DTensor's cost model, wherever the
specs say how: the mode places the operands of the ops that decide the
layout itself (``RULES``, each counted in ``StepCount.rules`` where it
acts), chosen by the op and its operands' placements.  FSDP: a weight
split over ``data`` is gathered before it computes.  Megatron: the
activations of a product with a weight are placed as its split asks
and a row-parallel product's partial sum is all-reduced at once, so the
residual stream stays replicated over ``model`` and the batch over the
data axes; the head is vocabulary-parallel, its log-sum-exp, gold logits
and their backward reduced across the vocabulary's shards; a fused
SwiGLU's halves move by collective-permutes; grouped-query attention
with fewer KV heads than shards replicates K and V and splits the
queries over their tokens.  Where no rule applies, DTensor's own
strategy places the op, and an op neither can place raises
``PartitionError`` naming it.  ``min_bytes`` (each argument read once and each output
written once, per device) and ``extract_memory``'s argument, output and
alias bytes come exact from the shard shapes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from . import sharding as sh
from .mesh import LaunchMesh
from .specs import CellSpec


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


# --------------------------------------------------------------------- #
# collectives (repro's hlo_stats.collect_collectives)
# --------------------------------------------------------------------- #
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")
# the collective ops of a partitioned step, by the name of their aten op
_COLLECTIVE_KIND = (("all_reduce", "all-reduce"),
                    ("all_gather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_to_all", "all-to-all"),
                    ("alltoall", "all-to-all"))
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
_COMM_NAMESPACES = {"_c10d_functional", "_c10d_functional_autograd",
                    "c10d", "_dtensor"}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of rank 0's program: its kind (``COLLECTIVE_OPS``),
    the bytes of its operands and of its result on this device, and the
    global ranks of its group."""
    kind: str
    in_bytes: int
    out_bytes: int
    ranks: Tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.ranks)

    @property
    def link_bytes(self) -> float:
        """Bytes this device sends over its link, by ``repro``'s ring
        rule (``hlo_stats.py``'s docstring): all-reduce 2 (n-1)/n s,
        all-gather (n-1)/n S_out, reduce-scatter (n-1)/n S_in, all-to-all
        (n-1)/n s, permute s.  ``repro``'s code multiplies a
        reduce-scatter's result shard instead of S_in, n times too little
        (ROADMAP C3); the port prices S_in."""
        frac = (self.n - 1) / self.n
        if self.kind == "all-reduce":
            return 2.0 * frac * self.out_bytes
        if self.kind == "reduce-scatter":
            return frac * self.in_bytes
        if self.kind == "collective-permute":
            return float(self.out_bytes)
        return frac * self.out_bytes


def _collective_kind(func) -> Optional[str]:
    """The kind of a communication op, ``None`` for the ops that move no
    bytes (``wait_tensor``); raises on a communication op it does not
    know, so nothing is left uncounted."""
    name = func._schema.name.split("::")[-1]
    if name in _NOT_COLLECTIVES:
        return None
    for key, kind in _COLLECTIVE_KIND:
        if key in name:
            return kind
    raise NotImplementedError(f"{func}: a communication op the dry run "
                              f"does not price")


def _group_ranks(func, args, kwargs) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    group = bound.get("group_name", bound.get("group"))
    if group is None:
        raise NotImplementedError(f"{func}: no group argument")
    if isinstance(group, str):
        group = _resolve_process_group(group)
    return tuple(dist.get_process_group_ranks(group))


@dataclasses.dataclass
class CollectiveStats:
    """``repro``'s record of a program's collectives, by kind: how many,
    the bytes of their results on a device, and the bytes it sends."""
    count: Dict[str, int]
    result_bytes: Dict[str, float]
    link_bytes: Dict[str, float]

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())

    def link_seconds(self, link_bw: float) -> float:
        return self.total_link_bytes / link_bw


def collect_collectives(ops: Iterable[Collective]) -> CollectiveStats:
    """The counterpart of ``repro``'s ``collect_collectives`` over a
    program's recorded collectives (a group of one moves nothing and is
    not counted, as there)."""
    count = {op: 0 for op in COLLECTIVE_OPS}
    result = {op: 0.0 for op in COLLECTIVE_OPS}
    link = {op: 0.0 for op in COLLECTIVE_OPS}
    for c in ops:
        if c.n <= 1 or c.out_bytes == 0:
            continue
        count[c.kind] += 1
        result[c.kind] += c.out_bytes
        link[c.kind] += c.link_bytes
    return CollectiveStats(count, result, link)


# --------------------------------------------------------------------- #
# the counting mode
# --------------------------------------------------------------------- #
def _dtensor_type():
    """DTensor's class, or ``None`` where ``torch.distributed`` is not
    built."""
    try:
        from torch.distributed.tensor import DTensor
        return DTensor
    except ImportError:
        return None


def _faking() -> bool:
    """Whether a ``FakeTensorMode`` is running the op: DTensor's sharding
    propagation runs each op once on global fake tensors."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class PartitionError(RuntimeError):
    """A DTensor op the dry run cannot partition: ``op`` names it."""

    def __init__(self, op: str, why: str):
        super().__init__(f"{op}: {why}")
        self.op, self.why = op, why

    def __reduce__(self):
        return PartitionError, (self.op, self.why)


def _local(t):
    """A DTensor's local tensor (lists too); anything else as is."""
    if hasattr(t, "placements"):
        return t.to_local()
    if isinstance(t, (list, tuple)):
        return type(t)(_local(x) for x in t)
    return t


def _placed(t, placements):
    """``t`` redistributed to ``placements`` (itself where it has them)."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, tuple(placements))


def _replicated(t):
    """``t`` with every DTensor in it (lists too) replicated on every
    mesh axis (all-gathers, all-reduces of partial sums)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return _placed(t, [Replicate()] * t.device_mesh.ndim)
    if isinstance(t, (list, tuple)):
        return type(t)(_replicated(x) for x in t)
    return t


def _model_axis(t) -> Optional[int]:
    names = t.device_mesh.mesh_dim_names or ()
    return names.index(MODEL_AXIS) if MODEL_AXIS in names else None


def _model_reduced(out):
    """A product's result with a partial sum over ``model`` all-reduced at
    once: the row-parallel product's all-reduce (Megatron), which keeps
    the residual stream replicated over ``model``."""
    from torch.distributed.tensor import Replicate
    i = _model_axis(out)
    if i is None or not out.placements[i].is_partial():
        return out
    return _placed(out, [Replicate() if j == i else p
                         for j, p in enumerate(out.placements)])


def _resolve_partial(func, args, kwargs, note):
    """``aten.gather`` over a dimension split over an axis gives a masked
    partial result (each shard gathers the indices it holds): the gather
    CE over a vocabulary split over ``model`` (the vocabulary-parallel
    head) is such a case, and so is one over ``data``.  The partial is
    summed at once by an all-reduce, the vocabulary-parallel gather's own
    collective (redistributing a masked partial to a shard fails in
    DTensor's mask buffer)."""
    from torch.distributed.tensor import Replicate
    out = func(*args, **kwargs)
    if any(p.is_partial() for p in out.placements):
        note("gather_partial")
        out = _placed(out, [Replicate() if p.is_partial() else p
                            for p in out.placements])
    return out


def _logsumexp_split(func, args, kwargs, note):
    """``logsumexp`` over a dimension split over an axis (the CE of the
    vocabulary-parallel head): the maximum and the sum of exponentials
    are reduced across the shards by two all-reduces of one value a row,
    as Megatron's vocabulary-parallel CE does, where DTensor would gather
    the whole row (the full-vocabulary logits on every device)."""
    x, dims = args[0], args[1]
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    dims = [d % x.ndim for d in ([dims] if isinstance(dims, int)
                                 else dims)]
    if not any(p.is_shard() and p.dim % x.ndim in dims
               for p in x.placements):
        return NotImplemented
    note("logsumexp_split")
    m = _replicated_partials(torch.amax(x, dims, keepdim=True))
    s = _replicated_partials(torch.sum(torch.exp(x - m), dims,
                                       keepdim=True))
    out = torch.log(s) + m
    if not keepdim:
        for d in sorted(dims, reverse=True):   # one at a time: torch 2.11
            out = out.squeeze(d)               # places no squeeze.dims
    return out


def _replicated_partials(t):
    from torch.distributed.tensor import Replicate
    return _placed(t, [Replicate() if p.is_partial() else p
                       for p in t.placements])


def _index_put(func, args, kwargs, note):
    """``index_put`` / ``index_put_``, placed by the destination's and the
    indices' placements (DTensor's own strategies for them differ between
    torch releases):

    * the destination split on an indexed dimension (the decode step
      writes the new token's K and V at ``cache_len`` of a cache whose
      sequence is split over ``model``; the backward of the MoE's token
      gather into a batch split over ``data``): as an SPMD partitioner
      writes a dynamic update into a split dimension, the indices and
      values are replicated (all-gathers; the values stay split where
      the destination is on a dimension it does not index) and each
      shard writes the entries that fall in its block; rank 0's block
      starts at 0, so an
      entry past its end is clamped into the block and writes back the
      value it finds there, or adds zero where the write accumulates (a
      select, no FLOP).  Exact where at most one entry of a row falls
      past the block's end, as each row's one new position does, and
      always where the write accumulates;
    * an accumulating write into a destination split on no indexed
      dimension, with indices split over an axis (the backward of the
      embedding lookup: each shard scatter-adds the gradients of its
      tokens): the values are placed as the indices and the destination,
      each shard accumulates its own rows, and the result is a partial
      sum over those axes (rank 0 holds the destination, the others
      zeros), which the parameter's gradient hook reduce-scatters."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dst, indices, values = args[0], list(args[1]), args[2]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                          False)
    if not isinstance(dst, DTensor):
        return NotImplemented
    k = len(indices)
    indexed = {d for d, i in enumerate(indices) if i is not None}
    split = {p.dim for p in dst.placements if p.is_shard()}
    if split & indexed:
        pos = sorted(indexed)
        note("index_put_shards")
        local = dst.to_local()
        idx, fits = [], None
        for d, i in enumerate(indices):
            if i is not None:
                i = _local(_replicated(i))
                if local.shape[d] != dst.shape[d]:
                    inside = i < local.shape[d]
                    fits = inside if fits is None else fits & inside
                    i = i.clamp(0, local.shape[d] - 1)
            idx.append(i)
        # a split dimension that is not indexed: the values split alike
        # (the indices' broadcast dimensions stand where the indexed ones
        # do when those are adjacent, else first)
        nb = len(torch.broadcast_shapes(*[i.shape for i in idx
                                          if i is not None]))
        rest = [d for d in range(dst.ndim) if d not in indexed]
        adjacent = pos == list(range(pos[0], pos[-1] + 1))
        vpl = []
        for p in dst.placements:
            d = p.dim % dst.ndim if p.is_shard() else None
            if d is None or d in indexed:
                vpl.append(_replicate())
            elif adjacent:
                vpl.append(Shard(d if d < pos[0] else d - len(pos) + nb))
            else:
                vpl.append(Shard(nb + rest.index(d)))
        vals = _local(_placed(values, vpl)) if isinstance(values, DTensor) \
            else values
        if fits is not None:
            # where the index broadcast's dimensions land in the result
            shape = list(torch.broadcast_shapes(
                *[i.shape for i in idx if i is not None]))
            if adjacent:
                mask = [1] * pos[0] + shape + [1] * (local.ndim - pos[-1]
                                                     - 1)
            else:
                mask = shape + [1] * (local.ndim - len(pos))
            found = torch.ops.aten.index.Tensor(local, idx)
            keep = torch.zeros_like(found) if accumulate else found
            vals = torch.where(fits.expand(shape).reshape(mask),
                               vals.expand_as(found), keep)
        out = func(local, idx, vals, accumulate)
        if func.name().endswith("_"):
            return dst
        return DTensor.from_local(out, dst.device_mesh, dst.placements,
                                  run_check=False)
    lead = sorted(indexed)
    if not accumulate or lead != list(range(len(lead))):
        return NotImplemented
    if func.name().endswith("_"):
        raise PartitionError(str(func), "an in-place accumulating "
                             "index_put_ with split indices")
    ipl = [i.placements for i in indices if isinstance(i, DTensor)]
    if not ipl:
        return NotImplemented
    nb = max(i.ndim for i in indices if i is not None)
    out_pl, val_pl, idx_pl = [], [], []
    for a in range(dst.device_mesh.ndim):
        pa = dst.placements[a]
        if pa.is_shard():       # a dimension that is not indexed
            out_pl.append(pa)
            val_pl.append(Shard(nb + pa.dim - k))
            idx_pl.append(Replicate())
        elif any(pl[a].is_shard() for pl in ipl):
            d = next(pl[a].dim for pl in ipl if pl[a].is_shard())
            out_pl.append(Partial())
            val_pl.append(Shard(d))
            idx_pl.append(Shard(d))
        else:
            out_pl.append(pa)
            val_pl.append(Replicate())
            idx_pl.append(Replicate())
    if not any(p.is_partial() for p in out_pl):
        return NotImplemented
    note("index_put_partial")
    idx = [None if i is None else _local(_placed(i, idx_pl))
           for i in indices]
    vals = _local(_placed(values, val_pl))
    local = _local(_placed(dst, [Replicate() if p.is_partial() else p
                                 for p in out_pl]))
    out = func(local, idx, vals, accumulate)
    return DTensor.from_local(out, dst.device_mesh, out_pl,
                              run_check=False, shape=dst.shape,
                              stride=dst.stride())


def _permuted_blocks(x, dim: int, start: int, end: int):
    """Where ``x[dim][start:end]`` keeps one block a shard: ``x`` split on
    ``dim`` over one mesh axis only, in n even blocks, and the slice's n
    blocks each inside one of them (the halves of a fused SwiGLU
    projection over ``model``).  Returns ``(axis, n, [the source shard of
    each block])``, or ``None``."""
    axes = [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim % x.ndim == dim]
    if len(axes) != 1 or type(x.placements[axes[0]]).__name__ != "Shard":
        return None
    i = axes[0]
    n = x.device_mesh.mesh.shape[i]
    src = _block_sources(x.shape[dim], n, start, end)
    return None if src is None else (i, n, src)


def _block_sources(size: int, n: int, start: int, end: int
                   ) -> Optional[List[int]]:
    """The shard of ``size`` split n ways that holds each of the n even
    blocks of ``[start, end)``, or ``None`` where one straddles two."""
    length = end - start
    if size % n or length % n or length <= 0:
        return None
    blk, out = size // n, length // n
    src = [(start + j * out) // blk for j in range(n)]
    if any((start + (j + 1) * out - 1) // blk != src[j] for j in range(n)):
        return None
    return src


def _axis_ranks(t, i: int) -> Tuple[int, ...]:
    import torch.distributed as dist
    return tuple(dist.get_process_group_ranks(t.device_mesh.get_group(i)))


def _slice_blocks(func, args, kwargs, note, record):
    """``x[..., start:end]`` of a dimension split over one axis, whose
    slice keeps one block a shard (``_permuted_blocks``: the gate and the
    up halves of a fused SwiGLU ``wi`` split over ``model``): each shard
    receives its block of the slice from the shard that holds it, one
    collective-permute, as an SPMD partitioner moves it, where DTensor
    would gather the whole dimension on every shard.  Rank 0's block is
    its own where the slice starts in its shard; else it stands in for
    the received one (same shape)."""
    from torch.distributed.tensor import DTensor
    x, dim = args[0], args[1] if len(args) > 1 else kwargs.get("dim", 0)
    start = args[2] if len(args) > 2 else kwargs.get("start", 0)
    end = args[3] if len(args) > 3 else kwargs.get("end", None)
    step = args[4] if len(args) > 4 else kwargs.get("step", 1)
    if not isinstance(x, DTensor) or step != 1:
        return NotImplemented
    dim %= x.ndim
    size = x.shape[dim]
    start = 0 if start is None else min(max(start + size if start < 0
                                            else start, 0), size)
    end = size if end is None else min(max(end + size if end < 0
                                           else end, 0), size)
    found = _permuted_blocks(x, dim, start, end)
    if found is None:
        return NotImplemented
    i, n, src = found
    note("slice_permuted")
    blk, out = size // n, (end - start) // n
    local = x.to_local()
    off = start - src[0] * blk if src[0] == 0 else 0
    block = local.narrow(dim, off, out)
    if src != list(range(n)):
        record("collective-permute", block, _axis_ranks(x, i))
    shape = list(x.shape)
    shape[dim] = end - start
    return DTensor.from_local(block, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _slice_backward_blocks(func, args, kwargs, note, record):
    """The backward of ``_slice_blocks``: each shard's block of the
    gradient goes back to the shard that holds its slice (one
    collective-permute) into zeros of the input's shards."""
    from torch.distributed.tensor import DTensor
    g, sizes, dim, start, end, step = args
    if not isinstance(g, DTensor) or step != 1:
        return NotImplemented
    dim %= g.ndim
    size = sizes[dim]
    start = min(max(start + size if start < 0 else start, 0), size)
    end = min(max(end + size if end < 0 else end, 0), size)
    axes = [i for i, p in enumerate(g.placements)
            if p.is_shard() and p.dim % g.ndim == dim]
    if len(axes) != 1:
        return NotImplemented
    i = axes[0]
    n = g.device_mesh.mesh.shape[i]
    src = _block_sources(size, n, start, end)
    if src is None:
        return NotImplemented
    blk, out = size // n, (end - start) // n
    note("slice_backward_permuted")
    gl = g.to_local()
    shape = list(gl.shape)
    shape[dim] = blk
    local = gl.new_zeros(shape)
    for j in range(n):          # rank 0's shard receives the blocks it holds
        if src[j] == 0:
            local.narrow(dim, start + j * out, out).copy_(gl)
    if src != list(range(n)):
        record("collective-permute", gl, _axis_ranks(g, i))
    full = list(sizes)
    return DTensor.from_local(local, g.device_mesh, g.placements,
                              run_check=False, shape=torch.Size(full),
                              stride=_contiguous_stride(full))


def _local_shape(shape, placements, sizes) -> List[int]:
    """Rank 0's block of ``shape`` under ``placements``: each split
    dimension cut as ``torch.chunk`` cuts it (rank 0's block the first,
    the larger where it does not divide)."""
    out = list(shape)
    for p, n in zip(placements, sizes):
        if p.is_shard():
            d = p.dim % len(out)
            out[d] = -(-out[d] // n)
    return out


def _scatter_add_shards(func, args, kwargs, note):
    """``scatter_add`` into a tensor split on the scattered dimension
    (the backward of the vocabulary-parallel gather: each gold logit's
    gradient lands in the shard that holds its word): the index and the
    source are replicated, and each shard adds the entries that fall in
    its block; rank 0's block starts at 0, so an entry past its end is
    clamped into the block and adds zero (a select).  Exact."""
    from torch.distributed.tensor import DTensor
    dst, dim, index, src = args[:4]
    if not isinstance(dst, DTensor):
        return NotImplemented
    dim %= dst.ndim
    if not any(p.is_shard() and p.dim % dst.ndim == dim
               for p in dst.placements):
        return NotImplemented
    note("scatter_add_shards")
    local = dst.to_local()
    want = [p if p.is_shard() and p.dim % dst.ndim != dim else _replicate()
            for p in dst.placements]
    idx = _local(_placed(index, want)) if isinstance(index, DTensor) \
        else index
    vals = _local(_placed(src, want)) if isinstance(src, DTensor) else src
    inside = idx < local.shape[dim]
    vals = torch.where(inside, vals, torch.zeros_like(vals))
    out = func(local, dim, idx.clamp(0, local.shape[dim] - 1), vals)
    if func.name().endswith("_"):
        return dst
    return DTensor.from_local(out, dst.device_mesh, dst.placements,
                              run_check=False, shape=dst.shape,
                              stride=dst.stride())


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _into_plain(func, args, kwargs, note):
    """An in-place op on a plain tensor with DTensor operands (a mask
    made with ``torch.ones`` and ``&=`` a comparison of decode positions;
    ``apply_moe``'s counts and expert buffers, zeros that
    ``scatter_add_`` / ``index_add_`` fill): under
    ``implicit_replication`` the plain tensor is the same on every rank,
    so its operands are replicated first (all-gathers) and the op runs on
    local tensors.  Exact, and what the plain tensor costs: the work is
    done whole on every rank."""
    note("into_plain")
    return func(*_local(_replicated(args)),
                **{k: _local(_replicated(v)) for k, v in kwargs.items()})


def _view_groups(a: Sequence[int], b: Sequence[int]
                 ) -> List[Tuple[List[int], List[int]]]:
    """The dimensions of shapes ``a`` and ``b`` (equal numels) in the
    smallest groups of equal products, in order."""
    out, i, j = [], 0, 0
    while i < len(a) or j < len(b):
        ga, gb, pa, pb = [], [], 1, 1
        if i < len(a):
            ga.append(i)
            pa *= a[i]
            i += 1
        if j < len(b):
            gb.append(j)
            pb *= b[j]
            j += 1
        while pa != pb:
            if pa < pb:
                ga.append(i)
                pa *= a[i]
                i += 1
            else:
                gb.append(j)
                pb *= b[j]
                j += 1
        out.append((ga, gb))
    return out


def _view_keeps(shape, new_shape, placements, sizes) -> bool:
    """Whether a view of ``shape`` as ``new_shape`` keeps the shards of
    ``placements`` (mesh axes of ``sizes``) as plain shards: a split
    dimension that the view splits in several leaves its shards to the
    outermost of them, which must divide by their number; one that the
    view merges with others must be the outermost of them (torch 2.13
    would place an inner one as a strided shard, 2.11 refuses it: the
    partition moves it, ``_reshape_whole``)."""
    ways: Dict[int, int] = {}
    for p, n in zip(placements, sizes):
        if p.is_shard():
            d = p.dim % len(shape)
            ways[d] = ways.get(d, 1) * n
    for ga, gb in _view_groups(list(shape), list(new_shape)):
        big_a = [d for d in ga if shape[d] > 1]
        big_b = [d for d in gb if new_shape[d] > 1]
        split = [d for d in big_a if d in ways]
        if not split:
            continue
        if len(big_a) > 1 and (split != [big_a[0]] or len(big_b) > 1):
            return False
        if len(big_b) > 1 and new_shape[big_b[0]] % ways[big_a[0]]:
            return False
    return True


def _reshape_whole(func, args, kwargs, note):
    """A view or reshape that would not keep a shard (``_view_keeps``)
    moves it, by the placements alone:

    * a split that cannot keep it (K or V, ``hkv * hd`` features into
      fewer heads than shards) gathers the tensor on that axis: the KV
      heads are replicated over ``model``, as Megatron replicates them
      where they are fewer than its ranks (an all-gather;
      ``partitioned_mha`` then keeps each shard's KV head);
    * a merge whose inner dimension is split moves the shard to the
      outermost merged dimension where it divides, else to a dimension
      the view leaves alone (an all-to-all);

    where neither keeps the shards, the tensor is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    x, new_shape = args[0], list(args[1])
    if -1 in new_shape:
        rest = 1
        for n in new_shape:
            rest *= n if n != -1 else 1
        new_shape[new_shape.index(-1)] = x.numel() // max(rest, 1)
    sizes = x.device_mesh.mesh.shape
    if _view_keeps(x.shape, new_shape, x.placements, sizes):
        return NotImplemented
    groups = _view_groups(list(x.shape), list(new_shape))
    group_of = {d: (ga, gb) for ga, gb in groups for d in ga}
    untouched = [ga[0] for ga, gb in groups if len(ga) == 1 and len(gb) == 1]

    def free(d: int, n: int, want) -> bool:
        ways = 1
        for b, q in enumerate(want):
            if q.is_shard() and q.dim % x.ndim == d:
                ways *= sizes[b]
        return x.shape[d] % (ways * n) == 0

    want = list(x.placements)
    moved = False
    for a, p in enumerate(x.placements):
        if not p.is_shard() or _view_keeps(x.shape, new_shape, [p],
                                           [sizes[a]]):
            continue
        d = p.dim % x.ndim
        ga, gb = group_of[d]
        big_a = [e for e in ga if x.shape[e] > 1]
        if len(big_a) > 1 and d != big_a[0]:          # an inner merge
            targets = [big_a[0]] + sorted(
                (e for e in untouched if e != d),
                key=lambda e: -x.shape[e])
        else:
            targets = []
        for e in targets:
            if free(e, sizes[a], want):
                want[a] = Shard(e)
                moved = True
                break
        else:
            want[a] = Replicate()
    if not _view_keeps(x.shape, new_shape, want, sizes):
        want = [Replicate() if p.is_shard() else p for p in x.placements]
        moved = False
    note("reshape_moved" if moved else "reshape_gathered")
    return func(_placed(x, want), *args[1:], **kwargs)


def _axis_ways(placements, sizes, dim: int) -> int:
    """The shards a dimension is split in under ``placements``."""
    n = 1
    for p, size in zip(placements, sizes):
        if p.is_shard() and p.dim == dim:
            n *= size
    return n


def _flip_local(func, args, kwargs, note):
    """``flip`` (the SSD scan's reversed cumulative sums): on the local
    block where no flipped dimension is split, else on the tensor
    gathered on the axes that split one (torch 2.11 has no strategy for
    it)."""
    from torch.distributed.tensor import DTensor, Replicate
    x, dims = args[0], [d % args[0].ndim for d in args[1]]
    want = [Replicate() if p.is_shard() and p.dim % x.ndim in dims else p
            for p in x.placements]
    if want != list(x.placements):
        note("flip_gathered")
        x = _placed(x, want)
    out = func(x.to_local(), dims)
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def partitioned_mha(q, k, v, **kw):
    """``models.layers.mha`` over DTensors, as an SPMD program runs
    attention: on each shard's local block, so no op inside it is placed
    by DTensor (its einsums merge the batch with the heads, which torch
    2.11 cannot place and 2.13 places as strided shards).  The batch
    stays on the data axes; on ``model``:

    * K and V split on their sequence (the decode cache's spec): each
      shard attends over its block of the cache with every query head,
      and the partial outputs and their softmax statistics are merged by
      all-reduces (split-K, as flash-decoding merges);
    * else the heads split over ``model`` where the KV heads divide
      (no collective);
    * else the query heads split over ``model`` (unevenly where they do
      not divide: rank 0 holds the first and most, as a padded split),
      K and V are replicated over ``model`` and each shard keeps the KV
      heads of its query heads (rank 0's: the first); an uneven split's
      output is gathered for the output projection.

    Rank 0's positions and masks are its rows (and, split-K, its
    columns) of the plain ones the model made."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..models import layers as L
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    sizes = mesh.mesh.shape
    blhd = kw.get("kv_layout", "blhd") == "blhd"
    hk, tk = (2, 1) if blhd else (1, 2)
    B, Tq, Hq, _ = q.shape
    Hkv = k.shape[hk]
    g = Hq // Hkv
    if not isinstance(k, DTensor):
        k = DTensor.from_local(k, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
        v = DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    qp, kp, rows, cols = [], [], 1, 1
    mode = "whole"
    for a, name in enumerate(names):
        n = sizes[a]
        if name in _DATA_AXES:
            on = q.placements[a].is_shard() and B % (rows * n) == 0
            qp.append(Shard(0) if on else Replicate())
            kp.append(Shard(0) if on else Replicate())
            rows *= n if on else 1
        elif k.placements[a].is_shard() and \
                k.placements[a].dim % k.ndim == tk:
            qp.append(Replicate())
            kp.append(Shard(tk))
            cols *= n
            mode = "split-k"
        elif Hkv % n == 0:
            qp.append(Shard(2))
            kp.append(Shard(hk))
            mode = "heads"
        else:
            qp.append(Shard(2))
            kp.append(Replicate())
            mode = "q-heads"
    ql = _placed(q, qp).to_local()
    kl = _placed(k, kp).to_local()
    vl = _placed(v, kp).to_local()
    if mode == "q-heads":
        # rank 0's query heads are the first; each keeps its KV head
        qn = ql.shape[2]
        if qn <= g and g % qn == 0:
            kv = torch.zeros(1, dtype=torch.long, device=kl.device)
        else:
            kv = torch.arange(qn, device=kl.device) // g
        kl, vl = kl.index_select(hk, kv), vl.index_select(hk, kv)

    def local(t, seq: bool):
        """Rank 0's rows (and split-K columns) of a position or mask."""
        if t is None:
            return None
        if isinstance(t, DTensor):
            t = _replicated(t).to_local()
        t = t.narrow(0, 0, t.shape[0] // rows) if t.shape[0] == B else t
        if seq and cols > 1:
            t = t.narrow(1, 0, t.shape[1] // cols)
        return t
    kw = dict(kw, q_positions=local(kw.get("q_positions"), False),
              kv_positions=local(kw.get("kv_positions"), True),
              kv_valid=local(kw.get("kv_valid"), True))
    out = L.mha(ql, kl, vl, **kw)
    if mode != "split-k":
        out = DTensor.from_local(out, mesh, qp, run_check=False,
                                 shape=q.shape,
                                 stride=_contiguous_stride(q.shape))
        if Hq % _axis_ways(qp, sizes, 2):
            # heads split unevenly: gathered for the output projection,
            # whose rows cannot split on head bounds
            out = _placed(out, [Replicate() if p.is_shard() and p.dim == 2
                                else p for p in qp])
        return out
    # the partial outputs and the rows' softmax statistics (max and sum,
    # float32) summed over the sequence's shards
    merge = [Partial() if kp[a].is_shard() and kp[a].dim == tk else qp[a]
             for a in range(mesh.ndim)]
    whole = [Replicate() if p.is_partial() else p for p in merge]
    stats = out.new_zeros(out.shape[:-1] + (2,), dtype=torch.float32)
    _placed(DTensor.from_local(stats, mesh, merge, run_check=False), whole)
    return _placed(DTensor.from_local(out, mesh, merge, run_check=False,
                                      shape=q.shape,
                                      stride=_contiguous_stride(q.shape)),
                   whole)


def partitioned_moe(p, cfg, x):
    """``models.layers.apply_moe`` over DTensors, expert-parallel as the
    specs split the experts over ``model``: each shard routes its own
    tokens (the batch on the data axes, the tokens replicated over
    ``model`` as the residual stream is) over every expert, computes the
    products of its experts only (rank 0 the first ``E / n``) and the
    shards' outputs are summed over ``model`` (an all-reduce, as the
    row-parallel products').  The router and the experts are gathered
    over the data axes first (FSDP), where DTensor would make the MoE's
    plain buffers whole, the global batch's tokens on every shard.  The
    load-balancing loss is the shard's own tokens'."""
    import types
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from ..models import layers as L
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    i = names.index(MODEL_AXIS) if MODEL_AXIS in names else None

    def fsdp(w):
        return _placed(w, [Replicate() if n in _DATA_AXES else pl
                           for n, pl in zip(names, w.placements)])
    xp = [Replicate() if a == i else pl
          for a, pl in enumerate(x.placements)]
    xl = _placed(x, xp).to_local()
    wi, wo = fsdp(p.wi), fsdp(p.wo)
    local = types.SimpleNamespace(router=_replicated(p.router).to_local(),
                                  wi=wi.to_local(), wo=wo.to_local())
    n = local.wi.shape[0]
    y, aux = L.apply_moe(local, cfg, xl, experts=(0, n))
    part = [Partial() if a == i and n < cfg.num_experts else pl
            for a, pl in enumerate(xp)]
    y = _placed(DTensor.from_local(y, mesh, part, run_check=False,
                                   shape=x.shape, stride=x.stride()), xp)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return y, aux


# the products: a weight among their operands is placed by its spec
_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}
# the lookups and convolutions with a weight (gathered over the data axes)
_LOOKUPS = {torch.ops.aten.embedding.default, torch.ops.aten.index.Tensor,
            torch.ops.aten.convolution.default}
_DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"
# the head's weights: tied (the embedding, transposed) or not
HEAD_PARAMS = ("embed", "lm_head")


def _writes_first(func) -> bool:
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None and \
        args[0].alias_info.is_write


# every rule the partition applies, by the name it is counted under
RULES = ("fsdp_gather", "head_vocab_split", "row_parallel_all_reduce",
         "lookup_model_gather", "gather_partial", "logsumexp_split",
         "logits_grad_vocab_split", "scatter_add_shards",
         "index_put_shards", "index_put_partial", "into_plain",
         "reshape_gathered", "reshape_moved", "slice_permuted",
         "slice_backward_permuted", "flip_gathered")

# DTensor ops placed by their operands' placements (see each rule); a
# rule returns ``NotImplemented`` where DTensor's own strategy applies.
# Each rule's collectives are counted, and each acting rule is counted in
# ``OpStats.rules``.
PARTITION_RULES = {torch.ops.aten.gather.default: _resolve_partial,
                   torch.ops.aten.logsumexp.default: _logsumexp_split,
                   torch.ops.aten.index_put_.default: _index_put,
                   torch.ops.aten.index_put.default: _index_put,
                   torch.ops.aten.view.default: _reshape_whole,
                   torch.ops.aten._unsafe_view.default: _reshape_whole,
                   torch.ops.aten.reshape.default: _reshape_whole,
                   torch.ops.aten.slice.Tensor: _slice_blocks,
                   torch.ops.aten.scatter_add.default: _scatter_add_shards,
                   torch.ops.aten.flip.default: _flip_local,
                   torch.ops.aten.scatter_add_.default: _scatter_add_shards,
                   torch.ops.aten.slice_backward.default:
                       _slice_backward_blocks}
# the rules that record a collective they issue themselves
_RECORDING = {_slice_blocks, _slice_backward_blocks}


class OpStats(TorchDispatchMode):
    """Counts, over the aten ops run under it: FLOPs by op (``flops``,
    ``by_op``), the bytes each op reads and writes (``unfused_bytes``,
    with ``io``), the peak of live bytes in storages that no tensor of
    ``exclude`` owns (``peak_bytes``: a storage counts from the op that
    first returns it until the last tensor the ops returned over it is
    freed, a weak reference's callback), and the collectives
    (``collectives``).  A DTensor op is placed by the partition's rules
    where one applies (products, lookups, ``PARTITION_RULES``, in-place
    ops on plain tensors) and handed to DTensor, so the mode counts the
    local program."""

    def __init__(self, exclude: Iterable[torch.Tensor] = (),
                 io: bool = True, flops: bool = True,
                 params: Dict[str, torch.Tensor] = None):
        super().__init__()
        self.io = io
        self.flops_on = flops
        self.flops = 0.0
        self.by_op: Dict[str, float] = collections.defaultdict(float)
        self.unfused_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collectives: List[Collective] = []
        self.rules: Dict[str, int] = collections.Counter()
        self._dtensor = _dtensor_type()
        self._fixing = False
        self._exclude = {_key(t) for t in exclude}
        params = params or {}
        local = dict(zip(params, local_tensors(params.values())))
        self._params = {_key(t) for t in local.values()}
        # the head's weights (by their shards) and their vocabulary sizes
        self._head = {_key(local[n]): t.shape[0 if n.endswith("embed")
                                              else -1]
                      for n, t in params.items()
                      if n.split(".")[-1] in HEAD_PARAMS}
        self.last_op: Optional[str] = None
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

    def _is_param(self, t) -> bool:
        return isinstance(t, self._dtensor) and \
            _key(t._local_tensor) in self._params

    def _weight(self, t, head: bool = False):
        """The placements a parameter operand (or a view of one) computes
        with, where they differ from its own; else ``None``.  Its data
        axes are replicated (``data`` on a weight is the specs' FSDP
        axis, ``launch/sharding.py``: FSDP gathers a layer's weights
        before it runs them).  In a product (``head``) the head's weight
        (``HEAD_PARAMS``, or its transpose) is
        split over ``model`` on the vocabulary (unevenly where the
        vocabulary does not divide: rank 0 holds the larger block, as a
        padded SPMD split does): the vocabulary-parallel head, whose
        logits stay split."""
        if not self._is_param(t):
            return None
        from torch.distributed.tensor import Replicate, Shard
        names = t.device_mesh.mesh_dim_names or ()
        want = [Replicate() if p.is_shard() and names[i] in _DATA_AXES
                else p for i, p in enumerate(t.placements)]
        i = _model_axis(t)
        vocab = self._head.get(_key(t._local_tensor))
        if head and vocab is not None and i is not None:
            # the head's weight or its transpose: split on the vocabulary
            want[i] = Shard(max(d for d, n in enumerate(t.shape)
                                if n == vocab))
        return None if list(t.placements) == want else want

    def _product(self, func, args, kwargs, note):
        """A matrix product: a parameter operand on its spec's placements
        less the data axes (``_weight``); where the second operand is a
        weight (``x @ w``, and the backward's ``g @ w.T``), the
        activation on ``model`` as the weight's split asks (its
        contraction split where the weight's rows are, its experts where
        the weight's are, else replicated), and the product's partial sum
        over ``model`` all-reduced at once (``_model_reduced``).  Given
        these operands DTensor's strategy is the one that moves nothing.
        A product of two activations (attention's, the backward's weight
        gradients) is DTensor's to place: its partial sums are reduced
        where they are used."""
        from torch.distributed.tensor import Replicate, Shard
        args = list(args)
        ia, ib = (0, 1) if func in (torch.ops.aten.mm.default,
                                    torch.ops.aten.bmm.default) else (1, 2)
        a = args[ia]
        weight_b = self._is_param(args[ib])
        for j in (ia, ib):
            want = self._weight(args[j], head=True)
            if want is not None:
                note("head_vocab_split" if _key(args[j]._local_tensor)
                     in self._head else "fsdp_gather")
                args[j] = _placed(args[j], want)
        b = args[ib]
        i = _model_axis(a) if isinstance(a, self._dtensor) else None
        if i is not None and weight_b:
            pb = b.placements[i]
            if pb.is_shard() and pb.dim % b.ndim == b.ndim - 2:
                want = Shard(a.ndim - 1)
            elif pb.is_shard() and b.ndim == 3 and pb.dim % 3 == 0:
                want = Shard(0)
            else:
                want = Replicate()
            args[ia] = _placed(a, [want if j == i else p
                                   for j, p in enumerate(a.placements)])
        out = func(*args, **kwargs)
        if not weight_b:
            return out
        reduced = _model_reduced(out)
        if reduced is not out:
            note("row_parallel_all_reduce")
        return reduced

    def _lookup(self, func, args, kwargs, note):
        """An embedding lookup or a convolution with a weight: the weight
        gathered over the data axes (``_weight``); a lookup's output is
        gathered over ``model`` (its features split there), so the
        residual stream is replicated over ``model``, as the products
        keep it."""
        from torch.distributed.tensor import Replicate
        args = list(args)
        j = 1 if func is torch.ops.aten.convolution.default else 0
        want = self._weight(args[j])
        if not self._is_param(args[j]):
            return NotImplemented
        if want is not None:
            note("fsdp_gather")
            args[j] = _placed(args[j], want)
        out = func(*args, **kwargs)
        i = _model_axis(out)
        if j == 0 and i is not None and out.placements[i].is_shard():
            note("lookup_model_gather")
            out = _placed(out, [Replicate() if k == i else p
                                for k, p in enumerate(out.placements)])
        return out

    def _zeros_like_logits(self, func, args, kwargs, note):
        """``new_zeros`` of the logits' shape from a tensor replicated
        over ``model`` (the backward of the gather CE makes the logits'
        gradient so): placed as the vocabulary-parallel head's logits
        are, the vocabulary over ``model`` and the batch over the data
        axes, where DTensor would make it whole on every shard
        (``_scatter_add_shards`` fills it)."""
        from torch.distributed.tensor import DTensor, Shard
        src, size = args[0], list(args[1])
        i = _model_axis(src)
        if i is None or not size or size[-1] not in \
                set(self._head.values()) or len(size) != src.ndim or \
                src.placements[i].is_shard():
            return NotImplemented
        note("logits_grad_vocab_split")
        names = src.device_mesh.mesh_dim_names or ()
        sizes = src.device_mesh.mesh.shape
        want, ways = [], 1
        for j, p in enumerate(src.placements):
            if j == i:
                want.append(Shard(len(size) - 1))
            elif names[j] in _DATA_AXES and size[0] % (ways * sizes[j]) \
                    == 0:
                want.append(Shard(0))      # the batch, as the logits'
                ways *= sizes[j]
            else:
                want.append(p if p.is_shard() else _replicate())
        local = src.to_local().new_zeros(_local_shape(
            size, want, src.device_mesh.mesh.shape), **kwargs)
        return DTensor.from_local(local, src.device_mesh, want,
                                  run_check=False, shape=torch.Size(size),
                                  stride=_contiguous_stride(size))

    def _dtensor_op(self, func, args, kwargs):
        if func is torch.ops.aten.detach_.default:
            # autograd detaching a redistributed parameter: metadata only,
            # done on the local shard (torch 2.11's DTensor has no
            # strategy for it)
            args[0]._local_tensor.detach_()
            return args[0]
        if self._fixing:
            return NotImplemented
        self.last_op = str(func)
        if func in _PRODUCTS:
            rule = self._product
        elif func in _LOOKUPS:
            rule = self._lookup
        elif func is torch.ops.aten.new_zeros.default and self._head:
            rule = self._zeros_like_logits
        elif args and isinstance(args[0], torch.Tensor) and \
                not isinstance(args[0], self._dtensor) and \
                _writes_first(func):
            rule = _into_plain
        else:
            rule = PARTITION_RULES.get(func)
        if rule is None:
            return NotImplemented
        self._fixing = True

        def note(name: str) -> None:
            self.rules[name] += 1
        try:
            with self:
                if rule in _RECORDING:
                    return rule(func, args, kwargs, note, self._record)
                return rule(func, args, kwargs, note)
        finally:
            self._fixing = False

    def _record(self, kind: str, local: torch.Tensor,
                ranks: Tuple[int, ...]) -> None:
        """A collective a rule issues on local tensors (a permute: as many
        bytes in as out)."""
        self.collectives.append(Collective(kind, _nbytes(local),
                                           _nbytes(local), ranks))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            return self._dtensor_op(func, args, kwargs)
        if _faking():
            return func(*args, **kwargs)
        if self.flops_on and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # as FlopCounterMode: an op with a decomposition is counted
            # as its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,),
                        [])
        if func.namespace in _COMM_NAMESPACES:
            kind = _collective_kind(func)
            if kind is not None:
                ins = _tensors(args, [])
                self.collectives.append(Collective(
                    kind, sum(map(_nbytes, ins)), sum(map(_nbytes, outs)),
                    _group_ranks(func, args, kwargs)))
        if self.flops_on:
            packet = func._overloadpacket
            if packet in flop_registry:
                n = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
                self.flops += n
                self.by_op[str(packet)] += n
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
    read and write, the peak of its live intermediate bytes, its
    collectives, and how often each of the partition's ``RULES`` acted
    (none of either unless it is partitioned)."""
    flops: float
    by_op: Dict[str, float]
    unfused_bytes: float
    peak_bytes: float
    collectives: List[Collective] = dataclasses.field(default_factory=list)
    rules: Dict[str, int] = dataclasses.field(default_factory=dict)


def local_tensors(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor, or its local shard where it is a DTensor."""
    dtensor = _dtensor_type()
    return [t.to_local() if dtensor is not None and isinstance(t, dtensor)
            else t for t in tensors]


def run_counted(step_fn: Callable, args: Tuple, exclude=(),
                flops: bool = True,
                params: Optional[Dict[str, torch.Tensor]] = None
                ) -> StepCount:
    """Run ``step_fn(*args)`` (meta tensors: nothing allocated, nothing
    launched) under ``OpStats``; FLOPs and op bytes only with ``flops``.
    ``exclude``: the arguments, DTensors or not, whose storages are not
    intermediates; ``params``: those of them that are weights, by name
    (placed by ``OpStats``' rules where a partitioned step computes with
    them).  Where the arguments hold DTensors the step runs under
    ``implicit_replication``: a plain tensor the model makes (RoPE's
    angles, positions) is the same on every rank; an op it cannot
    partition raises ``PartitionError`` naming the op."""
    exclude = list(exclude)
    params = params or {}
    stats = OpStats(local_tensors(exclude), io=flops, flops=flops,
                    params=params)
    dtensor = _dtensor_type()
    ctx = contextlib.nullcontext()
    partitioned = dtensor is not None and any(isinstance(t, dtensor)
                                              for t in exclude)
    if partitioned:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        ctx = implicit_replication()
    from ..models import layers as L
    L.PARTITIONED_MHA = partitioned_mha if partitioned else None
    L.PARTITIONED_MOE = partitioned_moe if partitioned else None
    try:
        with ctx, stats:
            step_fn(*args)
    except PartitionError:
        raise
    except Exception as e:
        if not partitioned or stats.last_op is None:
            raise
        raise PartitionError(stats.last_op,
                             f"{type(e).__name__}: {e}") from e
    finally:
        L.PARTITIONED_MHA = L.PARTITIONED_MOE = None
    return StepCount(stats.flops, dict(stats.by_op),
                     float(stats.unfused_bytes), float(stats.peak_bytes),
                     stats.collectives, dict(stats.rules))


def count_flops(step_fn: Callable, args: Tuple
                ) -> Tuple[float, Dict[str, float]]:
    """FLOPs over one run of ``step_fn(*args)``, total and by aten op."""
    count = run_counted(step_fn, args)
    return count.flops, count.by_op


def unfused_bytes(step_fn: Callable, args: Tuple) -> float:
    """The bytes the aten ops of one run of ``step_fn(*args)`` read and
    write (views excluded): an upper bound with no fusion at all."""
    return run_counted(step_fn, args).unfused_bytes


def _reduced(out):
    """The step's results with every pending partial sum reduced (a
    DTensor result with a ``Partial`` placement, such as logits whose
    contraction was split over ``model``, becomes replicated on that
    axis): a step returns whole values."""
    if isinstance(out, dict):
        return {k: _reduced(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_reduced(v) for v in out)
    if hasattr(out, "placements") and any(p.is_partial()
                                          for p in out.placements):
        from torch.distributed.tensor import Replicate
        return out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def count_cell(cell: CellSpec, flops: bool = True) -> StepCount:
    """One counted run of the cell's step: at its global batch, or, on a
    partitioned cell, rank 0's local program, whose results are reduced
    where they hold partial sums (``_reduced``)."""
    flat = cell.flat_args()
    step_fn = cell.step_fn
    if cell.partitioned:
        def step_fn(*args):
            return _reduced(cell.step_fn(*args))
    return run_counted(step_fn, cell.args, exclude=flat.values(),
                       flops=flops, params={p[len("params."):]: t
                                            for p, t in flat.items()
                                            if p.startswith("params.")})


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


def extract_memory(cell: CellSpec, mesh: Optional[LaunchMesh] = None, *,
                   temp: float) -> Dict[str, float]:
    """``repro``'s ``memory_analysis()`` fields for one device: argument,
    output and alias bytes from the shard shapes, and ``temp``, the peak
    of live intermediates of the local program (``StepCount.peak_bytes``
    of ``count_cell``)."""
    mesh = mesh or cell.mesh
    out = sum(_shard_bytes(o.shape, o.dtype, o.spec, mesh)
              for o in cell.outputs)
    alias = sum(_shard_bytes(o.shape, o.dtype, o.spec, mesh)
                for o in cell.outputs if o.alias)
    return {"argument_size_in_bytes": float(argument_bytes(cell, mesh)),
            "output_size_in_bytes": float(out),
            "alias_size_in_bytes": float(alias),
            "temp_size_in_bytes": float(temp)}
