"""The decode-serving mesh (port of ``repro.distributed.mesh``).

A mesh is a ``(data, model)`` grid of shards: KV pages, and so plan
subtasks, shard over ``data`` and KV heads over ``model``.  It takes one
of two forms:

* ``DecodeMesh`` (``decode_mesh``): every shard lives on one torch
  device, the engine's, and the shards run one after another inside one
  step (``step_fn.ShardedStep``), so the mesh's collectives are exchanges
  and sums over an explicit shard axis on that device.  A ``1x1`` mesh
  runs the whole sharded path on one shard;
* ``ProcessMesh`` (``process_mesh``): one process a shard over an
  initialized ``torch.distributed`` default group of ``D * M`` ranks.
  Rank ``r`` is shard ``(d, m) = divmod(r, M)`` (JAX's row-major device
  order, ``np.asarray(devices).reshape(D, M)``); it holds only its own
  slab of the pool (``kv_pool.RankKVPool``) and runs only its own shard
  of the step (``step_fn.RankStep``), and the exchanges become
  collectives over its data group (the ranks with its ``m``) and its
  model group (the ranks with its ``d``).

Every collective of a process mesh is a **slot gather**: each rank
writes its part into its own slot of a zeroed buffer (a row of a leading
group axis, or the pages and heads it holds) and the buffer is summed
over the group as ``int32`` words (``ProcessMesh.slot_gather``).  One writer a slot makes the sum an exact
gather of any bits (NaN, ``-0.0``, ``-1e30``), and an ``int32`` sum is
taken by gloo (CPU and CUDA tensors) and NCCL alike, inside a captured
CUDA graph too.  The backend is whatever the caller initialized the
group with: nothing here picks gloo or the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

# slot gathers issued (the fused step counts those recorded into a graph)
collectives = 0

# what an ``agree`` compares, as a code in the top bits of its 63-bit
# value: ranks that meet in two different agrees (one guarding a host
# collective that the others do not issue) learn each other's kind
AGREE_KINDS = ("the host state", "the plan epoch", "the step's metrics",
               "the saved arrays", "gather_context", "copy_pages",
               "host_max", "host_broadcast")
_KIND_SHIFT = 57


class MeshDivergenceError(RuntimeError):
    """The ranks of a process mesh disagree on their host state."""


@dataclasses.dataclass(frozen=True)
class DecodeMesh:
    """``data`` x ``model`` shards on ``device``."""

    data: int
    model: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {"data": self.data, "model": self.model}


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"DxM"`` -> ``(data, model)`` sizes (e.g. ``"2x2"``)."""
    try:
        d, m = spec.lower().split("x")
        d, m = int(d), int(m)
    except ValueError:
        raise ValueError(f"mesh spec must look like '2x1', got {spec!r}")
    if d < 1 or m < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {spec!r}")
    return d, m


def _check_sizes(data: int, model: int) -> None:
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {data}x{model}")
    if data & (data - 1):
        raise ValueError(f"data axis must be a power of two, got {data}")


def decode_mesh(data: int = 1, model: int = 1,
                device="cuda") -> DecodeMesh:
    """A ``(data, model)`` mesh with every shard on ``device``.  ``data``
    must be a power of two (the cross-shard POR merge is a
    recursive-doubling butterfly)."""
    _check_sizes(data, model)
    return DecodeMesh(int(data), int(model), torch.device(device))


def rank_coords(rank: int, model: int) -> Tuple[int, int]:
    """Rank -> its shard ``(d, m)``: row-major over ``(data, model)``."""
    return divmod(rank, model)


def group_ranks(data: int, model: int) -> Tuple[List[List[int]],
                                                List[List[int]]]:
    """The data groups (one a model shard ``m``: the ranks with that
    ``m``) and the model groups (one a data shard ``d``)."""
    by_m = [[d * model + m for d in range(data)] for m in range(model)]
    by_d = [[d * model + m for m in range(model)] for d in range(data)]
    return by_m, by_d


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This rank's shard of a ``data`` x ``model`` mesh of processes, on
    ``device``, with its data and model groups."""

    data: int
    model: int
    device: torch.device
    rank: int
    backend: str
    groups: Dict[str, object]      # "data" / "model" / "world" -> group
    # the guarded host collectives issued so far (``guard``)
    _guards: Iterator[int] = dataclasses.field(
        default_factory=itertools.count, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``DecodeMesh.shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's ``(d, m)``."""
        return rank_coords(self.rank, self.model)

    def slot_gather(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        """Gather over ``axis`` (``"data"``, ``"model"`` or ``"world"``)
        in place.  Each rank has written its own slot of ``buf`` (a row
        of a leading group axis, at its index in the group, or any part
        of ``buf`` that no other rank of the group writes) and left the
        rest zero; after the call every slot holds its writer's bits.
        The bytes are summed as ``int32`` words (one writer an element:
        an exact gather of any values)."""
        global collectives
        if not buf.is_contiguous() or buf.nbytes % 4:
            raise ValueError(f"slot_gather needs a contiguous buffer of "
                             f"whole 32-bit words, got {tuple(buf.shape)} "
                             f"{buf.dtype}")
        words = buf.view(-1).view(torch.uint8).view(torch.int32)
        torch.distributed.all_reduce(words, group=self.groups[axis])
        collectives += 1
        return buf

    def slot(self, axis: str) -> int:
        """This rank's slot in ``axis``'s group."""
        d, m = self.coords
        return {"data": d, "model": m, "world": self.rank}[axis]

    def host_max(self, values: Sequence[float]) -> List[float]:
        """Element-wise max of a host vector over every rank (float64)."""
        t = torch.tensor(list(values), dtype=torch.float64,
                         device=self.device)
        self.guard("host_max", t.nbytes)
        if t.numel():
            torch.distributed.all_reduce(
                t, op=torch.distributed.ReduceOp.MAX,
                group=self.groups["world"])
        return t.tolist()

    def host_broadcast(self, values: Sequence[float],
                       src: int = 0) -> List[float]:
        """Rank ``src``'s host vector (float64) on every rank: a value
        that one rank reads for itself (its clock) and every rank must
        act on alike.  One writer, the words summed as ``int64``: the
        bits arrive exactly."""
        t = torch.zeros(len(values), dtype=torch.float64,
                        device=self.device)
        self.guard("host_broadcast", t.nbytes)
        if self.rank == src:
            t.copy_(torch.tensor(list(values), dtype=torch.float64))
        if t.numel():
            torch.distributed.all_reduce(t.view(torch.int64),
                                         group=self.groups["world"])
        return t.tolist()

    def barrier(self) -> None:
        """Wait for every rank of the mesh (one small all-reduce on the
        mesh's device, so it orders with the device's work too)."""
        torch.distributed.all_reduce(
            torch.zeros(1, dtype=torch.int32, device=self.device),
            group=self.groups["world"])

    def shrink(self, data: int) -> Optional["ProcessMesh"]:
        """The first ``data`` data shards as a mesh of their own (an
        elastic restart's survivors), ``None`` on a rank outside it.
        Every rank of this mesh must call it, members or not, in one
        order, while all are still present: ``new_group`` is collective
        over the default group."""
        if data < 1 or data > self.data:
            raise ValueError(f"cannot shrink a {self.data}x{self.model} "
                             f"mesh to {data} data shards")
        return _build(data, self.model, self.device,
                      list(range(data * self.model)))

    def agree(self, value: int, what: str,
              kind: Optional[str] = None) -> None:
        """Raise ``MeshDivergenceError`` on every rank unless every rank
        passed the same ``value`` (a digest) for the same ``kind`` (one of
        ``AGREE_KINDS``, by default ``what``; any other counts as the
        first).  The kind's index rides in the top 6 bits above 57 bits
        of the digest, and one max-reduce of ``(-x, x)`` gives the least
        and the greatest value: where ranks meet in agrees of two kinds,
        the message names both."""
        kind = kind or what
        code = AGREE_KINDS.index(kind) if kind in AGREE_KINDS else 0
        x = (code << _KIND_SHIFT) | (int(value) & ((1 << _KIND_SHIFT) - 1))
        t = torch.tensor([-x, x], dtype=torch.int64, device=self.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                     group=self.groups["world"])
        lo, hi = -int(t[0]), int(t[1])
        if lo != hi:
            kinds = [AGREE_KINDS[v >> _KIND_SHIFT] for v in (lo, hi)]
            met = (f"; the ranks meet in two collectives, {kinds[0]} and "
                   f"{kinds[1]}" if kinds[0] != kinds[1] else "")
            raise MeshDivergenceError(
                f"rank {self.rank}: the ranks disagree on {what} "
                f"(digests {lo} .. {hi}; this rank's {x}{met})")

    def guard(self, kind: str, nbytes: int) -> None:
        """``agree`` on a digest of the mesh's count of guarded host
        collectives, ``kind`` and ``nbytes``, before a host collective
        whose occurrence depends on the host's decisions: a prefill's
        context gather, a replica promotion's page gather, ``host_max``,
        ``host_broadcast``.  A rank that issues one that the others do
        not meets their next agree (this guard, or a plan epoch's: 16
        bytes each) and every rank raises ``MeshDivergenceError`` naming
        the two, where the collectives themselves, of other sizes, would
        wait for the group's timeout.  The step's slot gathers, a fixed
        number a step, are not guarded."""
        seq, nbytes = next(self._guards), int(nbytes)
        self.agree(digest(seq, kind, nbytes),
                   f"host collective {seq} ({kind}, {nbytes} bytes)", kind)


def digest(*parts) -> int:
    """A 64-bit digest of host values: ``bytes`` (array contents) as they
    are, anything else by its ``repr``."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return int.from_bytes(h.digest(), "little")


def process_mesh(data: int = 1, model: int = 1,
                 device=None) -> ProcessMesh:
    """This rank's shard of a ``(data, model)`` mesh over the initialized
    default process group, whose world size must be ``data * model``.
    ``device`` defaults to ``cuda:{LOCAL_RANK}``.  Every rank must call
    it, in the same order as any other group it makes (it makes the
    data and model groups)."""
    import torch.distributed as dist

    _check_sizes(data, model)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("process_mesh needs an initialized default "
                           "process group (torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a {data}x{model} process mesh needs "
                         f"{data * model} ranks, the world has {world}")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return _build(data, model, torch.device(device), None)


def _build(data: int, model: int, device: torch.device,
           members: Optional[List[int]]) -> Optional[ProcessMesh]:
    """The mesh over the default group's ranks ``members`` (``None``: all
    of them, as they are); every rank of the default group makes every
    group, in one order."""
    import torch.distributed as dist

    _check_sizes(data, model)
    rank = dist.get_rank()
    if members is None:
        world = dist.group.WORLD
    else:
        world = dist.new_group(members)
        if rank not in members:
            world = None
    by_m, by_d = group_ranks(data, model)
    mine = rank_coords(rank, model) if world is not None else (-1, -1)
    groups: Dict[str, object] = {"world": world}
    for name, sets, i_mine in (("data", by_m, mine[1]),
                               ("model", by_d, mine[0])):
        for i, ranks in enumerate(sets):
            g = dist.new_group(ranks)
            if i == i_mine:
                groups[name] = g
    if world is None:
        return None
    return ProcessMesh(int(data), int(model), device, rank,
                       dist.get_backend(), groups)
