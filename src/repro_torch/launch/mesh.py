"""Launch meshes (port of ``repro.launch.mesh``): the axis names and sizes
the dry run's sharding rules read, with no devices behind them.

``repro`` builds JAX meshes over 256 or 512 (forced host) devices.  The
port has no SPMD compiler, so a ``LaunchMesh`` is only the layout: the
specs of ``launch/sharding.py`` name its axes, ``shard_shape`` divides a
tensor by its sizes, and ``launch/dryrun.py`` reckons each device's
bytes from that.

The production layouts keep ``repro``'s shapes so the specs compare one
to one: ``(data=16, model=16)`` for one pod, ``(pod=2, data=16,
model=16)`` for two.  On H100s a 256-card layout is 32 nodes of
``NODE_CARDS`` cards, ranks in the mesh's row-major order, so a 16-wide
``model`` axis spans two nodes (NVLink within a node, the network
between them): ``group_link`` names the slowest link of a group.

``device_mesh`` gives the port an SPMD partitioner without cards: a fake
world of ``mesh.size`` ranks in this process (its collectives do
nothing) and a ``torch.distributed`` ``DeviceMesh`` over it, on which
DTensor's sharding propagation partitions a step (``launch/specs.py``).
A two-pod mesh is partitioned as one pod's block (``pod_block``): the
``pod`` axis splits only the batch (and a batch-1 cache's sequence), so
rank 0's program is its pod's cell on the ``(data, model)`` axes plus the
all-reduces over its pod group (``pod_group``) that merge the pods.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

NODE_CARDS = 8             # H100 SXM cards a node (a DGX H100)


@dataclasses.dataclass(frozen=True)
class LaunchMesh:
    """Named mesh axes and their sizes, in order; no devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the sizes joined, as the dry run's
        file names spell them."""
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LaunchMesh:
    """16 x 16 cards (``data``, ``model``), or 2 x 16 x 16 with a leading
    ``pod`` axis that only the batch shards over."""
    if multi_pod:
        return LaunchMesh(("pod", "data", "model"), (2, 16, 16))
    return LaunchMesh(("data", "model"), (16, 16))


def make_host_mesh(data: Optional[int] = None,
                   model: Optional[int] = None) -> LaunchMesh:
    """A ``(data, model)`` mesh over the cards this process sees
    (``torch.cuda.device_count()``, at least 1): all of them on ``data``
    by default, the rest of one given size on the other axis."""
    n = max(torch.cuda.device_count(), 1)
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data < 1 or model < 1 or data * model > n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"cards; this process sees {n}")
    return LaunchMesh(("data", "model"), (data, model))


def mesh_axis_sizes(mesh: LaunchMesh) -> Tuple[int, ...]:
    return tuple(mesh.shape[a] for a in mesh.axis_names)


POD_AXIS = "pod"


def pod_block(mesh: LaunchMesh) -> LaunchMesh:
    """One pod of ``mesh``: its ``(data, model)`` axes without the leading
    ``pod`` axis (a mesh with no ``pod`` axis is its own block).  Ranks
    run row-major with ``pod`` the major axis, so pod 0 holds ranks 0 to
    ``block.size - 1`` in the block's own order: rank 0's ``data`` and
    ``model`` groups are the same global ranks on either mesh."""
    if POD_AXIS not in mesh.axis_names:
        return mesh
    if mesh.axis_names[0] != POD_AXIS:
        raise ValueError(f"mesh {mesh.axis_names}: the pod axis must lead")
    return LaunchMesh(mesh.axis_names[1:], mesh.sizes[1:])


def pod_group(mesh: LaunchMesh) -> Tuple[int, ...]:
    """Rank 0's group over ``pod``: one rank a pod, a block apart
    (``(0, 256)`` on 2x16x16); ``(0,)`` on a mesh with no ``pod`` axis."""
    return tuple(range(0, mesh.size, pod_block(mesh).size))


# --------------------------------------------------------------------- #
# the fake world
# --------------------------------------------------------------------- #
FAKE_BACKEND = "fake"


def _fake_backend() -> str:
    """The name of PyTorch's backend whose collectives do nothing,
    registered by importing ``torch.testing._internal.distributed.fake_pg``
    (present in the CPU and the CUDA builds of torch 2.11 and 2.13)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    return FAKE_BACKEND


def _clear_propagation_caches() -> None:
    """DTensor caches its sharding propagation by op and argument specs;
    a mesh equal to an earlier cell's can hit an entry of another model
    (torch 2.13 returned a top-1 output's shape to a top-2 op), so each
    world starts with them empty."""
    try:
        from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    except ImportError:
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        prop.propagate_op_sharding.cache_clear()
    else:
        _clear_sharding_prop_cache()


@contextlib.contextmanager
def device_mesh(mesh: LaunchMesh, device_type: str = "cpu"
                ) -> Iterator["torch.distributed.device_mesh.DeviceMesh"]:
    """A fake world of ``mesh.size`` ranks with this process as rank 0,
    and a ``DeviceMesh`` of ``device_type`` with the mesh's axis names and
    sizes over it (ranks in row-major order).  The world is destroyed on
    exit; one world at a time.

    The type is ``cpu`` by default, whatever the local shards' device:
    DTensor runs its sharding propagation on fake tensors of the mesh's
    type (a CPU-only torch cannot copy a strided fake ``cuda`` tensor),
    and its strategy costs read the type's device count (a ``cpu`` mesh
    gives the same choices on every machine, and makes no CUDA context).
    A shard moved from one dimension to another of an axis is an
    all-to-all on either type (``_alltoall_on_cpu``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "dry run's fake world needs this process alone")
    dist.init_process_group(_fake_backend(), store=dist.HashStore(),
                            rank=0, world_size=mesh.size)
    try:
        _clear_propagation_caches()
        with _alltoall_on_cpu():
            yield init_device_mesh(device_type, mesh.sizes,
                                   mesh_dim_names=mesh.axis_names)
    finally:
        _clear_propagation_caches()
        dist.destroy_process_group()


@contextlib.contextmanager
def _alltoall_on_cpu() -> Iterator[None]:
    """DTensor moves a shard from one dimension to another of the same
    axis by an all-to-all (``_dtensor::shard_dim_alltoall``), except on a
    ``cpu`` mesh, where it gathers the whole tensor and keeps a chunk
    (Gloo has no all-to-all).  The fake world moves nothing, so the
    all-to-all an H100 mesh issues is issued here too: the dry run prices
    what the cards would run."""
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            mesh.get_group(mesh_dim).group_name)

    old = getattr(pt, "shard_dim_alltoall", None)
    if old is None:             # a release that moves shards otherwise
        yield
        return
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = old


def nodes_of(ranks: Sequence[int]) -> int:
    """The nodes of ``NODE_CARDS`` cards a group of ranks spans."""
    return len({r // NODE_CARDS for r in ranks})


def group_link(ranks: Sequence[int]) -> str:
    """The slowest link a collective over ``ranks`` crosses: ``nvlink``
    within one node, ``network`` across nodes."""
    return "nvlink" if nodes_of(ranks) <= 1 else "network"
