"""Mesh serving (port of ``repro.distributed``): a sharded KV pool and a
sharded fused step, so one engine serves over a ``(data, model)`` grid of
shards.

* ``mesh.py``    — the mesh: its shape and where its shards live
  (``DecodeMesh``: every shard on one device; ``ProcessMesh``: one
  process a shard), and the process mesh's slot gather;
* ``kv_pool.py`` — ``ShardedKVPool``: pages over ``data``, KV heads over
  ``model``, one allocator per data shard; ``RankKVPool``: one rank's
  slab of it;
* ``step_fn.py`` — ``ShardedStep``: per-shard PAC and epilogue, the
  cross-shard POR merge, the head-parallel output projection, in one
  CUDA graph a signature; ``RankStep``: one rank's shard of it;
* ``launch.py``  — ``spawn_ranks``: a process mesh on one host;
* ``train_step.py`` — ``make_rank_train_step``: training over a process
  mesh, each rank's gradients gathered over ``data`` and summed in shard
  order (``launch/train.py --dist-backend``).

``repro`` runs the mesh as one program traced under ``shard_map`` over
its devices, with one controller.  The port runs it in one of two ways.

**Single controller** (``decode_mesh(data, model, device=)``): every
shard on one torch device; each shard reads its own contiguous slab of
the pool, ``ppermute`` becomes an exchange over an explicit shard axis
(``kernels.por.exchange``) and the ``psum`` over ``model`` an ordered sum
of the shards' partial products (``step_fn.model_sum``).

**Process mesh** (``process_mesh(data, model, device=None)`` over an
initialized default process group of ``data * model`` ranks): rank ``r``
is shard ``(d, m) = divmod(r, model)``, on ``cuda:{LOCAL_RANK}`` unless
the caller names a device.  Each rank holds the full weights and only
its own slab of the pool, runs PAC and the epilogue for its own shard,
and the step exchanges two things by slot gathers: the merge rows over
the data group (then ``por.mesh_merge`` on every rank of the group,
bitwise alike) and the output projection's partial products over the
model group (then the ordered ``model_sum``).  Every rank runs the same
host logic on the same inputs and checks at each plan epoch that the
ranks agree (``MeshDivergenceError`` otherwise).  The streams equal the
single controller's byte for byte.  Deadlines and queue timeouts are
decided on rank 0's clock (``ProcessMesh.host_broadcast``), and a fault
plan fires alike on every rank.  Under NCCL the step's collectives
are captured into its CUDA graph; under gloo the step runs uncaptured.

On the CPU (gloo, one process a shard)::

    from repro_torch.distributed.launch import spawn_ranks
    spawn_ranks(fn, 2, 2, "gloo", "/tmp/new-store-file", device="cpu")

runs ``fn(mesh)`` on four ranks (``fn`` builds a ``DecodeEngine(...,
fused=True, mesh=mesh, device=mesh.device)``).  On cards, one rank a
card::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2 \\
        --dist-backend nccl

and on one card, several gloo ranks sharing it: ``--dist-backend gloo
--device cuda:0``.
"""

from .kv_pool import (RankKVPool, ShardedKVPool,            # noqa: F401
                      ShardedPageAllocator)
from .mesh import (DecodeMesh, MeshDivergenceError,         # noqa: F401
                   ProcessMesh, decode_mesh, parse_mesh,
                   process_mesh)
from .step_fn import RankStep, ShardedStep, ShardedStepBase  # noqa: F401
from .train_step import make_rank_train_step                # noqa: F401
