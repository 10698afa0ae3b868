"""Mesh serving (port of ``repro.distributed``): a sharded KV pool and a
sharded fused step, so one engine serves over a ``(data, model)`` grid of
shards.

* ``mesh.py``    — the mesh: its shape and the torch device it lives on;
* ``kv_pool.py`` — ``ShardedKVPool``: pages over ``data``, KV heads over
  ``model``, one allocator per data shard;
* ``step_fn.py`` — ``ShardedStep``: per-shard PAC and epilogue, the
  cross-shard POR butterfly, the head-parallel output projection, in one
  CUDA graph a signature.

``repro`` runs the mesh as one program traced under ``shard_map`` over
its devices, with one controller.  The port keeps the single controller
and places every shard on one torch device: each shard reads its own
contiguous slab of the pool, ``ppermute`` becomes an exchange over an
explicit shard axis (``kernels.por.exchange``) and the ``psum`` over
``model`` an ordered sum of the shards' partial products
(``step_fn.model_sum``).  Those two functions are the transport; placing
shards on several cards would replace them and nothing else of the step.
"""

from .kv_pool import ShardedKVPool, ShardedPageAllocator  # noqa: F401
from .mesh import DecodeMesh, decode_mesh, parse_mesh     # noqa: F401
from .step_fn import ShardedStep, ShardedStepBase         # noqa: F401
