"""Start a process mesh on one host: one process a rank, each joined to a
``torch.distributed`` default group through a ``FileStore`` (a file, not
a TCP port, so concurrent launches never collide), each given its
``ProcessMesh``.

``spawn_ranks(fn, data, model, backend, init_file)`` runs ``fn(mesh,
*args)`` in ``data * model`` spawned processes and returns their results
in rank order; a rank that raises, or a launch that outlives
``timeout``, raises in the caller.  The backend is the caller's choice
(``"nccl"`` on cards, ``"gloo"`` on the CPU or several ranks on one
card); ``device=None`` gives rank ``r`` the card ``cuda:r``.  Across hosts
or under ``torchrun``, initialize the group from the environment and
call ``mesh.process_mesh`` instead (``launch/serve.py --dist-backend``).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import traceback
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp

# a rank's result or its traceback, put on the queue once
_OK, _ERR = "ok", "error"


def _rank_main(rank: int, fn: Callable, data: int, model: int,
               backend: str, init_file: str, device, args: Sequence,
               timeout_s: float, out) -> None:
    import torch.distributed as dist

    from .mesh import process_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    world = data * model
    try:
        store = dist.FileStore(init_file, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = process_mesh(data, model, device=device)
            out.put((rank, _OK, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, _ERR, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, data: int, model: int, backend: str,
                init_file: str, device=None, args: Sequence = (),
                timeout: float = 300.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on each rank of a ``data`` x ``model``
    process mesh (``fn`` and ``args`` are pickled: a module-level
    function).  ``init_file`` must not exist yet: it becomes the group's
    ``FileStore``.  ``PYTHONHASHSEED`` is fixed for the ranks, so every
    rank iterates its sets alike.  A rank may return while the others go
    on (an elastic restart's leavers, after ``ProcessMesh.shrink``): its
    result is kept and its process ends.  Returns the ranks' results in
    rank order."""
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file} exists: a FileStore must start "
                              f"from a new file")
    world = data * model
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    env_seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, fn, data, model, backend, init_file,
                                   device, tuple(args), timeout, out))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if env_seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = env_seed
    results: dict = {}
    errors: List[str] = []
    reported: set = set()
    now = datetime.datetime.now
    deadline = now() + datetime.timedelta(seconds=timeout)
    try:
        # drain the queue before joining (a writer blocks on a full pipe)
        while len(results) + len(errors) < world:
            left = (deadline - now()).total_seconds()
            try:
                rank, kind, value = out.get(timeout=min(max(left, 0.01),
                                                        1.0))
            except queue_mod.Empty:
                silent = [p for r, p in enumerate(procs)
                          if r not in reported]
                if left <= 0 or any(p.exitcode not in (None, 0)
                                    for p in silent):
                    errors.append(f"ranks timed out or died (exit codes "
                                  f"{[p.exitcode for p in procs]})")
                    break
                continue
            reported.add(rank)
            if kind == _OK:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                # the others may wait on it in a collective: a short grace
                deadline = min(deadline,
                               now() + datetime.timedelta(seconds=15))
    finally:
        for p in procs:
            # a failed launch's other ranks may be stuck in a collective
            p.join(timeout=1 if errors else 10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("process mesh failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
