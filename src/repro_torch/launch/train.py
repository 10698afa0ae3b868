"""Training launcher: the train loop with checkpoints and fault tolerance
(port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 20 --ckpt-dir build/ckpt

Runs on the card unless ``--device cpu``.  Features:

* the deterministic shardable data pipeline (exact resume);
* checkpoint save and restore (atomic manifest publish), every
  ``--ckpt-every`` steps and at the end;
* preemption tolerance: SIGTERM writes a final checkpoint and exits;
* the straggler watchdog: a step slower than ``--watchdog-factor`` x the
  running median is logged;
* the data axis on one device: ``--data D`` splits the global batch into
  D shards (rank r takes rows ``[r B/D, (r+1) B/D)`` of the global batch),
  which run one after another on the one device; their gradients are
  summed in shard order in float32 and averaged, the single-controller
  convention of ``distributed/``.  ``--fail-at-step`` simulates losing
  half of the data axis there: the loop saves, halves D, reloads the
  latest checkpoint and carries on (an elastic restart);
* the mesh over processes: ``--dist-backend {nccl,gloo}`` under
  ``torchrun --nproc-per-node D*M`` (``--data D --model M``; the world
  must be D*M) runs one rank a ``(data, model)`` shard
  (``distributed.process_mesh``, on ``cuda:{LOCAL_RANK}`` unless
  ``--device`` names another).  Rank ``(d, m)`` draws data shard ``d``'s
  rows (``SyntheticLM(dp_rank=d, dp_world=D)``) and takes
  ``distributed.train_step.make_rank_train_step``'s step, whose
  gradients are gathered over the data group and summed in shard order:
  every rank's losses, gradient norms and weights are the single
  controller's ``--data D`` run's, bit for bit.  Rank 0 alone prints.
  Checkpoints are written one shard a rank and published by rank 0;
  SIGTERM on any rank stops every rank at the same step (the flag is
  max-reduced once a step), each writing the ``sigterm`` checkpoint and
  exiting 0; the watchdog reads the mesh's step time (the max over the
  ranks); ``--fail-at-step`` saves on every rank, the upper half of the
  data ranks leave, and the rest go on as a ``D/2 x M`` mesh (its groups
  made before anyone leaves) from the checkpoint.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --data 2 --model 2 --dist-backend gloo --device cpu

``--model M`` is taken as ``repro`` takes it: ``repro`` builds the
parameters' model-axis specs and never applies them, so its train state
stays replicated over ``model`` and the losses do not change with M.
Replicated over ``model`` on one device, the step is computed once; over
processes each of the M ranks of a data shard computes it.  (The
tensor-parallel program of those specs is what ``launch/dryrun.py``
partitions on the meta device.)  ``repro``'s ``--host-devices``
simulates XLA devices on a CPU and has no counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import signal
import statistics
import sys
import time
from typing import List, Optional


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data", type=int, default=0,
                    help="data-axis size (shards run in turn on the device)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis size (the state is replicated over "
                         "it, as in repro: the step is computed once)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="simulate losing half the data axis at this step "
                         "(elastic restart)")
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, over processes "
                         "cuda:LOCAL_RANK; cpu for tests)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="run the (data, model) mesh as processes, one "
                         "rank a shard, under torchrun --nproc-per-node "
                         "D*M")
    args = ap.parse_args(argv)
    if args.model < 1:
        ap.error("--model must be at least 1")
    return args


def main(argv=None, history: Optional[List] = None, mesh=None) -> int:
    """Train; ``history`` (a list), if given, receives ``(step, loss,
    grad_norm)`` floats for every step this process ran.  ``mesh`` (a
    ``distributed.ProcessMesh`` of ``--data`` x ``--model``) trains as
    that rank; ``--dist-backend`` makes it from torchrun's environment."""
    args = parse_args(argv)
    if mesh is not None or args.dist_backend is None:
        return _train(args, history, mesh)
    import torch.distributed as dist

    from repro_torch.distributed.mesh import process_mesh

    dist.init_process_group(args.dist_backend)
    try:
        mesh = process_mesh(args.data or 1, args.model,
                            device=None if args.device == "cuda"
                            else args.device)
        return _train(args, history, mesh)
    finally:
        dist.destroy_process_group()


def _train(args, history: Optional[List], mesh) -> int:
    dp = args.data or 1
    if mesh is not None:
        if (mesh.data, mesh.model) != (dp, args.model):
            raise ValueError(f"a {mesh.data}x{mesh.model} mesh for "
                             f"--data {dp} --model {args.model}")
        if mesh.rank:
            # rank 0 alone prints
            with contextlib.redirect_stdout(io.StringIO()):
                return _loop(args, history, mesh)
    return _loop(args, history, mesh)


def _loop(args, history: Optional[List], mesh) -> int:
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed.train_step import make_rank_train_step
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import trainer
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import (cosine_schedule,
                                                make_optimizer)

    dp = args.data or 1
    dev = mesh.device if mesh is not None else torch.device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sched = cosine_schedule(args.lr, warmup=5, total=max(args.steps, 10))
    optimizer = make_optimizer(args.optimizer, sched)

    data_cfg = DataConfig(cfg.vocab_size, args.seq_len, args.global_batch)

    stop = {"now": False}
    prev_handler = signal.signal(
        signal.SIGTERM, lambda *a: stop.__setitem__("now", True))

    def build(data_axis: int):
        """The step for the current healthy data axis.  One process: its
        shards run in turn as microbatches, gradients summed in shard
        order; over processes: this rank's shard, gathered and summed in
        the same order."""
        if mesh is not None:
            return make_rank_train_step(
                cfg, optimizer, mesh, microbatches=args.microbatches,
                remat=False, clip_norm=1.0)
        return trainer.make_train_step(
            cfg, optimizer, microbatches=args.microbatches * data_axis,
            remat=False, clip_norm=1.0)

    def pipeline(start: int):
        # one process: the global batch (data shard r is its rows
        # [r B/D, (r+1) B/D)); over processes: this rank's data shard
        if mesh is None:
            return SyntheticLM(data_cfg, dp_rank=0, dp_world=1,
                               start_step=start)
        return SyntheticLM(data_cfg, dp_rank=mesh.coords[0],
                           dp_world=dp, start_step=start)

    step_fn = build(dp)

    start_step = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    state = trainer.init_state(cfg, optimizer, gen, device=dev)
    if args.ckpt_dir:
        restored = ckpt.load_latest(args.ckpt_dir, state)
        if restored:
            start_step, state, manifest = restored
            print(f"[resume] step {start_step} from {args.ckpt_dir}")
    data = pipeline(start_step)

    def save(step, tag=""):
        if not args.ckpt_dir:
            return
        ckpt.save_checkpoint(args.ckpt_dir, step, state,
                             num_shards=max(dp // 4, 1),
                             extra={"tag": tag, "arch": cfg.name},
                             mesh=mesh)
        print(f"[ckpt] saved step {step} {tag}")

    try:
        step_times = []
        t_total = time.time()
        step = start_step
        loss = float("nan")
        while step < args.steps:
            stopping = stop["now"]
            if mesh is not None:
                # a signal to any rank stops every rank at this step
                stopping = mesh.host_max([float(stopping)])[0] > 0
            if stopping:
                save(step, tag="sigterm")
                print("[preempt] SIGTERM checkpoint written, exiting cleanly")
                return 0
            if step == args.fail_at_step and dp > 1:
                # ---- simulated node failure: elastic restart ----
                print(f"[elastic] step {step}: simulating loss of half the "
                      f"data axis ({dp} -> {dp // 2}); re-meshing + "
                      f"resharding")
                save(step, tag="pre-failure")
                dp //= 2
                if mesh is not None:
                    # every rank makes the survivors' groups, then the
                    # upper half of the data ranks leave
                    mesh = mesh.shrink(dp)
                    if mesh is None:
                        return 0
                    data = pipeline(step)
                step_fn = build(dp)
                # the surviving shards reload the checkpoint
                if args.ckpt_dir:
                    _, state, _ = ckpt.load_latest(args.ckpt_dir, state)
                args.fail_at_step = -1  # once
            tokens, labels = (torch.from_numpy(a).to(dev)
                              for a in data.batch(step))
            t0 = time.time()
            state, metrics = step_fn(state, (tokens, labels))
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.time() - t0
            if mesh is not None:
                # the mesh's step takes as long as its slowest rank
                dt = mesh.host_max([dt])[0]
            if history is not None:
                history.append((step, loss, gnorm))
            step_times.append(dt)
            med = statistics.median(step_times)
            if len(step_times) > 3 and dt > args.watchdog_factor * med:
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s) — straggler detected")
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step:4d} loss {loss:.4f} "
                      f"gnorm {gnorm:.3f} {dt:.2f}s")
            step += 1
            data.step = step
            if args.ckpt_dir and step % args.ckpt_every == 0:
                save(step)
        save(args.steps, tag="final")
        print(f"done: {args.steps - start_step} steps in "
              f"{time.time() - t_total:.1f}s; final loss {loss:.4f}")
        return 0
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


if __name__ == "__main__":
    sys.exit(main())
