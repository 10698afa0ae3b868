"""The rank side of ``test_torch_process_train.py``: what each rank of a
training mesh over processes runs, in a module that imports neither
``jax`` nor ``repro`` (ranks are spawned processes that import it by
name).

The weights arrive as the ``np.savez`` of ``repro``'s ``init_params``
(keys joined by ``/``) and go through ``weights.from_jax_params``.
"""

import contextlib
import io
import os
import signal

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.distributed import train_step
from repro_torch.distributed.train_step import (BUCKET_BYTES,
                                                make_rank_train_step)
from repro_torch.launch import train as train_cli
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as O
from repro_torch.training import trainer
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.weights import from_jax_params

ARCHS = {"qwen3-4b": "qwen3-4b", "llama4-scout": "llama4-scout-17b-a16e"}
BATCH, SEQ, STEPS = 4, 16, 3
LR, WARMUP, TOTAL = 1e-3, 2, 10
# the launcher's flags in every CLI run here
CLI = ["--smoke", "--device", "cpu", "--global-batch", "4", "--seq-len",
       "16"]


def optimizer():
    return O.adamw(O.cosine_schedule(LR, WARMUP, TOTAL))


def load_params(path, cfg):
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = params
            *outer, leaf = key.split("/")
            for k in outer:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return from_jax_params(cfg, params)


def fresh_state(cfg, npz, opt):
    params = load_params(npz, cfg)
    return trainer.make_state(cfg, params, opt.init(params))


def batches(cfg, dp_rank=0, dp_world=1, steps=STEPS):
    data = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH),
                       dp_rank=dp_rank, dp_world=dp_world)
    return [tuple(torch.from_numpy(a) for a in data.batch(s))
            for s in range(steps)]


def numpy_tree(state):
    """The state's saved arrays by key (``checkpoint``'s flattening),
    bf16 as its 16 bits."""
    out = {}
    for key, leaf in ckpt._flatten(state):
        out[key], _ = ckpt._to_numpy(leaf)
    return out


def record(metrics):
    return {k: float(v) for k, v in metrics.items()}


def run_steps(step_fn, state, data):
    hist = []
    for b in data:
        state, met = step_fn(state, b)
        hist.append(record(met))
    return hist, numpy_tree(state)


def rank_steps(mesh, npzs, runs):
    """Each ``(arch, microbatches, bucket bytes)`` of ``runs`` (``None``:
    ``train_step.BUCKET_BYTES``, else set there for the run): ``STEPS``
    rank steps on this rank's rows; the metrics a step and the final
    state."""
    torch.set_num_threads(1)
    D = mesh.shape["data"]
    d, _ = mesh.coords
    out = {}
    for arch, mb, bucket in runs:
        cfg = smoke_config(ARCHS[arch])
        opt = optimizer()
        step = make_rank_train_step(cfg, opt, mesh, microbatches=mb,
                                    remat=False)
        train_step.BUCKET_BYTES = bucket or BUCKET_BYTES
        try:
            out[arch, mb, bucket] = run_steps(
                step, fresh_state(cfg, npzs[arch], opt), batches(cfg, d, D))
        finally:
            train_step.BUCKET_BYTES = BUCKET_BYTES
    return out


def controller_steps(npz, arch, data: int, mb: int):
    """The single controller's run of the same steps: the global batch,
    its ``data`` shards run in turn as ``data * mb`` microbatches."""
    cfg = smoke_config(ARCHS[arch])
    opt = optimizer()
    step = trainer.make_train_step(cfg, opt, microbatches=data * mb,
                                   remat=False)
    return run_steps(step, fresh_state(cfg, npz, opt), batches(cfg))


def rank_save(mesh, npz, path):
    """Two steps, then a save over the mesh at ``num_shards = D``."""
    torch.set_num_threads(1)
    cfg = smoke_config(ARCHS["qwen3-4b"])
    opt = optimizer()
    state = fresh_state(cfg, npz, opt)
    step = make_rank_train_step(cfg, opt, mesh, remat=False)
    d, _ = mesh.coords
    for b in batches(cfg, d, mesh.data, steps=2):
        state, _ = step(state, b)
    ckpt.save_checkpoint(path, 2, state, num_shards=mesh.data,
                         extra={"tag": "mesh"}, mesh=mesh)
    return ckpt.latest_step(path)


def controller_save(npz, data, path):
    """The one-process save of the same state."""
    cfg = smoke_config(ARCHS["qwen3-4b"])
    opt = optimizer()
    state = fresh_state(cfg, npz, opt)
    step = trainer.make_train_step(cfg, opt, microbatches=data,
                                   remat=False)
    for b in batches(cfg, steps=2):
        state, _ = step(state, b)
    ckpt.save_checkpoint(path, 2, state, num_shards=data,
                         extra={"tag": "mesh"})


def cli(argv, mesh=None, history=None):
    """``launch.train.main`` on ``argv`` + ``CLI``: its exit code, the
    history and what it printed."""
    hist = [] if history is None else history
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv + CLI, history=hist, mesh=mesh)
    return rc, list(hist), buf.getvalue()


def rank_cli(mesh, runs):
    """Each argv of ``runs`` through the launcher as this rank."""
    torch.set_num_threads(1)
    return [cli(argv, mesh) for argv in runs]


class SignalAt(list):
    """A history that sends this process SIGTERM once step ``step`` is
    recorded."""

    def __init__(self, step):
        super().__init__()
        self.step = step

    def append(self, item):
        super().append(item)
        if item[0] == self.step:
            os.kill(os.getpid(), signal.SIGTERM)


def rank_sigterm(mesh, argv, at_step):
    """Rank 1 signals itself once step ``at_step`` is done."""
    torch.set_num_threads(1)
    hist = SignalAt(at_step) if mesh.rank == 1 else []
    return cli(argv, mesh, hist)


def rank_diverge(mesh, npz):
    """Rank 1 is fed another batch than the rest of its data shard: every
    rank must raise ``MeshDivergenceError`` (returned by name)."""
    torch.set_num_threads(1)
    cfg = smoke_config(ARCHS["qwen3-4b"])
    opt = optimizer()
    step = make_rank_train_step(cfg, opt, mesh, remat=False)
    tokens, labels = batches(cfg, mesh.coords[0], mesh.data, steps=1)[0]
    if mesh.rank == 1:
        tokens = (tokens + 1) % cfg.vocab_size
    try:
        step(fresh_state(cfg, npz, opt), (tokens, labels))
    except mesh_mod.MeshDivergenceError as e:
        return type(e).__name__, str(e)
    return None, None


def rank_wrong_size(mesh):
    """A mesh of another shape than the launcher's flags, and a mesh
    wider than the world: both raise ``ValueError``."""
    out = []
    for fn in (lambda: train_cli.main(["--data", "1", "--steps", "1"]
                                      + CLI, mesh=mesh),
               lambda: mesh_mod.process_mesh(4, 1, device="cpu")):
        try:
            fn()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out
