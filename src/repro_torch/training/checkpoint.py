"""Checkpointing (port of ``repro.training.checkpoint``): per-host shard
files + manifest, atomic publish.

Layout::

    <dir>/step_000123/shard_00003.npz      one file per host
    <dir>/step_000123/MANIFEST.json        written LAST (atomic publish)

A step directory without a manifest is an incomplete/aborted save and is
ignored by ``latest_step``, so a preemption mid-save can never corrupt
the restore path.  Shard ``s`` holds piece ``s`` of every array split on
its leading axis; 0-d arrays and arrays shorter than the shard count live
whole in shard 0.  Restore re-assembles them (an elastic restart reuses
the same files).

Keys are the leaves' paths joined by ``/``: a ``TrainState`` saves its
``tree()`` (``step``, ``params/<state-dict name>``, ``opt_state/m/<name>``
and so on).  numpy has no bfloat16, so a bf16 tensor is stored as its raw
16 bits with ``"bfloat16"`` in the manifest: a restore is bit-exact.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, pre: str = "") -> List[Tuple[str, Any]]:
    if hasattr(tree, "with_tree"):          # a TrainState
        return _flatten(tree.tree(), pre)
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(pre[:-1], tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{pre}{k}/")
    return out


def _unflatten(like: Tree, values: Dict[str, Any], pre: str = "") -> Tree:
    if hasattr(like, "with_tree"):
        return like.with_tree(_unflatten(like.tree(), values, pre))
    if isinstance(like, dict):
        return {k: _unflatten(v, values, f"{pre}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, values, f"{pre}{i}/")
                          for i, v in enumerate(like))
    return values[pre[:-1]]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The array to store and the dtype to record."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_leaf(arr: np.ndarray, dtype: str, like):
    if not isinstance(like, torch.Tensor):
        return arr
    t = torch.from_numpy(np.array(arr))          # a copy; keeps 0-d
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    *, num_shards: int = 1, keep: int = 3,
                    extra: Optional[Dict] = None) -> str:
    """Save ``tree`` under ``ckpt_dir/step_NNNNNN``, atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step_dir = os.path.join(ckpt_dir, f"step_{step:06d}")
    tmp_dir = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")

    manifest = {"step": step, "num_shards": num_shards,
                "time": time.time(), "extra": extra or {},
                "arrays": {}}
    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(num_shards)]
    for key, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        manifest["arrays"][key] = {"shape": list(arr.shape),
                                   "dtype": dtype}
        if arr.ndim == 0 or num_shards == 1 or arr.shape[0] < num_shards:
            shards[0][key] = arr           # small/replicated: shard 0 owns it
            manifest["arrays"][key]["sharded"] = False
        else:
            manifest["arrays"][key]["sharded"] = True
            splits = np.array_split(arr, num_shards, axis=0)
            for s, piece in enumerate(splits):
                shards[s][key] = piece
    for s, shard in enumerate(shards):
        np.savez(os.path.join(tmp_dir, f"shard_{s:05d}.npz"), **shard)
    # manifest last: its presence marks the checkpoint complete
    with open(os.path.join(tmp_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    _gc(ckpt_dir, keep)
    return step_dir


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:06d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "MANIFEST.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: int, like: Tree,
                    ) -> Tuple[Tree, Dict]:
    """Restore a tree with the structure of ``like`` from ``step``: new
    tensors with the stored dtypes, each on its ``like`` leaf's device (a
    ``TrainState`` comes back as a new state on a new model)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    files = [np.load(os.path.join(step_dir, f"shard_{s:05d}.npz"))
             for s in range(manifest["num_shards"])]
    values = {}
    for key, leaf in _flatten(like):
        meta = manifest["arrays"][key]
        if meta["sharded"]:
            arr = np.concatenate([f[key] for f in files if key in f.files],
                                 axis=0)
        else:
            arr = files[0][key]
        assert list(arr.shape) == meta["shape"], (key, arr.shape, meta)
        values[key] = _to_leaf(arr, meta["dtype"], leaf)
    return _unflatten(like, values), manifest


def load_latest(ckpt_dir: str, like: Tree
                ) -> Optional[Tuple[int, Tree, Dict]]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, manifest = load_checkpoint(ckpt_dir, step, like)
    return step, tree, manifest
