"""Bridge from ``repro``'s JAX parameter tree to the port's state dict.

``from_jax_params(cfg, params)`` takes the tree that
``repro.models.transformer.init_params`` returns, with every leaf already
converted to a numpy array by the caller (``jax.tree.map(np.asarray,
params)``), and returns the state dict of ``models.transformer.Transformer``
— so both packages compute the same function on the same weights.  It
imports neither ``jax`` nor ``repro``.

A sub-layer's subtree flattens by its keys (``ln.scale``, ``ln.bias``,
``attn.wq.w``, ``attn.wq.b``, ``ln_x.*``, ``xattn.*``, ``ffn.wi.w`` for an
MLP, ``ffn.router`` / ``ffn.wi`` / ``ffn.wo`` for an MoE).  Layer order
follows ``repro.serving.engine.flat_layers``: period-major over the stacked
``blocks``, then the unrolled remainder ``rem``.  ``lm_head`` and the
``encoder`` tree (its layers, then its final norm) come across as they are.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ModelConfig


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16 from jax
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, pre: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{pre}{k}.", out)
    else:
        out[pre[:-1]] = _tensor(tree)


def from_jax_params(cfg: ModelConfig,
                    params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {"embed": _tensor(params["embed"])}
    _flatten(params["final_norm"], "final_norm.", out)
    i = 0
    for pi in range(cfg.num_periods):
        for s in range(cfg.period):
            _flatten(_index(params["blocks"][f"sub{s}"], pi),
                     f"layers.{i}.", out)
            i += 1
    for r in range(cfg.remainder_layers):
        _flatten(params["rem"][r], f"layers.{i}.", out)
        i += 1
    if "lm_head" in params:
        out["lm_head"] = _tensor(params["lm_head"])
    if "encoder" in params:
        for j, lp in enumerate(params["encoder"]["layers"]):
            _flatten(lp, f"encoder.layers.{j}.", out)
        _flatten(params["encoder"]["final_norm"], "encoder.final_norm.", out)
    return out


def _index(tree, pi: int):
    """Slice period ``pi`` out of a period-stacked subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, pi) for k, v in tree.items()}
    return tree[pi]
