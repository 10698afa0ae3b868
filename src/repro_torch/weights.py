"""Bridge from ``repro``'s JAX parameter tree to the port's state dict.

``from_jax_params(cfg, params)`` takes the tree that
``repro.models.transformer.init_params`` returns, with every leaf already
converted to a numpy array by the caller (``jax.tree.map(np.asarray,
params)``), and returns the state dict of ``models.transformer.Transformer``
— so both packages compute the same function on the same weights.  It
imports neither ``jax`` nor ``repro``.

Layer order follows ``repro.serving.engine.flat_layers``: period-major over
the stacked ``blocks``, then the unrolled remainder ``rem``.
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


def _sublayer(p: Dict[str, Any], pre: str, out: Dict[str, torch.Tensor]):
    out[pre + "ln.scale"] = _tensor(p["ln"]["scale"])
    for w in ("wq", "wk", "wv", "wo"):
        for leaf in p["attn"][w]:
            out[pre + f"attn.{w}.{leaf}"] = _tensor(p["attn"][w][leaf])
    out[pre + "ln2.scale"] = _tensor(p["ln2"]["scale"])
    for w in ("wi", "wo"):
        out[pre + f"ffn.{w}.w"] = _tensor(p["ffn"][w]["w"])


def from_jax_params(cfg: ModelConfig,
                    params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {
        "embed": _tensor(params["embed"]),
        "final_norm.scale": _tensor(params["final_norm"]["scale"]),
    }
    i = 0
    for pi in range(cfg.num_periods):
        for s in range(cfg.period):
            sub = params["blocks"][f"sub{s}"]
            period = _index(sub, pi)
            _sublayer(period, f"layers.{i}.", out)
            i += 1
    for r in range(cfg.remainder_layers):
        _sublayer(params["rem"][r], f"layers.{i}.", out)
        i += 1
    return out


def _index(tree, pi: int):
    """Slice period ``pi`` out of a period-stacked subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, pi) for k, v in tree.items()}
    return tree[pi]
