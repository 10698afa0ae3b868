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
Any tree of the parameters' structure maps the same way (a gradient,
Adam's moments); ``from_jax_train_state`` carries an AdamW training state
across.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ModelConfig
from .training.trainer import make_state


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                     # a contiguous copy; keeps 0-d
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16 from jax
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree, pre: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{pre}{k}.", out)
    else:
        out[pre[:-1]] = _tensor(tree)


def from_jax_params(cfg: ModelConfig,
                    params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of ``params`` (or of any tree of that structure: a
    gradient, Adam's ``m`` or ``v``)."""
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


def from_jax_train_state(cfg: ModelConfig, state):
    """The port's ``TrainState`` from ``repro``'s AdamW state, its leaves
    numpy arrays (``jax.tree.map(np.asarray, state)``): ``step``, the
    weights and ``m`` / ``v`` / ``count``, by state-dict name.

    An Adafactor state does not carry over: ``repro`` stacks a period's
    layers, so its Adafactor factors every per-layer 1-d leaf (each norm
    scale) jointly across periods as a ``(periods, n)`` leaf, which has
    no per-layer counterpart (the port's leaf keeps a full ``v``)."""
    opt = state.opt_state
    if "slots" in opt:
        raise ValueError("an Adafactor state does not carry over: repro "
                         "factors its period-stacked 1-d leaves across "
                         "layers; the port keeps a per-layer v")
    port_opt = {"m": from_jax_params(cfg, opt["m"]),
                "v": from_jax_params(cfg, opt["v"]),
                "count": _tensor(np.asarray(opt["count"]))}
    return make_state(cfg, from_jax_params(cfg, state.params), port_opt,
                      _tensor(np.asarray(state.step)))
