"""Config registry: ``get_config(arch_id)`` + smoke-test reductions.

The port carries only the configurations it can serve; ``qwen3-4b`` is the
paper's evaluation model and the first one ported.
"""

from __future__ import annotations

import dataclasses
import importlib

from .base import LayerKind, ModelConfig

_MODULES = {
    "qwen3-4b": "qwen3_4b",
}

PAPER_ARCH = "qwen3-4b"

__all__ = ["LayerKind", "ModelConfig", "PAPER_ARCH", "get_config",
           "smoke_config"]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (identical to
    ``repro.configs.smoke_config`` so both packages build one graph)."""
    cfg = get_config(name)
    n_kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
    group = cfg.group if cfg.num_heads else 0
    heads = n_kv * min(group, 2) if cfg.num_heads else 0
    # keep at least two full periods + remainder behaviour
    layers = min(cfg.num_layers, 2 * cfg.period + min(cfg.remainder_layers, 1))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=max(layers, 1),
        d_model=64,
        num_heads=heads,
        num_kv_heads=n_kv,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=257,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        capacity_factor=0.0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8 if cfg.ssm_state else 64,
        ssm_chunk=16,
        sliding_window=32 if cfg.sliding_window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_seq=min(cfg.frontend_seq, 12),
        dtype="float32",
    )
