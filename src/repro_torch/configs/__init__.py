"""Config registry: ``get_config(arch_id)`` + smoke-test reductions (the
port's copy of ``repro.configs``).

Every config of ``repro`` loads here and the model builds every one; the
engine serves the decoder-only ones (all but ``whisper-base``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

from .base import LayerKind, ModelConfig
from .shapes import SHAPES, InputShape

_MODULES = {
    "mamba2-2.7b": "mamba2_2_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-base": "whisper_base",
    "gemma-2b": "gemma_2b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma3-1b": "gemma3_1b",
    "llava-next-34b": "llava_next_34b",
    "qwen3-4b": "qwen3_4b",
}

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES if k != "qwen3-4b"]
PAPER_ARCH = "qwen3-4b"

__all__ = ["ASSIGNED_ARCHS", "InputShape", "LayerKind", "ModelConfig",
           "PAPER_ARCH", "SHAPES", "get_config", "served_archs",
           "shape_supported", "skip_reason", "smoke_config"]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def served_archs() -> List[str]:
    """The configs the port's engine serves: the decoder-only ones."""
    return [name for name in _MODULES if not get_config(name).encoder_layers]


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
        capacity_factor=0.0,  # no-drop: decode must match train exactly
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8 if cfg.ssm_state else 64,
        ssm_chunk=16,
        sliding_window=32 if cfg.sliding_window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_seq=min(cfg.frontend_seq, 12),
        dtype="float32",
    )


def shape_supported(cfg: ModelConfig, shape: str) -> bool:
    return shape not in {s for s, _ in cfg.skip_shapes}


def skip_reason(cfg: ModelConfig, shape: str) -> str:
    for s, r in cfg.skip_shapes:
        if s == shape:
            return r
    return ""
