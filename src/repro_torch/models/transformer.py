"""Decoder-only transformer, dense attention subset (port of
``repro.models.transformer``).

``Transformer`` holds the embedding, one ``DecoderLayer`` per layer in the
order ``repro.serving.engine.flat_layers`` flattens them (period-major,
then the remainder layers), the final norm and the tied unembedding.
``forward`` is the full-sequence (prefill) pass; the decode engine calls
``embed_tokens``, the layers and ``unembed`` itself.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import LayerKind, ModelConfig
from . import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig, override=None) -> torch.dtype:
    if override is not None:
        return override
    return _DTYPES[cfg.dtype]


def _check_supported(cfg: ModelConfig) -> None:
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if (kinds != {LayerKind("attn", "mlp")} or not cfg.tie_embeddings
            or cfg.encoder_layers or cfg.cross_attention
            or cfg.attn_logit_softcap or cfg.pos_embedding != "rope"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense attn+mlp decoders with tied "
            f"embeddings and RoPE only")


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: LayerKind, device=None,
                 dtype=None):
        super().__init__()
        self.kind = kind
        kw = dict(device=device, dtype=dtype)
        self.ln = L.RMSNorm(cfg.d_model, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = L.RMSNorm(cfg.d_model, **kw)
        self.ffn = L.MLP(cfg, **kw)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg, dtype)
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=device,
                        dtype=dtype), requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, cfg.layer_kind(i), device=device, dtype=dtype)
            for i in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig,
                        state: Dict[str, torch.Tensor]) -> "Transformer":
        """Wrap existing tensors (no copy): the model lives where they do."""
        model = cls(cfg, device="meta",
                    dtype=next(iter(state.values())).dtype)
        model.load_state_dict(state, assign=True)
        return model

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + tied unembedding -> float32 logits."""
        x = L.apply_norm(self.final_norm, x, self.cfg)
        return (x @ self.embed.T).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal pass. tokens (B, T) -> logits (B, T, V)."""
        cfg = self.cfg
        B, T = tokens.shape
        positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
        x = self.embed_tokens(tokens)
        for layer in self.layers:
            h = L.apply_norm(layer.ln, x, cfg)
            q, k, v = L.attn_project(layer.attn, cfg, h, positions)
            o = L.mha(q, k, v, causal=True, q_positions=positions,
                      kv_positions=positions)
            x = x + L.dense(layer.attn.wo,
                            o.reshape(B, T, cfg.num_heads * cfg.head_dim))
            x = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)
        return self.unembed(x)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> Dict[str, torch.Tensor]:
    """Random weights with ``repro.models.transformer.init_params``'s
    distributions: dense ``N(0, 1/fan_in)``, embedding ``N(0, 1/d_model)``,
    norm scales 1, biases 0.  Drawn in float32 from ``generator`` (which
    must live on ``device``), then cast.  The two packages draw different
    numbers from one seed; tests share weights through ``weights.py``."""
    _check_supported(cfg)
    dtype = torch_dtype(cfg, dtype)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    state = {"embed": normal((cfg.vocab_size, d), d ** -0.5),
             "final_norm.scale": ones(d)}
    shapes = {"attn.wq.w": (d, hq * hd), "attn.wk.w": (d, hkv * hd),
              "attn.wv.w": (d, hkv * hd), "attn.wo.w": (hq * hd, d),
              "ffn.wi.w": (d, 2 * cfg.d_ff), "ffn.wo.w": (cfg.d_ff, d)}
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        state[pre + "ln.scale"] = ones(d)
        state[pre + "ln2.scale"] = ones(d)
        for name, shape in shapes.items():
            state[pre + name] = normal(shape, 1.0 / math.sqrt(shape[0]))
        if cfg.qkv_bias:
            for w, n in (("wq", hq * hd), ("wk", hkv * hd),
                         ("wv", hkv * hd)):
                state[pre + f"attn.{w}.b"] = torch.zeros(
                    n, device=device, dtype=dtype)
    return state


def build_model(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """A ``Transformer`` with seeded random weights, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return Transformer.from_state_dict(
        cfg, init_params(cfg, gen, device=device, dtype=dtype))
