"""Core NN layers, dense subset (port of ``repro.models.layers``).

Parameters live in small ``nn.Module``s whose attribute names follow the
JAX parameter tree (``w``/``b``, ``scale``, ``wq``..``wo``, ``wi``/``wo``),
and the math is plain functions over them, as in ``repro``.  Weights keep
the JAX layout ``(d_in, d_out)`` so ``y = x @ w``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..configs.base import ModelConfig

MASK_VALUE = -1e30


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device,
                                          dtype=dtype), requires_grad=False)
        self.b = (nn.Parameter(torch.empty(d_out, device=device, dtype=dtype),
                               requires_grad=False) if bias else None)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, device=device, dtype=dtype),
                                  requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
        kw = dict(device=device, dtype=dtype)
        self.wq = Dense(d, hq * hd, cfg.qkv_bias, **kw)
        self.wk = Dense(d, hkv * hd, cfg.qkv_bias, **kw)
        self.wv = Dense(d, hkv * hd, cfg.qkv_bias, **kw)
        self.wo = Dense(hq * hd, d, **kw)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wi = Dense(cfg.d_model, 2 * cfg.d_ff, **kw)   # silu: gate|up
        self.wo = Dense(cfg.d_ff, cfg.d_model, **kw)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def apply_norm(p: RMSNorm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS norm computed in float32, cast back to the input dtype."""
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    xf = x.float()
    rms = torch.sqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
    return (xf / rms * p.scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (B, T, H, hd); positions: (B, T)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def attn_project(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 positions: Optional[torch.Tensor],
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p.wq, x).reshape(B, T, hq, hd)
    k = dense(p.wk, x).reshape(B, T, hkv, hd)
    v = dense(p.wv, x).reshape(B, T, hkv, hd)
    if cfg.pos_embedding == "rope" and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool, window: int = 0,
        q_positions: Optional[torch.Tensor] = None,
        kv_positions: Optional[torch.Tensor] = None,
        kv_valid: Optional[torch.Tensor] = None,
        q_chunk: int = 512) -> torch.Tensor:
    """Full attention as plain matmuls + softmax, q-chunked.

    q: (B, Tq, Hq, hd); k/v: (B, Tk, Hkv, hd).  Scores are taken in float32
    and the probabilities rounded to V's dtype before the PV product (the
    precision ``repro``'s einsums use).  Padded query rows carry position
    -1 and stay finite.
    """
    B, Tq, Hq, hd = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev)[None].expand(B, Tq)
    if kv_positions is None:
        kv_positions = torch.arange(Tk, device=dev)[None].expand(B, Tk)
    kf = k.float()
    vf = v.float()
    outs = []
    for c0 in range(0, Tq, q_chunk):
        qc = q[:, c0:c0 + q_chunk].float().reshape(B, -1, Hkv, g, hd)
        qpc = q_positions[:, c0:c0 + q_chunk]
        s = torch.einsum("bchgd,bkhd->bhgck", qc, kf) * scale
        mask = torch.ones((B, qpc.shape[1], Tk), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= kv_positions[:, None, :] <= qpc[:, :, None]
        if window > 0:
            mask &= kv_positions[:, None, :] > qpc[:, :, None] - window
        if kv_valid is not None:
            mask &= kv_valid[:, None, :]
        mask &= qpc[:, :, None] >= 0
        s = torch.where(mask[:, None, None], s, torch.full_like(s, MASK_VALUE))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgck,bkhd->bchgd", p.to(v.dtype).float(), vf)
        outs.append(o.reshape(B, -1, Hq, hd))
    return torch.cat(outs, 1).to(q.dtype)


def apply_mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(gate) * up, then the down projection."""
    if cfg.mlp_act != "silu":
        raise NotImplementedError(f"mlp_act {cfg.mlp_act!r} is not ported "
                                  f"yet")
    h = dense(p.wi, x)
    ff = cfg.d_ff
    return dense(p.wo, F.silu(h[..., :ff]) * h[..., ff:])


def apply_ffn_block(layer, cfg: ModelConfig, ffn: str,
                    x: torch.Tensor) -> torch.Tensor:
    """Post-mixer FFN half of a sub-layer: ln2 + mlp + residual."""
    if ffn == "none":
        return x
    if ffn != "mlp":
        raise NotImplementedError(f"ffn {ffn!r} is not ported yet")
    return x + apply_mlp(layer.ffn, cfg, apply_norm(layer.ln2, x, cfg))
