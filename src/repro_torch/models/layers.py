"""Core NN layers (port of ``repro.models.layers``, without its activation
sharding hints).

Parameters live in small ``nn.Module``s whose attribute names follow the
JAX parameter tree (``w``/``b``, ``scale``/``bias``, ``wq``..``wo``,
``wi``/``wo``, ``router``), and the math is plain functions over them, as
in ``repro``.  Weights keep the JAX layout ``(d_in, d_out)`` so
``y = x @ w``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..configs.base import ModelConfig

MASK_VALUE = -1e30
# the dry run's attention and MoE over DTensors (``launch/op_stats.py``,
# ``partitioned_mha`` / ``partitioned_moe``): set only while it
# partitions a step
PARTITIONED_MHA = None
PARTITIONED_MOE = None


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.w = _param((d_in, d_out), device, dtype)
        self.b = _param((d_out,), device, dtype) if bias else None


class Norm(nn.Module):
    """RMS norm (``scale``) or layer norm (``scale`` and ``bias``)."""

    def __init__(self, d: int, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.scale = _param((d,), device, dtype)
        self.bias = (_param((d,), device, dtype) if cfg.norm == "layer"
                     else None)


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


def _gate(cfg: ModelConfig) -> int:
    return 2 if cfg.mlp_act in ("silu", "geglu") else 1


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wi = Dense(cfg.d_model, _gate(cfg) * cfg.d_ff, **kw)
        self.wo = Dense(cfg.d_ff, cfg.d_model, **kw)


class MoE(nn.Module):
    """Top-k experts: the router stays float32 at any weight dtype."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = _param((d, E), device, torch.float32)
        self.wi = _param((E, d, _gate(cfg) * ff), device, dtype)
        self.wo = _param((E, ff, d), device, dtype)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS or layer norm computed in float32, cast back to the input
    dtype.  The variance divides by n, as ``jnp.var`` does."""
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = torch.var(xf, -1, keepdim=True, correction=0)
        y = (xf - mu) / torch.sqrt(var + cfg.norm_eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        rms = torch.sqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
        y = xf / rms * p.scale.float()
    return y.to(x.dtype)


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


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(s / cap) * cap if cap > 0 else s


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
        causal: bool, window: int = 0, softcap: float = 0.0,
        q_positions: Optional[torch.Tensor] = None,
        kv_positions: Optional[torch.Tensor] = None,
        kv_valid: Optional[torch.Tensor] = None,
        q_chunk: int = 512, kv_layout: str = "blhd") -> torch.Tensor:
    """Full attention as plain matmuls + softmax, q-chunked.

    q: (B, Tq, Hq, hd); k/v: (B, Tk, Hkv, hd) (``"blhd"``) or (B, Hkv, Tk,
    hd) (``"bhld"``, the dense decode cache's head-major layout).  Scores
    are taken in float32 (softcapped when ``softcap > 0``) and the
    probabilities rounded to V's dtype before the PV product (the
    precision ``repro``'s einsums use).  Padded query rows carry position
    -1 and stay finite.
    """
    if PARTITIONED_MHA is not None and hasattr(q, "placements"):
        return PARTITIONED_MHA(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_positions=q_positions,
                               kv_positions=kv_positions, kv_valid=kv_valid,
                               q_chunk=q_chunk, kv_layout=kv_layout)
    B, Tq, Hq, hd = q.shape
    if kv_layout == "bhld":
        Tk, Hkv = k.shape[2], k.shape[1]
        k_sub = "bhkd"
    else:
        Tk, Hkv = k.shape[1], k.shape[2]
        k_sub = "bkhd"
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
        s = torch.einsum(f"bchgd,{k_sub}->bhgck", qc, kf) * scale
        s = _softcap(s, softcap)
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
        o = torch.einsum(f"bhgck,{k_sub}->bchgd", p.to(v.dtype).float(), vf)
        outs.append(o.reshape(B, -1, Hq, hd))
    return torch.cat(outs, 1).to(q.dtype)


def attn_full(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence self-attention. Returns (y, k, v) for caching."""
    q, k, v = attn_project(p, cfg, x, positions)
    o = mha(q, k, v, causal=causal, window=window,
            softcap=cfg.attn_logit_softcap,
            q_positions=positions, kv_positions=positions)
    B, T = x.shape[:2]
    y = dense(p.wo, o.reshape(B, T, cfg.num_heads * cfg.head_dim))
    return y, k, v


def attn_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                cache_len: torch.Tensor, *, window: int = 0,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a dense cache.

    x: (B, 1, d); caches: (B, L, Hkv, hd); cache_len: (B,) tokens already
    present (the caller appends the new token's KV at index cache_len
    *before* calling, so attention covers cache_len+1 positions).
    Returns (y, k_new, v_new).
    """
    B = x.shape[0]
    positions = cache_len[:, None]                       # (B, 1)
    q, k_new, v_new = attn_project(p, cfg, x, positions)
    L = k_cache.shape[1]
    kv_pos = torch.arange(L, device=x.device)[None].expand(B, L)
    kv_valid = kv_pos <= cache_len[:, None]              # includes new token
    o = mha(q, k_cache, v_cache, causal=True, window=window,
            softcap=cfg.attn_logit_softcap, q_positions=positions,
            kv_positions=kv_pos, kv_valid=kv_valid, q_chunk=1)
    y = dense(p.wo, o.reshape(B, 1, cfg.num_heads * cfg.head_dim))
    return y, k_new, v_new


def cross_attn_full(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    kv_layout: str = "blhd") -> torch.Tensor:
    """Cross attention (no rope, bidirectional over encoder output)."""
    B, T, _ = x.shape
    hq, hd = cfg.num_heads, cfg.head_dim
    q = dense(p.wq, x).reshape(B, T, hq, hd)
    o = mha(q, enc_k, enc_v, causal=False, softcap=cfg.attn_logit_softcap,
            kv_layout=kv_layout)
    return dense(p.wo, o.reshape(B, T, hq * hd))


def cross_kv(p: Attention, cfg: ModelConfig, enc_out: torch.Tensor):
    B, S, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = dense(p.wk, enc_out).reshape(B, S, hkv, hd)
    v = dense(p.wv, enc_out).reshape(B, S, hkv, hd)
    return k, v


# --------------------------------------------------------------------- #
# FFN: dense MLP and MoE
# --------------------------------------------------------------------- #
def _act(h: torch.Tensor, kind: str, ff: int) -> torch.Tensor:
    """SwiGLU, GeGLU or plain GELU.  GELU is the tanh approximation, as
    ``jax.nn.gelu`` computes by default."""
    if kind == "silu":
        return F.silu(h[..., :ff]) * h[..., ff:]
    if kind == "geglu":
        return F.gelu(h[..., :ff], approximate="tanh") * h[..., ff:]
    return F.gelu(h, approximate="tanh")


def apply_mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = dense(p.wi, x)
    return dense(p.wo, _act(h, cfg.mlp_act, cfg.d_ff))


def apply_ffn_block(layer, cfg: ModelConfig, ffn: str, x: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-mixer FFN half of a sub-layer: ln2 + (mlp|moe) + residual.

    Shared by the full-sequence, dense-decode and paged-decode paths (eager
    and fused), so all of them stay op-identical.  Returns ``(x, aux)``:
    the MoE's load-balancing loss, a float32 zero for other FFN kinds.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, aux
    h2 = apply_norm(layer.ln2, x, cfg)
    if ffn == "moe":
        y2, aux = apply_moe(layer.ffn, cfg, h2)
    else:
        y2 = apply_mlp(layer.ffn, cfg, h2)
    return x + y2, aux


def _expert_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, N, k) @ (E, k, n) -> float32: the products of activation-dtype
    inputs accumulated and returned in float32 (``repro``'s
    ``preferred_element_type=f32``), never rounded to bf16 between.
    While autograd records (training) it takes the float32 product of
    the upcast inputs: ``bmm``'s ``out_dtype`` form has no derivative."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(a, w)
    recording = torch.is_grad_enabled() and (a.requires_grad
                                             or w.requires_grad)
    if a.is_cuda and not recording:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


def moe_capacity(cfg: ModelConfig, n: int) -> int:
    """Slots per expert and group for ``n`` tokens a group: the no-drop
    bound ``n * k`` when ``capacity_factor <= 0``."""
    nk = n * cfg.num_experts_per_tok
    return (nk if cfg.capacity_factor <= 0
            else max(1, int(cfg.capacity_factor * nk / cfg.num_experts)))


def moe_route(p: MoE, cfg: ModelConfig, xg: torch.Tensor):
    """The router and the queues of ``apply_moe`` for ``xg`` (G, n, d):
    returns ``(probs, gate_vals, idx, pos, cap)``: the router's softmax
    (G, n, E), each token's top-k gates (renormalised) and experts (G, n,
    k), each (token, choice)'s position in its expert's queue (G, n*k) and
    the capacity.  A pair is dropped where ``pos >= cap``."""
    G, n, _ = xg.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    nk = n * k
    i64 = torch.int64
    dev = xg.device
    logits = torch.einsum("gnd,de->gne", xg.float(), p.router)
    probs = torch.softmax(logits, -1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)           # (G, n, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # queue position of each (token, choice) in its (group, expert) queue:
    # a stable sort by expert id keeps ties in token-major order
    eid = idx.reshape(G, nk)
    order = torch.argsort(eid, dim=1, stable=True)
    sorted_eid = torch.gather(eid, 1, order)
    goff = torch.arange(G, device=dev, dtype=i64)[:, None] * E
    counts = torch.zeros(G * E, dtype=i64, device=dev).scatter_add_(
        0, (eid + goff).reshape(-1),
        torch.ones(G * nk, dtype=i64, device=dev)).reshape(G, E)
    starts = torch.cumsum(counts, 1) - counts               # (G, E)
    pos_sorted = (torch.arange(nk, device=dev, dtype=i64)[None]
                  - torch.gather(starts, 1, sorted_eid))
    pos = torch.zeros((G, nk), dtype=i64, device=dev).scatter_(
        1, order, pos_sorted)
    return probs, gate_vals, idx, pos, moe_capacity(cfg, n)


def apply_moe(p: MoE, cfg: ModelConfig, x: torch.Tensor,
              experts: Optional[Tuple[int, int]] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice MoE with capacity, sort-based dispatch, as
    ``repro``'s: the (token, choice) pairs are stable-sorted by expert id
    (token order sets the drop priority), queue positions come from
    segment counts (``moe_route``), and kept tokens land in ``(G, E, cap,
    d)`` expert buffers in the activation dtype.  Returns ``(y, aux)``
    with the Switch load-balancing loss.

    Nothing here reads a value on the host (no ``bincount``, ``nonzero``,
    mask indexing or ``.item()``): counts are ``scatter_add_`` into fixed
    zeros, so a CUDA graph can capture it.  ``cap`` follows the call's
    token count (``moe_capacity``).

    ``experts=(lo, hi)``: ``p.wi`` / ``p.wo`` hold experts lo..hi-1 only,
    and only their products are computed; the others' outputs are zeros
    (an expert-parallel shard's part of the sum)."""
    if PARTITIONED_MOE is not None and hasattr(x, "placements"):
        return PARTITIONED_MOE(p, cfg, x)
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    ff = cfg.d_ff
    n_total = B * T
    G = max(1, cfg.moe_groups)
    assert n_total % G == 0, (n_total, G)
    n = n_total // G                                        # tokens/group
    nk = n * k
    f32, i64 = torch.float32, torch.int64
    dev = x.device
    xg = x.reshape(G, n, d)
    probs, gate_vals, idx, pos, cap = moe_route(p, cfg, xg)
    eid = idx.reshape(G, nk)
    goff = torch.arange(G, device=dev, dtype=i64)[:, None] * E
    keep = pos < cap                                        # (G, nk)
    dst_c = torch.clamp(pos, max=cap - 1)

    # load-balancing aux loss (Switch): E * mean_g sum_e f_e * p_e
    density = torch.zeros(G * E, dtype=f32, device=dev).scatter_add_(
        0, (idx[..., 0] + goff).reshape(-1),
        torch.ones(G * n, dtype=f32, device=dev)).reshape(G, E) / n
    aux = E * torch.mean(torch.sum(density * probs.mean(1), -1))

    # dispatch: each kept (g, e, c) slot receives exactly one token, so the
    # index_add_ is a permutation (dropped pairs add zeros)
    cdt = x.dtype
    tok = torch.arange(nk, device=dev, dtype=i64) // k      # group-local
    vals = xg[:, tok] * keep[..., None].to(cdt)             # (G, nk, d)
    slot = ((eid + goff) * cap + dst_c).reshape(-1)         # (G * nk,)
    xin = torch.zeros((G * E * cap, d), dtype=cdt, device=dev).index_add_(
        0, slot, vals.reshape(-1, d))
    xin = xin.reshape(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)

    if experts is not None:
        xin = xin[experts[0]:experts[1]]
    h = _expert_mm(xin, p.wi)                               # (E, G*cap, F)
    h = _act(h, cfg.mlp_act, ff).to(cdt)
    out = _expert_mm(h, p.wo)                               # (E, G*cap, d)
    if experts is not None:
        whole = out.new_zeros((E,) + tuple(out.shape[1:]))
        whole[experts[0]:experts[1]] = out
        out = whole
    out = out.reshape(E, G, cap, d).transpose(0, 1).reshape(-1, d)

    gate_flat = gate_vals.reshape(G, nk) * keep.to(f32)
    picked = out[slot].reshape(G, n, k, d) * gate_flat.reshape(
        G, n, k, 1)
    y = torch.zeros((G, n, d), dtype=f32, device=dev)
    for j in range(k):          # the choices of a token, summed in order
        y = y + picked[:, :, j]
    return y.reshape(B, T, d).to(x.dtype), aux
