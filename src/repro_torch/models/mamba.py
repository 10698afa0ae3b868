"""Mamba-2 (SSD, state-space duality) mixer — port of
``repro.models.mamba`` in plain torch ops (arXiv:2405.21060).

Chunked SSD for prefill (an intra-chunk quadratic term and a sequential
scan over the chunk states) and an O(1) recurrent decode step.  One group
(B/C shared across heads).  ``mamba_recurrent_ref`` is the token-by-token
oracle for the chunked scan.

``repro``'s numerics are kept: the conv's SiLU in float32 cast back to
``xBC``'s dtype, a carried conv state cast to ``xBC``'s dtype before the
concatenation, the ``D`` skip through float32, the gated norm in float32,
``dt = softplus(dt + dt_bias)`` in float32 and ``A = -exp(A_log)``.
``repro`` scans the chunk states with ``jax.lax.associative_scan``; the
port loops over the chunks, the same recurrence with another order of
float32 additions.

States: ``conv`` (B, K-1, conv_dim) float32, the last ``K-1`` raw
(pre-conv) ``xBC`` rows; ``ssm`` (B, H, P, S) float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L

State = Tuple[torch.Tensor, torch.Tensor]

# elements of one block of the intra-chunk (B, chunks, H, Q, Q) tensors:
# chunks are processed in blocks of at most this size, so a long prefill
# never holds its whole quadratic term (4096 tokens at mamba2-2.7b's
# width would take 335 MB a tensor)
_BLOCK_ELEMS = 1 << 24


class Mamba2(nn.Module):
    """The mixer's parameters, named as ``repro``'s ``mamba_init`` tree:
    ``in_proj`` (d, 2 d_inner + 2 S + H) for z, xBC and dt; the depthwise
    ``conv_w`` (K, conv_dim) and ``conv_b``; ``A_log``, ``D`` and
    ``dt_bias`` (H,) float32; the gated norm's ``norm`` (d_inner,);
    ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, d_in, S, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, \
            cfg.ssm_heads
        conv_dim = d_in + 2 * S
        kw = dict(device=device, dtype=dtype)
        self.in_proj = L.Dense(d, 2 * d_in + 2 * S + H, **kw)
        self.conv_w = L._param((cfg.ssm_conv, conv_dim), device, dtype)
        self.conv_b = L._param((conv_dim,), device, dtype)
        self.A_log = L._param((H,), device, torch.float32)
        self.D = L._param((H,), device, torch.float32)
        self.dt_bias = L._param((H,), device, torch.float32)
        self.norm = L._param((d_in,), device, dtype)
        self.out_proj = L.Dense(d_in, d, **kw)


def state_shapes(cfg: ModelConfig) -> Tuple[Tuple[int, ...],
                                            Tuple[int, ...]]:
    """Per-row shapes of the ``conv`` and ``ssm`` states."""
    return ((cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
            (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, S, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * S]
    dt = zxbcdt[..., 2 * d_in + 2 * S:]
    assert dt.shape[-1] == H
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d. xBC: (B, T, C); w: (K, C)."""
    K = w.shape[0]
    T = xBC.shape[1]
    if init_state is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = init_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], 1)                       # (B, T+K-1, C)
    out = sum(xp[:, i:i + T] * w[i][None, None] for i in range(K))
    return F.silu((out + b[None, None]).float()).to(xBC.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    yf = (y * F.silu(z.float())).float()
    rms = torch.sqrt((yf * yf).mean(-1, keepdim=True) + eps)
    return (yf / rms * scale.float()).to(y.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: (B, T, H, P); dt: (B, T, H); A: (H,) negative;
    Bm/Cm: (B, T, S).  Returns (y (B, T, H, P) in x's dtype, final state
    (B, H, P, S) float32).

    Every three-operand product of ``repro`` is taken as a scaling then
    one batched matmul, so no (B, chunks, Q, Q, H, P) or (B, chunks, Q, H,
    P, S) tensor is formed; the intra-chunk term runs over blocks of
    chunks of at most ``_BLOCK_ELEMS`` elements."""
    Bsz, T, H, P = x.shape
    S = Bm.shape[-1]
    Q = min(chunk, T)
    nc = -(-T // Q)
    pad = nc * Q - T
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    xf = x.float().reshape(Bsz, nc, Q, H, P)
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    Bc = Bm.float().reshape(Bsz, nc, Q, S)
    Cc = Cm.float().reshape(Bsz, nc, Q, S)

    dA = dtc * A[None, None, None, :]                   # (B,nc,Q,H) log-decay
    cum = torch.cumsum(dA, 2)

    # intra-chunk (diagonal) term: y_i = sum_j C_i.B_j e^{cum_i-cum_j} dt_j x_j
    y_diag = torch.empty_like(xf)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    blk = max(1, _BLOCK_ELEMS // max(1, Bsz * H * Q * Q))
    for c0 in range(0, nc, blk):
        c1 = min(nc, c0 + blk)
        cb = torch.einsum("bnis,bnjs->bnij", Cc[:, c0:c1], Bc[:, c0:c1])
        ch = cum[:, c0:c1].permute(0, 1, 3, 2)           # (B,n,H,Q)
        seg = (ch[..., :, None] - ch[..., None, :]).masked_fill(
            ~causal, float("-inf"))
        w = torch.exp(seg) * dtc[:, c0:c1].permute(0, 1, 3, 2)[..., None, :]
        w = w * cb[:, :, None]                           # (B,n,H,i,j)
        y_diag[:, c0:c1] = torch.einsum("bnhij,bnjhp->bnihp", w,
                                        xf[:, c0:c1])

    # chunk states: S_c = sum_j e^{cum_last - cum_j} dt_j x_j B_j^T
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc    # (B,nc,Q,H)
    states = torch.einsum("bnjhp,bnjs->bnhps", xf * w_end[..., None], Bc)
    gamma = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)

    # inter-chunk recurrence s_c = s_{c-1} gamma_c + S_c (``repro``:
    # an associative scan of the same operator)
    prev = torch.empty_like(states)                      # state entering c
    s = (torch.zeros_like(states[:, 0]) if init_state is None
         else init_state.float())
    for c in range(nc):
        prev[:, c] = s
        s = s * gamma[:, c, :, None, None] + states[:, c]

    # off-diagonal term: y_i += (C_i . prev_state) e^{cum_i}
    y_off = torch.einsum("bnis,bnhps->bnihp", Cc, prev) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(Bsz, nc * Q, H, P)
    if pad:
        y = y[:, :T]
    return y.to(x.dtype), s


def _mix(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
         conv0: Optional[torch.Tensor], ssm0: Optional[torch.Tensor],
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shared body of ``mamba_forward`` and ``mamba_prefill``:
    returns (out (B, T, d), raw xBC, final ssm state)."""
    B, T, _ = x.shape
    d_in, S, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    zxbcdt = x @ p.in_proj.w
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, p.conv_w, p.conv_b, init_state=conv0)
    x_ssm = xBC[..., :d_in].reshape(B, T, H, P)
    Bm = xBC[..., d_in:d_in + S]
    Cm = xBC[..., d_in + S:]
    dt = _softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, final = ssd_chunked(x_ssm, dt, A, Bm, Cm, cfg.ssm_chunk,
                           init_state=ssm0)
    y = y + x_ssm.float().to(y.dtype) \
        * p.D[None, None, :, None].to(y.dtype)
    y = y.reshape(B, T, d_in)
    y = _gated_norm(y, z, p.norm, cfg.norm_eps)
    return y @ p.out_proj.w, xBC_raw, final


def mamba_forward(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                  ) -> Tuple[torch.Tensor, State]:
    """Full-sequence Mamba-2 block from zero state. x: (B, T, d).
    Returns (y, (conv_state, ssm_state)) for decode continuation; the
    conv state is left-padded with zeros when T < K-1."""
    B, T, _ = x.shape
    out, xBC_raw, final = _mix(p, cfg, x, None, None)
    K = cfg.ssm_conv
    conv_state = xBC_raw[:, -(K - 1):].float()
    if T < K - 1:
        conv_state = torch.cat(
            [conv_state.new_zeros((B, K - 1 - T, conv_state.shape[-1])),
             conv_state], 1)
    return out, (conv_state, final)


def mamba_prefill(p: Mamba2, cfg: ModelConfig, h: torch.Tensor,
                  init: Optional[State]) -> Tuple[torch.Tensor, State]:
    """A prefill span from a carried state (``repro``'s engine
    ``_mamba_prefill``): ``init=None`` is ``mamba_forward``; otherwise the
    conv resumes from ``init``'s conv rows and the scan from its ssm
    state, and the new conv state is the last K-1 raw rows of the carried
    rows followed by the span's."""
    if init is None:
        return mamba_forward(p, cfg, h)
    conv0, ssm0 = init
    out, xBC_raw, final = _mix(p, cfg, h, conv0, ssm0)
    K = cfg.ssm_conv
    conv_tail = torch.cat([conv0, xBC_raw.float()], 1)[:, -(K - 1):]
    return out, (conv_tail, final)


def mamba_decode(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor,
                 ) -> Tuple[torch.Tensor, State]:
    """One-token recurrent step. x: (B, 1, d); conv_state: (B, K-1,
    conv_dim); ssm_state: (B, H, P, S).  Returns (y, (conv', ssm'))."""
    B = x.shape[0]
    d_in, S, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    zxbcdt = x @ p.in_proj.w
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, p.conv_w, p.conv_b,
                       init_state=conv_state)            # (B, 1, conv_dim)
    new_conv = torch.cat([conv_state[:, 1:], xBC_raw.float()], 1)
    x_ssm = xBC[..., :d_in].reshape(B, H, P)
    Bm = xBC[:, 0, d_in:d_in + S]
    Cm = xBC[:, 0, d_in + S:]
    dt1 = _softplus(dt[:, 0].float() + p.dt_bias)        # (B, H)
    A = -torch.exp(p.A_log)
    dA = torch.exp(dt1 * A[None])                        # (B, H)
    xs = x_ssm.float()
    new_state = (ssm_state * dA[:, :, None, None]
                 + dt1[:, :, None, None] * xs[..., None]
                 * Bm.float()[:, None, None, :])
    y = torch.einsum("bhps,bs->bhp", new_state, Cm.float())
    y = y + xs * p.D[None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = _gated_norm(y, z, p.norm, cfg.norm_eps)
    return y @ p.out_proj.w, (new_conv, new_state)


def zero_state(cfg: ModelConfig, batch: int, device=None) -> State:
    """Zero float32 (conv, ssm) states for ``batch`` rows."""
    cs, ss = state_shapes(cfg)
    return (torch.zeros((batch,) + cs, dtype=torch.float32, device=device),
            torch.zeros((batch,) + ss, dtype=torch.float32, device=device))


def mamba_recurrent_ref(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                        ) -> torch.Tensor:
    """Token-by-token reference (the oracle for ``ssd_chunked``)."""
    conv_state, ssm_state = zero_state(cfg, x.shape[0], x.device)
    outs = []
    for t in range(x.shape[1]):
        y, (conv_state, ssm_state) = mamba_decode(
            p, cfg, x[:, t:t + 1], conv_state, ssm_state)
        outs.append(y)
    return torch.cat(outs, 1)
