"""FlashDecoding baseline (dense 4D batch KV layout): CUDA kernel + plain
version.

The paper's baseline: decode attention over regular ``(B, L, n_kv, d)``
tensors — each request's KV is read independently, so a shared prefix is
fetched once *per request*.  ``flash_decode`` runs the hand-written CUDA
kernel in ``csrc/flash_decode.cu`` (the port of the Pallas kernel
``repro.kernels.flash_decode.flash_decode``) when its tensors lie on the
card, and ``flash_decode_torch`` when they lie on the CPU.

CoDec over a ``core.plan.flash_plan`` (every request its own task chain) is
the *plan-level* baseline over the paged pool (the ``flash`` backend); this
kernel is the *layout-level* baseline over dense tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .ref import MASK_VALUE

# launches of the CUDA kernel in this process (plain-path calls are not
# counted); chip_smoke.py resets it before the phase that drives it
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# what the kernel takes: the kernels' head dims (d % 16 == 0, 16 <= d <=
# 256), and any number of query heads per KV head (h_q % n_kv == 0), as
# the TPU kernel does
HEAD_DIMS = build.HEAD_DIMS
# a pass-1 block takes a multiple of this many visible positions (the
# kernel's tile)
SPLIT_TILE = 64
# blocks an SM that the grid holds where every row reaches L
BLOCKS_PER_SM = 8
# a block that holds h query heads takes at least ceil(h / HEADS_PER_TILE)
# tiles, so that its partial (h x d floats, written and read once more by
# the merge) stays a small share of the K and V it reads, as long as the
# grid keeps MIN_BLOCKS_PER_SM blocks an SM
HEADS_PER_TILE = 4
MIN_BLOCKS_PER_SM = 1


def flash_decode_torch(q: torch.Tensor,        # (B, h_q, d)
                       k: torch.Tensor,        # (B, L, n_kv, d)
                       v: torch.Tensor,
                       kv_lens: torch.Tensor,  # (B,)
                       *, window: int = 0) -> torch.Tensor:
    """Dense decode attention as plain torch ops, output in ``q.dtype``.

    Row ``b`` attends over positions ``[0, kv_lens[b])`` (and, with a
    window, only ``p > kv_lens[b] - 1 - window``).  Positions outside that
    range may hold anything, NaN included: V is selected away there and
    the scores are replaced, never multiplied by 0.
    """
    B, h_q, d = q.shape
    _, L, n_kv, _ = k.shape
    group = h_q // n_kv
    pos = torch.arange(L, device=q.device)
    lens = kv_lens.to(device=q.device, dtype=torch.int64)[:, None]
    mask = pos[None, :] < lens                                 # (B, L)
    if window > 0:
        mask = mask & (pos[None, :] > lens - 1 - window)
    m4 = mask[:, None, None, :]                                # (B,1,1,L)
    qf = q.float().reshape(B, n_kv, group, d)
    kf = k.float().permute(0, 2, 1, 3)                         # (B,kv,L,d)
    vf = torch.where(mask[:, None, :, None], v.float().permute(0, 2, 1, 3),
                     0.0)
    s = torch.einsum("bhgd,bhnd->bhgn", qf, kf) * (1.0 / math.sqrt(d))
    s = torch.where(m4, s, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.where(m4, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = (torch.einsum("bhgn,bhnd->bhgd", p, vf)
         / torch.clamp(l, min=1e-30)[..., None])
    return o.reshape(B, h_q, d).to(q.dtype)


def split_tokens(row_heads: int, span: int, num_sms: int,
                 heads: int = 1) -> int:
    """Visible positions T that a pass-1 block takes: the least multiple
    of ``SPLIT_TILE`` at which rows of ``span`` positions give at most
    about ``BLOCKS_PER_SM`` blocks an SM over ``row_heads`` (rows x KV
    heads x head chunks); for a block of ``heads`` query heads at least
    ceil(heads / HEADS_PER_TILE) tiles, unless that leaves fewer than
    about ``MIN_BLOCKS_PER_SM`` blocks an SM.  A row of n visible
    positions takes ceil(n / T) blocks, each with the same work, so a
    short row costs only its own blocks."""
    def tokens(per_sm):
        splits = max(1, -(-per_sm * num_sms // max(row_heads, 1)))
        return SPLIT_TILE * max(1, -(-span // (SPLIT_TILE * splits)))
    wide = SPLIT_TILE * -(-heads // HEADS_PER_TILE)
    return max(tokens(BLOCKS_PER_SM), min(wide, tokens(MIN_BLOCKS_PER_SM)))


def kernel_refusal(d: int, h_q: int, n_kv: int) -> Optional[str]:
    """Why the kernel does not take head dim ``d`` with ``h_q`` query
    heads over ``n_kv`` KV heads, or None where it does."""
    if d not in HEAD_DIMS or n_kv < 1 or h_q < n_kv or h_q % n_kv:
        return (f"the kernel takes d a multiple of 16 from 16 to 256 and h_q "
                f"a multiple of n_kv, got d={d} h_q={h_q} n_kv={n_kv}")
    return None


def _check(name: str, t: torch.Tensor, dev, dtypes) -> None:
    if t.device != dev:
        raise ValueError(f"flash_decode: {name} on {t.device}, expected "
                         f"{dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"flash_decode: {name} has dtype {t.dtype}, "
                        f"expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"flash_decode: {name} must be contiguous")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_lens: torch.Tensor, *, chunk: int = 256,
                 window: int = 0) -> torch.Tensor:
    """Dense-batch decode attention -> (B, h_q, d) in ``q.dtype``.

    q: (B, h_q, d) float32/bfloat16; k, v: (B, L, n_kv, d) float32 or
    bfloat16 (one type for both); kv_lens: (B,) int32.  ``chunk`` (the TPU
    kernel's KV tile) is accepted for signature parity; the result does
    not depend on it.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise).
    """
    if chunk <= 0:
        raise ValueError(f"flash_decode: chunk must be positive, got {chunk}")
    if q.device.type == "cpu":
        return flash_decode_torch(q, k, v, kv_lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    dev = q.device
    _check("q", q, dev, _DTYPES)
    _check("k", k, dev, _DTYPES)
    _check("v", v, dev, (k.dtype,))
    _check("kv_lens", kv_lens, dev, (torch.int32,))
    B, h_q, d = q.shape
    Bk, L, n_kv, dk = k.shape
    if v.shape != k.shape or Bk != B or dk != d or kv_lens.shape != (B,):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_lens "
                         f"{tuple(kv_lens.shape)} do not fit")
    why = kernel_refusal(d, h_q, n_kv)
    if why is not None:
        raise ValueError(f"flash_decode: {why}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned "
                         "(vector loads)")
    lib = build.load()
    q_bf16, kv_bf16 = int(q.dtype == torch.bfloat16), \
        int(k.dtype == torch.bfloat16)
    # blocks a KV head (a group past what one block holds is cut into
    # chunks); each counts toward filling the card
    group = h_q // n_kv
    chunks = lib.codec_flash_decode_chunks(d, group, kv_bf16, q_bf16)
    span = min(L, window) if window > 0 else L
    T = split_tokens(B * n_kv * chunks, span,
                     torch.cuda.get_device_properties(dev)
                     .multi_processor_count, -(-group // chunks))
    S = max(1, -(-span // T))
    o_part = torch.empty((B, S, h_q, d), dtype=torch.float32, device=dev)
    m_part = torch.empty((B, S, h_q), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, S, h_q), dtype=torch.float32, device=dev)
    out = torch.empty((B, h_q, d), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.codec_flash_decode(
        q.data_ptr(), q_bf16, k.data_ptr(), v.data_ptr(), kv_bf16,
        kv_lens.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), out.data_ptr(), B, L, h_q, n_kv, d, int(window),
        T, S, 1.0 / math.sqrt(d), stream)
    build.check(err, "codec_flash_decode")
    global launches
    launches += 1
    return out
