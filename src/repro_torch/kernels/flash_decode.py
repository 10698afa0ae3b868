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

import torch

from . import build
from .ref import MASK_VALUE

# launches of the CUDA kernel in this process (plain-path calls are not
# counted); chip_smoke.py resets it before the phase that drives it
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
# what the kernel takes: these head dims, and any number of query heads
# per KV head (h_q % n_kv == 0), as the TPU kernel does
HEAD_DIMS = (64, 128, 256)
# a split keeps at least this many KV positions
SPLIT_TILE = 64


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


def num_splits(batch_heads: int, L: int, num_sms: int) -> int:
    """KV splits per (row, KV head): the smallest power of two that gives
    at least two blocks per SM, capped so each split keeps at least
    ``SPLIT_TILE`` positions."""
    cap = max(1, L // SPLIT_TILE)
    s = 1
    while 2 * s <= cap and batch_heads * s < 2 * num_sms:
        s *= 2
    return s


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
    if d not in HEAD_DIMS or n_kv < 1 or h_q % n_kv:
        raise ValueError(f"flash_decode: the kernel takes d in {HEAD_DIMS} "
                         f"and h_q a multiple of n_kv, got d={d} h_q={h_q} "
                         f"n_kv={n_kv}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned "
                         "(vector loads)")
    lib = build.load()
    # the query heads one block holds; a wider group takes several blocks
    # a KV head, and each counts toward filling the card
    G = lib.codec_flash_decode_chunk(d, h_q // n_kv)
    chunks = -(-(h_q // n_kv) // G)
    S = num_splits(B * n_kv * chunks, L,
                   torch.cuda.get_device_properties(dev).multi_processor_count)
    o_part = torch.empty((B, S, h_q, d), dtype=torch.float32, device=dev)
    m_part = torch.empty((B, S, h_q), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, S, h_q), dtype=torch.float32, device=dev)
    out = torch.empty((B, h_q, d), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.codec_flash_decode(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
        v.data_ptr(), int(k.dtype == torch.bfloat16), kv_lens.data_ptr(),
        o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        out.data_ptr(), B, L, h_q, n_kv, d, int(window), S,
        1.0 / math.sqrt(d), stream)
    build.check(err, "codec_flash_decode")
    global launches
    launches += 1
    return out
