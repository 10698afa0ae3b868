"""Token samplers (port of ``repro.serving.sampler``).

Greedy decoding is an argmax.  At ``temperature > 0`` each row draws from
its own ``fold_in(key, row)`` stream with the Gumbel-max trick, exactly as
``jax.random.categorical`` does, so the port's streams equal ``repro``'s
token for token.  That needs JAX's generator bit for bit, so this module
carries ``jax.random``'s threefry2x32 in integer torch ops, in the layout
of JAX's default ``jax_threefry_partitionable=True`` mode:

* a key is two uint32 words, held as an int64 tensor of shape ``(..., 2)``
  (``torch.uint32`` has no arithmetic on the CPU): every add, shift and
  rotate is masked back to 32 bits;
* ``split`` and ``random_bits`` hash the 64-bit iota of the output shape
  (high word, low word) under the key; ``random_bits`` xors the two output
  words; ``fold_in(key, d)`` hashes the pair ``(0, d)``;
* ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts 1
  and scales into ``[minval, maxval)``; ``gumbel`` is ``-log(-log(u))``
  over ``u`` in ``[tiny, 1)`` (JAX's default low-range mode).

Every function takes keys with leading batch axes, so a whole batch of
per-row keys hashes in one pass, on the host or inside a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def check_temperature(temperature: float) -> None:
    """Raise unless ``temperature`` is finite and >= 0 (0 = greedy)."""
    temperature = float(temperature)
    if temperature < 0.0 or not math.isfinite(temperature):
        raise ValueError(
            f"temperature must be finite and >= 0 (0 = greedy argmax), "
            f"got {temperature}")


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``; int64 tensors holding uint32 values,
    broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off, as ``repro``
    runs: the words ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _iota(shape: Sequence[int], device) -> torch.Tensor:
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError("random bits over 2**32 elements")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash_iota(key: torch.Tensor, shape: Sequence[int]):
    """Both threefry words over the iota of ``shape`` under each key of
    ``key`` (batch axes lead the result).  The iota's high words are 0."""
    lo = _iota(shape, key.device)
    nd = len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + (1,) * nd)
    k2 = key[..., 1].reshape(key.shape[:-1] + (1,) * nd)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, shape ``(..., num, 2)``."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], -1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of the uint32 ``data`` (an int or an int
    tensor, broadcast against the key's batch axes)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 values in int64, shape
    ``key.shape[:-1] + shape``."""
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # float32 bounds as Python floats (no host-to-device copy, so a CUDA
    # graph can capture this); XLA fuses the scale into one fma: the
    # float32 product is exact in float64, so one float64 add and a cast
    # round as it does
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (low dynamic range mode)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the argmax of the
    logits plus Gumbel noise; one key per leading row of ``logits``."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, -1)


def sample(logits: torch.Tensor, key: torch.Tensor,
           temperature: float = 0.0, top_k: int = 0, *,
           compiled: bool = False) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32 token ids.

    Row ``i`` draws from ``fold_in(key, i)``, so a row's sample does not
    depend on the batch's row count (the fused step pads rows to a
    bucket).  ``compiled``: divide by the temperature as ``repro``'s
    jitted fused step does, where XLA turns the division by a constant
    into a product with its float32 reciprocal; ``repro``'s eager calls
    divide exactly.
    """
    check_temperature(temperature)
    temperature = float(temperature)
    if temperature == 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    if compiled:
        logits = logits * float(np.float32(1.0) / np.float32(temperature))
    else:
        # a device scalar: CUDA divides by a host scalar through its
        # reciprocal
        logits = logits / torch.full((), temperature, dtype=logits.dtype,
                                     device=logits.device)
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    rows = torch.arange(logits.shape[0], device=logits.device)
    keys = fold_in(key, rows)                                   # (B, 2)
    return categorical(keys, logits).to(torch.int32)
