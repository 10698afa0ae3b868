"""Token samplers (port of ``repro.serving.sampler``, greedy only)."""

from __future__ import annotations

import math

import torch


def check_temperature(temperature: float) -> None:
    """Raise unless ``temperature`` is one the sampler can serve.

    Sampling at ``temperature > 0`` must draw ``repro``'s threefry bits
    (``fold_in(key, row)`` per row) to keep streams identical across the
    two packages; that generator is not ported yet.
    """
    temperature = float(temperature)
    if temperature < 0.0 or not math.isfinite(temperature):
        raise ValueError(
            f"temperature must be finite and >= 0 (0 = greedy argmax), "
            f"got {temperature}")
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature > 0 needs the threefry sampler, not ported yet")


def sample(logits: torch.Tensor, temperature: float = 0.0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32 token ids (greedy argmax)."""
    check_temperature(temperature)
    return torch.argmax(logits, -1).to(torch.int32)
