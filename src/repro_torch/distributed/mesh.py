"""The decode-serving mesh (port of ``repro.distributed.mesh``).

A mesh is a ``(data, model)`` grid of shards: KV pages, and so plan
subtasks, shard over ``data`` and KV heads over ``model``.  In the port
every shard lives on one torch device, the engine's: the shards run one
after another inside one step (``step_fn.ShardedStep``), so the mesh's
collectives are exchanges and sums over an explicit shard axis on that
device.  A ``1x1`` mesh runs the whole sharded path on one shard.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DecodeMesh:
    """``data`` x ``model`` shards on ``device``."""

    data: int
    model: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {"data": self.data, "model": self.model}


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"DxM"`` -> ``(data, model)`` sizes (e.g. ``"2x2"``)."""
    try:
        d, m = spec.lower().split("x")
        d, m = int(d), int(m)
    except ValueError:
        raise ValueError(f"mesh spec must look like '2x1', got {spec!r}")
    if d < 1 or m < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {spec!r}")
    return d, m


def decode_mesh(data: int = 1, model: int = 1,
                device="cuda") -> DecodeMesh:
    """A ``(data, model)`` mesh with every shard on ``device``.  ``data``
    must be a power of two (the cross-shard POR merge is a
    recursive-doubling butterfly)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {data}x{model}")
    if data & (data - 1):
        raise ValueError(f"data axis must be a power of two, got {data}")
    return DecodeMesh(int(data), int(model), torch.device(device))
