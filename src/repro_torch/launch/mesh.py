"""Launch meshes (port of ``repro.launch.mesh``): the axis names and sizes
the dry run's sharding rules read, with no devices behind them.

``repro`` builds JAX meshes over 256 or 512 (forced host) devices.  The
port has no SPMD compiler, so a ``LaunchMesh`` is only the layout: the
specs of ``launch/sharding.py`` name its axes, ``shard_shape`` divides a
tensor by its sizes, and ``launch/dryrun.py`` reckons each device's
bytes from that.

The production layouts keep ``repro``'s shapes so the specs compare one
to one: ``(data=16, model=16)`` for one pod, ``(pod=2, data=16,
model=16)`` for two.  On H100s a 256-card layout is 32 nodes of 8 cards,
so a 16-wide ``model`` axis spans two nodes (NVLink within a node, the
network between them); the dry run does not model that link, nor any
collective (ROADMAP A17).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LaunchMesh:
    """Named mesh axes and their sizes, in order; no devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the sizes joined, as the dry run's
        file names spell them."""
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LaunchMesh:
    """16 x 16 cards (``data``, ``model``), or 2 x 16 x 16 with a leading
    ``pod`` axis that only the batch shards over."""
    if multi_pod:
        return LaunchMesh(("pod", "data", "model"), (2, 16, 16))
    return LaunchMesh(("data", "model"), (16, 16))


def make_host_mesh(data: Optional[int] = None,
                   model: Optional[int] = None) -> LaunchMesh:
    """A ``(data, model)`` mesh over the cards this process sees
    (``torch.cuda.device_count()``, at least 1): all of them on ``data``
    by default, the rest of one given size on the other axis."""
    n = max(torch.cuda.device_count(), 1)
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data < 1 or model < 1 or data * model > n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"cards; this process sees {n}")
    return LaunchMesh(("data", "model"), (data, model))


def mesh_axis_sizes(mesh: LaunchMesh) -> Tuple[int, ...]:
    return tuple(mesh.shape[a] for a in mesh.axis_names)
