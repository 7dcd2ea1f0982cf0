"""Production and debug meshes, device-free: the counterpart of
``repro.launch.mesh``.

The JAX package builds its meshes from forced host devices (512 of them for
the multi-pod dry run). The port's dry run needs only the mesh's axis names
and sizes, as ``jax.sharding.AbstractMesh`` gives them: :class:`Mesh` holds
those and nothing else, so a 2 x 16 x 16 mesh costs no device, no process
and no process group. Building a ``torch.distributed.DeviceMesh`` from it
(one rank per chip, the placements of :mod:`repro_torch.sharding.rules`
executed by DTensor) waits on ``ROADMAP.md``, queue 1, item 6
(``torch.distributed``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh, in mesh order.

    ``shape`` maps each axis name to its size in that order (as
    ``AbstractMesh.shape`` does); ``size`` is the number of chips."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod: (pod=2, data=16, model=16) = 512 chips."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_debug_mesh(*, multi_pod: bool = False, data: int = 2,
                    model: int = 2) -> Mesh:
    """A tiny mesh for tests: (data, model), or (pod=2, data, model).
    ``make_debug_mesh(data=1, model=1)`` is one card."""
    if multi_pod:
        return Mesh((2, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))
