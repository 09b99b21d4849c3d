"""Device meshes: named axes over an explicit list of devices.

One process drives every device of a mesh (tensor-parallel serving,
``distributed/tp.py``), so a mesh here is only a grid of torch devices
with axis names; no process group stands behind it. A device may appear
several times (shards that share one card). The JAX package's pod
meshes (``make_production_mesh``) belong to its TPU cost tooling and are
not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of torch devices of shape ``shape``,
    axis i named ``axis_names[i]``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self):
        return list(self.devices.ravel())


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``devices`` (default: the
    first ``prod(shape)`` visible CUDA devices; too few is a
    ``ValueError``)."""
    from repro_torch.distributed.tp import default_devices
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "rank")
    n = math.prod(shape)
    devices = (default_devices(n) if devices is None
               else [torch.device(d) for d in devices])
    if len(devices) != n:
        raise ValueError(f"mesh {shape} needs {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def single_device_mesh(device=None) -> Mesh:
    """The (data=1, model=1) mesh over ``device`` (default the first
    CUDA device)."""
    return make_mesh((1, 1), ("data", "model"),
                     None if device is None else [device])
