"""Device meshes: named axes over an explicit list of devices.

One process drives every device of a mesh (tensor-parallel serving,
``distributed/tp.py``; sharded training, ``training/sharded.py``; the
mesh serving programs, ``distributed/mesh_serving.py``), so a mesh here
is only a grid of torch devices with axis names; no process group
stands behind it. A device may appear several times (shards that share
one card). The mesh programs take ("data", "model") or ("pod", "data",
"model") (``check_axes``).

``make_production_mesh`` is the JAX package's production pod mesh, (16,
16) or (2, 16, 16), every device ``meta`` by default: the counterpart of
the reference's 512 placeholder host devices, on which the dry-run
(``launch/dryrun.py``) counts a cell without running its kernels. It is
not a CPU fallback.
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


MESH_AXES = (("data", "model"), ("pod", "data", "model"))


def check_axes(mesh: Mesh, what: str = "a mesh") -> None:
    """Refuse a mesh whose axes are not ("data", "model") or ("pod",
    "data", "model")."""
    if tuple(mesh.axis_names) not in MESH_AXES:
        raise ValueError(f"{what} has axes ('data', 'model') or ('pod', "
                         f"'data', 'model'), not {mesh.axis_names}")


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """The JAX package's production mesh: (data=16, model=16), or with
    ``multi_pod`` (pod=2, data=16, model=16), every device ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MESH_AXES[1] if multi_pod else MESH_AXES[0]
    return make_mesh(shape, axes, [device] * math.prod(shape))


def single_device_mesh(device=None) -> Mesh:
    """The (data=1, model=1) mesh over ``device`` (default the first
    CUDA device)."""
    return make_mesh((1, 1), ("data", "model"),
                     None if device is None else [device])
