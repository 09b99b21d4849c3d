"""Logical-axis sharding rules and explicit placement over a device mesh.

Model code names each parameter dimension by a *logical* axis
(``Model.param_axes``); the rules map logical axes onto the physical mesh
axes ``(data, model)``, as the JAX package's ``distributed/sharding.py``
does:

  * batch            -> data              (data parallelism)
  * heads / qkv_out  -> model             (query heads, padded to a
                                           multiple of the model axis)
  * kv_out           -> model             (the flattened K/V projection)
  * o_in / d_ff      -> model             (row- and column-parallel FFN)
  * vocab            -> model             (vocab-parallel table and loss)
  * opt_fsdp         -> data              (ZeRO-1: the optimizer leaves'
                                           largest unnamed dimension)

A spec is a plain tuple with one entry per dimension: ``None``, a mesh
axis name, or a tuple of names. The JAX package hands its specs to GSPMD
(``constrain``, ``mesh_context``); here one process drives every device
of the mesh, so a spec places a tensor explicitly: ``place`` gives each
device of the mesh its part (``Placed``), and ``Placed.gather`` puts the
parts back together.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


def _tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict (the model code imports
    this module, so it cannot import ``training.tree``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, MeshAxes]

    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        """Logical axes -> spec; an unknown axis maps to ``None``, and a
        mesh axis that an earlier dimension took is not used again."""
        parts, used = [], set()
        for ax in axes:
            m = self.rules.get(ax) if ax is not None else None
            if m is None:
                parts.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a not in used)
            used.update(ms)
            parts.append(None if not ms else ms[0] if len(ms) == 1 else ms)
        return tuple(parts)

    def tree_specs(self, axes_tree):
        """A tree of logical-axis tuples -> the tree of their specs."""
        return _tree_map(self.spec, axes_tree)

    def with_rules(self, **updates) -> "ShardingRules":
        new = dict(self.rules)
        new.update(updates)
        return ShardingRules(new)


def data_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def default_rules(mesh: Mesh, *, seq_shard: bool = False,
                  long_context: bool = False) -> ShardingRules:
    """The baseline rules; ``seq_shard`` puts the sequence on the data
    axes, ``long_context`` spreads the context of batch-1 cells over
    (data, model) and replicates the batch."""
    data = data_axes_of(mesh)
    rules: Dict[str, MeshAxes] = {
        # activations
        "batch": None if long_context else data,
        "seq": data if seq_shard else None,
        "kv_seq": (*data, "model") if long_context else "model",
        "d_model": None,
        "heads": "model",
        "kv_heads": None,
        "head_dim": None,
        # parameters
        "qkv_out": "model",
        "kv_out": "model",
        "o_in": "model",
        "d_ff": "model",
        "vocab": "model",
        "experts": None,
        "layers": None,
        "fsdp": None,
        "opt_fsdp": data,           # ZeRO-1: optimizer state over data
        # ssm
        "ssm_inner": "model",
        "ssm_state": None,
        "ssm_heads": "model",
        "conv_w": None,
        "dt_rank": None,
    }
    return ShardingRules(rules)


def fsdp_rules(mesh: Mesh, **kw) -> ShardingRules:
    """Weights sharded in two dimensions (grok-1-314b): the expert FFN
    width over (data, model) and the ``fsdp`` axis over data."""
    data = data_axes_of(mesh)
    return default_rules(mesh, **kw).with_rules(
        fsdp=data, d_ff=(*data, "model"))


def pad_heads(n_heads: int, n_kv_heads: int,
              axis_size: int) -> Tuple[int, int]:
    """(padded query heads, group size): the group grows until
    group x KV heads divides by the model axis; the KV heads are never
    padded."""
    if n_heads == 0:
        return 0, 0
    group = max(n_heads // n_kv_heads, 1)
    padded = n_kv_heads * group
    while padded % axis_size:
        group += 1
        padded = n_kv_heads * group
    return padded, group


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


# --------------------------------------------------------------- placement
def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 coord: Sequence[int], name: str = "tensor"
                 ) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the device at mesh
    coordinate ``coord`` holds under ``spec``. A dimension that its mesh
    axes do not divide raises a ``ValueError`` naming ``name``."""
    if len(spec) != len(shape):
        raise ValueError(f"{name}: spec {spec} has {len(spec)} entries for "
                         f"a tensor of shape {tuple(shape)}")
    where = dict(zip(mesh.axis_names, coord))
    out = []
    for dim, (n, entry) in enumerate(zip(shape, spec)):
        index, count = 0, 1
        for ax in entry_axes(entry):
            if ax not in mesh.shape:
                raise ValueError(f"{name}: mesh axis {ax!r} is not in the "
                                 f"mesh {mesh.axis_names}")
            index, count = index * mesh.shape[ax] + where[ax], \
                count * mesh.shape[ax]
        if n % count:
            raise ValueError(f"{name}: dimension {dim} ({n}) does not "
                             f"divide over mesh axes {entry_axes(entry)} "
                             f"({count} devices)")
        size = n // count
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def mesh_coords(mesh: Mesh) -> List[Tuple[int, ...]]:
    """Every device coordinate of the mesh in row-major order, the order
    of ``Mesh.device_list()`` and of ``Placed.parts``."""
    return list(itertools.product(*(range(s) for s in mesh.devices.shape)))


def replica_of(spec: Spec, mesh: Mesh, coord: Sequence[int]) -> bool:
    """True where the device at ``coord`` holds the first copy of its
    block: its coordinate is 0 on every mesh axis ``spec`` does not
    name."""
    named = {a for e in spec for a in entry_axes(e)}
    return all(c == 0 for ax, c in zip(mesh.axis_names, coord)
               if ax not in named)


@dataclasses.dataclass
class Placed:
    """A tensor of ``shape`` placed by ``spec`` over ``mesh``: ``parts``
    holds each device's block, contiguous and on that device, in
    ``mesh_coords`` order."""

    parts: List[torch.Tensor]
    spec: Spec
    shape: Tuple[int, ...]
    mesh: Mesh

    def block(self, coord: Sequence[int]) -> Tuple[slice, ...]:
        return block_slices(self.shape, self.spec, self.mesh, coord)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the first device's),
        from the first copy of each block."""
        dev = self.parts[0].device if device is None else device
        out = torch.empty(self.shape, dtype=self.parts[0].dtype, device=dev)
        for coord, part in zip(mesh_coords(self.mesh), self.parts):
            if replica_of(self.spec, self.mesh, coord):
                out[self.block(coord)] = part.to(dev)
        return out


def place(x: torch.Tensor, spec: Spec, mesh: Mesh,
          name: str = "tensor", share: bool = False) -> Placed:
    """``x`` split by ``spec``: each device of ``mesh`` gets a contiguous
    copy of its block (a replicated block is copied to every device that
    holds it). With ``share`` (read-only weights) a device that several
    shards of the mesh name holds each distinct block once, and a block
    that is the whole of a contiguous ``x`` already on its device is
    ``x`` itself."""
    from repro_torch.distributed.tp import _device
    parts, held = [], {}
    for coord, dev in zip(mesh_coords(mesh), mesh.device_list()):
        dev = _device(dev) if share else dev
        sl = block_slices(x.shape, spec, mesh, coord, name)
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        if share and key in held:
            parts.append(held[key])
            continue
        whole = all(s.stop - s.start == n for s, n in zip(sl, x.shape))
        if share and whole and x.device == dev and x.is_contiguous():
            part = x
        else:
            part = x[sl].to(dev, copy=True).contiguous()
        held[key] = part
        parts.append(part)
    return Placed(parts, tuple(spec), tuple(x.shape), mesh)


def place_tree(tree, specs, mesh: Mesh, prefix: str = "",
               share: bool = False):
    """``place`` over a tree and its tree of specs; each leaf's path names
    it in a refusal."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh, f"{prefix}/{k}", share)
                for k, v in tree.items()}
    return place(tree, specs, mesh, prefix.lstrip("/") or "tensor", share)


def gather_tree(tree, device=None):
    """A tree of ``Placed`` leaves made whole on ``device``."""
    return _tree_map(lambda p: p.gather(device), tree)
