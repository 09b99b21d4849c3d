"""Tensor-parallel serving context (DESIGN.md §16).

One ``TPContext`` describes the shards the serving engine splits device
state over: the KV-head axis of the paged page pool, the KV output axis
of the restoration weight pack (``core/restoration.py``), and the head
axis of decode attention. One process drives every shard: shard ``s`` is
a contiguous tensor on ``devices[s]``, an explicit list that may name one
card several times (the shards then run one after another on it) or
``tp`` CPU shards. ``tp == 1`` (``spmd`` False) makes every placement
helper the identity, so one code path serves both.

The byte-identity discipline of the JAX package holds here too:

  * every sharded tensor is split on a dimension that no sum runs over
    (KV heads, flattened KV outputs), so each output element is still one
    full-depth sum computed on one shard, by the launch of the same
    kernel that computes it at ``tp == 1``: restored K/V and attention
    outputs are bitwise those of ``tp == 1``;
  * the restore sink never crosses shards: a projection group gives K/V
    already split by heads (``Sharded``) and the pool is split the same
    way, so each shard's page writes are its own;
  * the one gather of a decode step is the ``torch.cat`` of the shards'
    attention outputs onto ``devices[0]`` before the output projection,
    which, and everything after it, runs whole on ``devices[0]``.

Where the JAX package runs fewer shards than asked when the host has
fewer devices, this context refuses: too few cards is a ``ValueError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Sequence, Union

import torch

TP_AXIS = "model"


def _device(d) -> torch.device:
    """``d`` as a torch device, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def default_devices(tp: int, kind: str = "cuda") -> List[torch.device]:
    """The first ``tp`` visible CUDA devices, or ``tp`` CPU shards for
    ``kind="cpu"``. Too few cards is a ``ValueError`` naming the count."""
    if kind == "cpu":
        return [torch.device("cpu")] * tp
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < tp:
        raise ValueError(f"tensor parallelism over tp={tp} cards, but "
                         f"{have} CUDA device(s) are visible; shards never "
                         "fall back to fewer cards (pass an explicit device "
                         "list to put several shards on one card)")
    return [torch.device("cuda", i) for i in range(tp)]


@dataclasses.dataclass
class Sharded:
    """A tensor split on ``axis`` into one part per shard, in shard
    order; part ``s`` lives on the context's ``devices[s]``."""

    parts: List[torch.Tensor]
    axis: int

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return torch.Size(s)

    def __getitem__(self, i: int) -> "Sharded":
        """Index ``i`` of the leading axis of every part (a layer of a
        stacked pool)."""
        if not isinstance(i, int) or self.axis == 0:
            raise TypeError("a Sharded tensor takes one integer index on "
                            "an axis it is not split on")
        return Sharded([p[i] for p in self.parts], self.axis - 1)

    def unsqueeze(self, dim: int) -> "Sharded":
        return Sharded([p.unsqueeze(dim) for p in self.parts],
                       self.axis + (dim <= self.axis))

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: part 0's)."""
        dev = self.parts[0].device if device is None else device
        return torch.cat([p.to(dev) for p in self.parts], self.axis)


def on_device(device: torch.device):
    """Make ``device`` current for a launch on it (a kernel's stream
    belongs to its device)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def gathered(x, device=None):
    """``x`` whole: a ``Sharded`` value gathered (onto ``device``, or its
    first part's), a tensor as it is."""
    return x.gather(device) if isinstance(x, Sharded) else x


class TPContext:
    """``tp`` shards over ``devices`` (default ``default_devices(tp)``; a
    device kind ``"cpu"``/``"cuda"`` picks that kind's default).

    ``spmd`` is True only when ``tp > 1``; every placement helper is the
    identity otherwise, so callers never branch."""

    def __init__(self, tp: int = 1,
                 devices: Union[None, str, Sequence] = None, *,
                 axis: str = TP_AXIS):
        self.tp = max(int(tp), 1)
        self.axis = axis
        if devices is None or isinstance(devices, str):
            devices = default_devices(self.tp, devices or "cuda")
        devices = [_device(d) for d in devices]
        if len(devices) != self.tp:
            raise ValueError(f"tp={self.tp} shards need {self.tp} devices, "
                             f"got {len(devices)}")
        self.devices = devices
        self.device0 = devices[0]
        self.spmd = self.tp > 1
        from repro_torch.launch.mesh import make_mesh
        self.mesh = make_mesh((self.tp,), (axis,), devices)

    def __repr__(self):
        return (f"TPContext(tp={self.tp}, spmd={self.spmd}, devices="
                f"{[str(d) for d in self.devices]})")

    def key(self):
        """Hashable identity for plan-cache keys."""
        return (self.tp, self.spmd)

    def distinct(self) -> List[torch.device]:
        """The devices, each once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def validate_heads(self, n_kv_heads: int) -> None:
        if self.spmd and n_kv_heads % self.tp:
            raise ValueError(
                f"tensor-parallel width tp={self.tp} must divide the "
                f"model's n_kv_heads={n_kv_heads} (each shard owns an "
                f"equal slice of the KV-head axis)")

    # ----------------------------------------------------------- placement
    def shard_kv(self, x: torch.Tensor, axis: int):
        """``x`` split on ``axis`` into ``tp`` contiguous parts, part s on
        ``devices[s]`` (``x`` itself when not SPMD)."""
        if not self.spmd:
            return x
        if x.shape[axis] % self.tp:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} does not "
                             f"split into tp={self.tp} shards")
        return Sharded([c.to(d).contiguous()
                        for c, d in zip(x.chunk(self.tp, axis),
                                        self.devices)], axis)

    def replicate(self, x: torch.Tensor):
        """``x`` on every shard's device, as a list in shard order: one
        copy per distinct device, never two to one device (``x`` itself
        when not SPMD)."""
        if not self.spmd:
            return x
        on = {d: x.to(d) for d in self.distinct()}
        return [on[d] for d in self.devices]

    def unshard(self, x):
        """The one gather onto ``devices[0]``: a ``Sharded`` value whole
        there (the seam back into single-device code: history gathers for
        an unsharded prefill, snapshots for the host store)."""
        if not self.spmd:
            return x
        return (x.gather(self.device0) if isinstance(x, Sharded)
                else x.to(self.device0))

    def join(self) -> None:
        """Make ``devices[0]``'s current stream wait for the work queued
        so far on every other device's current stream, so that an event
        recorded on it after this spans every shard's launches."""
        if self.device0.type != "cuda":
            return
        main = torch.cuda.current_stream(self.device0)
        for d in self.distinct()[1:]:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            main.wait_event(ev)


def context(tp: Union[int, TPContext, None], device) -> TPContext:
    """The context of an engine on ``device``: ``tp`` itself when it is
    one, else ``tp`` shards of ``device``'s kind (the first ``tp`` cards
    on CUDA). Its first device must be ``device``: the weights and the
    unsharded work stay there."""
    ctx = (tp if isinstance(tp, TPContext)
           else TPContext(tp or 1, [device] if (tp or 1) == 1
                          else torch.device(device).type))
    if ctx.device0 != _device(device):
        raise ValueError(f"the first shard's device {ctx.device0} is not "
                         f"the model's {torch.device(device)}")
    return ctx
