"""Collectives over the model axis of a mesh, as autograd functions.

One process drives every shard, so a "collective" here takes a list of
per-shard tensors (shard order, each on its shard's device) and returns
one tensor per shard. Each shard's graph is what one rank of a Megatron
style tensor-parallel step would build, and the three operators are the
ones that keep its gradients right (Shoeybi et al. 2019, "f" and "g"):

  * ``copy_to_shards`` (f): identity forward; backward sums the shards'
    gradients, because a replicated activation that enters the parallel
    region feeds every shard;
  * ``reduce_from_shards`` (g): forward sums the shards' partial results
    (a row-parallel product, a vocab-parallel lookup or sum); backward
    hands each shard the gradient its own copy received;
  * ``gather_from_shards``: forward concatenates the shards' slices on
    every shard; backward gives each slice the sum over shards of the
    gradient of that slice (a reduce-scatter), since each shard uses its
    copy of the whole for a different part of the work (its query heads'
    K/V).

Every sum runs in shard order on the first shard's device and is then
copied out, so each shard gets the same bits and two runs give the same
bits. With one shard every operator is the identity.

Each reports itself to the counter in force (``launch/exec_cost.py``)
by the JAX package's HLO kind, with each shard's operand bytes:
``reduce_from_shards`` and the backward of ``copy_to_shards`` as an
all-reduce, ``gather_from_shards`` as an all-gather (its backward as a
reduce-scatter), ``max_over_shards`` as an all-reduce. The copy of the
result each shard gets is attributed to that shard.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.launch import exec_cost


def _ordered_sum(tensors: Sequence[Optional[torch.Tensor]], like):
    """The sum of the non-None ``tensors`` in order, on ``like``'s
    device; zeros like ``like`` when all are None."""
    dev = like.device
    total = None
    for t in tensors:
        if t is None:
            continue
        total = t.to(dev) if total is None else total + t.to(dev)
    return torch.zeros_like(like) if total is None else total


def _spread(total: torch.Tensor, devices, owners) -> tuple:
    """A copy of ``total`` on each device (its own tensor each), copy i
    counted to shard ``owners[i]``."""
    out = []
    for d, r in zip(devices, owners):
        with exec_cost.at(r):
            out.append(total.to(d, copy=True))
    return tuple(out)


def _owners(parts) -> list:
    return [exec_cost.owner(p) for p in parts]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        ctx.owners = _owners(parts)
        return tuple(p.view_as(p) for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        exec_cost.report_collective(
            "all-reduce", [g for g in grads if g is not None],
            [r for g, r in zip(grads, ctx.owners) if g is not None])
        like = next(g for g in grads if g is not None)
        return _spread(_ordered_sum(grads, like.to(ctx.devices[0])),
                       ctx.devices, ctx.owners)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        owners = _owners(parts)
        exec_cost.report_collective("all-reduce", parts, owners)
        devices = [p.device for p in parts]
        return _spread(_ordered_sum(parts, parts[0]), devices, owners)

    @staticmethod
    def backward(ctx, *grads):
        return grads


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.owners = _owners(parts)
        exec_cost.report_collective("all-gather", parts, ctx.owners)
        whole = torch.cat([p.to(parts[0].device) for p in parts], dim)
        return _spread(whole, ctx.devices, ctx.owners)

    @staticmethod
    def backward(ctx, *grads):
        exec_cost.report_collective(
            "reduce-scatter", [g for g in grads if g is not None],
            [r for g, r in zip(grads, ctx.owners) if g is not None])
        like = next(g for g in grads if g is not None)
        total = _ordered_sum(grads, like.to(ctx.devices[0]))
        pieces = torch.split(total, ctx.sizes, ctx.dim)
        out = []
        for p, d, r in zip(pieces, ctx.devices, ctx.owners):
            with exec_cost.at(r):
                out.append(p.to(d, copy=True).contiguous())
        return (None,) + tuple(out)


def copy_to_shards(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """f: the replicated ``parts`` as they are; their gradients summed
    over shards in backward."""
    return list(parts) if len(parts) == 1 else list(_Copy.apply(*parts))


def reduce_from_shards(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """g: the sum of ``parts`` in shard order, on every shard."""
    return list(parts) if len(parts) == 1 else list(_Reduce.apply(*parts))


def gather_from_shards(parts: List[torch.Tensor],
                       dim: int) -> List[torch.Tensor]:
    """The shards' slices concatenated on ``dim``, on every shard; each
    slice's gradient is summed over shards."""
    return (list(parts) if len(parts) == 1
            else list(_Gather.apply(dim, *parts)))


def max_over_shards(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise max of ``parts`` on every shard, outside autograd
    (a softmax's stabilising max)."""
    if len(parts) > 1:
        exec_cost.report_collective("all-reduce", parts)
    with torch.no_grad():
        top = parts[0].detach()
        for p in parts[1:]:
            top = torch.maximum(top, p.detach().to(top.device))
        return [top.to(p.device) for p in parts]
