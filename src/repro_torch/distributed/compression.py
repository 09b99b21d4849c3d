"""Gradient/communication compression: the JAX package's
``distributed/compression.py`` over per-shard tensors.

The reference uses these on no path of its train step (its backward
reduces in the gradients' own dtype, and its error-feedback buffer,
``AdamWConfig.error_feedback``, folds the bf16 residual into the next
step); nor does the port's sharded step (``training/sharded.py``), which
reduces in fp32. They are library functions with the reference's wire
formats:

  * ``compressed_psum(parts)``: the parts cast to bf16 and summed in
    bf16;
  * ``compressed_psum(parts, int8=True)``: each part quantised to int8
    with its own per-tensor scale, the int8 values summed in int32, and
    the total multiplied by the largest of the scales (the reference's
    ``pmax``).

Where the reference's ``psum`` runs inside a ``shard_map``, one call here
takes the list of the axis' per-shard tensors, sums them in shard order
and returns one result per shard, on its device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.training.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale fp32 scalar): scale = max|x| / 127 + 1e-12 and
    q = clip(round(x / scale), -127, 127); |q·scale - x| is at most
    scale/2 up to fp32 rounding."""
    x = x.float()
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(parts: Sequence[torch.Tensor], *,
                    int8: bool = False) -> List[torch.Tensor]:
    """The sum over one mesh axis of ``parts`` (one tensor per shard, in
    shard order), in the reference's wire format: bf16 (a bf16 result),
    or int8 with an int32 total times the largest scale (fp32). Returns
    the sum on each part's device."""
    dev0 = parts[0].device
    if not int8:
        total = parts[0].to(torch.bfloat16).to(dev0)
        for p in parts[1:]:
            total = total + p.to(torch.bfloat16).to(dev0)
    else:
        quant = [quantize_int8(p) for p in parts]
        acc = quant[0][0].to(dev0, torch.int32)
        scale = quant[0][1].to(dev0)
        for q, s in quant[1:]:
            acc = acc + q.to(dev0, torch.int32)
            scale = torch.maximum(scale, s.to(dev0))
        total = acc.float() * scale
    return [total.to(p.device) for p in parts]


def tree_cast_bf16(tree):
    """A gradient tree in the bf16 wire format: floating leaves cast to
    bf16, the others as they are."""
    return tree_map(lambda g: g.to(torch.bfloat16)
                    if g.is_floating_point() else g, tree)
