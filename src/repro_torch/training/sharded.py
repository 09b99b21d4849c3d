"""Sharded training over a (data x model) mesh, driven by one process.

The port's counterpart of the JAX package's ``jax.jit(train_step)`` under
the state's shardings: GSPMD partitions the reference's step; here the
step is written out for an explicit ``Mesh`` (``launch/mesh.py``; axes
("data", "model"), or ("pod", "data", "model") with the batch and ZeRO
over ("pod", "data") as one data axis in pod-major order) and
``ShardingRules`` (``distributed/sharding.py``), one graph per device of
the mesh, joined by the collectives of ``distributed/collectives.py``.

  state:     the fp32 master, m and v (and ef) placed by
             ``Trainer.state_axes``' specs (ZeRO-1: a leaf with an
             unnamed dimension is split over ``data`` on its largest
             such dimension, the others are split only over ``model``),
             one ``Placed`` per leaf, a part on every device
  compute:   each device's compute parameters are its master parts, made
             whole over ``data`` where ZeRO split them, cast to the model
             dtype inside the graph
  data:      the batch split over ``data``; each data shard's gradient of
             a leaf split over ``data`` is reduce-scattered onto its
             slice, of a leaf replicated over ``data`` summed
  model:     the ``lm`` families (dense, moe, vlm) through the one
             training forward, ``transformer.lm_train_forward_shards``,
             and the one loss, ``train_step.chunked_ce_loss_shards``,
             with each data shard's list of model shards (the plain
             ``Trainer`` calls them with one shard): Megatron style by the
             rules, the table vocab-sharded and the cross-entropy
             vocab-parallel
  global:    the gradient norm over every element once; the MoE
             load-balance aux from the global f and P (sums over every
             data shard, then E·Σ f·P), never a mean of per-shard auxes
  order:     every cross-shard sum runs in shard order, and the backward
             runs on one thread whatever the devices, so two runs of one
             mesh give the same bits, on one card or across cards
  count:     under a counter (``launch/exec_cost.py``) each device's
             work is attributed to its shard, and the ZeRO gather and
             the gradient reduction report themselves as collectives

The ssm, hybrid and enc-dec families train over ``data`` only (each data
shard runs the model's own training forward); a model axis above 1 is
refused for them, as are rules this step does not implement: ``seq`` on
a mesh axis, a non-None ``fsdp``, ``d_ff`` over more than ``model``
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (Placed, ShardingRules,
                                              block_slices, data_axes_of,
                                              default_rules, entry_axes,
                                              gather_tree, mesh_coords,
                                              place_tree, replica_of)
from repro_torch.distributed.tp import on_device
from repro_torch.launch import exec_cost
from repro_torch.launch.mesh import Mesh, check_axes
from repro_torch.models import transformer as tfm
from repro_torch.models.layers.moe import load_balance_aux
from repro_torch.training.optimizer import adamw_apply, clip_scale
from repro_torch.training.train_step import Trainer, chunked_ce_loss_shards
from repro_torch.training.tree import (tree_map, tree_paths, tree_unflatten)

UNPORTED = "is not ported (ROADMAP.md, queue 1)"


def _refuse(model, rules: ShardingRules, M: int,
            data: tuple = ("data",)) -> None:
    r = rules.rules
    if entry_axes(r.get("batch")) != data:
        raise ValueError(f"the batch on mesh axes {entry_axes(r.get('batch'))}"
                         f" (long_context placement) {UNPORTED}")
    if r.get("seq") is not None:
        raise ValueError(f"the sequence on a mesh axis (seq_shard) {UNPORTED}")
    if r.get("fsdp") is not None:
        raise ValueError(f"weights sharded over fsdp={r['fsdp']!r} "
                         f"(fsdp_rules) {UNPORTED}")
    if entry_axes(r.get("d_ff")) not in ((), ("model",)):
        raise ValueError(f"d_ff over {entry_axes(r['d_ff'])} {UNPORTED}")
    if M > 1 and model.kind != "lm":
        raise ValueError(f"{model.cfg.name}: a model axis of {M} over the "
                         f"{model.kind} family's blocks {UNPORTED}")
    if model.kind == "lm" and model.h.attn.q_heads % M:
        raise ValueError(
            f"{model.cfg.name}: {model.h.attn.q_heads} query heads do not "
            f"split over a model axis of {M}; build the Model with "
            f"model_axis={M} to pad them")


def _block_of(t: torch.Tensor, slices) -> torch.Tensor:
    """The block ``slices`` of a tensor broadcastable to the full leaf
    (its size-1 dimensions are not sliced)."""
    return t[tuple(sl if n > 1 else slice(None)
                   for n, sl in zip(t.shape, slices))]


def _data_dim(spec, cspec, data: tuple = ("data",)) -> Optional[int]:
    """The dimension ZeRO split over the ``data`` axes in a master spec
    whose compute spec is ``cspec`` (None when they are equal)."""
    if tuple(spec) == tuple(cspec):
        return None
    diff = [i for i, (a, b) in enumerate(zip(spec, cspec)) if a != b]
    if (len(diff) != 1 or cspec[diff[0]] is not None
            or entry_axes(spec[diff[0]]) != data):
        raise ValueError(f"master spec {spec} against compute spec {cspec}"
                         f": only a ZeRO split over data {UNPORTED}")
    return diff[0]


# ------------------------------------------------------------ the trainer
class ShardedTrainer:
    """``trainer``'s step over ``mesh`` (axes ("data", "model") or ("pod",
    "data", "model")) under ``rules`` (default ``default_rules(mesh)``).
    The model must be laid out for the mesh's model axis
    (``Model(model_axis=M)``) where its heads need padding. D counts the
    data shards (pod x data on a pod mesh); device r is data shard
    r // M, model shard r % M."""

    def __init__(self, trainer: Trainer, mesh: Mesh,
                 rules: Optional[ShardingRules] = None):
        check_axes(mesh, "a training mesh")
        self.trainer = trainer
        self.model = trainer.model
        self.mesh = mesh
        self.rules = rules or default_rules(mesh)
        self.M = mesh.shape["model"]
        self.D = mesh.size // self.M
        self.data = data_axes_of(mesh)
        _refuse(self.model, self.rules, self.M, self.data)
        self.axes = self.model.param_axes()
        self.coords = mesh_coords(mesh)
        self.devices = mesh.device_list()
        self.compute_specs = [s for _, s in tree_paths(
            self.rules.tree_specs(self.axes))]

    # ------------------------------------------------------------ state
    def state_axes(self, state) -> dict:
        return self.trainer.state_axes(self.axes, state, self.D)

    def state_specs(self, state) -> dict:
        return self.rules.tree_specs(self.state_axes(state))

    def place_state(self, state) -> dict:
        """``state`` (whole, any device) placed over the mesh."""
        return place_tree(state, self.state_specs(state), self.mesh)

    def init_state(self, seed: int = 0) -> dict:
        return self.place_state(self.trainer.init_state(seed))

    def gather_state(self, pstate, device=None) -> dict:
        """The whole state on ``device`` (default the first device's):
        what a checkpoint saves."""
        return gather_tree(pstate, device)

    def state_bytes(self, pstate) -> List[int]:
        """Bytes of state each device of the mesh holds."""
        out = [0] * len(self.coords)
        for _, leaf in tree_paths(pstate):
            for r, part in enumerate(leaf.parts):
                out[r] += part.numel() * part.element_size()
        return out

    # ------------------------------------------------------------- step
    def _compute_part(self, leaf: Placed, cspec, r: int) -> torch.Tensor:
        """Device r's compute block of a master leaf: its master part, or
        the master parts along ``data`` concatenated where ZeRO split
        them."""
        dim = _data_dim(leaf.spec, cspec, self.data)
        if dim is None:
            return leaf.parts[r]
        m = r % self.M
        dev = self.devices[r]
        if self.D > 1:
            exec_cost.report_collective("all-gather", [leaf.parts[r]], [r])
        with exec_cost.at(r):
            return torch.cat([leaf.parts[d2 * self.M + m].to(dev)
                              for d2 in range(self.D)], dim)

    def _shard_batch(self, batch: dict, d: int) -> dict:
        B = batch["tokens"].shape[0]
        if B % self.D:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"data={self.D}")
        specs = self.model.train_batch_sharding(self.rules)
        coord = self.coords[d * self.M]
        return {k: v[block_slices(v.shape, specs[k], self.mesh, coord)]
                for k, v in batch.items()}

    def _forward(self, trees, batch):
        """Per device root losses and the step's (ce, aux) parts."""
        model, D, M = self.model, self.D, self.M
        dt = model.dtype
        cast = [tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                         t) for t in trees]
        B, S = batch["tokens"].shape
        roots, ces, stats = [None] * len(trees), [], []
        for d in range(D):
            ranks = [d * M + m for m in range(M)]
            part = self._shard_batch(batch, d)
            if model.kind != "lm":
                r = ranks[0]
                dev = self.devices[r]
                local = {k: v.to(dev) for k, v in part.items()}
                with on_device(dev), exec_cost.at(r):
                    total, parts = self.trainer.loss_fn(cast[r], local)
                    share = part["tokens"].shape[0] / B
                    roots[r] = total * share
                    ces.append(parts["ce"] * share)
                continue
            devs = [self.devices[r] for r in ranks]
            moved = {k: [v.to(dev) for dev in devs] for k, v in part.items()}
            ps = [cast[r] for r in ranks]
            c = model.cfg
            with exec_cost.shards(ranks[0]):
                xs, st = tfm.lm_train_forward_shards(
                    ps, moved["tokens"], model.h,
                    patches=moved.get("patches"))
                ce = chunked_ce_loss_shards(
                    [p["embed"] for p in ps], xs, moved["targets"],
                    softcap=c.logit_softcap, true_vocab=c.vocab_size,
                    n_chunks=self.trainer.loss_chunks, denom=B * S)
            for r, x in zip(ranks, ce):
                roots[r] = x
            ces.append(ce[0])
            stats.append(st)
        dev0 = self.devices[0]
        ce = ces[0].to(dev0)
        for x in ces[1:]:
            ce = ce + x.to(dev0)
        aux = 0.0
        if model.kind == "lm" and model.h.moe is not None:
            # per model shard m: every layer's routing stats of every
            # data shard, joined on data shard 0's shard m
            auxes = [load_balance_aux(
                [[st[li][m] for st in stats] for li in range(len(stats[0]))],
                B * S) for m in range(M)]
            w = self.trainer.aux_weight
            for m in range(M):
                roots[m] = roots[m] + w * auxes[m]
            aux = auxes[0]
        return roots, ce, aux

    def train_step(self, pstate: dict, batch: dict) -> Tuple[dict, Dict]:
        """(new placed state, metrics: loss, ce, aux, grad_norm) for a
        whole ``batch`` (on any device; split over ``data`` here)."""
        params = pstate["params"]
        paths = [p for p, _ in tree_paths(params)]
        placed = [leaf for _, leaf in tree_paths(params)]
        R = len(self.coords)
        leaves = [[self._compute_part(leaf, cs, r).detach().requires_grad_(
            True) for leaf, cs in zip(placed, self.compute_specs)]
            for r in range(R)]
        trees = [tree_unflatten(params, row) for row in leaves]
        with torch.enable_grad():
            roots, ce, aux = self._forward(trees, batch)
            flat = [t for row in leaves for t in row]
            live = [i for i, x in enumerate(roots) if x is not None]
            # one backward thread for every device: with a thread per
            # card, two threads can recompute one checkpointed block (it
            # spans the shards) at once, and tensors that take gradients
            # from several cards would sum them in arrival order
            with torch.autograd.set_multithreading_enabled(False):
                grads = torch.autograd.grad([roots[i] for i in live], flat,
                                            allow_unused=True)
        n = len(placed)
        grads = [[grads[r * n + i] for i in range(n)] for r in range(R)]
        with torch.no_grad():
            new_state, gnorm = self._update(pstate, placed, paths, leaves,
                                            grads)
        loss = ce + self.trainer.aux_weight * aux
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "aux": aux.detach() if isinstance(aux, torch.Tensor)
                   else aux, "grad_norm": gnorm}
        return new_state, metrics

    def _master_grads(self, placed, paths, leaves, grads):
        """Each leaf's gradient on each device's master part: the data
        shards' compute gradients summed in order (the slice ZeRO gave the
        device where it split the leaf), padded heads' slices zeroed."""
        masks = self.model.head_pad_masks()
        out = []
        for i, (path, leaf) in enumerate(zip(paths, placed)):
            dim = _data_dim(leaf.spec, self.compute_specs[i], self.data)
            parts = []
            for r in range(len(self.coords)):
                d, m = divmod(r, self.M)
                dev = self.devices[r]
                if self.D > 1 and grads[r][i] is not None:
                    exec_cost.report_collective(
                        "all-reduce" if dim is None else "reduce-scatter",
                        [grads[r][i]], [r])
                total = None
                with exec_cost.at(r):
                    for d2 in range(self.D):
                        src = d2 * self.M + m
                        g = grads[src][i]
                        if g is None:
                            g = torch.zeros_like(leaves[src][i])
                        if dim is not None:
                            size = leaf.parts[r].shape[dim]
                            g = g.narrow(dim, d * size, size)
                        g = g.to(dev)
                        total = g if total is None else total + g
                    if path in masks:
                        total = total * _block_of(
                            masks[path].to(dev),
                            leaf.block(self.coords[r])).to(total.dtype)
                parts.append(total)
            out.append(parts)
        return out

    def _update(self, pstate, placed, paths, leaves, grads):
        cfg = self.trainer.opt
        opt = pstate["opt"]
        g = self._master_grads(placed, paths, leaves, grads)
        if cfg.error_feedback:
            efs = [leaf for _, leaf in tree_paths(opt["ef"])]
            g = [[x.float() + e for x, e in zip(parts, ef.parts)]
                 for parts, ef in zip(g, efs)]
        dev0 = self.devices[0]
        sq = None
        for leaf, parts in zip(placed, g):
            for r, coord in enumerate(self.coords):
                if replica_of(leaf.spec, self.mesh, coord):
                    with exec_cost.at(r):
                        s = torch.sum(torch.square(parts[r].float())).to(
                            dev0)
                    sq = s if sq is None else sq + s
        gnorm = torch.sqrt(sq)
        scale = clip_scale(gnorm, cfg)
        news = []
        params = pstate["params"]
        for r in range(len(self.coords)):
            dev = self.devices[r]
            part = tree_map(lambda leaf: leaf.parts[r], pstate)
            grads_r = tree_unflatten(params, [parts[r] for parts in g])
            state_r = {k: v for k, v in part["opt"].items()}
            with exec_cost.at(r):
                news.append(adamw_apply(part["params"], grads_r, state_r,
                                        cfg, scale.to(dev)))
        new = {"params": [p for p, _ in news], "opt": [o for _, o in news]}

        def assemble(like, per_device):
            if isinstance(like, dict):
                return {k: assemble(v, [t[k] for t in per_device])
                        for k, v in like.items()}
            return Placed(list(per_device), like.spec, like.shape, self.mesh)

        return ({"params": assemble(params, new["params"]),
                 "opt": assemble(opt, new["opt"])}, gnorm)
