"""Serving programs over a (data x model) mesh, driven by one process.

The port's counterpart of the JAX package's mesh serving programs
(``launch/dryrun.py::build_cell``: ``serve_prefill``, ``restore_op`` and
``serve_decode``, each ``Model`` call jitted under the rules' shardings):
GSPMD partitions the reference's programs; here the model's own forward
functions run over shard lists (``transformer.lm_forward_shards``,
``lm_decode_step_shards``, ``ssm.ssm_forward_shards``,
``ssm_decode_step_shards``, of which the plain calls are the one-shard
case), and ``MeshServer`` places their inputs and outputs for an explicit
``Mesh`` (axes ("data", "model"), or ("pod", "data", "model") with the
batch over ("pod", "data") as one data axis in pod-major order;
``launch/mesh.py``) under ``ShardingRules`` (``distributed/sharding.py``),
one part per device.

  weights   placed by the rules (``place_params``): query heads
            (``qkv_out``), ``o_in``, ``d_ff`` and ``vocab`` over model;
            each device also holds the whole K/V projection of every
            layer (wk, wv, their biases), which kernel #1 reads: every
            model shard projects K/V of all heads, an M-fold repeat of
            that product (ROADMAP.md)
  batch     by ``Model.prefill_batch_sharding``: rows over ``data``
            (over ("pod", "data") on a pod mesh)
  prefill   per data shard, ``lm_forward_shards`` over its model shards;
            the emitted K/V and the captured hidden states keep each
            shard's context slice: they come out in the cache's layout
  restore   hidden (L, B, S, D) placed as ("layers", "batch", "kv_seq",
            "d_model"): each shard projects its (L, B/D, S/C, D) block
            at its absolute positions in one kernel-#1 launch
            (``transformer.lm_restore_kv``), so the restored K/V lands in
            the cache's context layout with no gather
  decode    the cache (L, B, Smax, Kv, hd) placed as ("layers", "batch",
            "kv_seq", "kv_heads", "head_dim"): context shard c holds
            positions [c·Smax/C, (c+1)·Smax/C) of every KV head; per data
            shard, ``lm_decode_step_shards`` over its model shards and
            its rows' context shards (``transformer.block_decode_shards``:
            kernel #3 per slice with ``kv_start`` and the log-sum-exp,
            merged in fp32 in shard order)
  ssm       (falcon-mamba) ``ssm_inner`` over model: each shard holds its
            channels' conv (B, W-1, I/M) and ssm (B, I/M, N) states and
            scans them through kernel #6 (``layers/mamba.py::
            apply_mamba1_shards``)

With ``long_context`` (``default_rules(mesh, long_context=True)``) the
context goes over (pod, data, model), C = D·M shards, and the batch is
replicated: each data shard prefills the same rows and keeps its slices;
a decode step runs once, on data shard 0's model shards over all C
context shards, and the other data shards hold copies of its results.

On a 1x1 mesh each program is the plain ``Model`` call, bit for bit. A
count of a program (``launch/exec_cost.py``) attributes each data
shard's work to its shards (``exec_cost.shards``), and the callers that
know the decode lengths on the host (``launch/dryrun.py::build_cell``)
pass them, so a counted run reads no value back from the device.
Refused, with a message that names ROADMAP.md: the hybrid and enc-dec
families, ``fsdp_rules``, ``seq_shard``, and rules that put the other
axes elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.distributed.sharding import (Placed, ShardingRules,
                                              _tree_map, block_slices,
                                              data_axes_of, default_rules,
                                              entry_axes, mesh_coords,
                                              place_tree, replica_of)
from repro_torch.distributed.tp import on_device
from repro_torch.launch import exec_cost
from repro_torch.launch.mesh import Mesh, check_axes
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers.embedding import padded_vocab
from repro_torch.models.layers.mamba import mamba1_channel_order

UNPORTED = "is not ported (ROADMAP.md, queue 1)"
HIDDEN_AXES = ("layers", "batch", "kv_seq", "d_model")
MODEL_AXES = ("qkv_out", "o_in", "d_ff", "vocab", "heads")
SSM_AXES = ("ssm_inner",)


def refuse(model, rules: ShardingRules, M: int,
           data: tuple = ("data",)) -> None:
    """Raise a ``ValueError`` naming ROADMAP.md for what the mesh
    programs do not implement; ``data`` the mesh's data axes."""
    r = rules.rules
    if not model.adapter.supports_mesh:
        raise ValueError(f"{model.cfg.name}: mesh serving of the "
                         f"{model.kind} family {UNPORTED}")
    if r.get("seq") is not None:
        raise ValueError(f"the sequence on a mesh axis (seq_shard) "
                         f"{UNPORTED}")
    if r.get("fsdp") is not None:
        raise ValueError(f"weights sharded over fsdp={r['fsdp']!r} "
                         f"(fsdp_rules) {UNPORTED}")
    layout = (entry_axes(r.get("batch")), entry_axes(r.get("kv_seq")))
    if layout not in ((data, ("model",)), ((), (*data, "model"))):
        raise ValueError(f"the batch over {layout[0]} and the context over "
                         f"{layout[1]} {UNPORTED}: the default rules and "
                         "long_context are")
    for ax in MODEL_AXES + (SSM_AXES if model.kind == "ssm" else ()):
        if M > 1 and entry_axes(r.get(ax)) != ("model",):
            raise ValueError(f"{ax} over {entry_axes(r.get(ax))} {UNPORTED}"
                             f": the mesh programs put it on 'model'")
    if model.kind == "lm" and model.h.attn.q_heads % M:
        raise ValueError(
            f"{model.cfg.name}: {model.h.attn.q_heads} query heads do not "
            f"split over a model axis of {M}; build the Model with "
            f"model_axis={M} to pad them")
    if model.kind == "ssm" and model.h.mamba.d_inner % M:
        raise ValueError(f"{model.cfg.name}: d_inner "
                         f"{model.h.mamba.d_inner} does not split over a "
                         f"model axis of {M}")


@dataclasses.dataclass
class MeshParams:
    """Weights placed over a mesh: ``placed`` the rules' layout (a tree of
    ``Placed``), ``local`` each device's tree in ``mesh_coords`` order
    (an lm stack's with the whole K/V projection of every layer)."""

    placed: dict
    local: List[dict]


def _first_copies(placed: Placed):
    """(block slices, part) of the first copy of each block."""
    return [(placed.block(coord), part) for coord, part in
            zip(mesh_coords(placed.mesh), placed.parts)
            if replica_of(placed.spec, placed.mesh, coord)]


class MeshServer:
    """``model``'s serving programs over ``mesh`` under ``rules`` (default
    ``default_rules(mesh)``). An lm model whose heads need padding must be
    built with ``model_axis`` equal to the mesh's model axis. D counts
    the data shards (pod x data on a pod mesh)."""

    def __init__(self, model, mesh: Mesh,
                 rules: Optional[ShardingRules] = None):
        check_axes(mesh, "a serving mesh")
        self.model = model
        self.mesh = mesh
        self.rules = rules or default_rules(mesh)
        self.M = mesh.shape["model"]
        self.D = mesh.size // self.M
        refuse(model, self.rules, self.M, data_axes_of(mesh))
        self.long_context = entry_axes(self.rules.rules["batch"]) == ()
        # context shards: M per data shard, or D·M over the whole mesh
        self.C = self.D * self.M if self.long_context else self.M
        self.coords = mesh_coords(mesh)
        self.devices = mesh.device_list()
        self.cache_specs = model.cache_sharding(self.rules)
        self.batch_specs = model.prefill_batch_sharding(self.rules)
        self.hidden_spec = self.rules.spec(HIDDEN_AXES)

    # ------------------------------------------------------------ layout
    def _ranks(self, d: int) -> List[int]:
        return [d * self.M + m for m in range(self.M)]

    def _block(self, shape, spec, r: int):
        return block_slices(shape, spec, self.mesh, self.coords[r])

    def place_params(self, params: dict) -> MeshParams:
        """``params`` (whole, any device) placed by the rules; blocks that
        several shards of one device hold are held once there."""
        tree = params
        if self.model.kind == "ssm" and self.M > 1:
            blocks = dict(params["blocks"])
            blocks["m"] = dict(blocks["m"])
            blocks["m"]["in_proj"] = mamba1_channel_order(
                blocks["m"]["in_proj"], self.M)
            tree = dict(params, blocks=blocks)
        specs = self.rules.tree_specs(self.model.param_axes())
        placed = place_tree(tree, specs, self.mesh, share=True)
        local = [_tree_map(lambda p, r=r: p.parts[r], placed)
                 for r in range(len(self.coords))]
        if self.model.kind == "lm":
            whole = {}
            names = [n for n in ("wk", "wv", "bk", "bv")
                     if n in params["blocks"]["attn"]]
            for r, dev in enumerate(self.devices):
                key = str(dev)
                if key not in whole:
                    whole[key] = {n: params["blocks"]["attn"][n].to(dev)
                                  for n in names}
                attn = dict(local[r]["blocks"]["attn"])
                attn.update(whole[key])
                local[r]["blocks"] = dict(local[r]["blocks"], attn=attn)
        return MeshParams(placed, local)

    def _place(self, x: torch.Tensor, spec, shape=None) -> Placed:
        """``x`` (whole) placed by ``spec`` as a tensor of ``shape``
        (default its own; a longer dimension is zero past ``x``'s end)."""
        return self._reshape_parts([(tuple(slice(0, n) for n in x.shape),
                                     x)], spec, tuple(shape or x.shape),
                                   x.dtype)

    def _reshape_parts(self, pieces, spec, shape, dtype) -> Placed:
        """A tensor of ``shape`` placed by ``spec`` from ``pieces``, (block
        slices, tensor) pairs that cover a prefix of it: each device's
        block is built from the pieces it overlaps, zeros elsewhere."""
        parts = []
        for r, dev in enumerate(self.devices):
            sl = self._block(shape, spec, r)
            out = torch.zeros(tuple(s.stop - s.start for s in sl),
                              dtype=dtype, device=dev)
            for src_sl, src in pieces:
                lo = [max(a.start, b.start) for a, b in zip(sl, src_sl)]
                hi = [min(a.stop, b.stop) for a, b in zip(sl, src_sl)]
                if any(h <= l for l, h in zip(lo, hi)):
                    continue
                dst = tuple(slice(l - a.start, h - a.start)
                            for l, h, a in zip(lo, hi, sl))
                got = tuple(slice(l - b.start, h - b.start)
                            for l, h, b in zip(lo, hi, src_sl))
                out[dst] = src[got].to(dev)
            parts.append(out)
        return Placed(parts, tuple(spec), tuple(shape), self.mesh)

    def place_hidden(self, hidden: torch.Tensor,
                     ctx_len: Optional[int] = None) -> Placed:
        """Stored hidden states (L, B, S, D) placed as ("layers", "batch",
        "kv_seq", "d_model"), zero past S up to ``ctx_len`` positions (a
        cache's capacity: its restored K/V then has the cache's layout)."""
        L, B, S, D = hidden.shape
        return self._place(hidden, self.hidden_spec,
                           (L, B, ctx_len or S, D))

    def place_cache(self, cache: dict, ctx_len: Optional[int] = None
                    ) -> dict:
        """A decode cache by ``Model.cache_sharding``: an lm cache's k/v
        (L, B, S, Kv, hd), whole or ``Placed`` (prefill's or a restore's),
        with ``ctx_len`` positions (default S; zero past S); an ssm
        cache's conv/ssm states; lengths (B,). Placed K/V already in the
        cache's layout is taken as it is."""
        out = {}
        for name, x in cache.items():
            spec = self.cache_specs[name]
            if name == "lengths" and not isinstance(x, Placed):
                x = torch.as_tensor(x, dtype=torch.int32)
            shape = tuple(x.shape)
            if name in ("k", "v"):
                shape = shape[:2] + (ctx_len or shape[2],) + shape[3:]
            if isinstance(x, Placed):
                if tuple(x.spec) == tuple(spec) and tuple(x.shape) == shape:
                    out[name] = x
                else:
                    out[name] = self._reshape_parts(
                        _first_copies(x), spec, shape, x.parts[0].dtype)
                continue
            out[name] = self._place(x, spec, shape)
        return out

    # ------------------------------------------------------------ batch
    def _batch_part(self, name: str, x: torch.Tensor, r: int):
        """Device r's block of a batch leaf (``prefill_batch_sharding``),
        on its device."""
        sl = self._block(x.shape, self.batch_specs[name], r)
        return x[sl].to(self.devices[r])

    def _vocab(self) -> int:
        return padded_vocab(self.model.cfg.vocab_size)

    def _placed(self, parts, axes, shape) -> Placed:
        return Placed(list(parts), self.rules.spec(axes), tuple(shape),
                      self.mesh)

    # ----------------------------------------------------------- prefill
    def prefill(self, mp: MeshParams, batch: dict, *,
                capture_hidden: bool = False) -> dict:
        """The reference's ``serve_prefill``: ``batch["tokens"]`` (B, S)
        (and a VLM's ``patches`` (B, n_vis, D)), whole on any device,
        placed by ``Model.prefill_batch_sharding``. Each data shard runs
        ``transformer.lm_forward_shards`` (``ssm.ssm_forward_shards``)
        over its model shards, keeping each shard's context slice of the
        K/V and hidden states. Returns dict(logits: ``Placed`` (B, 1, V)
        of the last position, vocab over model; lm: kv, a (k, v) pair of
        ``Placed`` (L, B, S, Kv, hd) in the cache's layout; ssm: states, a
        (conv, ssm) pair of ``Placed`` in the cache's layout; hidden:
        ``Placed`` (L, B, S, D) as ("layers", "batch", "kv_seq",
        "d_model") with ``capture_hidden``, else None)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        if not self.long_context and B % self.D:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"data={self.D}")
        lm = self.model.kind == "lm"
        if (lm or capture_hidden) and S % self.C:
            raise ValueError(f"{S} tokens do not split over {self.C} "
                             "context shards")
        c, h = self.model.cfg, self.model.h
        L = c.n_layers
        hshape = (L, B, S, c.d_model)
        logits, hparts, first, second = {}, {}, {}, {}
        for d in range(self.D):
            ranks = self._ranks(d)
            ps = [mp.local[r] for r in ranks]
            toks = [self._batch_part("tokens", tokens, r) for r in ranks]
            keep = (None if self.C == 1 else
                    [self._block(hshape, self.hidden_spec, r)[2]
                     for r in ranks])
            with exec_cost.shards(ranks[0]):
                if lm:
                    pts = ([self._batch_part("patches", batch["patches"],
                                             r) for r in ranks]
                           if "patches" in batch else None)
                    out = tfm.lm_forward_shards(
                        ps, toks, h, patches=pts,
                        capture_hidden=capture_hidden, emit_kv=True,
                        final_logits_only=True, keep=keep)
                    pairs = out["kv"]
                else:
                    out = ssm_lib.ssm_forward_shards(
                        ps, toks, h, capture_hidden=capture_hidden,
                        emit_state=True, final_logits_only=True, keep=keep)
                    pairs = out["states"]
            for i, r in enumerate(ranks):
                logits[r] = out["logits"][i]
                first[r], second[r] = pairs[i]
                if capture_hidden:
                    hparts[r] = out["hidden"][i]
        order = range(len(self.coords))
        res = {"logits": self._placed([logits[r] for r in order],
                                      ("batch", None, "vocab"),
                                      (B, 1, self._vocab())),
               "hidden": (Placed([hparts[r] for r in order],
                                 self.hidden_spec, hshape, self.mesh)
                          if capture_hidden else None)}
        if lm:
            shapes = {n: (L, B, S, c.n_kv_heads, c.head_dim_)
                      for n in ("k", "v")}
        else:
            m = h.mamba
            shapes = {"conv": (L, B, m.d_conv - 1, m.d_inner),
                      "ssm": (L, B, m.d_inner, m.d_state)}
        (n1, s1), (n2, s2) = shapes.items()
        res["kv" if lm else "states"] = (
            Placed([first[r] for r in order], self.cache_specs[n1], s1,
                   self.mesh),
            Placed([second[r] for r in order], self.cache_specs[n2], s2,
                   self.mesh))
        return res

    # ----------------------------------------------------------- restore
    def restore_kv_from_hidden(self, mp: MeshParams, hidden: Placed):
        """The reference's ``restore_op``, the paper's op: K/V of every
        layer from ``hidden`` placed by ``place_hidden``, each shard's
        (L, B/D, S/C, D) block at its absolute positions in one kernel-#1
        launch. Returns (k, v), ``Placed`` (L, B, S, Kv, hd) in the
        cache's layout."""
        if self.model.kind != "lm":
            raise ValueError(f"{self.model.cfg.name}: attention-free arch; "
                             "its state is restored whole, not from hidden "
                             "states")
        if tuple(hidden.spec) != tuple(self.hidden_spec):
            raise ValueError(f"hidden placed as {hidden.spec}, not "
                             f"{self.hidden_spec}")
        c = self.model.cfg
        L, B, S, _ = hidden.shape
        ks, vs = [], []
        for r, part in enumerate(hidden.parts):
            sl = hidden.block(self.coords[r])
            b, s = sl[1].stop - sl[1].start, sl[2].stop - sl[2].start
            dev = part.device
            with on_device(dev, r):
                pos = torch.arange(sl[2].start, sl[2].stop,
                                   device=dev)[None, :].expand(b, s)
                k, v = tfm.lm_restore_kv(mp.local[r], part, self.model.h,
                                         positions=pos, end=sl[2].stop)
            ks.append(k)
            vs.append(v)
        shape = (L, B, S, c.n_kv_heads, c.head_dim_)
        return (Placed(ks, self.cache_specs["k"], shape, self.mesh),
                Placed(vs, self.cache_specs["v"], shape, self.mesh))

    # ------------------------------------------------------------ decode
    def _streams(self):
        """(model shard ranks, context shard ranks) of each data shard
        that runs a decode step. Under long_context the batch is
        replicated and every row's context spans all D·M shards: data
        shard 0 runs the step over all of them, and the other data shards
        hold copies of its results. An ssm cache holds no context: every
        data shard runs its own copy of the states."""
        if self.long_context and self.model.kind == "lm":
            return [(self._ranks(0), list(range(len(self.coords))))]
        return [(self._ranks(d), self._ranks(d)) for d in range(self.D)]

    def decode_step(self, mp: MeshParams, cache: dict,
                    tokens: torch.Tensor, host_lengths=None):
        """The reference's ``serve_decode`` (``decode_step_full``): one
        token per row, ``tokens`` (B, 1) whole on any device, ``cache`` as
        ``place_cache`` gives it (written in place), each data shard's
        step ``transformer.lm_decode_step_shards`` over its model shards
        and its rows' context shards (``ssm.ssm_decode_step_shards`` over
        its ``ssm_inner`` shards). ``host_lengths`` (B,): the cache's
        lengths on the host, where the caller knows them (then the step
        reads none back from the device). Returns (logits ``Placed`` (B,
        1, V), the new cache, hidden ``Placed`` (L, B, 1, D) as
        ("layers", "batch", None, "d_model"))."""
        logits, hidden = {}, {}
        for ranks, ctx in self._streams():
            ps = [mp.local[r] for r in ranks]
            toks = [self._batch_part("tokens", tokens, r) for r in ranks]
            with exec_cost.shards(ranks[0]):
                if self.model.kind == "lm":
                    kc, vc = cache["k"], cache["v"]
                    host = None
                    if host_lengths is not None:
                        rows = self._block((tokens.shape[0],),
                                           self.cache_specs["lengths"],
                                           ranks[0])[0]
                        host = [int(n) for n in list(host_lengths)[rows]]
                    lg, hid = tfm.lm_decode_step_shards(
                        ps, toks, self.model.h,
                        k=[kc.parts[r] for r in ctx],
                        v=[vc.parts[r] for r in ctx],
                        lengths=[cache["lengths"].parts[r] for r in ctx],
                        starts=(None if len(ctx) == 1 else
                                [self._start(kc, r) for r in ctx]),
                        host_lengths=host,
                        host_starts=[self._block(kc.shape, kc.spec, r)[2]
                                     .start for r in ctx])
                else:
                    lg, hid = ssm_lib.ssm_decode_step_shards(
                        ps, toks, self.model.h,
                        conv=[cache["conv"].parts[r] for r in ranks],
                        ssm=[cache["ssm"].parts[r] for r in ranks])
            for r, x, y in zip(ranks, lg, hid):
                logits[r], hidden[r] = x, y
        c = self.model.cfg
        B = tokens.shape[0]
        order = range(len(self.coords))
        # the copies of data shard 0's results (long_context)
        for r in order:
            if r not in logits:
                dev = self.devices[r]
                exec_cost.report_collective(
                    "collective-permute",
                    [(logits[r % self.M], hidden[r % self.M])], [r])
                with exec_cost.at(r):
                    logits[r] = logits[r % self.M].to(dev)
                    hidden[r] = hidden[r % self.M].to(dev)
        new = []
        for r in order:
            with exec_cost.at(r):
                new.append(cache["lengths"].parts[r] + 1)
        new_len = self._placed(new, ("batch",), (B,))
        return (self._placed([logits[r] for r in order],
                             ("batch", None, "vocab"), (B, 1, self._vocab())),
                dict(cache, lengths=new_len),
                self._placed([hidden[r] for r in order],
                             ("layers", "batch", None, "d_model"),
                             (c.n_layers, B, 1, c.d_model)))

    def _start(self, placed: Placed, r: int) -> torch.Tensor:
        """(b,) int32: the absolute position of the first key of device
        r's context slice of the cache, one per row of its block."""
        sl = self._block(placed.shape, placed.spec, r)
        return torch.full((sl[1].stop - sl[1].start,), sl[2].start,
                          dtype=torch.int32, device=self.devices[r])
