"""Serving programs over a (data x model) mesh, driven by one process.

The port's counterpart of the JAX package's mesh serving programs
(``launch/dryrun.py::build_cell``: ``serve_prefill``, ``restore_op`` and
``serve_decode``, each ``Model`` call jitted under the rules' shardings):
GSPMD partitions the reference's programs; here the model's own forward
functions run over shard lists (``transformer.lm_forward_shards``,
``lm_decode_step_shards``, ``ssm.ssm_forward_shards``,
``ssm_decode_step_shards``, ``hybrid.hybrid_forward_shards``,
``hybrid_decode_step_shards``, ``encdec.encode_shards``,
``decode_prefill_shards``, ``decode_step_shards``, of which the plain
calls are the one-shard case), and ``MeshServer`` places their inputs
and outputs for an explicit ``Mesh`` (axes ("data", "model"), or ("pod",
"data", "model") with the batch over ("pod", "data") as one data axis in
pod-major order; ``launch/mesh.py``) under ``ShardingRules``
(``distributed/sharding.py``), one part per device.

  weights   placed by the rules (``place_params``): query heads
            (``qkv_out``), ``o_in``, ``d_ff`` and ``vocab`` over model;
            each device also holds the whole K/V projection of every
            attention stack (wk, wv, their biases: the lm blocks, zamba2's
            attention blocks, whisper's encoder, decoder self- and
            cross-attention), which kernel #1 reads: every model shard
            projects K/V of all heads, an M-fold repeat of that product
            (ROADMAP.md)
  batch     by ``Model.prefill_batch_sharding``: rows over ``data``
            (over ("pod", "data") on a pod mesh); whisper's frames whole
            along ``seq`` on every model shard of a data shard
  prefill   per data shard, the family's forward over its model shards;
            the emitted K/V and the captured hidden states keep each
            shard's context slice: they come out in the cache's layout
  restore   hidden (L, B, S, D) placed as ("layers", "batch", "kv_seq",
            "d_model"): each shard projects its (L, B/D, S/C, D) block
            at its absolute positions in one kernel-#1 launch
            (``transformer.lm_restore_kv``), so the restored K/V lands in
            the cache's context layout with no gather (whisper's self
            cache is whole along the context: its slices are gathered
            over model, an all-gather)
  decode    the cache (L, B, Smax, Kv, hd) placed as ("layers", "batch",
            "kv_seq", "kv_heads", "head_dim"): context shard c holds
            positions [c·Smax/C, (c+1)·Smax/C) of every KV head; per data
            shard, the step over its model shards and its rows' context
            shards (``transformer.block_decode_shards``: kernel #3 per
            slice with ``kv_start`` and the log-sum-exp, merged in fp32
            in shard order)
  ssm       (falcon-mamba) ``ssm_inner`` over model: each shard holds its
            channels' conv (B, W-1, I/M) and ssm (B, I/M, N) states and
            scans them through kernel #6 (``layers/mamba.py::
            apply_mamba1_shards``)
  hybrid    (zamba2) attention blocks as the lm stack (attn_k/attn_v
            (n_super, B, Smax, Kv, hd) over ``kv_seq``); the Mamba2
            blocks over ``ssm_heads`` (``layers/mamba.py::
            apply_mamba2_shards``): the ssm state (n_super, k-1, B, H, P,
            N) by heads, the conv state (n_super, k-1, B, W-1, I + 2GN)
            split evenly over model as the reference splits it, which is
            not on head boundaries. Beyond the reference's even split,
            each shard holds its heads' in_proj columns plus a copy of
            the B/C columns (2GN = 128 at zamba2) and their conv channels
            and weights (at M = 16: 448 conv channels against the even
            328), and a decode step regathers each conv state around its
            block (``mamba2_conv_from_layout``/``to_layout``)
  encdec    (whisper) the encoder and the decoder on the query-head
            shards (kernel #5 non-causal in the encoder and the prompt's
            cross-attention); self_k/self_v (L, B, DEC_BUF, H, hd) whole
            along the context on every shard; cross_k/cross_v (L, B,
            S_enc, H, hd) over ``kv_seq``: each shard projects the whole
            cross K/V (kernel #1) and keeps its slice; a decode step
            attends the whole self cache on its query heads and each
            cross slice with ``enc_len`` through kernel #3, merged as the
            lm cache's

With ``long_context`` (``default_rules(mesh, long_context=True)``) the
context goes over (pod, data, model), C = D·M shards, and the batch is
replicated: each data shard prefills the same rows and keeps its slices;
a decode step runs once, on data shard 0's model shards over all C
context shards, and the other data shards hold copies of its results
(and of a hybrid stack's new Mamba2 states).

On a 1x1 mesh each program is the plain ``Model`` call, bit for bit. A
count of a program (``launch/exec_cost.py``) attributes each data
shard's work to its shards (``exec_cost.shards``), and the callers that
know the decode lengths on the host (``launch/dryrun.py::build_cell``)
pass them, so a counted run reads no value back from the device.
Refused, with a message that names ROADMAP.md: ``fsdp_rules``,
``seq_shard``, rules that put the other axes elsewhere, an enc-dec model
under ``long_context``, and widths that do not split over the model
axis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.distributed.collectives import gather_from_shards
from repro_torch.distributed.sharding import (Placed, ShardingRules,
                                              _tree_map, block_slices,
                                              data_axes_of, default_rules,
                                              entry_axes, mesh_coords,
                                              place_tree, replica_of)
from repro_torch.distributed.tp import on_device
from repro_torch.launch import exec_cost
from repro_torch.launch.mesh import Mesh, check_axes
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers.embedding import padded_vocab
from repro_torch.models.layers.mamba import (mamba1_channel_order,
                                             mamba2_shard_params)

UNPORTED = "is not ported (ROADMAP.md, queue 1)"
HIDDEN_AXES = ("layers", "batch", "kv_seq", "d_model")
MODEL_AXES = ("qkv_out", "o_in", "d_ff", "vocab", "heads")
FAMILY_AXES = {"ssm": ("ssm_inner",), "hybrid": ("ssm_inner", "ssm_heads")}
# the attention stacks whose whole K/V projection every device holds
KV_STACKS = {"lm": (("blocks", "attn"),), "hybrid": (("attn", "attn"),),
             "encdec": (("enc_blocks", "attn"), ("dec_blocks", "self_attn"),
                        ("dec_blocks", "cross_attn"))}
# the prefill outputs beside the logits, and the cache leaves they fill
OUTPUTS = {"lm": {"kv": ("k", "v")}, "ssm": {"states": ("conv", "ssm")},
           "hybrid": {"kv": ("attn_k", "attn_v"),
                      "mamba_states": ("conv", "ssm")},
           "encdec": {"kv": ("self_k", "self_v"),
                      "cross_kv": ("cross_k", "cross_v")}}
# the cache leaf split along the context, whose slices a decode step reads
CONTEXT_LEAF = {"lm": "k", "hybrid": "attn_k", "encdec": "cross_k"}
# cache leaves with a context axis that ``place_cache``'s ctx_len widens
WIDENED = ("k", "v", "attn_k", "attn_v", "self_k", "self_v")


def _widths(model) -> dict:
    """{what: size} of every width the model axis must divide."""
    c, h = model.cfg, model.h
    if model.kind == "lm":
        return {"query heads": h.attn.q_heads}
    if model.kind == "ssm":
        return {"d_inner": h.mamba.d_inner}
    if model.kind == "hybrid":
        m = h.mamba
        return {"query heads": c.n_heads, "ssm_heads": m.n_heads,
                "conv channels": m.conv_channels}
    return {"query heads": c.n_heads}


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
    if model.kind == "encdec" and layout[0] == ():
        raise ValueError(f"{model.cfg.name}: an enc-dec model under "
                         f"long_context {UNPORTED}")
    for ax in MODEL_AXES + FAMILY_AXES.get(model.kind, ()):
        if M > 1 and entry_axes(r.get(ax)) != ("model",):
            raise ValueError(f"{ax} over {entry_axes(r.get(ax))} {UNPORTED}"
                             f": the mesh programs put it on 'model'")
    for what, n in _widths(model).items():
        if n % M:
            raise ValueError(
                f"{model.cfg.name}: {n} {what} do not split over a model "
                f"axis of {M}" + ("; build the Model with model_axis="
                                  f"{M} to pad them" if model.kind == "lm"
                                  else ""))


@dataclasses.dataclass
class MeshParams:
    """Weights placed over a mesh: ``placed`` the rules' layout (a tree of
    ``Placed``), ``local`` each device's tree in ``mesh_coords`` order
    (with the whole K/V projection of every attention stack, and a
    hybrid stack's Mamba2 blocks by ``mamba2_shard_params``)."""

    placed: dict
    local: List[dict]


def _first_copies(placed: Placed):
    """(block slices, part) of the first copy of each block."""
    return [(placed.block(coord), part) for coord, part in
            zip(mesh_coords(placed.mesh), placed.parts)
            if replica_of(placed.spec, placed.mesh, coord)]


def _kept(x: torch.Tensor, sl: slice, dim: int) -> torch.Tensor:
    """Positions ``sl`` of x along ``dim``: x itself when that is all of
    it, else a copy, so that x can be freed."""
    if sl == slice(None) or (sl.start == 0 and sl.stop == x.shape[dim]):
        return x
    return x.narrow(dim, sl.start, sl.stop - sl.start).clone()


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
        kind = self.model.kind
        tree = params
        if kind == "ssm" and self.M > 1:
            blocks = dict(params["blocks"])
            blocks["m"] = dict(blocks["m"])
            blocks["m"]["in_proj"] = mamba1_channel_order(
                blocks["m"]["in_proj"], self.M)
            tree = dict(params, blocks=blocks)
        specs = self.rules.tree_specs(self.model.param_axes())
        placed = place_tree(tree, specs, self.mesh, share=True)
        local = [_tree_map(lambda p, r=r: p.parts[r], placed)
                 for r in range(len(self.coords))]
        held = {}
        for r, dev in enumerate(self.devices):
            for outer, inner in KV_STACKS.get(kind, ()):
                key = (str(dev), outer, inner)
                if key not in held:
                    held[key] = {n: t.to(dev) for n, t in
                                 params[outer][inner].items()
                                 if n in ("wk", "wv", "bk", "bv")}
                stack = dict(local[r][outer])
                stack[inner] = dict(stack[inner], **held[key])
                local[r][outer] = stack
            if kind == "hybrid" and self.M > 1:
                m = self.coords[r][-1]
                key = (str(dev), "mamba", m)
                if key not in held:
                    held[key] = _tree_map(
                        lambda t: t.to(dev), mamba2_shard_params(
                            params["mamba"]["m"], self.model.h.mamba,
                            self.M, m))
                local[r]["mamba"] = dict(local[r]["mamba"], m=held[key])
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
        cache's capacity: its restored K/V then has the cache's layout).
        L: a hybrid stack's attention blocks, an enc-dec stack's decoder
        layers."""
        L, B, S, D = hidden.shape
        return self._place(hidden, self.hidden_spec,
                           (L, B, ctx_len or S, D))

    def place_cache(self, cache: dict, ctx_len: Optional[int] = None
                    ) -> dict:
        """A decode cache by ``Model.cache_sharding``, in the reference's
        layout: K/V (an lm cache's k/v, a hybrid one's attn_k/attn_v, an
        enc-dec one's self_k/self_v), whole or ``Placed`` (prefill's or a
        restore's), with ``ctx_len`` positions (default their own; zero
        past them); a hybrid cache's conv/ssm and an ssm cache's states;
        an enc-dec cache's cross_k/cross_v and scalar enc_len; lengths
        (B,). Placed leaves already in the cache's layout are taken as
        they are."""
        out = {}
        for name, x in cache.items():
            spec = self.cache_specs[name]
            if name in ("lengths", "enc_len") and not isinstance(x, Placed):
                x = torch.as_tensor(x, dtype=torch.int32)
            shape = tuple(x.shape)
            if name in WIDENED:
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

    def _hidden_rows(self) -> int:
        """The rows of the stored hidden states the restore reads."""
        return (self.model.h.n_super if self.model.kind == "hybrid"
                else self.model.cfg.n_layers)

    def _cache_shapes(self, B: int, S: int, S_enc: int = 0) -> dict:
        """The prefill outputs' shapes by cache leaf: K/V of S positions
        (an enc-dec one's cross K/V of S_enc), the recurrent states."""
        c, h = self.model.cfg, self.model.h
        kv = (self._hidden_rows(), B, S, c.n_kv_heads, c.head_dim_)
        out = {n: kv for n in ("k", "v", "attn_k", "attn_v", "self_k",
                               "self_v")}
        out["cross_k"] = out["cross_v"] = (c.n_layers, B, S_enc,
                                           c.n_kv_heads, c.head_dim_)
        if self.model.kind == "ssm":
            m = h.mamba
            out["conv"] = (c.n_layers, B, m.d_conv - 1, m.d_inner)
            out["ssm"] = (c.n_layers, B, m.d_inner, m.d_state)
        if self.model.kind == "hybrid":
            m, lead = h.mamba, (h.n_super, h.k - 1, B)
            out["conv"] = lead + (m.d_conv - 1, m.conv_channels)
            out["ssm"] = lead + (m.n_heads, m.head_dim, m.d_state)
        return out

    # ----------------------------------------------------------- prefill
    def prefill(self, mp: MeshParams, batch: dict, *,
                capture_hidden: bool = False) -> dict:
        """The reference's ``serve_prefill``: ``batch["tokens"]`` (B, S)
        (a VLM's ``patches`` (B, n_vis, D), an enc-dec model's ``frames``
        (B, S_enc, D) and its decoder prompt), whole on any device,
        placed by ``Model.prefill_batch_sharding``. Each data shard runs
        the family's forward over its model shards, keeping each shard's
        context slice of the K/V and hidden states. Returns dict(logits:
        ``Placed`` (B, 1, V) of the last position, vocab over model;
        hidden: ``Placed`` (L, B, S, D) as ("layers", "batch", "kv_seq",
        "d_model") with ``capture_hidden`` (a hybrid stack's attention
        blocks' inputs, an enc-dec stack's decoder layers'), else None;
        and in the cache's layout, as the reference's ``serve_prefill``
        returns them: lm kv, a (k, v) pair of ``Placed`` (L, B, S, Kv,
        hd); ssm states, a (conv, ssm) pair; hybrid kv (n_super, B, S,
        Kv, hd) and mamba_states, a (conv, ssm) pair; enc-dec kv, the
        self K/V (L, B, S, Kv, hd) whole along the context, and cross_kv,
        the cross K/V (L, B, S_enc, Kv, hd) over ``kv_seq``)."""
        kind = self.model.kind
        tokens = batch["tokens"]
        B, S = tokens.shape
        S_enc = batch["frames"].shape[1] if kind == "encdec" else 0
        if not self.long_context and B % self.D:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"data={self.D}")
        for n, needed in ((S, kind in ("lm", "hybrid") or capture_hidden),
                          (S_enc, kind == "encdec")):
            if needed and n % self.C:
                raise ValueError(f"{n} positions do not split over "
                                 f"{self.C} context shards")
        hshape = (self._hidden_rows(), B, S, self.model.cfg.d_model)
        shapes = self._cache_shapes(B, S, S_enc)
        names = OUTPUTS[kind]
        logits, hparts = {}, {}
        got = {leaf: {} for pair in names.values() for leaf in pair}
        for d in range(self.D):
            ranks = self._ranks(d)
            ps = [mp.local[r] for r in ranks]
            toks = [self._batch_part("tokens", tokens, r) for r in ranks]
            keep = (None if self.C == 1 else
                    [self._block(hshape, self.hidden_spec, r)[2]
                     for r in ranks])
            with exec_cost.shards(ranks[0]):
                out = self._prefill_shards(ps, toks, batch, ranks,
                                           capture_hidden, keep)
            for i, r in enumerate(ranks):
                logits[r] = out["logits"][i]
                if capture_hidden:
                    hparts[r] = out["hidden"][i]
                for key, pair in names.items():
                    for leaf, t in zip(pair, out[key][i]):
                        got[leaf][r] = t
        order = range(len(self.coords))
        res = {"logits": self._placed([logits[r] for r in order],
                                      ("batch", None, "vocab"),
                                      (B, 1, self._vocab())),
               "hidden": (Placed([hparts[r] for r in order],
                                 self.hidden_spec, hshape, self.mesh)
                          if capture_hidden else None)}
        for key, pair in names.items():
            res[key] = tuple(Placed([got[n][r] for r in order],
                                    self.cache_specs[n], shapes[n],
                                    self.mesh) for n in pair)
        return res

    def _prefill_shards(self, ps, toks, batch, ranks, capture_hidden,
                        keep) -> dict:
        """One data shard's prefill over its model shards ``ranks``:
        dict(logits, hidden per shard, and per shard the family's
        outputs in the cache's layout)."""
        h = self.model.h
        kind = self.model.kind
        if kind == "lm":
            pts = ([self._batch_part("patches", batch["patches"], r)
                    for r in ranks] if "patches" in batch else None)
            return tfm.lm_forward_shards(
                ps, toks, h, patches=pts, capture_hidden=capture_hidden,
                emit_kv=True, final_logits_only=True, keep=keep)
        if kind == "ssm":
            return ssm_lib.ssm_forward_shards(
                ps, toks, h, capture_hidden=capture_hidden, emit_state=True,
                final_logits_only=True, keep=keep)
        if kind == "hybrid":
            out = hybrid_lib.hybrid_forward_shards(
                ps, toks, h, capture_hidden=capture_hidden, emit_state=True,
                final_logits_only=True, keep=keep)
            out["hidden"] = out["attn_hidden"]
            return out
        frames = [self._batch_part("frames", batch["frames"], r)
                  for r in ranks]
        enc, _ = encdec_lib.encode_shards(ps, frames, h)
        cross = []
        for m, (p, e) in enumerate(zip(ps, enc)):
            with on_device(e.device, m):
                cross.append(encdec_lib.cross_kv(p, e, h))
        del enc
        out = encdec_lib.decode_prefill_shards(
            ps, toks, h, cross=cross, capture_hidden=capture_hidden,
            emit_kv=True, final_logits_only=True, keep=keep)
        # each shard keeps its context slice of the cross K/V
        spec = self.cache_specs["cross_k"]
        out["cross_kv"] = []
        for (ck, cv), r in zip(cross, ranks):
            shape = (ck.shape[0], batch["frames"].shape[0]) + ck.shape[2:]
            sl = self._block(shape, spec, r)[2]
            out["cross_kv"].append((_kept(ck, sl, 2), _kept(cv, sl, 2)))
        return out

    # ----------------------------------------------------------- restore
    def restore_kv_from_hidden(self, mp: MeshParams, hidden: Placed):
        """The reference's ``restore_op``, the paper's op: K/V of every
        attention layer (a hybrid stack's attention blocks, an enc-dec
        stack's decoder self-attention) from ``hidden`` placed by
        ``place_hidden``, each shard's (L, B/D, S/C, D) block at its
        absolute positions in one kernel-#1 launch. Returns (k, v),
        ``Placed`` (L, B, S, Kv, hd) in the cache's layout: along the
        context as the hidden states (an enc-dec self cache: each data
        shard's slices gathered over its model shards, whole on each)."""
        kind = self.model.kind
        if kind == "ssm":
            raise ValueError(f"{self.model.cfg.name}: attention-free arch; "
                             "its state is restored whole, not from hidden "
                             "states")
        if tuple(hidden.spec) != tuple(self.hidden_spec):
            raise ValueError(f"hidden placed as {hidden.spec}, not "
                             f"{self.hidden_spec}")
        c, h = self.model.cfg, self.model.h
        L, B, S, _ = hidden.shape
        restore = {"lm": tfm.lm_restore_kv,
                   "hybrid": hybrid_lib.hybrid_restore_attn_kv,
                   "encdec": encdec_lib.restore_self_kv}[kind]
        ks, vs = [], []
        for r, part in enumerate(hidden.parts):
            sl = hidden.block(self.coords[r])
            b, s = sl[1].stop - sl[1].start, sl[2].stop - sl[2].start
            dev = part.device
            with on_device(dev, r):
                pos = torch.arange(sl[2].start, sl[2].stop,
                                   device=dev)[None, :].expand(b, s)
                k, v = restore(mp.local[r], part, h, positions=pos,
                               end=sl[2].stop)
            ks.append(k)
            vs.append(v)
        names = OUTPUTS[kind]["kv"]
        if kind == "encdec" and self.M > 1:
            for d in range(self.D):
                rk = self._ranks(d)
                with exec_cost.shards(rk[0]):
                    gk = gather_from_shards([ks[r] for r in rk], 2)
                    gv = gather_from_shards([vs[r] for r in rk], 2)
                for r, x, y in zip(rk, gk, gv):
                    ks[r], vs[r] = x, y
        shape = (L, B, S, c.n_kv_heads, c.head_dim_)
        return (Placed(ks, self.cache_specs[names[0]], shape, self.mesh),
                Placed(vs, self.cache_specs[names[1]], shape, self.mesh))

    # ------------------------------------------------------------ decode
    def _streams(self):
        """(model shard ranks, context shard ranks) of each data shard
        that runs a decode step. Under long_context the batch is
        replicated and every row's context spans all D·M shards: data
        shard 0 runs the step over all of them, and the other data shards
        hold copies of its results. An ssm cache holds no context: every
        data shard runs its own copy of the states."""
        if self.long_context and self.model.kind != "ssm":
            return [(self._ranks(0), list(range(len(self.coords))))]
        return [(self._ranks(d), self._ranks(d)) for d in range(self.D)]

    def decode_step(self, mp: MeshParams, cache: dict,
                    tokens: torch.Tensor, host_lengths=None,
                    host_enc_len: Optional[int] = None):
        """The reference's ``serve_decode`` (``decode_step_full``): one
        token per row, ``tokens`` (B, 1) whole on any device, ``cache`` as
        ``place_cache`` gives it (written in place), each data shard's
        step the family's over its model shards and its rows' context
        shards (``transformer.lm_decode_step_shards``,
        ``ssm.ssm_decode_step_shards`` over its ``ssm_inner`` shards,
        ``hybrid.hybrid_decode_step_shards``,
        ``encdec.decode_step_shards``). ``host_lengths`` (B,) and an
        enc-dec cache's ``host_enc_len``: the cache's lengths on the host,
        where the caller knows them (then the step reads none back from
        the device). Returns (logits ``Placed`` (B, 1, V), the new cache,
        hidden ``Placed`` (L, B, 1, D) as ("layers", "batch", None,
        "d_model"); L a hybrid stack's attention blocks)."""
        kind = self.model.kind
        h = self.model.h
        B = tokens.shape[0]
        logits, hidden = {}, {}
        for ranks, ctx in self._streams():
            ps = [mp.local[r] for r in ranks]
            toks = [self._batch_part("tokens", tokens, r) for r in ranks]
            host = None
            if host_lengths is not None:
                rows = self._block((B,), self.cache_specs["lengths"],
                                   ranks[0])[0]
                host = [int(n) for n in list(host_lengths)[rows]]
            ctx_kv = CONTEXT_LEAF.get(kind)
            split = ({} if ctx_kv is None else dict(
                starts=(None if len(ctx) == 1 else
                        [self._start(cache[ctx_kv], r) for r in ctx]),
                host_starts=[self._block(cache[ctx_kv].shape,
                                         cache[ctx_kv].spec, r)[2].start
                             for r in ctx]))
            with exec_cost.shards(ranks[0]):
                if kind == "lm":
                    lg, hid = tfm.lm_decode_step_shards(
                        ps, toks, h, k=[cache["k"].parts[r] for r in ctx],
                        v=[cache["v"].parts[r] for r in ctx],
                        lengths=[cache["lengths"].parts[r] for r in ctx],
                        host_lengths=host, **split)
                elif kind == "ssm":
                    lg, hid = ssm_lib.ssm_decode_step_shards(
                        ps, toks, h,
                        conv=[cache["conv"].parts[r] for r in ranks],
                        ssm=[cache["ssm"].parts[r] for r in ranks])
                elif kind == "hybrid":
                    lg, hid = hybrid_lib.hybrid_decode_step_shards(
                        ps, toks, h,
                        k=[cache["attn_k"].parts[r] for r in ctx],
                        v=[cache["attn_v"].parts[r] for r in ctx],
                        conv=[cache["conv"].parts[r] for r in ranks],
                        ssm=[cache["ssm"].parts[r] for r in ranks],
                        lengths=[cache["lengths"].parts[r] for r in ctx],
                        host_lengths=host, **split)
                    hid = [ah for _, ah in hid]
                else:
                    lg, hid = encdec_lib.decode_step_shards(
                        ps, toks, h,
                        self_k=[cache["self_k"].parts[r] for r in ranks],
                        self_v=[cache["self_v"].parts[r] for r in ranks],
                        cross_k=[cache["cross_k"].parts[r] for r in ctx],
                        cross_v=[cache["cross_v"].parts[r] for r in ctx],
                        enc_len=[cache["enc_len"].parts[r] for r in ctx],
                        lengths=[cache["lengths"].parts[r] for r in ranks],
                        host_lengths=host, host_enc_len=host_enc_len,
                        **split)
            for r, x, y in zip(ranks, lg, hid):
                logits[r], hidden[r] = x, y
        c = self.model.cfg
        order = range(len(self.coords))
        # the copies of data shard 0's results (long_context), and of a
        # hybrid stack's new Mamba2 states
        states = ("conv", "ssm") if kind == "hybrid" else ()
        for r in order:
            if r not in logits:
                dev = self.devices[r]
                src = r % self.M
                exec_cost.report_collective(
                    "collective-permute",
                    [(logits[src], hidden[src],
                      *(cache[n].parts[src] for n in states))], [r])
                with exec_cost.at(r):
                    logits[r] = logits[src].to(dev)
                    hidden[r] = hidden[src].to(dev)
                    for n in states:
                        cache[n].parts[r].copy_(cache[n].parts[src])
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
                             (self._hidden_rows(), B, 1, c.d_model)))

    def _start(self, placed: Placed, r: int) -> torch.Tensor:
        """(b,) int32: the absolute position of the first key of device
        r's context slice of the cache, one per row of its block."""
        sl = self._block(placed.shape, placed.spec, r)
        return torch.full((sl[1].stop - sl[1].start,), sl[2].start,
                          dtype=torch.int32, device=self.devices[r])
