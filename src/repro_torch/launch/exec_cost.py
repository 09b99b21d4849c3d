"""Counted execution: the port's counterpart of the JAX package's
``launch/hlo_cost.py``.

The reference lowers a cell to HLO and counts its cost from the text:
dot/convolution FLOPs, HBM bytes of every top-level instruction and the
operand bytes of every collective, per device of the SPMD program. The
port has no HLO: ``ExecCounter`` watches the program run instead, as a
``TorchDispatchMode`` over every aten op, and the kernels and collectives
report to it:

  flops             matrix products only (mm, addmm, bmm, baddbmm and the
                    convolutions, through ``torch.utils.flop_counter``'s
                    formulas, 2 per multiply-add, as ``hlo_cost.dot_flops``
                    counts them), plus each kernel launch's operations
                    (``kernels/*.py``'s ``*_cost``)
  bytes             operand and result bytes of every aten op, each tensor
                    counted where it holds at least ``hbm_threshold``
                    bytes (``hlo_cost.analyze_hlo``'s rule); views and
                    reshapes are free, copies count, an operand more than
                    64x its op's result is taken to be read in a window of
                    the result's size, and a scatter into a buffer counts
                    its update twice, as the reference counts a
                    dynamic-update-slice; plus each kernel launch's bytes
  bytes_all         the same with no threshold
  collectives       operand bytes by the reference's kind names, as each
                    collective of ``distributed/collectives.py`` (and each
                    copy of a placed block between shards) reports them
  launches          kernel launches by kernel (``KERNELS``)

Everything is attributed to the shard that did the work, not to a tensor's
device: the shards of a mesh may share one card (or ``meta``). A shard is
named by ``shard``/``at`` contexts (``distributed/tp.py::on_device``
pushes one around each shard's launches); outside one, an op belongs to
the shard that allocated the largest of its operands (else that holds
the largest of the program's arguments among them). Per-device figures
are the busiest shard's; totals are kept beside them. Memory: the live
bytes of the storages each shard allocated (freed when the storage
dies), and their peak.

On ``meta`` an op seen before at the same shapes is not run again: its
output is made fresh from the first run's shapes and strides, and its
cost is the first run's (the sweep over a 256-shard mesh repeats each op
per shard and layer).

A kernel never runs while it is counted: on a CPU tensor its plain
version runs with the counter paused, on a ``meta`` tensor only its
output's shape is made (``kernels/ops.py``), so a count on ``meta`` (the
dry-run's placeholder devices) equals one executed on the CPU or the card.
The reference's HLO-text collective parser (``roofline.collective_bytes``)
has no counterpart: the collectives report themselves.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")
# the kernels by name, with their number in PERF.md's table (#2 is #1 at
# G = 1)
KERNELS = {"restore_kv_grouped": 1, "decode_attention": 3,
           "decode_attention_paged": 4, "flash_attention": 5,
           "ssm_update": 6}
HBM_THRESHOLD = 1 << 20

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
             _aten.convolution, _aten._convolution,
             _aten.convolution_backward}
# ops that move no data: allocation and host reads
_FREE = {_aten.empty, _aten.empty_strided, _aten.empty_like,
         _aten.new_empty, _aten.new_empty_strided, _aten._local_scalar_dense,
         _aten.set_, _aten.resize_}
# ops that write an update into a buffer: read and write the update,
# read the indices, never the whole buffer
_UPDATES = {_aten.index_put_, _aten.index_put, _aten._index_put_impl_,
            _aten.scatter_, _aten.scatter, _aten.scatter_add_,
            _aten.scatter_add, _aten.slice_scatter, _aten.select_scatter,
            _aten.masked_scatter_, _aten.index_copy_}

_counter: Optional["ExecCounter"] = None     # the counter in force
_stack: List[int] = []                       # explicit shard contexts
_base: List[int] = [0]                       # offsets of relative shards


def active() -> Optional["ExecCounter"]:
    """The counter in force, or None."""
    return _counter


@contextlib.contextmanager
def at(index: Optional[int]):
    """Attribute what runs inside to shard ``index`` of the mesh (its
    position in ``mesh_coords`` order); None names no shard."""
    if index is None or _counter is None:
        yield
        return
    _stack.append(int(index))
    try:
        yield
    finally:
        _stack.pop()


@contextlib.contextmanager
def shards(base: int):
    """Number the shards that ``shard`` names from ``base`` (a data
    shard's first shard: its model shards are base + m)."""
    _base.append(int(base))
    try:
        yield
    finally:
        _base.pop()


def current() -> Optional[int]:
    """The shard an explicit context names now, or None (an autograd
    function keeps it for its backward)."""
    return _stack[-1] if _stack and _counter is not None else None


def index(i: int) -> int:
    """Shard ``i`` counted from the current ``shards`` base, as a mesh
    index."""
    return _base[-1] + int(i)


def shard(i: Optional[int]):
    """``at`` shard ``i`` counted from the current ``shards`` base."""
    return at(None if i is None else index(i))


def owner(t) -> Optional[int]:
    """The shard that allocated ``t``'s storage while counted, or None."""
    if _counter is None or not isinstance(t, torch.Tensor):
        return None
    return _counter._owner.get(_key(t))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _flat(args) -> List[torch.Tensor]:
    """The tensors of an aten op's arguments (tensors, or lists of
    them)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _flat_out(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for x in out if isinstance(x, torch.Tensor)]
    return []


_PLAIN = {bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format, type(None)}


def _item(a):
    t = type(a)
    if t in _PLAIN:
        return a
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.is_meta)
    if t is list or t is tuple:
        return tuple(_item(x) for x in a)
    raise TypeError


def _spec_key(func, args, kwargs):
    """A key of the op at its operands' shapes, strides and dtypes (None
    where an argument has no such key)."""
    try:
        key = [func]
        for a in args:
            key.append(_item(a))
        for k, v in kwargs.items():
            key.append((k, _item(v)))
        return tuple(key)
    except TypeError:
        return None


def _spec_of(out):
    """What ``_rebuild`` needs to make fresh meta tensors like ``out``
    (None where their storages are not the plain strided ones)."""
    def one(t):
        s = (tuple(t.shape), t.stride(), t.dtype)
        probe = torch.empty_strided(s[0], s[1], dtype=s[2], device="meta")
        if probe.untyped_storage().nbytes() != t.untyped_storage().nbytes() \
                or t.storage_offset():
            raise ValueError
        return s
    try:
        if isinstance(out, torch.Tensor):
            return ("t", one(out))
        if isinstance(out, (list, tuple)) and all(
                isinstance(x, torch.Tensor) for x in out):
            return (type(out), [one(x) for x in out])
    except ValueError:
        return None
    return None


def _rebuild(spec):
    def one(s):
        return torch.empty_strided(s[0], s[1], dtype=s[2], device="meta")
    kind, body = spec
    return one(body) if kind == "t" else kind(one(s) for s in body)


@contextlib.contextmanager
def paused():
    """Run without counting (a kernel's plain version, a host read)."""
    c = _counter
    if c is None:
        yield
        return
    c._paused += 1
    try:
        yield
    finally:
        c._paused -= 1


def report_kernel(name: str, flops: float, nbytes: float, outputs,
                  inputs) -> None:
    """One launch of kernel ``name`` with its cost, its ``outputs`` (new
    storages among them are allocated by the launching shard) and the
    ``inputs`` that name the shard outside an explicit context."""
    c = _counter
    if c is None or c._paused:
        return
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}")
    ins = _tensors(inputs)
    r = c._shard_of(ins)
    c.launches[r][name] = c.launches[r].get(name, 0) + 1
    c.flops[r] += flops
    c.bytes[r] += nbytes
    c.bytes_all[r] += nbytes
    in_keys = {_key(t) for t in ins}
    c._allocate([t for t in _tensors(outputs) if _key(t) not in in_keys], r)


def report_collective(kind: str, parts: Iterable,
                      owners: Optional[List[Optional[int]]] = None) -> None:
    """A collective of ``kind`` over ``parts``, each a tensor (or a list
    of tensors) that shard ``owners[i]`` contributes (default: the shard
    that allocated it); its bytes are that shard's operand bytes."""
    c = _counter
    if c is None or c._paused:
        return
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    parts = list(parts)
    for i, p in enumerate(parts):
        ts = _tensors(p)
        r = owners[i] if owners is not None else None
        if r is None:
            r = next((o for o in (c._owner.get(_key(t)) for t in ts)
                      if o is not None), None)
        if r is None:
            r = c._shard_of(ts)
        nb = sum(_nbytes(t) for t in ts)
        c.collectives[r][kind] = c.collectives[r].get(kind, 0) + nb


class ExecCounter(TorchDispatchMode):
    """Counts what runs inside ``with ExecCounter(n_shards):`` (see the
    module docstring); ``own`` names the shard that holds each of the
    program's arguments. Only one counter is in force at a time."""

    def __init__(self, n_shards: int = 1,
                 hbm_threshold: int = HBM_THRESHOLD):
        super().__init__()
        self.n = int(n_shards)
        self.hbm_threshold = hbm_threshold
        self.flops = [0.0] * self.n
        self.bytes = [0.0] * self.n
        self.bytes_all = [0.0] * self.n
        self.collectives: List[Dict[str, float]] = [{} for _ in
                                                    range(self.n)]
        self.launches: List[Dict[str, int]] = [{} for _ in range(self.n)]
        self.live = [0] * self.n
        self.peak = [0] * self.n
        self.live_total = 0
        self.peak_total = 0
        self.arg_bytes = [0] * self.n
        self.arg_total = 0
        self._owner: Dict[int, int] = {}
        self._args: set = set()
        self._memo: dict = {}
        self._paused = 0

    # --------------------------------------------------------- context
    def __enter__(self):
        global _counter
        if _counter is not None:
            raise RuntimeError("one ExecCounter at a time")
        _counter = self
        _clear_upload_caches()
        return super().__enter__()

    def __exit__(self, *exc):
        global _counter
        try:
            return super().__exit__(*exc)
        finally:
            _counter = None

    # ------------------------------------------------------- ownership
    def own(self, tensors, r: int) -> None:
        """Shard ``r`` holds ``tensors`` (the program's arguments): ops
        reading them belong to it, and their bytes are its
        ``arg_bytes``. A storage another shard already owns stays that
        shard's for attribution and counts for both shards' arguments
        once each."""
        seen = set()
        for t in _tensors(tensors):
            k = _key(t)
            if k in seen:
                continue
            seen.add(k)
            nb = t.untyped_storage().nbytes()
            self.arg_bytes[r] += nb
            if k not in self._args:
                self._args.add(k)
                self.arg_total += nb
            self._owner.setdefault(k, r)

    def _shard_of(self, tensors) -> int:
        """The explicit context's shard, else the owner of the largest
        operand allocated while counted (the first of equals), else of
        the largest argument (weights that shards of one device share
        belong to the first of them), else the ``shards`` base."""
        if _stack:
            r = _stack[-1]
        else:
            best = {False: (-1, None), True: (-1, None)}
            for t in tensors:
                k = _key(t)
                o = self._owner.get(k)
                if o is None:
                    continue
                is_arg = k in self._args
                nb = _nbytes(t)
                if nb > best[is_arg][0]:
                    best[is_arg] = (nb, o)
            r = best[False][1]
            if r is None:
                r = best[True][1]
            if r is None:
                r = _base[-1]
        if not 0 <= r < self.n:
            raise ValueError(f"shard {r} outside a mesh of {self.n}")
        return r

    def _allocate(self, outs, r: int) -> None:
        for t in outs:
            s = t.untyped_storage()
            k = s._cdata
            if k in self._owner:
                continue
            nb = s.nbytes()
            self._owner[k] = r
            self.live[r] += nb
            self.live_total += nb
            self.peak[r] = max(self.peak[r], self.live[r])
            self.peak_total = max(self.peak_total, self.live_total)
            weakref.finalize(s, self._free, k, r, nb)

    def _free(self, k: int, r: int, nb: int) -> None:
        if self._owner.get(k) != r or k in self._args:
            return
        del self._owner[k]
        self.live[r] -= nb
        self.live_total -= nb

    # ----------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        ins = _flat(args) + _flat(tuple(kwargs.values()))
        key = _spec_key(func, args, kwargs)
        entry = self._memo.get(key) if key is not None else None
        if entry is not None and entry[3] is not None:
            out = _rebuild(entry[3])     # a meta op seen at these shapes
        else:
            out = func(*args, **kwargs)
        outs = _flat_out(out)
        in_keys = {_key(t) for t in ins}
        if entry is None:
            entry = self._entry(func, args, kwargs, ins, out, outs, in_keys)
            if key is not None:
                self._memo[key] = entry
        counted, flops, sizes, _ = entry
        if not counted:
            return out
        r = self._shard_of(ins)
        self.flops[r] += flops
        self.bytes_all[r] += sum(sizes)
        self.bytes[r] += sum(x for x in sizes if x >= self.hbm_threshold)
        self._allocate([t for t in outs if _key(t) not in in_keys], r)
        return out

    def _entry(self, func, args, kwargs, ins, out, outs, in_keys):
        """(counted, flops, byte terms, the output's spec to rebuild on
        meta or None) of one op at its operands' shapes."""
        packet = func._overloadpacket
        mutable = func._schema.is_mutable
        aliased = [_key(t) in in_keys for t in outs]
        if func.is_view or packet in _FREE or (
                not mutable and outs and all(aliased)):
            return False, 0.0, (), None          # views and allocations
        flops = 0.0
        if packet in _PRODUCTS:
            from torch.utils.flop_counter import flop_registry
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        sizes = tuple(self._byte_terms(packet, ins, outs))
        spec = None
        if (not mutable and not any(aliased) and outs
                and all(t.device.type == "meta" for t in ins + outs)
                and len({_key(t) for t in outs}) == len(outs)):
            spec = _spec_of(out)
        return True, flops, sizes, spec

    @staticmethod
    def _byte_terms(packet, ins, outs) -> List[int]:
        if packet in _UPDATES:
            # index_put_(self, indices, values) and the scatters: the
            # update read and written, the indices read
            upd = ins[1:]
            return ([2 * _nbytes(upd[-1])] + [_nbytes(t) for t in upd[:-1]]
                    if upd else [])
        if packet is _aten.copy_:
            return [2 * _nbytes(ins[1])]
        result = sum(_nbytes(t) for t in outs)
        return [result] + [b for b in (_nbytes(t) for t in ins)
                           if b <= 64 * max(result, 1)]

    # -------------------------------------------------------- results
    def result(self) -> dict:
        """The reference's ``analyze_hlo`` keys (per device: the busiest
        shard's) with per-shard lists and totals beside them."""
        coll_bytes = [sum(c.values()) for c in self.collectives]
        busiest = max(range(self.n), key=lambda r: coll_bytes[r])
        names = sorted({k for d in self.launches for k in d})
        total_launches = {k: sum(d.get(k, 0) for d in self.launches)
                          for k in names}
        peaks = [a + p for a, p in zip(self.arg_bytes, self.peak)]
        return {
            "flops": max(self.flops), "bytes": max(self.bytes),
            "bytes_all": max(self.bytes_all),
            "collectives": dict(self.collectives[busiest]),
            "collective_bytes": coll_bytes[busiest],
            "launches": {k: max(d.get(k, 0) for d in self.launches)
                         for k in names},
            "peak_memory": max(peaks), "temp_bytes": max(self.peak),
            "arg_bytes": max(self.arg_bytes),
            "per_shard": {"flops": list(self.flops),
                          "bytes": list(self.bytes),
                          "bytes_all": list(self.bytes_all),
                          "collectives": [dict(c) for c in self.collectives],
                          "launches": [dict(d) for d in self.launches],
                          "peak_memory": peaks,
                          "temp_bytes": list(self.peak),
                          "arg_bytes": list(self.arg_bytes)},
            "total": {"flops": sum(self.flops), "bytes": sum(self.bytes),
                      "bytes_all": sum(self.bytes_all),
                      "collective_bytes": sum(coll_bytes),
                      "launches": total_launches,
                      "peak_memory": self.arg_total + self.peak_total,
                      "arg_bytes": self.arg_total},
        }


def _clear_upload_caches() -> None:
    """Forget the small per-device uploads the model code caches (row
    indices, prefill lengths), so a count does not depend on what ran
    before it."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import attention
    transformer._row.cache_clear()
    attention._prefill_lens.cache_clear()


def count(fn, *args, n_shards: int = 1, owners=None,
          hbm_threshold: int = HBM_THRESHOLD):
    """(fn(*args), the counter's ``result()``): ``owners`` lists, per
    shard, the tensors of ``args`` it holds (``ExecCounter.own``)."""
    with ExecCounter(n_shards, hbm_threshold) as c:
        for r, ts in enumerate(owners or []):
            c.own(ts, r)
        out = fn(*args)
    return out, c.result()
