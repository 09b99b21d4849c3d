"""Asynchronous, atomically committed checkpoints of a tensor tree.

Layout (the JAX package's):
    <root>/step_000000042.tmp/   (written)
    <root>/step_000000042/       (atomic rename = commit)
        manifest.json            step, leaf paths, dtypes
        leaf_00000.npy …         one file per leaf, in sorted-key order

A bf16 leaf is stored as its 16-bit pattern (numpy has no bf16) and its
dtype is kept in the manifest, so it comes back bit for bit.

``save`` snapshots every leaf to host memory synchronously, the part
that must finish before training moves on, and writes the files on a
background thread; ``wait`` joins it, and every ``save`` waits for the
one before (one checkpoint in flight). ``restore(like)`` loads onto the
devices and dtypes of ``like``'s leaves.

A sharded state (``Placed`` leaves, ``training/sharded.py``) is saved
whole, each leaf gathered from its parts, so the files do not depend on
the mesh; a ``Placed`` leaf of ``like`` gets the whole leaf placed by its
own spec over its own mesh, so a checkpoint restores onto any mesh (the
JAX package's elastic reshard).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import Placed, place
from repro_torch.training.tree import tree_paths, tree_unflatten

# dtypes numpy cannot hold, stored as integers of the same width
_BITS = {torch.bfloat16: torch.int16}


def _to_host(t) -> Tuple[np.ndarray, str]:
    if isinstance(t, Placed):
        t = t.gather(torch.device("cpu"))
    t = torch.as_tensor(t).detach()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.to("cpu", copy=True).numpy(), name


def _from_host(arr: np.ndarray, name: str) -> torch.Tensor:
    dtype = getattr(torch, name)
    t = torch.from_numpy(arr)
    return t.view(dtype) if dtype in _BITS else t


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, wait: bool = False) -> None:
        self.wait()
        host = [(k, *_to_host(v)) for k, v in tree_paths(state)]
        manifest = {"step": step, "keys": [k for k, _, _ in host],
                    "dtypes": [d for _, _, d in host]}

        def _write():
            try:
                tmp, final = self._dir(step) + ".tmp", self._dir(step)
                os.makedirs(tmp, exist_ok=True)
                for i, (_, arr, _) in enumerate(host):
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)                     # atomic commit
                self._retain()
            except Exception as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if wait:
            self.wait()

    def wait(self) -> None:
        """Join the write in flight; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, *, step: Optional[int] = None) -> Tuple[int, Any]:
        """(step, state): the checkpoint at ``step`` (default the latest)
        in the structure of ``like``, each leaf on the device and in the
        dtype of ``like``'s."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like_paths = tree_paths(like)
        if [k for k, _ in like_paths] != manifest["keys"]:
            raise ValueError(f"checkpoint {d} holds another tree")
        leaves = []
        for i, ((_, ref), name) in enumerate(zip(like_paths,
                                                 manifest["dtypes"])):
            t = _from_host(np.load(os.path.join(d, f"leaf_{i:05d}.npy")),
                           name)
            if isinstance(ref, Placed):
                leaves.append(place(t.to(ref.parts[0].dtype), ref.spec,
                                    ref.mesh, manifest["keys"][i]))
                continue
            ref = torch.as_tensor(ref)
            leaves.append(t.to(device=ref.device, dtype=ref.dtype))
        return step, tree_unflatten(like, leaves)
