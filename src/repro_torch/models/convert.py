"""Parameters carried across from the JAX package.

``from_jax_params`` takes the JAX package's own ``split(model.init(...))``
value tree as numpy arrays (or anything ``np.asarray`` takes) and returns
the port's parameter dict: same tree, layer stacks kept stacked, the table
with its padded vocabulary. Missing keys raise."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.models.layers.embedding import padded_vocab


def _take(tree, path, shape, *, device, dtype):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"JAX parameter tree lacks {'/'.join(path)}")
        node = node[key]
    arr = np.asarray(node)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{'/'.join(path)} has shape {arr.shape}, "
                         f"expected {tuple(shape)}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=dtype)


def from_jax_params(np_tree: dict, cfg: ArchConfig, *, device,
                    dtype=torch.float32) -> dict:
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd = cfg.head_dim_
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    vp = padded_vocab(cfg.vocab_size)

    def take(path, shape):
        return _take(np_tree, path, shape, device=device, dtype=dtype)

    embed = {"table": take(("embed", "table"), (vp, D))}
    if not cfg.tie_embeddings:
        embed["unembed"] = take(("embed", "unembed"), (D, vp))
    attn_shapes = {"wq": (L, D, qd), "wk": (L, D, kvd), "wv": (L, D, kvd),
                   "wo": (L, qd, D)}
    if cfg.qkv_bias:
        attn_shapes.update(bq=(L, qd), bk=(L, kvd), bv=(L, kvd))
    mlp_shapes = {"w_up": (L, D, F), "w_down": (L, F, D)}
    if cfg.ffn_glu:
        mlp_shapes["w_gate"] = (L, D, F)
    norms = ["ln1", "ln2"] + (["post_ln1", "post_ln2"]
                              if cfg.post_attn_norm else [])

    def norm(path, lead):
        out = {"scale": take(path + ("scale",), lead + (D,))}
        if cfg.norm == "layernorm":
            out["bias"] = take(path + ("bias",), lead + (D,))
        return out

    blocks = {n: norm(("blocks", n), (L,)) for n in norms}
    blocks["attn"] = {k: take(("blocks", "attn", k), s)
                      for k, s in attn_shapes.items()}
    blocks["mlp"] = {k: take(("blocks", "mlp", k), s)
                     for k, s in mlp_shapes.items()}
    return {"embed": embed, "blocks": blocks,
            "final_norm": norm(("final_norm",), ())}
