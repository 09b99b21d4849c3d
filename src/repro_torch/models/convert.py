"""Parameters carried across from the JAX package.

``from_jax_params`` takes the JAX package's own ``split(model.init(...))``
value tree as numpy arrays (or anything ``np.asarray`` takes) and returns
the port's parameter dict: same tree, layer stacks kept stacked, the table
with its padded vocabulary. The ``lm`` tree (dense blocks' ``mlp``, or
the MoE blocks' ``moe``: router (L, D, E), w_up and w_gate (L, E, D, F),
w_down (L, E, F, D)) and the ``ssm`` (Mamba1) tree are taken; ``a_log`` stays fp32 whatever the model dtype,
as the JAX package initialises it. Missing keys raise."""
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
    L, D = cfg.n_layers, cfg.d_model
    vp = padded_vocab(cfg.vocab_size)

    def take(path, shape, dt=dtype):
        return _take(np_tree, path, shape, device=device, dtype=dt)

    def norm(path, lead):
        out = {"scale": take(path + ("scale",), lead + (D,))}
        if cfg.norm == "layernorm":
            out["bias"] = take(path + ("bias",), lead + (D,))
        return out

    embed = {"table": take(("embed", "table"), (vp, D))}
    if not cfg.tie_embeddings:
        embed["unembed"] = take(("embed", "unembed"), (D, vp))
    if cfg.family == "ssm":
        blocks = {"ln": norm(("blocks", "ln"), (L,)),
                  "m": _mamba1(take, cfg)}
    else:
        blocks = _dense_blocks(take, norm, cfg)
    return {"embed": embed, "blocks": blocks,
            "final_norm": norm(("final_norm",), ())}


def _mamba1(take, cfg: ArchConfig) -> dict:
    L, D = cfg.n_layers, cfg.d_model
    I, N, W = cfg.ssm_expand * D, cfg.ssm_state, cfg.ssm_conv
    R = max(D // 16, 1)
    shapes = {"in_proj": (L, D, 2 * I), "conv_w": (L, I, W),
              "conv_b": (L, I), "x_proj": (L, I, R + 2 * N),
              "dt_proj": (L, R, I), "dt_bias": (L, I), "d_skip": (L, I),
              "out_proj": (L, I, D)}
    m = {k: take(("blocks", "m", k), s) for k, s in shapes.items()}
    m["a_log"] = take(("blocks", "m", "a_log"), (L, I, N), torch.float32)
    return m


def _dense_blocks(take, norm, cfg: ArchConfig) -> dict:
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd = cfg.head_dim_
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn_shapes = {"wq": (L, D, qd), "wk": (L, D, kvd), "wv": (L, D, kvd),
                   "wo": (L, qd, D)}
    if cfg.qkv_bias:
        attn_shapes.update(bq=(L, qd), bk=(L, kvd), bv=(L, kvd))
    if cfg.n_experts:
        E = cfg.n_experts
        ffn, ffn_shapes = "moe", {"router": (L, D, E), "w_up": (L, E, D, F),
                                  "w_down": (L, E, F, D)}
        if cfg.ffn_glu:
            ffn_shapes["w_gate"] = (L, E, D, F)
    else:
        ffn, ffn_shapes = "mlp", {"w_up": (L, D, F), "w_down": (L, F, D)}
        if cfg.ffn_glu:
            ffn_shapes["w_gate"] = (L, D, F)
    norms = ["ln1", "ln2"] + (["post_ln1", "post_ln2"]
                              if cfg.post_attn_norm else [])
    blocks = {n: norm(("blocks", n), (L,)) for n in norms}
    blocks["attn"] = {k: take(("blocks", "attn", k), s)
                      for k, s in attn_shapes.items()}
    blocks[ffn] = {k: take(("blocks", ffn, k), s)
                   for k, s in ffn_shapes.items()}
    return blocks
