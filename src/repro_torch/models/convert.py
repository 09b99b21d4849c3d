"""Parameters carried across from the JAX package.

``from_jax_params`` takes the JAX package's own ``split(model.init(...))``
value tree as numpy arrays (or anything ``np.asarray`` takes) and returns
the port's parameter dict: same tree, layer stacks kept stacked, the table
with its padded vocabulary, and the learned position table
(``embed/positions``) of a stack without RoPE. The ``lm`` tree (dense
blocks' ``mlp``, or the MoE blocks' ``moe``: router (L, D, E), w_up and
w_gate (L, E, D, F), w_down (L, E, F, D)), the ``ssm`` (Mamba1) tree, the
``hybrid`` tree (``mamba`` stacked (n_super, k-1, ...), ``attn`` blocks
stacked (n_super, ...)) and the ``encdec`` tree (``enc_blocks`` and
``enc_norm`` of the encoder; ``dec_blocks`` with ``self_attn``, ``ln_x``
and ``cross_attn``) are taken; ``a_log`` (and Mamba2's ``dt_bias`` and
``d_skip``) stay fp32 whatever the model dtype, as the JAX package
initialises them. Missing keys raise. ``from_jax_train_state`` carries a
whole train state (params, AdamW moments, step) the same way."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.arch import ArchConfig
from repro_torch.distributed.sharding import pad_heads
from repro_torch.models.layers.embedding import MAX_POSITIONS, padded_vocab


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
                    dtype=torch.float32, model_axis: int = 1) -> dict:
    """``model_axis``: the JAX model's, whose query heads an lm tree
    carries padded to a multiple of it (``pad_heads``)."""
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
    if not cfg.use_rope and cfg.family not in ("ssm", "hybrid"):
        embed["positions"] = take(("embed", "positions"), (MAX_POSITIONS, D))
    out = {"embed": embed, "final_norm": norm(("final_norm",), ())}
    if cfg.is_encoder_decoder:
        out["enc_blocks"] = _dense_blocks(take, norm, cfg, "enc_blocks",
                                          cfg.encoder_layers)
        out["enc_norm"] = norm(("enc_norm",), ())
        out["dec_blocks"] = _dec_blocks(take, norm, cfg)
    elif cfg.family == "ssm":
        out["blocks"] = {"ln": norm(("blocks", "ln"), (L,)),
                         "m": _mamba1(take, cfg)}
    elif cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        lead = (L // k, k - 1)
        out["mamba"] = {"ln": norm(("mamba", "ln"), lead),
                        "m": _mamba2(take, cfg, lead)}
        out["attn"] = _dense_blocks(take, norm, cfg, "attn", L // k)
    else:
        out["blocks"] = _dense_blocks(take, norm, cfg, "blocks", L,
                                      pad_heads(cfg.n_heads, cfg.n_kv_heads,
                                                model_axis)[0])
    return out


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


def _mamba2(take, cfg: ArchConfig, lead: tuple) -> dict:
    D, N = cfg.d_model, cfg.ssm_state
    I = cfg.ssm_expand * D
    H = I // cfg.ssm_headdim
    C = I + 2 * N
    shapes = {"in_proj": (D, 2 * I + 2 * N + H), "conv_w": (C, cfg.ssm_conv),
              "conv_b": (C,), "gate_norm": (I,), "out_proj": (I, D)}
    m = {k: take(("mamba", "m", k), lead + s) for k, s in shapes.items()}
    for k in ("dt_bias", "a_log", "d_skip"):
        m[k] = take(("mamba", "m", k), lead + (H,), torch.float32)
    return m


def _attn_shapes(cfg: ArchConfig, L: int, q_heads: int = 0) -> dict:
    D, hd = cfg.d_model, cfg.head_dim_
    qd, kvd = (q_heads or cfg.n_heads) * hd, cfg.n_kv_heads * hd
    shapes = {"wq": (L, D, qd), "wk": (L, D, kvd), "wv": (L, D, kvd),
              "wo": (L, qd, D)}
    if cfg.qkv_bias:
        shapes.update(bq=(L, qd), bk=(L, kvd), bv=(L, kvd))
    return shapes


def _dec_blocks(take, norm, cfg: ArchConfig) -> dict:
    """The enc-dec decoder's blocks: self- and cross-attention, each with
    its input norm, and a plain FFN."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    blocks = {n: norm(("dec_blocks", n), (L,))
              for n in ("ln1", "ln_x", "ln2")}
    for a in ("self_attn", "cross_attn"):
        blocks[a] = {k: take(("dec_blocks", a, k), s)
                     for k, s in _attn_shapes(cfg, L).items()}
    blocks["mlp"] = {"w_up": take(("dec_blocks", "mlp", "w_up"), (L, D, F)),
                     "w_down": take(("dec_blocks", "mlp", "w_down"),
                                    (L, F, D))}
    return blocks


def _dense_blocks(take, norm, cfg: ArchConfig, root: str, L: int,
                  q_heads: int = 0) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    attn_shapes = _attn_shapes(cfg, L, q_heads)
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
    blocks = {n: norm((root, n), (L,)) for n in norms}
    blocks["attn"] = {k: take((root, "attn", k), s)
                      for k, s in attn_shapes.items()}
    blocks[ffn] = {k: take((root, ffn, k), s)
                   for k, s in ffn_shapes.items()}
    return blocks


def from_jax_train_state(np_state: dict, cfg: ArchConfig, *,
                         device, model_axis: int = 1) -> dict:
    """The JAX package's train state ``{"params", "opt": {"m", "v",
    "step"[, "ef"]}}`` (as numpy) as the port's: params and each moment
    tree through ``from_jax_params``'s leaf mapping in fp32, so that m
    and v sit beside their parameters, and the step an int32 scalar."""
    opt = np_state["opt"]

    def tree(t):
        return from_jax_params(t, cfg, device=device, dtype=torch.float32,
                               model_axis=model_axis)

    out = {"m": tree(opt["m"]), "v": tree(opt["v"]),
           "step": torch.tensor(int(np.asarray(opt["step"])),
                                dtype=torch.int32, device=device)}
    if "ef" in opt:
        out["ef"] = tree(opt["ef"])
    return {"params": tree(np_state["params"]), "opt": out}
