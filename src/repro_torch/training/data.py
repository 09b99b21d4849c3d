"""Deterministic, resumable training data and the serving traces.

Training batches are a stateless function of (seed, step): a restart
after a failure at step N sees exactly the batches an uninterrupted run
would have seen, and skipping ahead is O(1). Each batch is drawn from its
own explicit generator, numpy's ``default_rng`` seeded with ``(seed,
step)``. The JAX package draws from ``jax.random``, whose bits the port
cannot reproduce: the two packages give different tokens for the same
(seed, step), so a comparison between them feeds one batch to both.

The serving traces (ShareGPT4-like multi-round conversations, L-Eval-like
long-context tasks) are copies of the JAX package's numpy code and give
its rounds exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def batch_at(cfg: DataConfig, step: int, *, targets: bool = True,
             device="cpu") -> dict:
    """The (seed, step)-deterministic batch: ``tokens`` (B, S) int64 and,
    with ``targets``, the next tokens (B, S)."""
    rng = np.random.default_rng([cfg.seed, step])
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (cfg.global_batch, cfg.seq_len + 1),
        dtype=np.int64)).to(device)
    out = {"tokens": toks[:, :-1]}
    if targets:
        out["targets"] = toks[:, 1:]
    return out


# Each family's training shape at full width on one 80 GB card: arch ->
# (layers, None for all; batch; tokens). falcon-mamba-7b's depth and
# sequence are cut for the plain backward of kernel #6 (~35 launches per
# token and layer), zamba2-2.7b runs 2 of its 9 super-blocks and
# internvl2-26b 1 of 48 layers (its untied 92553 x 6144 embeddings are
# most of it). An enc-dec batch carries CARD_TRAIN_FRAMES frames, a VLM's
# CARD_TRAIN_PATCHES patch positions (``side_inputs``).
CARD_TRAIN_SHAPES = {"llama2-7b": (4, 4, 2048),
                     "granite-moe-1b-a400m": (None, 4, 2048),
                     "falcon-mamba-7b": (4, 2, 512),
                     "zamba2-2.7b": (12, 2, 2048),
                     "whisper-medium": (None, 4, 448),
                     "internvl2-26b": (1, 2, 2048)}
CARD_TRAIN_FRAMES = 1500         # whisper-medium's encoder frames
CARD_TRAIN_PATCHES = 256         # internvl2-26b's patch positions


def side_inputs(arch_cfg, batch: int, *, frames: int, patches: int = 0,
                seed: Optional[int] = None, device="cpu") -> dict:
    """The inputs beside the tokens that ``arch_cfg``'s training forward
    takes: an enc-dec's ``frames`` (batch, frames, d_model) and, with
    ``patches`` above 0, a VLM's ``patches`` (batch, patches, d_model),
    fp32: normals x 0.1 and x 0.02 from numpy's ``default_rng(seed)``, or
    zeros when ``seed`` is None (the JAX package's launcher gives an
    enc-dec zero frames and a VLM no patches)."""
    rng = None if seed is None else np.random.default_rng(seed)

    def draw(n: int, scale: float) -> torch.Tensor:
        shape = (batch, n, arch_cfg.d_model)
        x = (np.zeros(shape, np.float32) if rng is None else
             (rng.standard_normal(shape) * scale).astype(np.float32))
        return torch.from_numpy(x).to(device)

    out = {}
    if arch_cfg.is_encoder_decoder:
        out["frames"] = draw(frames, 0.1)
    if arch_cfg.family == "vlm" and patches:
        out["patches"] = draw(patches, 0.02)
    return out


def stream(cfg: DataConfig, start_step: int = 0, *,
           device="cpu") -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, device=device)
        step += 1


# ---------------------------------------------------------- serving traces
@dataclasses.dataclass
class Round:
    session_id: str
    input_len: int
    output_len: int
    arrival: float           # seconds


def sharegpt_trace(n_sessions: int, rounds_per_session: int = 5, *,
                   rate: float = 1.0, round_interval: float = 30.0,
                   seed: int = 0) -> List[Round]:
    """ShareGPT4-like trace (paper Fig 3): Poisson session arrivals,
    per-round lognormal input ~66.8 / output ~358.8 tokens."""
    rng = np.random.default_rng(seed)
    rounds: List[Round] = []
    t = 0.0
    for s in range(n_sessions):
        t += rng.exponential(1.0 / rate)
        rt = t
        for r in range(rounds_per_session):
            inp = max(int(rng.lognormal(np.log(50.0), 0.8)), 4)
            out = max(int(rng.lognormal(np.log(250.0), 0.9)), 8)
            rounds.append(Round(f"s{s}", inp, out, rt))
            rt += round_interval
    rounds.sort(key=lambda r: r.arrival)
    return rounds


def leval_trace(n_requests: int, *, seed: int = 0,
                zipf_alpha: Optional[float] = None,
                n_contexts: int = 20) -> List[Round]:
    """L-Eval-like trace (paper Table 1): bimodal — long shared contexts
    (mean ≈16k tokens), short instructions/outputs (<100). With
    ``zipf_alpha`` the context popularity is Zipfian (paper Fig 15)."""
    rng = np.random.default_rng(seed)
    ctx_lens = np.clip(rng.lognormal(np.log(9000.0), 0.7, n_contexts),
                       4000, 16384).astype(int)
    del ctx_lens             # drawn to keep the reference's random stream
    rounds = []
    t = 0.0
    for i in range(n_requests):
        if zipf_alpha is None:
            ctx = int(rng.integers(n_contexts))
        else:
            ranks = np.arange(1, n_contexts + 1, dtype=np.float64)
            p = ranks ** -zipf_alpha
            ctx = int(rng.choice(n_contexts, p=p / p.sum()))
        t += rng.exponential(2.0)
        rounds.append(Round(f"ctx{ctx}", int(rng.integers(16, 100)),
                            int(rng.integers(4, 64)), t))
    return rounds
