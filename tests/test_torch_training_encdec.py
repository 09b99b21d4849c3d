"""The port's training path for the encoder-decoder family
(whisper-medium) against the JAX package's, on the same inputs, under
``test_torch_training.py``'s tolerances and the step rule of
``test_torch_training_lm_families.py``.

The batch carries frame embeddings (2, 32, D) x 0.1 for the encoder
beside 32 target tokens; the encoder's blocks attend without a causal
mask, the decoder's self-attention with one, and its cross-attention
over the 32 frames (kernel #5 under autograd, Sq = 32 = Skv here; a test
below takes 48 frames, Sq != Skv). Loss, ce, every gradient leaf (every
encoder layer's q/k/v projections and every decoder layer's cross K/V
projections non-zero), three AdamW steps and the forward logits are held
against the JAX ``Trainer``."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.models.convert import from_jax_train_state
from test_torch_training import LOSS_RTOL
from test_torch_training_lm_families import (check_logits,
                                             check_loss_and_grads,
                                             check_three_steps, jbatch,
                                             make_pair, tbatch)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(rules):
    return make_pair("whisper-medium", rules)


def test_loss_and_every_gradient_match_jax(pair, monkeypatch):
    cfg = pair[0]
    grads = check_loss_and_grads(pair, monkeypatch)
    enc = grads["enc_blocks"]["attn"]
    cross = grads["dec_blocks"]["cross_attn"]
    for w in ("wq", "wk", "wv"):
        for li in range(cfg.encoder_layers):
            assert torch.count_nonzero(enc[w][li]) > 0, (w, li)
    for w in ("wk", "wv"):
        for li in range(cfg.n_layers):
            assert torch.count_nonzero(cross[w][li]) > 0, (w, li)


def test_three_train_steps_match_jax(pair, monkeypatch):
    check_three_steps(pair, monkeypatch)


def test_forward_logits_match_jax(pair):
    assert check_logits(pair)["aux"] == 0.0


@pytest.mark.parametrize("frames", [48, 7])
def test_cross_attention_over_more_or_fewer_frames(rules, monkeypatch,
                                                   frames):
    """Loss and every gradient with 48 and 7 encoder frames against 32
    target tokens: cross-attention's Sq != Skv under autograd."""
    check_loss_and_grads(make_pair("whisper-medium", rules, frames=frames),
                         monkeypatch)


def test_frames_reach_the_loss(pair):
    cfg, jt, jstate, tt, batch = pair
    params = from_jax_train_state(jax.tree.map(np.asarray, jstate), cfg,
                                  device="cpu")["params"]
    with torch.no_grad():
        a = tt.loss_fn(params, tbatch(batch))[0]
        b = tt.loss_fn(params, tbatch(dict(batch,
                                           frames=batch["frames"] * 0)))[0]
    jb = float(jt.loss_fn(jstate["params"],
                          jbatch(dict(batch, frames=batch["frames"] * 0)))[0])
    np.testing.assert_allclose(float(b), jb, rtol=LOSS_RTOL)
    assert not torch.equal(a, b)
