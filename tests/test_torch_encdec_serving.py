"""The enc-dec family (whisper-medium) through the port's serving engine,
held against the JAX model on the same weights (``reduced_for_smoke``,
fp32, seeded numpy frames and prompts).

Each request's greedy tokens equal the JAX model's direct greedy (its
prefill over the encoder frames and the whole token stream, then its
decode steps), with 8 sessions of mixed encoder and prompt lengths over 2
slots, mid-stream preemption and a second round of retired sessions,
whose cross state comes back from the store; the paged backend gives the
contiguous backend's tokens. Also the refusals: a first residency without
frames, an encoder context past ``enc_seq``, and prefix sharing (whose
failure in the JAX package a test reproduces)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.config.hardware import PAPER_A100 as JAX_A100
from repro.configs import get_arch as jax_get_arch
from repro.core.hcache import HCacheManager as JaxManager
from repro.models import Model as JaxModel
from repro.models.module import split
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.storage import ChunkStore as JaxStore
from repro.storage import make_array as jax_make_array
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100
from repro_torch.configs import get_arch
from repro_torch.core.hcache import HCacheManager
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import (EncDecBackend, InferenceEngine,
                                 PagedEncDecBackend, Request)
from repro_torch.storage import ChunkStore, make_array

ARCH = "whisper-medium"
CTX = 96


@pytest.fixture(scope="module")
def pair(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jax_reduced(jax_get_arch(ARCH))
    jm = JaxModel(cfg, rules=rules, dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    tcfg = reduced_for_smoke(get_arch(ARCH))
    tm = Model(tcfg, device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    yield tcfg, jm, jparams, tm, tparams
    torch.set_num_threads(n)


def _frames(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, cfg.d_model)) * 0.1).astype(np.float32)


def _engine(pair, **kw):
    _, _, _, tm, tparams = pair
    mgr = HCacheManager(tm, ChunkStore(make_array("dram", 4),
                                       chunk_tokens=16), hw=PAPER_A100,
                        schedule_override="hidden")
    args = dict(max_batch=2, max_seq=CTX, prefill_chunk=8)
    args.update(kw)
    return InferenceEngine(tm, tparams, mgr, **args)


def direct_greedy(jm, jparams, frames, prompt, n_new, step):
    """The JAX model's prefill over the frames and the whole token stream,
    then greedy decode steps through ``step`` (its ``decode_step``, under
    ``jax.jit``), as ``tests/test_encdec_engine.py`` computes it."""
    pre = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)[None],
                               "frames": jnp.asarray(frames)[None]})
    S = len(prompt)

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, CTX - x.shape[2]), (0, 0),
                           (0, 0)))

    ck, cv = pre["cross_kv"]
    cache = {"self_k": pad(pre["kv"][0]), "self_v": pad(pre["kv"][1]),
             "cross_k": ck, "cross_v": cv,
             "enc_len": jnp.asarray(ck.shape[2], jnp.int32),
             "lengths": jnp.asarray([S], jnp.int32)}
    out = [int(jnp.argmax(pre["logits"][0, -1]))]
    for _ in range(n_new - 1):
        tok = jnp.asarray([[out[-1]]], jnp.int32)
        lg, cache = step(jparams, cache, tok)
        out.append(int(jnp.argmax(lg[0, -1])))
    return out


# 8 sessions: encoder lengths 12/20 and prompt lengths 7/11 alternating
# (so every decode batch can mix enc_len), 5 new tokens; round 2 gives
# s0 and s3 6 more prompt tokens and 4 new ones, without frames
def _jobs(cfg):
    rng = np.random.default_rng(7)
    return [(f"s{i}", _frames(cfg, (12, 20)[i % 2], 20 + i),
             rng.integers(0, cfg.vocab_size, (7, 11)[i // 2 % 2]).astype(
                 np.int32)) for i in range(8)]


@pytest.fixture(scope="module")
def served(pair):
    """Both backends' tokens for the two rounds, and their metrics."""
    cfg = pair[0]
    jobs = _jobs(cfg)
    rng = np.random.default_rng(8)
    again = {sid: rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
             for sid in ("s0", "s3")}
    out = {}
    for backend in ("contiguous", "paged"):
        eng = _engine(pair, backend=backend, preempt_quantum=3)
        for sid, frames, prompt in jobs:
            eng.submit(Request(sid, prompt, max_new_tokens=5,
                               frames=frames))
        eng.run()
        r0 = {sid: eng.result(sid) for sid, _, _ in jobs}
        for sid, prompt in again.items():
            eng.submit(Request(sid, prompt, max_new_tokens=4))
        eng.run()
        r1 = {sid: eng.result(sid) for sid in again}
        out[backend] = (r0, r1, eng.metrics, type(eng.kv))
        assert not eng.kv.enc_len_np.any()          # freed on retire
        eng.close()
    return jobs, again, out


@pytest.fixture(scope="module")
def reference(pair, served):
    """The JAX model's direct greedy for each request of ``served``: round
    0 from its prompt, round 1 over the whole stream (a round's last token
    never enters the history), with round 0's tokens of the contiguous
    run."""
    _, jm, jparams, _, _ = pair
    jobs, again, out = served
    step = jax.jit(jm.decode_step)
    r0 = {sid: direct_greedy(jm, jparams, f, p, 5, step)
          for sid, f, p in jobs}
    frames = {sid: f for sid, f, _ in jobs}
    prompts = {sid: p for sid, _, p in jobs}
    got0 = out["contiguous"][0]
    r1 = {sid: direct_greedy(jm, jparams, frames[sid], np.concatenate(
        [prompts[sid], np.asarray(got0[sid][:-1], np.int32), p2]), 4, step)
        for sid, p2 in again.items()}
    return r0, r1


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_engine_gives_the_jax_models_direct_greedy(served, reference,
                                                   backend):
    r0, r1, metrics, kind = served[2][backend]
    assert kind is {"contiguous": EncDecBackend,
                    "paged": PagedEncDecBackend}[backend]
    assert metrics.preemptions > 0 and metrics.restored_tokens > 0
    assert (r0, r1) == reference


def test_paged_gives_the_contiguous_tokens(served):
    out = served[2]
    assert out["paged"][:2] == out["contiguous"][:2]
    assert out["paged"][2].preemptions == out["contiguous"][2].preemptions


def test_a_first_residency_without_frames_raises(pair):
    eng = _engine(pair)
    eng.submit(Request("nof", np.arange(5, dtype=np.int32),
                       max_new_tokens=2))
    try:
        with pytest.raises(ValueError, match="frames"):
            eng.run()
    finally:
        eng.close()


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_an_encoder_context_past_enc_seq_raises(pair, backend):
    eng = _engine(pair, backend=backend, enc_seq=16)
    assert eng.kv.enc_seq == 16
    eng.submit(Request("big", np.arange(5, dtype=np.int32),
                       max_new_tokens=2, frames=_frames(pair[0], 24, 1)))
    try:
        with pytest.raises(ValueError, match="enc_seq=16"):
            eng.run()
    finally:
        eng.close()


def test_prefix_sharing_is_refused(pair):
    with pytest.raises(NotImplementedError, match="cross state"):
        _engine(pair, backend="paged", prefix_sharing=True)


def test_reference_prefix_sharing_of_an_encdec_session_fails(pair):
    """The JAX package's prefix sharing over enc-dec pages: a second
    session with the first one's decoder prompt adopts its pages and
    prefills on the history path against a cross state that was never
    written (cross-attention over 0 keys). With sharing off the same run
    completes."""
    cfg, jm, jparams, _, _ = pair
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               40).astype(np.int32)

    def run(sharing):
        mgr = JaxManager(jm, JaxStore(jax_make_array("dram", 4),
                                      chunk_tokens=16), hw=JAX_A100,
                         schedule_override="hidden", store_dtype=np.float32)
        eng = JaxEngine(jm, jparams, mgr, max_batch=2, max_seq=96,
                        prefill_chunk=64, backend="paged",
                        prefix_sharing=sharing)
        eng.submit(JaxRequest("a", prompt, max_new_tokens=4,
                              frames=_frames(cfg, 24, 1)))
        eng.step()
        eng.step()
        eng.submit(JaxRequest("b", prompt, max_new_tokens=4,
                              frames=_frames(cfg, 24, 2)))
        eng.run()
        return eng.result("b")

    assert len(run(False)) == 4
    with pytest.raises(ZeroDivisionError):
        run(True)


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_serve_cli_serves_whisper_two_rounds(backend, capsys):
    serve_cli.main(["--device", "cpu", "--arch", ARCH, "--enc-seq", "64",
                    "--sessions", "2", "--rounds", "2", "--prompt-len", "20",
                    "--gen", "3", "--max-seq", "64", "--backend", backend])
    out = capsys.readouterr().out
    assert out.startswith(f"{ARCH}: 4 layers")
    for rnd in range(2):
        for s in range(2):
            assert f"round {rnd} user{s}: 3 tokens" in out
    name = "paged-encdec" if backend == "paged" else "encdec"
    assert f"cache backend {name}" in out
    assert "recoverable sessions: ['user0', 'user1']" in out
