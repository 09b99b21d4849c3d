"""The port's MoE layer (``models/layers/moe.py``) against the JAX
package's ``apply_moe``, and the MoE stack through the serving engine.

Layer: the same inputs and weights (numpy, from a seed) through both, at
atol 1e-5, in cases that drop assignments (the dropped count computed
here from the routing and asserted > 0), decode (S = 1, capacity 1), and
granite's 32 experts top-8. Each case asserts that every token's k-th
and (k+1)-th router probabilities lie more than 1e-4 apart, so fp32
rounding cannot flip its choice between the frameworks. Rows are routed
on their own (changing the other rows leaves row 0's bits) and two calls
give the same bits.

Engine: granite-moe-1b-a400m at smoke size (weights from the JAX
package's init) on the contiguous and paged backends, 5 sessions x 2
rounds over 3 slots with preemption and a recompute/hidden plan: paged
equals contiguous bitwise, every restore equals the K/V the session held
at its pause, and every generated token is the greedy choice of the
session's own segments (each prefill chunk over its history, then one
token at a time) run again at B = 1."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.arch import reduced_for_smoke as jax_reduced
from repro.configs import get_arch as jax_get_arch
from repro.models import Model as JaxModel
from repro.models.layers import moe as jmoe
from repro.models.module import split
from repro_torch.config.arch import reduced_for_smoke
from repro_torch.config.hardware import PAPER_A100
from repro_torch.configs import get_arch
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import moe as tmoe
from repro_torch.serving import Request
from repro_torch.storage import ChunkStore, make_array
from test_torch_engine import CheckedEngine, MixedPlanManager

ATOL = 1e-5
MARGIN = 1e-4


def _layer(seed, B, S, D, E, K, F, skew=0.0):
    """Weights and input of one MoE call; ``skew`` > 0 pulls every token
    towards expert 0 (a shared input direction that its router column
    follows), so its capacity overflows."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) * D ** -0.5,
         "w_up": rng.standard_normal((E, D, F)) * D ** -0.5,
         "w_gate": rng.standard_normal((E, D, F)) * D ** -0.5,
         "w_down": rng.standard_normal((E, F, D)) * F ** -0.5}
    x = rng.standard_normal((B, S, D))
    if skew:
        x += skew
        p["router"][:, 0] = np.abs(p["router"][:, 0])
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _routing(p, x, K):
    """numpy top-k experts (B, S, K) and the smallest k-th vs (k+1)-th
    probability margin."""
    logits = x.astype(np.float64) @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1)
    top = np.take_along_axis(probs, order, -1)
    margin = (top[..., K - 1] - top[..., K]).min() if K < probs.shape[-1] \
        else 1.0
    return order[..., :K], float(margin)


def _dropped(top_e, S, E, K):
    C = math.ceil(S * K / E * 1.25) if S * K >= E else S * K
    C = max(min(C, S), 1)
    counts = np.stack([np.bincount(row.reshape(-1), minlength=E)
                       for row in top_e])
    return int(np.maximum(counts - C, 0).sum()), C


def _both(p, x, E, K, rules):
    B, S, D = x.shape
    F = p["w_up"].shape[-1]
    want, _ = jmoe.apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jmoe.MoEHyper(E, K, D, F),
                             rules)
    got = tmoe.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), tmoe.MoEHyper(E, K, D, F))
    return got, np.asarray(want)


# (name, seed, B, S, D, E, K, F, skew, drops expected)
CASES = [("drops", 0, 2, 24, 32, 4, 2, 16, 1.0, True),
         ("decode", 1, 3, 1, 32, 4, 2, 16, 0.0, False),
         ("granite experts", 8, 2, 50, 16, 32, 8, 8, 0.0, True)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_apply_moe_matches_the_reference(case, rules):
    _, seed, B, S, D, E, K, F, skew, drops = case
    p, x = _layer(seed, B, S, D, E, K, F, skew)
    top_e, margin = _routing(p, x, K)
    assert margin > MARGIN, margin
    n_drop, C = _dropped(top_e, S, E, K)
    assert C == tmoe.capacity(S, tmoe.MoEHyper(E, K, D, F))
    assert (n_drop > 0) == drops, n_drop
    got, want = _both(p, x, E, K, rules)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    h = tmoe.MoEHyper(E, K, D, F)
    _, slot = tmoe.route({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), h)
    assert slot.shape == (B, S * K)
    assert int((slot == E * C).sum()) == n_drop
    if S == 1:
        assert C == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_moe_rows_are_routed_alone(dtype):
    """Row 0's output is the same bits whatever the other rows hold."""
    p, x = _layer(3, 3, 20, 32, 8, 2, 16, skew=0.5)
    h = tmoe.MoEHyper(8, 2, 32, 16)
    pt = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
    xt = torch.from_numpy(x).to(dtype)
    a = tmoe.apply_moe(pt, xt, h)
    other = xt.clone()
    other[1:] = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 20, 32)).astype(np.float32)).to(dtype)
    b = tmoe.apply_moe(pt, other, h)
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[1], b[1])
    # and alone: a batch of one routes row 0 the same way
    _, slot_a = tmoe.route(pt, xt, h)
    _, slot_1 = tmoe.route(pt, xt[:1], h)
    assert torch.equal(slot_a[:1], slot_1)


def test_apply_moe_is_deterministic():
    p, x = _layer(5, 2, 33, 32, 4, 2, 16, skew=1.0)
    h = tmoe.MoEHyper(4, 2, 32, 16)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    assert torch.equal(tmoe.apply_moe(pt, xt, h), tmoe.apply_moe(pt, xt, h))


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def granite(rules):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    name = "granite-moe-1b-a400m"
    jm = JaxModel(jax_reduced(jax_get_arch(name)), rules=rules,
                  dtype=jnp.float32, remat="none")
    jparams, _ = split(jm.init(jax.random.PRNGKey(0)))
    cfg = reduced_for_smoke(get_arch(name))
    tm = Model(cfg, device="cpu")
    yield cfg, tm, from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine_runs(granite):
    cfg, tm, params = granite
    rng = np.random.default_rng(11)
    rounds = [[(f"u{i}", rng.integers(0, cfg.vocab_size, int(n)).astype(
        np.int32), 6) for i, n in enumerate(rng.integers(10, 30, 5))],
        [(f"u{i}", rng.integers(0, cfg.vocab_size, 7).astype(np.int32), 4)
         for i in range(5)]]
    runs = {}
    for backend in ("contiguous", "paged"):
        mgr = MixedPlanManager(
            tm, ChunkStore(make_array("dram", 4), chunk_tokens=16),
            hw=PAPER_A100)
        eng = CheckedEngine(tm, params, mgr, max_batch=3, max_seq=96,
                            prefill_chunk=8, preempt_quantum=2,
                            backend=backend)
        tokens = []
        for reqs in rounds:
            for sid, prompt, n in reqs:
                eng.submit(Request(sid, prompt, max_new_tokens=n))
            eng.run()
            tokens.append({sid: eng.result(sid) for sid, _, _ in reqs})
        mgr.saver.drain()
        manifests = {sid: mgr.store.get_manifest(sid) for sid, _, _ in
                     rounds[0]}
        streams = {sid: np.asarray(mgr.store.get_blob(sid, "tok", 0))
                   for sid, _, _ in rounds[0]}
        eng.close()
        runs[backend] = (tokens, eng, manifests, streams)
    return rounds, runs


def test_moe_engine_paged_equals_contiguous_bitwise(engine_runs):
    _, runs = engine_runs
    c, p = runs["contiguous"], runs["paged"]
    assert p[0] == c[0]
    ce, pe = c[1], p[1]
    assert ce.snapshots.keys() == pe.snapshots.keys()
    for sid, (k, v) in ce.snapshots.items():
        assert torch.equal(k, pe.snapshots[sid][0])
        assert torch.equal(v, pe.snapshots[sid][1])


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_moe_engine_restores_equal_their_snapshots(engine_runs, backend):
    """Recompute layers replay the session's prefill chunks and its decode
    steps 3 rows wide; the restored K/V is the K/V held at the pause."""
    _, runs = engine_runs
    eng = runs[backend][1]
    assert eng.metrics.preemptions > 0 and len(eng.checked) >= 5
    assert all("recompute" in m and "hidden" in m for _, m in eng.checked)
    segs = [seg for man in runs[backend][2].values()
            for seg in man["segments"]]
    assert any(s[2] == "decode" and s[3] == 3 for s in segs)
    assert sum(s[2] == "prefill" for s in segs) > 10


def _segment_logits(model, params, toks, segments):
    """Logits (N, V) at every position of ``toks`` computed the way the
    engine computed them, at B = 1: each prefill segment over the history
    before it, each decode segment one token at a time."""
    N = len(toks)
    t = torch.from_numpy(toks.astype(np.int64))
    cache = model.init_cache(1, N)
    out = []
    for seg in segments:
        start, n, kind = seg[0], seg[1], seg[2]
        if kind == "prefill":
            hist = ((cache["k"][:, :, :start], cache["v"][:, :, :start])
                    if start else None)
            res = tfm.lm_forward(params, t[None, start:start + n], model.h,
                                 hist_kv=hist, hist_len=start or None,
                                 emit_kv=True)
            cache["k"][:, :, start:start + n] = res["kv"][0]
            cache["v"][:, :, start:start + n] = res["kv"][1]
            out.append(res["logits"][0])
            continue
        for pos in range(start, start + n):
            cache["lengths"] = torch.tensor([pos], dtype=torch.int32)
            lg, cache = model.decode_step(params, cache, t[None, pos:pos + 1])
            out.append(lg[0])
    return torch.cat(out)


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_moe_engine_tokens_are_greedy_over_the_sessions_segments(
        engine_runs, granite, backend):
    """MoE capacity follows the segment length, so the greedy reference
    runs the session's own segments, not one unchunked forward."""
    cfg, tm, params = granite
    rounds, runs = engine_runs
    tokens, _, manifests, streams = runs[backend]
    for sid, _, _ in rounds[0]:
        man = manifests[sid]
        stream = streams[sid][:man["n_tokens"]]
        want = []
        for rnd, reqs in enumerate(rounds):
            prompt = next(p for s, p, _ in reqs if s == sid)
            want += [int(x) for x in prompt] + tokens[rnd][sid][:-1]
        assert [int(x) for x in stream] == want
        logits = _segment_logits(tm, params, stream, man["segments"])
        assert logits.shape[0] == len(stream)
        off = 0
        for rnd, reqs in enumerate(rounds):
            prompt = next(p for s, p, _ in reqs if s == sid)
            gen = tokens[rnd][sid]
            at = off + len(prompt) - 1
            picks = [int(i) for i in logits[at:at + len(gen)].argmax(-1)]
            assert picks == gen, (sid, rnd)
            off += len(prompt) + len(gen) - 1
