"""The scan kernel's host side (``kernels/ssm_update.py::ssm_scan_plan``
and ``scan_cost``), from shapes only.

Kernel #6 walks all S tokens of a layer call in one launch. Its plan cuts
the rows over blocks and each row's N states over N / 4 lanes, stages the
tokens a chunk at a time (or, at decode sizes, reads them straight from
device memory), and sums y over a row's lanes in an order fixed by N
alone, so a token's bits do not depend on S, Bt or the staging. A numpy
walk of that order (fp32, the kernel's exp2 of dt·A·log2 e) is held
against the JAX package's Pallas kernel in interpret mode, token by
token, and against the plain version, at atol = rtol = 1e-5: only the
order of the sums and the exp's last bits differ."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_update import ssm_update_pallas
from repro_torch.kernels import ssm_update as tssm

TOL = dict(atol=1e-5, rtol=1e-5)
SMEM_LIMIT = 232448                  # a block's shared memory on an H100
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("Bt,I,N", [(1, 8192, 16), (3, 1000, 8), (4, 96, 4),
                                    (2, 130, 16), (1, 33, 4)])
def test_plan_covers_every_state_once(Bt, I, N):
    """Every (b, i, n) belongs to exactly one compute thread of the grid,
    and a thread past row I holds nothing."""
    plan = tssm.ssm_scan_plan(Bt, I, N, 7, torch.bfloat16)
    assert plan.lanes * plan.rows == tssm.THREADS
    seen = np.zeros((Bt, I, N), np.int32)
    nblocks, nbatch = plan.grid
    assert nbatch == Bt and (nblocks - 1) * plan.rows < I <= nblocks * plan.rows
    for b in range(nbatch):
        for bx in range(nblocks):
            for thread in range(tssm.THREADS):
                got = plan.lane_states(bx, b, thread, I)
                if got is None:
                    assert bx == nblocks - 1
                    continue
                bb, i, ns = got
                assert len(ns) == 4 and ns[-1] < N
                seen[bb, i, ns.start:ns.stop] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("N", tssm.STATE_SIZES)
@pytest.mark.parametrize("S", [1, 2, 4, 5, 31, 32, 33, 64, 65, 2000, 8192])
def test_stages_tile_the_tokens_in_order(S, N):
    """The staged chunks cover [0, S) in scan order without gap or
    overlap, each at most one slot long; a slot is a whole number of the
    kernel's 4-token batches; decode sizes (S <= BATCH) take no ring."""
    plan = tssm.ssm_scan_plan(1, 8192, N, S, torch.bfloat16)
    ranges = plan.stage_ranges(S)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert all(0 < b - a <= plan.tokens for a, b in ranges)
    assert plan.tokens % tssm.BATCH == 0
    if S <= tssm.BATCH:
        assert plan.stages == 0 and plan.smem_bytes == 0
        assert plan.threads == tssm.THREADS
    else:
        assert 2 <= plan.stages <= tssm.STAGES
        assert plan.threads == tssm.THREADS + tssm.PRODUCER


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", tssm.STATE_SIZES)
@pytest.mark.parametrize("S", [1, 5, 64, 2000])
def test_plan_fits_shared_memory(S, N, dtype):
    """The ring (slots of dt, x, B, C as copied, bf16 widened to fp32, and
    the read-ahead room) fits a block's 227 KB; two blocks of the falcon
    shape fit one SM."""
    plan = tssm.ssm_scan_plan(1, 8192, N, S, dtype)
    assert 0 <= plan.smem_bytes <= SMEM_LIMIT
    if N == 16 and dtype == torch.bfloat16 and plan.stages:
        assert 2 * plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("N", tssm.STATE_SIZES)
def test_plan_depends_on_shapes_alone(N):
    """The same shapes give the same plan; the lanes per row and the y
    reduction's masks follow N alone, whatever S, Bt, I or dtype."""
    ref = tssm.ssm_scan_plan(1, 8192, N, 1, torch.bfloat16)
    for Bt, I, S, dtype in [(4, 8192, 1, torch.bfloat16),
                            (1, 8192, 2000, torch.bfloat16),
                            (3, 96, 33, torch.float32),
                            (65535, 8, 1, torch.float32)]:
        plan = tssm.ssm_scan_plan(Bt, I, N, S, dtype)
        assert plan == tssm.ssm_scan_plan(Bt, I, N, S, dtype)
        assert (plan.lanes, plan.rows, plan.masks) == (ref.lanes, ref.rows,
                                                       ref.masks)
    assert ref.lanes == N // 4
    assert sorted(ref.masks) == [1 << j for j in range(len(ref.masks))]


@pytest.mark.parametrize("Bt,I,N,S,dtype", [
    (65536, 8, 16, 1, torch.bfloat16), (1, 8, 2, 1, torch.bfloat16),
    (1, 8, 32, 1, torch.float32), (1, 8, 16, 1, torch.float16),
    (1, 8, 16, 0, torch.float32), (0, 8, 16, 1, torch.float32)])
def test_plan_refuses_what_the_kernel_does_not_take(Bt, I, N, S, dtype):
    with pytest.raises((ValueError, TypeError)):
        tssm.ssm_scan_plan(Bt, I, N, S, dtype)


def _inputs(rng, Bt, I, N, S):
    return dict(
        h=rng.normal(size=(Bt, I, N)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, size=(Bt, S, I)).astype(np.float32),
        x=rng.normal(size=(Bt, S, I)).astype(np.float32),
        A=-rng.uniform(0.5, 2.0, size=(I, N)).astype(np.float32),
        B=rng.normal(size=(Bt, S, N)).astype(np.float32),
        C=rng.normal(size=(Bt, S, N)).astype(np.float32),
        d_skip=rng.normal(size=(I,)).astype(np.float32))


def _plan_walk(a, plan):
    """The kernel's arithmetic in numpy fp32, token after token: each
    lane's four states advanced with exp2(dt · A log2 e), its four
    products h · C summed in n order, then the lanes' partials added over
    the plan's xor masks in turn, and D · x added last."""
    f32 = np.float32
    h = a["h"].copy()
    Bt, I, N = h.shape
    S = a["x"].shape[1]
    G = plan.lanes
    a2 = (a["A"] * f32(np.log2(np.e))).reshape(I, G, 4)
    y = np.empty((Bt, S, I), f32)
    for t in range(S):
        d = a["dt"][:, t][:, :, None, None]                      # (Bt,I,1,1)
        dx = d * a["x"][:, t][:, :, None, None]
        Bv = a["B"][:, t].reshape(Bt, 1, G, 4)
        Cv = a["C"][:, t].reshape(Bt, 1, G, 4)
        hs = h.reshape(Bt, I, G, 4)
        hs = np.exp2(d * a2[None]) * hs + dx * Bv
        h = hs.reshape(Bt, I, N)
        prod = hs * Cv
        p = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
        for m in plan.masks:                                     # (Bt,I,G)
            p = p + p[..., np.arange(G) ^ m]
        assert np.all(p == p[..., :1])       # every lane holds the same sum
        y[:, t] = p[..., 0] + a["d_skip"] * a["x"][:, t]
    return h, y


@pytest.mark.parametrize("Bt,I,N,S", [(2, 64, 16, 6), (1, 32, 8, 5),
                                      (3, 16, 4, 9), (1, 40, 16, 1)])
def test_plan_walk_matches_pallas_and_plain(Bt, I, N, S):
    a = _inputs(np.random.default_rng(Bt * 100 + N * 10 + S), Bt, I, N, S)
    plan = tssm.ssm_scan_plan(Bt, I, N, S, torch.float32)
    h, y = _plan_walk(a, plan)
    hj = jnp.asarray(a["h"])
    for t in range(S):
        hj, yj = ssm_update_pallas(hj, a["dt"][:, t], a["x"][:, t], a["A"],
                                   a["B"][:, t], a["C"][:, t], a["d_skip"],
                                   interpret=True)
        np.testing.assert_allclose(y[:, t], np.asarray(yj), **TOL)
    np.testing.assert_allclose(h, np.asarray(hj), **TOL)
    hp = torch.from_numpy(a["h"].copy())
    yp = tssm.ssm_scan_plain(hp, *(torch.from_numpy(a[k]) for k in
                                   ("dt", "x", "A", "B", "C", "d_skip")))
    np.testing.assert_allclose(y, yp.numpy(), **TOL)
    np.testing.assert_allclose(h, hp.numpy(), **TOL)


def _per_token_bytes(Bt, I, N, es):
    """Bytes of the single-token update as chip_smoke.py counted them
    before the scan: h read and h' written (fp32), A and dt (fp32), x, B,
    C, D read and y written (``es`` bytes each)."""
    return (2 * Bt * I * N * 4 + I * N * 4 + Bt * I * 4
            + es * (2 * Bt * I + 2 * Bt * N + I))


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("Bt,I,N", [(4, 8192, 16), (1, 8192, 16),
                                    (3, 96, 4)])
def test_scan_cost_adds_only_the_per_token_streams(Bt, I, N, es):
    """At S = 1 the count equals the single-token update's; each further
    token adds dt and x read, y written and B, C read, and its operations,
    and nothing of the state, A or D."""
    flops1, bytes1 = tssm.scan_cost(Bt, I, N, 1, es)
    assert bytes1 == _per_token_bytes(Bt, I, N, es)
    assert flops1 == Bt * I * (7 * N + 3)
    for S in (2, 33, 2000, 8192):
        flops, nbytes = tssm.scan_cost(Bt, I, N, S, es)
        assert flops == S * flops1
        assert nbytes - bytes1 == (S - 1) * Bt * (I * 4 + 2 * I * es
                                                  + 2 * N * es)
