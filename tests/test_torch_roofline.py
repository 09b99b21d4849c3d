"""The port's roofline (``repro_torch/launch/roofline.py``) against the JAX
package's, the kernels' cost formulas against the bounds that PERF.md's
table of kernels states, and the execution counter
(``repro_torch/launch/exec_cost.py``) on programs whose cost is known."""
import dataclasses

import pytest
import torch

from repro.config import hardware as jax_hw
from repro.config.shapes import SHAPES_BY_NAME as JAX_SHAPES
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.launch import roofline as jax_roofline
from repro_torch.config.hardware import H100_SXM, PROFILES, TPU_V5E
from repro_torch.config.shapes import SHAPES_BY_NAME
from repro_torch.configs import REGISTRY
from repro_torch.distributed.collectives import reduce_from_shards
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import restore_kv as rkv
from repro_torch.kernels import ssm_update as ssu
from repro_torch.launch import exec_cost, roofline

# one cell's counted work, handed to both rooflines
COUNTS = dict(flops_per_device=3.7e14, bytes_per_device=2.1e11,
              coll_breakdown={"all-reduce": 1.5e9, "all-gather": 4.0e8},
              peak_memory=1.2e10)


def test_tpu_profile_is_the_reference_one():
    assert dataclasses.asdict(TPU_V5E) == dataclasses.asdict(jax_hw.TPU_V5E)
    assert "tpu_v5e" not in PROFILES and H100_SXM.name not in PROFILES
    assert (H100_SXM.flops, H100_SXM.hbm_bw, H100_SXM.interconnect_bw,
            H100_SXM.hbm_capacity) == (989e12, 3.35e12, 450e9, 80e9)


def test_header_is_the_reference_one():
    assert roofline.HEADER == jax_roofline.HEADER


@pytest.mark.parametrize("shape", sorted(SHAPES_BY_NAME))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_roofline_equals_the_reference(arch, shape):
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    cfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    s, js = SHAPES_BY_NAME[shape], JAX_SHAPES[shape]
    assert roofline.model_flops(cfg, s) == jax_roofline.model_flops(jcfg, js)
    got = roofline.analyze(cfg, s, mesh_name="16x16", chips=256, hw=TPU_V5E,
                           **COUNTS)
    want = jax_roofline.analyze(jcfg, js, mesh_name="16x16", chips=256,
                                hw=jax_hw.TPU_V5E, **COUNTS)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()


def test_report_from_a_record_and_main(tmp_path, capsys):
    rec = {"cell": "qwen2-7b__decode_32k__16x16__base", "arch": "qwen2-7b",
           "shape": "decode_32k", "mesh": "16x16", "chips": 256,
           "variant": "base", "flops": 2e12, "bytes_accessed": 8e9,
           "collectives": {"all-reduce": 1e8}, "peak_memory": 2**33}
    import json
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps(
        {"cell": "x", "arch": "qwen2-7b", "shape": "long_500k",
         "mesh": "16x16", "variant": "base", "skipped": "why"}))
    rep = roofline.report_from_json(str(tmp_path / "a.json"))
    assert rep.compute_s == pytest.approx(2e12 / 989e12)
    assert rep.memory_s == pytest.approx(8e9 / 3.35e12)
    assert rep.bottleneck == "memory"
    roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert roofline.HEADER in out and rep.row() in out
    assert "SKIP | qwen2-7b | long_500k | 16x16 | why" in out


# ------------------------------------------------ the kernels' formulas
def _bound_ms(flops, nbytes):
    return max(flops / H100_SXM.flops, nbytes / H100_SXM.hbm_bw) * 1e3


@pytest.mark.parametrize("kernel,cost,bound", [
    ("#1 G=8 S=1024 D=KV=4096",
     lambda: rkv.restore_cost(8, 1024, 4096, 4096, 128), 0.556),
    ("#3 B=3 Kv=32 lens 1100/2017/4096",
     lambda: dec.decode_cost(1, 128, [n for n in (1100, 2017, 4096)
                                      for _ in range(32)]), 0.0353),
    ("#4 B=4 Kv=32 bs=16 lens 2300/1537/777/2049",
     lambda: dec.decode_cost(1, 128, [n for n in (2300, 1537, 777, 2049)
                                      for _ in range(32)],
                             table_entries=sum(-(-n // 16) for n in
                                               (2300, 1537, 777, 2049))),
     0.0326),
    ("#5 1024-token causal self-prefill, H=Kv=32",
     lambda: fa.flash_cost(1, 1024, 1024, 32, 32, 128, offsets=[0],
                           kv_lens=[1024]), 0.0100),
    ("#6 Bt=4 S=1 I=8192 N=16",
     lambda: ssu.scan_cost(4, 8192, 16, 1, 2), 0.00149),
])
def test_kernel_formulas_give_the_perf_table_bounds(kernel, cost, bound):
    """The Bound ms column of PERF.md's table of kernels (NVIDIA H100
    80GB HBM3 peaks: 989 TFLOP/s bf16, 3.35 TB/s) at its timed shapes."""
    assert _bound_ms(*cost()) == pytest.approx(bound, rel=5e-3), kernel


def test_flash_pairs_count_the_visible_pairs():
    # causal, 4 queries from position 2 over 5 live keys: 3 + 4 + 5 + 5
    assert fa.flash_pairs([2], [5], 4) == 17
    assert fa.flash_pairs([0], [6], 6, window=2) == 11
    assert fa.flash_pairs([0, 1], [3, 3], 2, causal=False) == 12


def test_decode_live_keys_follow_the_slice():
    assert dec.live_keys([10, 40], 16) == [10, 16]
    assert dec.live_keys([40], 16, kv_start=[16]) == [16]
    assert dec.live_keys([20], 16, kv_start=16) == [4]
    assert dec.live_keys([20], 32, window=8) == [8]


# ---------------------------------------------------------- the counter
def test_counter_loop_of_products():
    """The reference's scan of 6 products of 128^3 (tests/test_roofline.py),
    as the port runs it: a loop."""
    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    _, r = exec_cost.count(f, torch.randn(128, 128),
                           torch.randn(6, 128, 128))
    assert r["flops"] == 6 * 2 * 128 ** 3


def test_counter_nested_loops_of_products():
    def g(x, ws):
        for wset in ws:
            for w in wset:
                x = torch.matmul(x, w)
        return x

    _, r = exec_cost.count(g, torch.randn(64, 64),
                           torch.randn(3, 4, 64, 64))
    assert r["flops"] == 12 * 2 * 64 ** 3


@pytest.mark.parametrize("n,counted", [(512, True), (256, False)])
def test_counter_bytes_at_the_threshold(n, counted):
    """One add of two (n, n) fp32 tensors: operands and result, each
    charged to ``bytes`` when it holds at least 1 MiB."""
    a, b = torch.randn(n, n), torch.randn(n, n)
    _, r = exec_cost.count(torch.add, a, b)
    each = 4 * n * n
    assert r["bytes_all"] == 3 * each
    assert r["bytes"] == (3 * each if counted else 0)


def test_counter_views_are_free_and_copies_count():
    x = torch.randn(512, 512)
    _, r = exec_cost.count(lambda t: t.view(-1).reshape(512, 512).t(), x)
    assert r["bytes_all"] == 0
    _, r = exec_cost.count(lambda t: t.t().contiguous(), x)
    assert r["bytes_all"] == 2 * 4 * 512 * 512


def test_a_cpu_launch_counts_the_kernel_once():
    """The plain version runs paused: the count is the kernel's formula
    alone, not the plain version's products and copies."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(6, 2, 16, generator=g)
    k = torch.randn(6, 40, 16, generator=g)
    v = torch.randn(6, 40, 16, generator=g)
    lens = torch.tensor([40, 7, 0, 13, 40, 25], dtype=torch.int32)

    def run(q, k, v, n):
        return ops.decode_attention(q, k, v, n,
                                    host_kv_len=[40, 7, 0, 13, 40, 25])

    out, r = exec_cost.count(run, q, k, v, lens)
    flops, nbytes = dec.decode_cost(2, 16, [40, 7, 0, 13, 40, 25],
                                    elem_bytes=4)
    assert r["launches"] == {"decode_attention": 1}
    assert (r["flops"], r["bytes_all"]) == (flops, nbytes)
    torch.testing.assert_close(out, dec.decode_attention_plain(q, k, v,
                                                               lens))


def test_meta_launch_gives_the_output_spec_without_running():
    q = torch.empty(4, 2, 16, device="meta")
    k = torch.empty(2, 64, 2, 16, device="meta")
    n = torch.empty(4, dtype=torch.int32, device="meta")
    out, r = exec_cost.count(
        lambda: ops.decode_attention(q, k, k, n, host_kv_len=[64] * 4))
    assert out.device.type == "meta" and out.shape == q.shape
    assert r["launches"] == {"decode_attention": 1}
    with pytest.raises(ValueError, match="host lengths"):
        exec_cost.count(lambda: ops.decode_attention(q, k, k, n))


def test_row_parallel_sum_reports_its_all_reduce():
    a, b = torch.randn(4, 8), torch.randn(4, 8)
    out, r = exec_cost.count(reduce_from_shards, [a, b], n_shards=2,
                             owners=[[a], [b]])
    assert r["per_shard"]["collectives"] == [{"all-reduce": 128},
                                             {"all-reduce": 128}]
    assert r["collectives"] == {"all-reduce": 128}
    assert r["collective_bytes"] == 128
    torch.testing.assert_close(out[1], a + b)
