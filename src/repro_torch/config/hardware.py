"""Hardware profiles.

The HCache cost model / bubble-free scheduler needs (FLOPS, host-link BW,
storage BW) tuples. The port plans with the paper's own GPU platforms
(Table 2); ``PAPER_H800`` is the Hopper profile the manager defaults to.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops: float                 # peak dense FLOP/s (bf16/fp16)
    hbm_bw: float                # bytes/s on-chip HBM
    interconnect_bw: float       # bytes/s per ICI/NVLink link
    host_link_bw: float          # bytes/s accelerator<->host (PCIe)
    storage_bw: float            # bytes/s aggregate storage backend read BW
    hbm_capacity: float          # bytes per chip
    chips: int = 1
    # fixed per-device-dispatch cost charged to every compute-stream task
    # in the restoration replay (kernel launch + host-side framework
    # overhead). 0.0 keeps the paper's pure-bandwidth/FLOPs model; the
    # grouped restoration path amortizes this over group_size layers —
    # see benchmarks/bench_restore_batch.py for the knob's measurable
    # effect on makespan.
    dispatch_overhead: float = 0.0
    # tensor-parallel mesh width the restoration compute runs SPMD over
    # (DESIGN.md §16): projection FLOPs divide across the shards, the
    # dispatch overhead is charged once per launch (one XLA program, not
    # one per device). 1 = the classic single-device model.
    mesh_devices: int = 1

    def with_mesh(self, tp: int) -> "HardwareProfile":
        """A copy priced for a ``tp``-wide tensor-parallel mesh. The name
        changes too, so profiles for different meshes never alias in
        caches keyed by profile identity."""
        tp = max(int(tp), 1)
        if tp == self.mesh_devices:
            return self
        base = self.name.split("-tp")[0]
        return dataclasses.replace(
            self, name=base if tp == 1 else f"{base}-tp{tp}",
            mesh_devices=tp)

    def derated(self, *, storage: float = 1.0, host_link: float = 1.0,
                flops: float = 1.0,
                dispatch_overhead: float = None) -> "HardwareProfile":
        """A copy with bandwidths/FLOPs scaled and an optional dispatch
        overhead — the shape real hardware diverges from its datasheet in
        (shared PCIe lanes, filesystem overhead on the SSDs, sustained
        vs peak GEMM throughput). Every profile here is a guess until
        the online profiler (core/profiler.py) measures it; derated
        copies stand in for "what the machine actually does" in
        calibration tests and bench_sched."""
        return dataclasses.replace(
            self, name=self.name + "-derated",
            storage_bw=self.storage_bw * storage,
            host_link_bw=self.host_link_bw * host_link,
            flops=self.flops * flops,
            dispatch_overhead=(self.dispatch_overhead
                               if dispatch_overhead is None
                               else dispatch_overhead))


TB = 1e12
GB = 1e9

# --- paper platforms (Table 2; FP16 FLOPS, PCIe transmission) ----------------
PAPER_A100 = HardwareProfile("a100", 312e12, 2039 * GB, 600 * GB, 32 * GB,
                             4 * 6.9 * GB, 40 * GB)
PAPER_A30 = HardwareProfile("a30", 165e12, 933 * GB, 200 * GB, 32 * GB,
                            4 * 6.9 * GB, 24 * GB)
PAPER_4090 = HardwareProfile("4090", 330e12, 1008 * GB, 64 * GB, 32 * GB,
                             4 * 6.9 * GB, 24 * GB)
PAPER_L20 = HardwareProfile("l20", 120e12, 864 * GB, 64 * GB, 32 * GB,
                            4 * 6.9 * GB, 48 * GB)
PAPER_H800 = HardwareProfile("h800", 990e12, 3350 * GB, 400 * GB, 64 * GB,
                             4 * 6.9 * GB, 80 * GB)

PROFILES = {p.name: p for p in
            (PAPER_A100, PAPER_A30, PAPER_4090, PAPER_L20, PAPER_H800)}

# Efficiency assumed for the cost model's GEMM estimates (cuBLAS
# sustained fraction on well-shaped GEMMs).
GEMM_EFFICIENCY = 0.65

# Storage devices for the chunk store simulation (paper's PM9A3).
SSD_READ_BW = 6.9 * GB
SSD_WRITE_BW = 4.0 * GB
DRAM_BW = 80 * GB

# Cross-host NIC link defaults for the distributed chunk store (100 GbE
# per host shard; RTT covers the request round-trip + kernel stack).
NIC_BW = 12.5 * GB
NIC_RTT = 30e-6

# The paper's chunk size (§5): 64 tokens per stored chunk.
PAPER_CHUNK_TOKENS = 64
