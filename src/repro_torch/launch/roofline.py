"""Roofline analysis of counted dry-run cells: the JAX package's
``launch/roofline.py`` over the port's records (``launch/dryrun.py``).

Three terms per (arch x shape x mesh), all in seconds per device (the
busiest shard's counted work, ``launch/exec_cost.py``):

    compute    = FLOPs_per_device / peak_FLOPs_per_chip
    memory     = bytes_per_device / HBM_bw_per_chip
    collective = collective_bytes_per_device / interconnect_bw

The peaks default to ``H100_SXM``'s datasheet figures (989 TFLOP/s bf16
dense, 3.35 TB/s, NVLink 450 GB/s per direction): a report is counted
work against peaks, not a measurement. The reference's HLO-text
``collective_bytes`` has no counterpart: the counter reports the
collectives' breakdown by kind itself (a record's ``collectives``).

MODEL_FLOPS (the "useful" compute): 6·N·D for training, 2·N·D for
prefill/decode, N = active params, D = global tokens processed; the
restore cell's is the K/V projections over every stored layer-token. The
ratio MODEL_FLOPS / (FLOPs · chips) exposes recompute, padding and
masking waste.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from repro_torch.config.arch import ArchConfig
from repro_torch.config.hardware import H100_SXM, HardwareProfile
from repro_torch.config.shapes import InputShape


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    peak_memory_bytes: Optional[float] = None

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.compute_s * 1e3:.3f} | {self.memory_s * 1e3:.3f} | "
                f"{self.collective_s * 1e3:.3f} | {self.bottleneck} | "
                f"{self.useful_ratio:.2f} | "
                f"{(self.peak_memory_bytes or 0) / 2**30:.2f} |")


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    if shape.kind == "restore":
        # the paper's op: K/V projections over every stored layer-token
        from repro_torch.core.cost_model import layer_costs
        tokens = shape.global_batch * shape.seq_len
        return sum(c.c_hidden for c in layer_costs(cfg, tokens))
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    return factor * n_active * tokens


def analyze(cfg: ArchConfig, shape: InputShape, *, mesh_name: str,
            chips: int, flops_per_device: float, bytes_per_device: float,
            coll_breakdown: Optional[Dict[str, int]] = None,
            peak_memory: Optional[float] = None,
            hw: HardwareProfile = H100_SXM) -> RooflineReport:
    coll_breakdown = dict(coll_breakdown or {})
    coll = sum(coll_breakdown.values())
    compute_s = flops_per_device / hw.flops
    memory_s = bytes_per_device / hw.hbm_bw
    collective_s = coll / hw.interconnect_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total = flops_per_device * chips
    ratio = mf / total if total else 0.0
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops_per_device, bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll, coll_breakdown=coll_breakdown,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=mf, useful_ratio=ratio,
        peak_memory_bytes=peak_memory)


HEADER = ("| arch | shape | mesh | compute ms | memory ms | collective ms "
          "| bottleneck | useful ratio | peak GiB/dev |\n"
          "|---|---|---|---|---|---|---|---|---|")


def report_from_json(path: str, hw: HardwareProfile = H100_SXM
                     ) -> RooflineReport:
    from repro_torch.config.shapes import SHAPES_BY_NAME
    from repro_torch.configs import get_arch
    with open(path) as f:
        rec = json.load(f)
    return analyze(
        get_arch(rec["arch"]), SHAPES_BY_NAME[rec["shape"]],
        mesh_name=rec["mesh"], chips=rec["chips"],
        flops_per_device=rec["flops"], bytes_per_device=rec["bytes_accessed"],
        coll_breakdown=rec["collectives"],
        peak_memory=rec.get("peak_memory"), hw=hw)


def main(argv=None) -> None:
    import argparse
    import glob
    import os
    from collections import Counter

    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="experiments/dryrun")
    p.add_argument("--variant", default="base")
    p.add_argument("--mesh", default=None)
    args = p.parse_args(argv)

    rows = []
    skips = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("variant", "base") != args.variant:
            continue
        if args.mesh and rec.get("mesh") != args.mesh:
            continue
        if "skipped" in rec:
            skips.append(rec)
            continue
        if "error" in rec:
            print(f"ERROR CELL: {rec['cell']}: {rec['error']}")
            continue
        rows.append(report_from_json(path))

    print(HEADER)
    for r in sorted(rows, key=lambda r: (r.arch, r.shape, r.mesh)):
        print(r.row())
    print()
    for rec in skips:
        print(f"SKIP | {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
              f"{rec['skipped']}")
    if rows:
        c = Counter(r.bottleneck for r in rows)
        print(f"\nbottlenecks: {dict(c)}")


if __name__ == "__main__":
    main()
