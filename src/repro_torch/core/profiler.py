"""Online restoration profiler: the port's copy of the JAX package's
``core/profiler.py`` (same fits, same JSON; a profile saved by either
package loads in the other with the same rates).

Every number the bubble-free scheduler plans with — host-link/storage
bandwidth, GEMM efficiency, per-dispatch overhead — starts life as a
guess in ``config/hardware.py``. The ``RestorationExecutor`` walks a
task graph of *real* work (striped chunk reads, grouped projections,
recompute segments); this module folds the seconds of those tasks into a
``MeasuredProfile`` that ``cost_model.method_times`` (and through it
``scheduler.solve``, ``capacity.restore_makespan`` and the group-size
planner) consume *in place of* the static profile, so the (L_H, L_KV,
L_RE) split and the restore-group boundaries are re-planned from
observed reality and converge within a few restores. IO samples are the
store's read-service seconds; compute samples are device seconds on the
card (CUDA events around a group's norm and kernel) and wall seconds on
the CPU.

Model, per task kind: ``seconds = overhead + work / rate`` where work is
bytes for IO kinds and FLOPs for compute kinds. Observations are folded
as EMA-weighted ``(work, seconds)`` moments per power-of-two token
bucket; with two or more buckets the (overhead, rate) pair comes from a
weighted least-squares line over the bucket means, with one bucket the
fit degenerates to a through-origin rate. The intercept of the compute
kinds IS the measured per-dispatch overhead (the quantity
``HardwareProfile.dispatch_overhead`` guessed) — ``method_times`` uses
only the marginal rate for per-layer costs, and ``replay`` charges the
measured overhead once per compute task, exactly as the static model
did.

Plan-cache invalidation: consumers memoize schedules and group plans per
``epoch``. The epoch bumps only when a kind's fitted prediction drifts
more than ``drift`` (5% default) from its last-snapshotted fit — so
plans are re-derived while calibration is still moving and reused once
it has converged.

Persistence: ``save``/``load`` round-trip the bucket moments to JSON
(``launch/serve.py --hw-profile``), so a restart starts from the
previous run's calibration instead of the datasheet guesses.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

# work units: bytes for IO-stream kinds, FLOPs for compute-stream kinds
IO_KINDS = ("io_h", "io_kv", "io_enc")
COMPUTE_KINDS = ("project", "recompute", "project_cross")
KINDS = IO_KINDS + COMPUTE_KINDS


def link_kind(kind: str, link: int) -> str:
    """Cell name for a per-NIC-link rate sample: ``io_h@L2`` = io_h
    served over link 2. The distributed store's links can be
    heterogeneous (mixed NIC generations, a degraded path), so the
    profiler keeps a per-link fit next to the aggregate one."""
    return f"{kind}@L{int(link)}"


def base_kind(kind: str) -> str:
    return kind.split("@", 1)[0]


def mesh_kind(kind: str, mesh: int) -> str:
    """Cell name for a per-mesh rate sample: ``project@M4`` = the grouped
    projection launched over a 4-device tensor-parallel mesh. Sharded launches have a genuinely different
    seconds-per-FLOP (the FLOPs are counted whole but each device runs
    1/tp of them), so each mesh width learns its own fit instead of
    poisoning the single-device cell."""
    return f"{kind}@M{int(mesh)}"


@dataclasses.dataclass
class _Bucket:
    """EMA moments of one (kind, token-bucket) cell."""

    work: float = 0.0        # EMA of observed work units per task
    seconds: float = 0.0     # EMA of observed seconds per task
    n: int = 0               # raw sample count (gauge + LS weight)

    def fold(self, work: float, seconds: float, alpha: float) -> None:
        if self.n == 0:
            self.work, self.seconds = work, seconds
        else:
            self.work += alpha * (work - self.work)
            self.seconds += alpha * (seconds - self.seconds)
        self.n += 1


class MeasuredProfile:
    """Per-kind, per-bucket observed task times + the derived cost fits.

    ``record`` is called by the executor once per real task;
    ``rate``/``overhead``/``predict`` are the planning-side reads. All
    methods fall back to ``None`` when a kind has no samples yet, so the
    static ``HardwareProfile`` keeps covering unmeasured kinds.
    """

    def __init__(self, alpha: float = 0.4, drift: float = 0.05):
        self.alpha = float(alpha)
        self.drift = float(drift)
        self.kinds: Dict[str, Dict[int, _Bucket]] = {}
        self.epoch = 0
        self._snap: Dict[str, Tuple[float, float]] = {}

    # ------------------------------------------------------------ recording
    def record(self, kind: str, bucket: int, work: float,
               seconds: float, link: Optional[int] = None,
               mesh: Optional[int] = None) -> None:
        """Fold one observed task: ``work`` units took ``seconds``.
        Non-positive observations are dropped (an untimed backend).
        ``link`` additionally folds the sample into the per-link cell
        (``io_h@L{link}``) so the planner can price heterogeneous NICs;
        the aggregate cell still learns every sample. ``mesh`` > 1
        redirects the sample to the per-mesh cell (``project@M{mesh}``)
        INSTEAD of the aggregate one — a tp-sharded launch's rate is not
        the single-device rate and must not contaminate its fit."""
        if base_kind(kind) not in KINDS or work <= 0.0 or seconds <= 0.0:
            return
        if mesh is not None and int(mesh) > 1:
            kind = mesh_kind(kind, mesh)
        for k in ((kind,) if link is None
                  else (kind, link_kind(kind, link))):
            cell = self.kinds.setdefault(k, {}).setdefault(int(bucket),
                                                           _Bucket())
            cell.fold(float(work), float(seconds), self.alpha)
            fit = self._fit(k)
            old = self._snap.get(k)
            if old is None or self._drifted(k, old, fit):
                self.epoch += 1
                self._snap[k] = fit

    def _drifted(self, kind: str, old: Tuple[float, float],
                 new: Tuple[float, float]) -> bool:
        # drift = the fit's PREDICTIONS moved, not its raw coefficients
        # (a 0 -> 1e-19 intercept wobble is float noise, not a new
        # machine). Evaluate both lines at the observed work range.
        probes = [c.work for c in self.kinds.get(kind, {}).values()
                  if c.n > 0] or [1.0]
        for w in (min(probes), max(probes)):
            a = old[0] + old[1] * w
            b = new[0] + new[1] * w
            scale = max(abs(a), abs(b))
            if scale > 0.0 and abs(a - b) / scale > self.drift:
                return True
        return False

    # -------------------------------------------------------------- fitting
    def _fit(self, kind: str) -> Optional[Tuple[float, float]]:
        """(overhead_seconds, seconds_per_work_unit) for ``kind``.

        Weighted least squares over the bucket means (weights = sample
        counts); a single bucket cannot separate fixed from marginal cost
        and degenerates to a through-origin rate."""
        cells = self.kinds.get(kind)
        if not cells:
            return None
        pts = [(c.work, c.seconds, float(c.n)) for c in cells.values()
               if c.n > 0]
        if not pts:
            return None
        sw = sum(w for _, _, w in pts)
        mx = sum(x * w for x, _, w in pts) / sw
        my = sum(y * w for _, y, w in pts) / sw
        var = sum(w * (x - mx) ** 2 for x, _, w in pts) / sw
        if len(pts) < 2 or var <= (1e-6 * mx) ** 2:
            return (0.0, my / mx if mx > 0 else 0.0)
        cov = sum(w * (x - mx) * (y - my) for x, y, w in pts) / sw
        slope = cov / var
        if slope <= 0.0:                    # noise inversion: rate fallback
            return (0.0, my / mx if mx > 0 else 0.0)
        intercept = max(my - slope * mx, 0.0)
        return (intercept, slope)

    # ------------------------------------------------------------- queries
    def samples(self, kind: Optional[str] = None) -> int:
        if kind is not None:
            return sum(c.n for c in self.kinds.get(kind, {}).values())
        return sum(self.samples(k) for k in self.kinds)

    def sample_counts(self) -> Dict[str, int]:
        return {k: self.samples(k) for k in sorted(self.kinds)}

    def rate(self, kind: str, link: Optional[int] = None,
             mesh: Optional[int] = None) -> Optional[float]:
        """Marginal seconds per work unit (slope), or None unmeasured.
        With ``link``, the per-link fit is preferred and the aggregate
        fit is the fallback (a link with no samples yet prices like the
        average link, not like the datasheet). With ``mesh`` > 1, the
        per-mesh cell is preferred; an unmeasured mesh falls back to the
        single-device slope divided by the mesh width — the ideal-scaling
        prior the static model uses — rather than pricing a 4-way launch
        at single-device speed."""
        if mesh is not None and int(mesh) > 1:
            fit = self._fit(mesh_kind(kind, mesh))
            if fit is not None and fit[1] > 0.0:
                return fit[1]
            base = self.rate(kind, link=link)
            return None if base is None else base / int(mesh)
        if link is not None:
            fit = self._fit(link_kind(kind, link))
            if fit is not None and fit[1] > 0.0:
                return fit[1]
        fit = self._fit(kind)
        return None if fit is None or fit[1] <= 0.0 else fit[1]

    def overhead(self, kind: str) -> Optional[float]:
        """Fixed per-task seconds (intercept), or None unmeasured."""
        fit = self._fit(kind)
        return None if fit is None else fit[0]

    def predict(self, kind: str, work: float) -> Optional[float]:
        """Full task seconds for ``work`` units (overhead + marginal)."""
        fit = self._fit(kind)
        if fit is None:
            return None
        return fit[0] + fit[1] * work

    def dispatch_overhead(self, mesh: Optional[int] = None)\
            -> Optional[float]:
        """Measured per-dispatch launch overhead: the fitted intercept of
        the grouped-projection kind (the compute kind with enough work
        variation to separate fixed from marginal cost). An SPMD launch
        pays this ONCE per launch, not per device — with ``mesh`` > 1 the
        per-mesh cell's intercept is preferred (it was measured around a
        sharded launch) and the single-device intercept is the fallback
        (launch cost does not scale with the mesh)."""
        if mesh is not None and int(mesh) > 1:
            got = self.overhead(mesh_kind("project", mesh))
            if got is not None:
                return got
        return self.overhead("project")

    # ---------------------------------------------------------- persistence
    def to_json(self) -> dict:
        return {
            "alpha": self.alpha, "drift": self.drift, "epoch": self.epoch,
            "kinds": {k: {str(b): {"work": c.work, "seconds": c.seconds,
                                   "n": c.n}
                          for b, c in cells.items()}
                      for k, cells in self.kinds.items()},
        }

    @classmethod
    def from_json(cls, data: dict) -> "MeasuredProfile":
        p = cls(alpha=data.get("alpha", 0.4), drift=data.get("drift", 0.05))
        for kind, cells in data.get("kinds", {}).items():
            for b, c in cells.items():
                p.kinds.setdefault(kind, {})[int(b)] = _Bucket(
                    work=float(c["work"]), seconds=float(c["seconds"]),
                    n=int(c["n"]))
            fit = p._fit(kind)
            if fit is not None:
                p._snap[kind] = fit
        p.epoch = int(data.get("epoch", 0))
        return p

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "MeasuredProfile":
        with open(path) as f:
            return cls.from_json(json.load(f))
