"""Fault tolerance: supervised training loop, failure injection and the
straggler policy, over the port's ``CheckpointManager``.

On a real 1000+-node deployment the supervisor is the cluster controller;
here it is the in-process loop that the launcher runs, with the same
contract: every step is restartable from the last committed checkpoint and
the data pipeline is a pure function of the step counter (training/data.py)
— so a restart is state-restore + skip-ahead, nothing else.

Straggler mitigation policy (documented for multi-host): each step has a
deadline = p50 × ``straggler_factor``; a host missing two consecutive
deadlines is declared slow, the job checkpoints, and the supervisor
restarts on the reduced/replaced slice. In-process we implement deadline
*detection* and surface it in metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

from repro_torch.training.checkpoint import CheckpointManager


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure at given steps (tests/drills)."""

    fail_at: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_steps: int = 0
    final_step: int = 0


def run_supervised(step_fn: Callable[[int], Dict], *,
                   ckpt: CheckpointManager,
                   save_state: Callable[[], object],
                   load_state: Callable[[int, object], None],
                   n_steps: int,
                   ckpt_every: int = 10,
                   max_restarts: int = 5,
                   straggler_factor: float = 3.0) -> SupervisorReport:
    """Run ``step_fn(step)`` for n_steps with checkpoint/restart.

    ``save_state()`` returns the live train state; ``load_state(step,
    state)`` installs a restored one. step_fn may raise (hardware fault /
    injected failure) — the supervisor restores and resumes."""
    report = SupervisorReport()
    step = 0
    if ckpt.latest_step() is not None:
        restored = ckpt.restore(save_state())
        step = restored[0] + 1
        load_state(*restored)
    durations = []
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            step_fn(step)
            dt = time.perf_counter() - t0
            if durations:
                p50 = sorted(durations)[len(durations) // 2]
                if dt > straggler_factor * p50:
                    report.straggler_steps += 1
            durations.append(dt)
            report.steps_run += 1
            if step % ckpt_every == 0:
                ckpt.save(step, save_state())
            step += 1
        except Exception:
            report.restarts += 1
            if report.restarts > max_restarts:
                raise
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is None:
                step = 0
                continue
            restored_step, state = ckpt.restore(save_state())
            load_state(restored_step, state)
            step = restored_step + 1
    ckpt.wait()
    report.final_step = step
    return report
