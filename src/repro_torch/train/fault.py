"""Fault tolerance and straggler machinery.

Counterpart of the reference package's ``train/fault.py``.  On a
multi-host cluster these hooks would bind to a coordination service
(heartbeats, preemption notices); here the same logic is driven by step
timing and signals, and the restart path is exercised for real (kill
mid-run, resume, bitwise continuation).

Components:
  * StepMonitor  — per-step EWMA timing; a step slower than ``ratio``x the
    EWMA marks the host as straggling.  At scale the action is to evict the
    replica and rebuild the mesh (elastic), which is exactly what
    ``plan_elastic_remesh`` computes.
  * PreemptionGuard — SIGTERM/SIGINT => finish the current step, synchronous
    checkpoint, exit cleanly.
  * run_resumable  — checkpoint/restart training driver: restores the newest
    valid checkpoint (params+opt+step; the data order is a function of the
    step), saves async every ``ckpt_every`` steps.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

from repro_torch.train import checkpoint as ckpt


@dataclass
class StepMonitor:
    ratio: float = 2.5
    alpha: float = 0.1
    ewma: float = 0.0
    n: int = 0
    stragglers: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step looked straggly."""
        if self.n >= 3 and dt > self.ratio * self.ewma:
            self.stragglers.append((step, dt, self.ewma))
            slow = True
        else:
            slow = False
        self.ewma = dt if self.n == 0 else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        self.n += 1
        return slow


def plan_elastic_remesh(mesh_shape: tuple, axis_names: tuple, lost: int):
    """Given ``lost`` failed hosts, compute the largest healthy sub-mesh that
    keeps the "model" axis intact (TP groups must stay whole) by shrinking
    the outermost DP axis.  Returns (new_shape, dropped_replicas)."""
    shape = list(mesh_shape)
    tp = shape[-1]
    dp_total = 1
    for s in shape[:-1]:
        dp_total *= s
    # each DP replica spans `tp` chips; losing any chip kills its replica
    lost_replicas = min(dp_total, (lost + tp - 1) // tp)
    new_dp = dp_total - lost_replicas
    if new_dp <= 0:
        raise RuntimeError("no healthy replicas left")
    return (new_dp, tp), lost_replicas


class PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._orig = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for sig, h in self._orig.items():
            signal.signal(sig, h)
        return False


def run_resumable(train_step, state_template, data_fn, *, steps: int,
                  ckpt_dir: str, ckpt_every: int = 50, monitor=None,
                  fail_at: int | None = None):
    """Checkpoint/restart driver.  ``data_fn(step)`` must be stateless
    (indexed access) so the data order is reproducible across restarts.
    ``fail_at`` injects a crash (tests).  Each step waits for the device
    by reading its loss on the host.  Returns (state, last_step)."""
    state, start = ckpt.restore(state_template, ckpt_dir)
    if state is None:
        state, start = state_template, -1
    monitor = monitor or StepMonitor()
    with PreemptionGuard() as guard:
        for step in range(start + 1, steps):
            t0 = time.perf_counter()
            state, metrics = train_step(state, data_fn(step))
            float(metrics["loss"])
            monitor.record(step, time.perf_counter() - t0)
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            if step % ckpt_every == 0 or guard.requested or step == steps - 1:
                ckpt.save_async(state, ckpt_dir, step)
            if guard.requested:
                ckpt.wait_pending()
                return state, step
    ckpt.wait_pending()
    return state, steps - 1
