"""Fault-injection plan for the serving robustness layer (DESIGN.md §7).

A copy of the reference package's ``testing/faults.py``, the
``REPRO_FAULTS`` environment route included.  The port's engines and
backends consult ``sleep_block``, ``check_search``, ``drift_override`` and
``audit_override``; the replica tier (``serving.replica``) consults
``check_replica`` and ``replica_delay``, and persistence
(``api.persistence``) ``check_save`` and ``torn_frame``.

The serving stack has three failure modes the paper's instability result
implies in production: a pathological block that blows the latency budget,
a device step that dies mid-batch, and a crash that tears the last delta-WAL
frame.  This module makes all three *injectable* so the chaos tests
and the chip run (``chip_smoke.py``) can drive them deterministically:

    with faults.inject(slow_block_s=0.01):
        sess.search(Q, 10, deadline_s=0.005)     # deadline now fires

Three injection routes, in precedence order:

1. ``SchedulePolicy(faults=FaultPlan(...))`` — scoped to one session; the
   backends consult their policy's plan first.
2. ``faults.inject(...)`` — a context manager that installs a process-global
   plan (used by tests).
3. ``REPRO_FAULTS="slow_block_s=0.01,fail_search_after=3"`` — environment
   variable, parsed once, for injecting into a process you don't own (the CI
   smoke step).

Hook points (all no-ops when no plan is active):

``sleep_block(plan)``
    called by both engines between row-block groups — simulates a slow
    block/host ("Bang for the Buck": identical workloads vary widely across
    cloud instances), which is what makes deadline expiry testable.
``check_search(plan)``
    called at backend ``search()`` entry — raises :class:`FaultError` on the
    N-th call (0-indexed count AFTER which the next call fails), simulating
    a device-step exception the serving loop must absorb.
``torn_frame(plan, buf)``
    consulted by the delta WAL's ``append`` — returns the byte prefix to
    actually write and whether to simulate a crash (the writer then raises
    :class:`SimulatedCrash` after the partial write, modeling power loss
    mid-frame).  Consumed once per armed plan.
``drift_override(plan, score)`` / ``audit_override(plan, recall)``
    consulted by the guardrail layer (core.guardrails, DESIGN.md §9) —
    replace the sentinel's measured drift score / the audit-or-canary
    sample recall, so breaker trips and audit divergence are injectable
    deterministically (the guardrail state-machine edge tests).
``check_replica(plan, idx)`` / ``replica_delay(plan, idx)``
    consulted by the replicated serving tier (serving.replica, DESIGN.md
    §10) per replica dispatch — kill replica ``dead_replica`` (immediately,
    or after its ``fail_replica_after``-th dispatch) and report an extra
    simulated stall for replica ``slow_replica`` (charged to the virtual
    timeline, never slept: failover replays stay fast and replay-exact).
``check_save(plan)``
    consulted by ``save_session`` between the tmp-file write and the atomic
    ``os.replace`` — raises :class:`SimulatedCrash` on the armed save,
    modeling power loss mid-snapshot (the old snapshot must survive).

``FaultPlan`` is a frozen dataclass (hashable, safe inside the frozen
``SchedulePolicy``); mutable runtime counters live module-side and reset
whenever a new plan is installed via :func:`inject` / :func:`install`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time


class FaultError(RuntimeError):
    """Injected device-step failure (the harness's stand-in for a CUDA/
    driver error escaping a search call)."""


class SimulatedCrash(RuntimeError):
    """Injected process death mid-WAL-write: the frame on disk is torn and
    the caller never gets an acknowledgement."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject.  All fields default to "no fault".

    ``slow_block_s``        sleep this long per scanned block group.
    ``fail_search_after``   raise ``FaultError`` on search call number N
                            (0-based; -1 = never).
    ``torn_frame_keep``     on the next WAL frame write, keep only this
                            fraction of the frame's bytes (0 <= f < 1) and
                            raise ``SimulatedCrash``; -1.0 = never.
    ``drift_score``         override the guardrail sentinel's raw batch
                            drift score with this value (0 <= s <= 1;
                            -1.0 = no override) — makes breaker trips
                            deterministic regardless of query content.
    ``audit_recall``        override the guardrail audit/canary sampled
                            recall (0 <= r <= 1; -1.0 = no override) —
                            injects audit divergence without needing a
                            screen that actually loses neighbors.
    ``dead_replica``        replica index whose dispatches raise
                            ``FaultError`` (-1 = none).  Fails immediately
                            unless ``fail_replica_after`` delays the onset.
    ``fail_replica_after``  the dead replica serves this many dispatches
                            first, then every later one fails (-1 = fail
                            from the first dispatch) — the mid-run kill.
    ``slow_replica``        replica index reporting an extra simulated
                            stall per dispatch (-1 = none).
    ``slow_replica_s``      the stall, in (virtual) seconds, charged to
                            ``slow_replica``'s dispatch wall.
    ``crash_save``          raise ``SimulatedCrash`` on save call number N
                            (0-based), after the tmp write but before the
                            atomic rename (-1 = never).
    """

    slow_block_s: float = 0.0
    fail_search_after: int = -1
    torn_frame_keep: float = -1.0
    drift_score: float = -1.0
    audit_recall: float = -1.0
    dead_replica: int = -1
    fail_replica_after: int = -1
    slow_replica: int = -1
    slow_replica_s: float = 0.0
    crash_save: int = -1


# module-side runtime state: the active global plan and mutable counters
# (keyed by plan identity so a SchedulePolicy-scoped plan gets its own count)
_GLOBAL: FaultPlan | None = None
_COUNTERS: dict = {}


def _env_plan() -> FaultPlan | None:
    spec = os.environ.get("REPRO_FAULTS", "").strip()
    if not spec:
        return None
    kw: dict = {}
    for item in spec.split(","):
        key, _, val = item.partition("=")
        key = key.strip()
        if key not in FaultPlan.__dataclass_fields__:
            raise ValueError(f"REPRO_FAULTS: unknown field {key!r}")
        typ = FaultPlan.__dataclass_fields__[key].type
        kw[key] = int(val) if "int" in typ else float(val)
    return FaultPlan(**kw)


def active(policy=None) -> FaultPlan | None:
    """The plan in effect: the policy-scoped plan, else the global/context
    plan, else the ``REPRO_FAULTS`` environment plan."""
    plan = getattr(policy, "faults", None)
    if plan is not None:
        return plan
    return _GLOBAL if _GLOBAL is not None else _env_plan()


def _reset(plan: FaultPlan) -> None:
    """Drop every counter keyed to ``plan``'s identity.  Must cover ALL
    counter kinds: a dataclass freed after its context exits can be
    re-allocated at the same ``id()``, and a stale key would make the new
    plan think it already fired."""
    _COUNTERS.pop(id(plan), None)
    _COUNTERS.pop(("torn", id(plan)), None)
    _COUNTERS.pop(("save", id(plan)), None)
    for key in [k for k in _COUNTERS
                if isinstance(k, tuple) and k[:2] == ("replica", id(plan))]:
        _COUNTERS.pop(key, None)


@contextlib.contextmanager
def inject(**kw):
    """Install a process-global :class:`FaultPlan` for the ``with`` body
    (counters reset on entry and the previous plan is restored on exit)."""
    global _GLOBAL
    prev = _GLOBAL
    plan = FaultPlan(**kw)
    _GLOBAL = plan
    _reset(plan)
    try:
        yield plan
    finally:
        _GLOBAL = prev
        _reset(plan)


def install(plan: FaultPlan | None) -> FaultPlan | None:
    """Swap the process-global plan *without* a context scope and return the
    previous one.  The failover benchmark uses this to kill and later revive
    a replica at chosen points of a Poisson replay — a ``with`` block can't
    straddle the replay loop.  Counters for the incoming plan are reset;
    callers restore the returned plan when done."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = plan
    if plan is not None:
        _reset(plan)
    return prev


def sleep_block(plan: FaultPlan | None) -> None:
    """Engine hook: stall one block group (no-op without a plan)."""
    if plan is not None and plan.slow_block_s > 0.0:
        time.sleep(plan.slow_block_s)


def check_search(plan: FaultPlan | None) -> None:
    """Backend hook: raise :class:`FaultError` when this call is the plan's
    ``fail_search_after``-th search (one failure, then the plan is spent)."""
    if plan is None or plan.fail_search_after < 0:
        return
    n = _COUNTERS.get(id(plan), 0)
    _COUNTERS[id(plan)] = n + 1
    if n == plan.fail_search_after:
        raise FaultError(
            f"injected device-step failure on search call {n} "
            f"(FaultPlan.fail_search_after={plan.fail_search_after})")


def drift_override(plan: FaultPlan | None, score: float) -> float:
    """Guardrail hook: replace the sentinel's measured raw drift score
    (``core.guardrails.Guardrail.run``) with the plan's, when armed."""
    if plan is None or plan.drift_score < 0.0:
        return score
    return float(plan.drift_score)


def audit_override(plan: FaultPlan | None, recall: float) -> float:
    """Guardrail hook: replace the measured audit/canary sample recall with
    the plan's, when armed — the audit-divergence injection route."""
    if plan is None or plan.audit_recall < 0.0:
        return recall
    return float(plan.audit_recall)


def check_replica(plan: FaultPlan | None, idx: int) -> None:
    """Replica-tier hook: raise :class:`FaultError` when replica ``idx`` is
    the plan's dead replica.  With ``fail_replica_after`` >= 0 the replica
    serves that many dispatches first (the mid-run kill); unlike
    ``check_search`` the failure is *persistent* — every dispatch after the
    onset fails until the plan is swapped out (revival)."""
    if plan is None or plan.dead_replica < 0 or idx != plan.dead_replica:
        return
    key = ("replica", id(plan), idx)
    n = _COUNTERS.get(key, 0)
    _COUNTERS[key] = n + 1
    if plan.fail_replica_after < 0 or n >= plan.fail_replica_after:
        raise FaultError(
            f"injected replica failure: replica {idx} dead "
            f"(dispatch {n}, FaultPlan.fail_replica_after="
            f"{plan.fail_replica_after})")


def replica_delay(plan: FaultPlan | None, idx: int) -> float:
    """Replica-tier hook: extra *simulated* seconds to charge to replica
    ``idx``'s dispatch wall (0.0 when not the slow replica).  Charged, not
    slept — the hedged-dispatch timeline stays virtual and replay-exact."""
    if plan is None or plan.slow_replica < 0 or idx != plan.slow_replica:
        return 0.0
    return float(max(plan.slow_replica_s, 0.0))


def check_save(plan: FaultPlan | None) -> None:
    """Persistence hook: raise :class:`SimulatedCrash` on the plan's
    ``crash_save``-th snapshot save, after the tmp file is written but
    before the atomic rename — the crash point the atomic-save test proves
    leaves the previous snapshot intact."""
    if plan is None or plan.crash_save < 0:
        return
    key = ("save", id(plan))
    n = _COUNTERS.get(key, 0)
    _COUNTERS[key] = n + 1
    if n == plan.crash_save:
        raise SimulatedCrash(
            f"injected crash on save {n} (FaultPlan.crash_save="
            f"{plan.crash_save}): tmp written, rename never happened")


def torn_frame(plan: FaultPlan | None, buf: bytes) -> tuple[bytes, bool]:
    """WAL hook: (bytes to actually write, crash_after_write).  Tears at
    most once per plan — later frames write whole again."""
    if plan is None or plan.torn_frame_keep < 0.0 \
            or _COUNTERS.get(("torn", id(plan))):
        return buf, False
    _COUNTERS[("torn", id(plan))] = True
    keep = max(0, min(len(buf) - 1, int(len(buf) * plan.torn_frame_keep)))
    return buf[:keep], True
