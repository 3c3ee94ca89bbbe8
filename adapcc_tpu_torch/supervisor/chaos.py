"""Deterministic chaos harness for real multi-process runs (the port of
:mod:`adapcc_tpu.supervisor.chaos`).

The elastic fault plans (:mod:`adapcc_tpu_torch.elastic.faults`) inject failures
*logically* — dropped arrivals at the coordinator funnel, per-step relay
masks.  This module spells the same plans as **real process faults** so
the supervisor's heartbeat-loss detection is exercised by genuine
cross-process silence:

- ``down``  → ``SIGKILL`` the rank's process (its heartbeats stop cold);
- ``slow``  → a ``SIGSTOP``/``SIGCONT`` duty cycle that stretches the
  process's wall time by the event's ``slowdown`` factor — the rank keeps
  heartbeating (slower), its self-reported step walltimes inflate, and
  the supervisor's slow-rank rule (``ADAPCC_SLOW_RANK_FACTOR``) demotes a
  *really straggling process*, not a synthetic median;
- ``recover`` → ``SIGCONT`` (a killed rank cannot be un-killed; its
  recovery event maps to the deployment's restart story, not a signal).

The schedule is a pure function of ``(plan, step_period_s)`` — same plan,
same byte-identical action list — so two chaos drills under one seed see
identical fault timelines, the property every deterministic-injection
test in this repo rides on.

The third seam is the heartbeat transport itself: :class:`BeatChaos`
drops or delays individual beats deterministically (hash-seeded per
``(seed, rank, seq)``), which tests detection without touching any
process — a lossy control network, in one object.
"""

from __future__ import annotations

import hashlib
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

from adapcc_tpu_torch.elastic.faults import FaultPlan

#: duty-cycle granularity for the SIGSTOP straggler: one stop+cont pair
#: per window, stopped for ``1 - 1/slowdown`` of it
DEFAULT_DUTY_WINDOW_S = 0.2

_SIGNALS = {
    "kill": signal.SIGKILL,
    "stop": signal.SIGSTOP,
    "cont": signal.SIGCONT,
}


@dataclass(frozen=True)
class ChaosAction:
    """One scheduled signal: deliver ``kind`` to ``rank`` at ``at_s``
    seconds after the injector starts."""

    at_s: float
    kind: str
    rank: int

    def __post_init__(self) -> None:
        if self.kind not in _SIGNALS:
            raise ValueError(
                f"unknown chaos action {self.kind!r}; expected one of "
                f"{sorted(_SIGNALS)}"
            )
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s}")


def wall_schedule(
    plan: FaultPlan,
    step_period_s: float,
    duty_window_s: float = DEFAULT_DUTY_WINDOW_S,
) -> List[ChaosAction]:
    """Compile a step-indexed :class:`FaultPlan` into a wall-clock signal
    schedule (module doc).  Pure and deterministic: sorted by
    ``(at_s, rank, kind)``, byte-identical across calls.

    ``slow`` events become a stop/cont duty cycle from the event's step
    until the rank's ``recover`` step (or one step past the plan's last
    event): stopped ``1 − 1/slowdown`` of every ``duty_window_s``, so the
    process's wall time stretches by ≈``slowdown``.
    """
    if step_period_s <= 0:
        raise ValueError(f"step_period_s must be > 0, got {step_period_s}")
    if duty_window_s <= 0:
        raise ValueError(f"duty_window_s must be > 0, got {duty_window_s}")
    actions: List[ChaosAction] = []
    horizon_s = (plan.last_step() + 1) * step_period_s
    for i, e in enumerate(plan.events):
        t0 = e.step * step_period_s
        if e.kind == "down":
            actions.append(ChaosAction(t0, "kill", e.rank))
        elif e.kind == "recover":
            # harmless for a killed rank (no pid to signal by then); ends
            # a straggler's duty cycle for sure even if windows drifted
            actions.append(ChaosAction(t0, "cont", e.rank))
        else:  # slow
            until = next(
                (
                    later.step * step_period_s
                    for later in plan.events[i + 1:]
                    if later.rank == e.rank and later.kind != "slow"
                ),
                horizon_s,
            )
            stopped = duty_window_s * (1.0 - 1.0 / e.slowdown)
            t = t0
            while t < until:
                if stopped > 0:
                    actions.append(ChaosAction(round(t, 9), "stop", e.rank))
                    actions.append(
                        ChaosAction(round(t + stopped, 9), "cont", e.rank)
                    )
                t += duty_window_s
    return sorted(actions, key=lambda a: (a.at_s, a.rank, a.kind))


class ChaosInjector:
    """Deliver a :func:`wall_schedule` to real processes.

    ``run(pids)`` sleeps to each action's offset and sends the signal; a
    rank whose process already exited is skipped (killing a corpse is not
    an error — the schedule outliving a process is the normal end state
    of a ``down`` event).  ``start``/``join`` run it on a thread so the
    drill's training loop keeps the main thread.
    """

    def __init__(
        self,
        plan: FaultPlan,
        step_period_s: float,
        duty_window_s: float = DEFAULT_DUTY_WINDOW_S,
    ) -> None:
        self.plan = plan
        self.step_period_s = float(step_period_s)
        self.schedule: Tuple[ChaosAction, ...] = tuple(
            wall_schedule(plan, step_period_s, duty_window_s)
        )
        self.delivered: List[ChaosAction] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _signal(self, pid: int, action: ChaosAction) -> bool:
        try:
            os.kill(pid, _SIGNALS[action.kind])
        except (ProcessLookupError, PermissionError):
            return False
        self.delivered.append(action)
        return True

    def run(self, pids: Mapping[int, int]) -> List[ChaosAction]:
        missing = [r for r in {a.rank for a in self.schedule} if r not in pids]
        if missing:
            raise ValueError(
                f"chaos schedule names ranks {sorted(missing)} with no pid"
            )
        t0 = time.monotonic()
        for action in self.schedule:
            delay = t0 + action.at_s - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                break
            self._signal(pids[action.rank], action)
        return list(self.delivered)

    def start(self, pids: Mapping[int, int]) -> "ChaosInjector":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("chaos injector already running")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, args=(dict(pids),), name="adapcc-chaos",
            daemon=True,
        )
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        self.join(timeout=5)


class BeatChaos:
    """Deterministic heartbeat drop/delay at the transport seam.

    ``gate(rank, seq)`` → ``(send, delay_s)``: whether beat ``seq`` from
    ``rank`` goes out at all, and how long to hold it first.  Decisions
    are hash-seeded per ``(seed, rank, seq)`` — no RNG state, so two
    clients (or one client re-created after a crash) gate identically.
    """

    def __init__(
        self,
        drop_rate: float = 0.0,
        delay_s: float = 0.0,
        delay_rate: float = 0.0,
        seed: int = 0,
    ) -> None:
        if not 0.0 <= drop_rate <= 1.0 or not 0.0 <= delay_rate <= 1.0:
            raise ValueError("drop_rate/delay_rate must be in [0, 1]")
        if delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {delay_s}")
        self.drop_rate = float(drop_rate)
        self.delay_s = float(delay_s)
        self.delay_rate = float(delay_rate)
        self.seed = int(seed)

    def _unit(self, rank: int, seq: int, salt: str) -> float:
        h = hashlib.sha256(
            f"{self.seed}:{rank}:{seq}:{salt}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def gate(self, rank: int, seq: int) -> Tuple[bool, float]:
        if self._unit(rank, seq, "drop") < self.drop_rate:
            return False, 0.0
        delay = (
            self.delay_s
            if self._unit(rank, seq, "delay") < self.delay_rate
            else 0.0
        )
        return True, delay


__all__ = [
    "BeatChaos",
    "ChaosAction",
    "ChaosInjector",
    "DEFAULT_DUTY_WINDOW_S",
    "wall_schedule",
]
