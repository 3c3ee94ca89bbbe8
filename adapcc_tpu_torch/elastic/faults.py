"""Deterministic fault model: a seeded schedule of rank-level failures (the
port of :mod:`adapcc_tpu.elastic.faults`; a plan file written by either
package loads in the other unchanged).

The paper's robustness claims (stragglers demoted to forwarding relays;
collectives that continue with the alive subset) are only testable if the
failures themselves are reproducible.  A :class:`FaultPlan` is a list of
``(step, kind, rank)`` events — ``down`` / ``slow`` / ``recover`` — replayed
deterministically: ``state_at(step)`` folds every event up to and including
``step`` into the down-set and the slow-map, so two runs of the same plan
see byte-identical fault timelines on any backend, hardware or CPU.

Injection points (the two funnels every failover path flows through):

- the coordinator's ``hook_arrive``/``controller_arrive`` funnel
  (:class:`adapcc_tpu_torch.coordinator.logic.CoordinatorLogic` takes a
  ``fault_plan``): a down rank's arrival is dropped at the funnel and the
  barrier's expected count shrinks, so fault detection fires
  *deterministically* instead of waiting out a wall-clock timeout;
- the simulated replay (:func:`adapcc_tpu_torch.sim.replay.simulate_fault_plan`):
  the same plan prices detection → swap → degraded steady state on the
  calibrated α-β model.

``ADAPCC_FAULT_PLAN`` points at a JSON artifact (see :func:`load_fault_plan`)
so a battery entry or a workload run can inject the identical schedule from
the environment with zero wiring at the call site.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np

#: env var pointing at a fault-plan JSON artifact
FAULT_PLAN_ENV = "ADAPCC_FAULT_PLAN"

#: the event vocabulary; anything else is a loud error, never a silent no-op
FAULT_KINDS = ("down", "slow", "recover")

#: default straggler slowdown factor for ``slow`` events (the sim's
#: ``predict_degradation`` default — one number across injection and pricing)
DEFAULT_SLOWDOWN = 4.0


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault transition at a training step."""

    step: int
    kind: str
    rank: int
    slowdown: float = DEFAULT_SLOWDOWN

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}"
            )
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "slow" and self.slowdown < 1.0:
            raise ValueError(
                f"slow-event slowdown must be >= 1, got {self.slowdown}"
            )

    def to_dict(self) -> dict:
        out = {"step": self.step, "kind": self.kind, "rank": self.rank}
        if self.kind == "slow":
            out["slowdown"] = self.slowdown
        return out

    @classmethod
    def from_dict(cls, obj: Mapping) -> "FaultEvent":
        return cls(
            step=int(obj["step"]),
            kind=str(obj["kind"]),
            rank=int(obj["rank"]),
            slowdown=float(obj.get("slowdown", DEFAULT_SLOWDOWN)),
        )


@dataclass(frozen=True)
class FaultState:
    """The fault picture at one step: who is dead, who is slow (and by
    how much).  Slow ranks are candidates for relay demotion; down ranks
    are out of the collective entirely."""

    down: FrozenSet[int]
    slow: Tuple[Tuple[int, float], ...]  # sorted (rank, slowdown) pairs

    @property
    def slow_map(self) -> Dict[int, float]:
        return dict(self.slow)

    @property
    def faulty(self) -> FrozenSet[int]:
        return self.down | frozenset(r for r, _ in self.slow)

    @property
    def healthy(self) -> bool:
        return not self.down and not self.slow


class FaultPlan:
    """A deterministic, serializable schedule of fault events.

    ``world`` is the world size the plan was authored for; every consumer
    validates it against the runtime world (injecting a plan for the wrong
    world would silently shift which ranks die).
    """

    def __init__(
        self,
        events: Sequence[FaultEvent],
        world: int,
        label: str = "fault-plan",
    ) -> None:
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        bad = [e for e in events if not 0 <= e.rank < world]
        if bad:
            raise ValueError(
                f"fault events {bad} name ranks outside world [0, {world})"
            )
        self.world = world
        self.label = label
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.rank, e.kind))
        )
        # the plan must never kill the whole world: a step where every rank
        # is down has no leader to freeze an active list and no alive subset
        # for the collectives to continue with
        for step in sorted({e.step for e in self.events}):
            st = self.state_at(step)
            if len(st.down) >= world:
                raise ValueError(
                    f"fault plan kills the entire world at step {step}; at "
                    "least one rank must stay alive"
                )

    # -- replay ----------------------------------------------------------------

    def events_at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def state_at(self, step: int) -> FaultState:
        """Fold every event with ``event.step <= step`` into one state."""
        down: set = set()
        slow: Dict[int, float] = {}
        for e in self.events:
            if e.step > step:
                break
            if e.kind == "down":
                down.add(e.rank)
                slow.pop(e.rank, None)
            elif e.kind == "slow":
                if e.rank not in down:
                    slow[e.rank] = e.slowdown
            else:  # recover
                down.discard(e.rank)
                slow.pop(e.rank, None)
        return FaultState(
            down=frozenset(down), slow=tuple(sorted(slow.items()))
        )

    def down_at(self, step: int) -> FrozenSet[int]:
        return self.state_at(step).down

    def alive_at(self, step: int) -> FrozenSet[int]:
        return frozenset(range(self.world)) - self.state_at(step).down

    def contributing_at(self, step: int) -> FrozenSet[int]:
        """Ranks that contribute to step ``step``'s collectives: alive and
        not demoted to a forwarding relay (slow ranks are demoted)."""
        st = self.state_at(step)
        return (
            frozenset(range(self.world))
            - st.down
            - frozenset(r for r, _ in st.slow)
        )

    def mask_at(self, step: int) -> np.ndarray:
        """``[world]`` bool contribution mask for step ``step`` — the shape
        the engine/trainer data plane consumes."""
        m = np.zeros((self.world,), dtype=bool)
        m[sorted(self.contributing_at(step))] = True
        if not m.any():
            # every rank demoted/down would zero the collective's divisor;
            # the plan constructor forbids all-down, so this can only be
            # "everyone slow" — keep the alive ranks contributing instead
            m[sorted(self.alive_at(step))] = True
        return m

    def last_step(self) -> int:
        return max((e.step for e in self.events), default=0)

    def chaos_schedule(self, step_period_s: float, **kwargs):
        """The plan's **cross-process spelling**:
        compile the step-indexed events into a wall-clock signal schedule
        for real worker processes — ``down`` → SIGKILL, ``slow`` → a
        SIGSTOP/SIGCONT duty cycle stretching wall time by the event's
        ``slowdown`` (so the slow-rank demotion rule is exercised by a
        genuinely straggling process), ``recover`` → SIGCONT.  Delegates
        to :func:`adapcc_tpu_torch.supervisor.chaos.wall_schedule`; pure and
        deterministic like every other replay of this plan."""
        from adapcc_tpu_torch.supervisor.chaos import wall_schedule

        return wall_schedule(self, step_period_s, **kwargs)

    # -- serialization ---------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "world": self.world,
            "label": self.label,
            "events": [e.to_dict() for e in self.events],
        }

    @classmethod
    def from_dict(cls, obj: Mapping) -> "FaultPlan":
        return cls(
            events=[FaultEvent.from_dict(e) for e in obj.get("events", ())],
            world=int(obj["world"]),
            label=str(obj.get("label", "fault-plan")),
        )

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- canned plans ----------------------------------------------------------

    @classmethod
    def seeded(
        cls,
        world: int,
        steps: int,
        seed: int = 0,
        n_faults: int = 2,
        recover: bool = True,
        slowdown: float = DEFAULT_SLOWDOWN,
    ) -> "FaultPlan":
        """Deterministic pseudo-random plan: ``n_faults`` events (alternating
        down/slow) at distinct steps on distinct ranks, each recovered a few
        steps later when ``recover``.  Same (world, steps, seed) → the same
        plan, byte for byte — the property every fault-sweep row rides on."""
        if world < 2:
            raise ValueError("a seeded fault plan needs world >= 2")
        rng = np.random.default_rng(seed)
        n_faults = min(n_faults, world - 1, max(1, steps // 2))
        ranks = rng.choice(world, size=n_faults, replace=False)
        fault_steps = sorted(
            int(s) for s in rng.choice(max(1, steps - 2), size=n_faults, replace=False)
        )
        events: List[FaultEvent] = []
        for i, (rank, step) in enumerate(zip(ranks, fault_steps)):
            kind = "down" if i % 2 == 0 else "slow"
            events.append(
                FaultEvent(step=step, kind=kind, rank=int(rank), slowdown=slowdown)
            )
            if recover:
                events.append(
                    FaultEvent(
                        step=min(steps - 1, step + 2), kind="recover", rank=int(rank)
                    )
                )
        return cls(events, world, label=f"seeded:{seed}")

    def __repr__(self) -> str:
        return (
            f"FaultPlan(world={self.world}, events={len(self.events)}, "
            f"label={self.label!r})"
        )


def load_fault_plan(
    world: Optional[int] = None, env: Optional[Mapping[str, str]] = None
) -> Optional[FaultPlan]:
    """The ``ADAPCC_FAULT_PLAN`` funnel: None when the env is unset, the
    parsed plan otherwise.  A set-but-broken value (missing file, malformed
    JSON, world mismatch) raises loudly — a typo'd injection artifact must
    never silently run a healthy world (the ADAPCC_MERGE_ROUNDS policy).
    One shared funnel with ``ADAPCC_CONGESTION_PROFILE``
    (:func:`adapcc_tpu_torch.utils.artifacts.load_env_json_artifact`)."""
    from adapcc_tpu_torch.utils.artifacts import load_env_json_artifact

    return load_env_json_artifact(
        FAULT_PLAN_ENV,
        FaultPlan.from_dict,
        kind="fault-plan",
        world=world,
        env=env,
        mismatch_hint="injecting it as-is would shift which ranks die",
    )
