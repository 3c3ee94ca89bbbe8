"""Per-rank liveness state machine: healthy → suspected → dead.

The port of :mod:`adapcc_tpu.supervisor.liveness`.  The elastic loop
detects failures from *injected* fault plans folded
into the coordinator's arrival funnel; a production deployment needs the
other funnel — real cross-process silence.  Ranks lease liveness by
heartbeating through the coordinator channel
(:class:`adapcc_tpu_torch.coordinator.service.HeartbeatClient`); this module is
the policy half the supervisor daemon runs over the raw last-beat
timestamps:

- **healthy** — the rank's last beat is within ``timeout_s``;
- **suspected** — silence exceeded ``timeout_s`` but not yet the
  confirmation window (``grace`` further heartbeat periods).  A beat here
  returns the rank to healthy with no decision recorded — the
  false-positive guard for a GC pause / SIGSTOP blip / a briefly
  congested control link;
- **dead** — silence exceeded ``timeout_s + grace × period_s``: the rank
  confirmably stopped leasing, the supervisor journals a demotion and
  actuates the world shrink.

Every transition is a pure function of (last-beat timestamp, now), so the
machine is deterministic under injected clocks — the same property the
fault plans have, extended to wall-clock detection.  The state vocabulary
is exported for the observability gauges (numeric codes, stable).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from adapcc_tpu_torch.elastic.worldview import (
    HEARTBEAT_TIMEOUT_ENV,
    _env_float,
    heartbeat_timeout_s,
)
from adapcc_tpu_torch.primitives import FAULT_TOLERANT_TIME_S

#: expected heartbeat cadence (seconds): ranks beat once per period, the
#: confirmation window is ``grace`` of these past the timeout
HEARTBEAT_PERIOD_ENV = "ADAPCC_HEARTBEAT_PERIOD_S"

#: confirmation count: how many further missed periods past the timeout
#: turn suspicion into a confirmed death (>= 1)
HEARTBEAT_GRACE_ENV = "ADAPCC_HEARTBEAT_GRACE"

DEFAULT_HEARTBEAT_PERIOD_S = 1.0
DEFAULT_HEARTBEAT_GRACE = 2

#: liveness states, with stable numeric codes for the metrics gauges
HEALTHY, SUSPECTED, DEAD = "healthy", "suspected", "dead"
STATE_CODES = {HEALTHY: 0, SUSPECTED: 1, DEAD: 2}

#: recent step-walltime reports retained per rank for the slow-rank rule
MEDIANS_KEPT = 16


def _env_int(name: str, default: int) -> int:
    """Loud parse of an int knob (the ADAPCC_MERGE_ROUNDS policy)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError as e:
        raise ValueError(f"{name}={raw!r}: expected an integer") from e
    if value < 1:
        raise ValueError(f"{name}={raw!r}: must be >= 1")
    return value


def heartbeat_period_s(default: float = DEFAULT_HEARTBEAT_PERIOD_S) -> float:
    return _env_float(HEARTBEAT_PERIOD_ENV, default)


def heartbeat_grace(default: int = DEFAULT_HEARTBEAT_GRACE) -> int:
    return _env_int(HEARTBEAT_GRACE_ENV, default)


@dataclass(frozen=True)
class LivenessConfig:
    """The three knobs of the detection latency/false-positive trade:
    suspicion after ``timeout_s`` of silence, death after ``grace``
    further missed ``period_s`` heartbeats.  ``from_env`` reads the
    ``ADAPCC_HEARTBEAT_*`` rows (malformed → loud)."""

    timeout_s: float = FAULT_TOLERANT_TIME_S
    period_s: float = DEFAULT_HEARTBEAT_PERIOD_S
    grace: int = DEFAULT_HEARTBEAT_GRACE

    def __post_init__(self) -> None:
        if self.timeout_s <= 0 or self.period_s <= 0:
            raise ValueError(
                f"timeout_s/period_s must be > 0, got "
                f"{self.timeout_s}/{self.period_s}"
            )
        if self.grace < 1:
            raise ValueError(f"grace must be >= 1, got {self.grace}")

    @property
    def confirm_s(self) -> float:
        """Silence that confirms a death: the suspicion timeout plus the
        grace window."""
        return self.timeout_s + self.grace * self.period_s

    @classmethod
    def from_env(
        cls, timeout_default: float = FAULT_TOLERANT_TIME_S
    ) -> "LivenessConfig":
        return cls(
            timeout_s=heartbeat_timeout_s(timeout_default),
            period_s=heartbeat_period_s(),
            grace=heartbeat_grace(),
        )


@dataclass
class RankHealth:
    """One rank's liveness picture — the gauge row the observability
    satellite exports (age/missed/state per rank)."""

    rank: int
    state: str = HEALTHY
    last_beat: float = 0.0
    beats: int = 0
    #: heartbeat periods elapsed since the last beat (expected: 0 or 1)
    missed: int = 0

    def row(self, now: float) -> dict:
        return {
            "rank": self.rank,
            "state": self.state,
            "age_s": round(max(0.0, now - self.last_beat), 6),
            "missed": self.missed,
            "beats": self.beats,
        }


class LivenessTable:
    """The per-rank state machines, swept together.

    ``beat(rank, now)`` renews the rank's lease (and optionally records a
    reported step walltime for the slow-rank rule); ``sweep(now)`` folds
    elapsed silence into state transitions and returns them.  Both take
    explicit timestamps so tests drive the machine deterministically; the
    daemon passes its monotonic clock.
    """

    def __init__(
        self, world: int, config: Optional[LivenessConfig] = None,
        now: float = 0.0,
    ) -> None:
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.config = config if config is not None else LivenessConfig()
        # the lease starts at construction: a rank that NEVER beats (died
        # during launch) is detected exactly like one that stopped
        self.ranks: Dict[int, RankHealth] = {
            r: RankHealth(rank=r, last_beat=now) for r in range(world)
        }
        self._medians: Dict[int, List[float]] = {r: [] for r in range(world)}

    def _check_rank(self, rank: int) -> None:
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} outside world [0, {self.world})")

    # -- inputs ----------------------------------------------------------------

    def beat(
        self, rank: int, now: float, median_s: Optional[float] = None
    ) -> Optional[Tuple[int, str, str]]:
        """Renew ``rank``'s lease at ``now``; returns the transition
        ``(rank, old, new)`` when the beat flipped a non-healthy state
        back (suspected → healthy is the false-positive guard firing,
        dead → healthy is a real recovery), else None."""
        self._check_rank(rank)
        h = self.ranks[rank]
        h.last_beat = max(h.last_beat, now)
        h.beats += 1
        h.missed = 0
        if median_s is not None and median_s > 0:
            kept = self._medians[rank]
            kept.append(float(median_s))
            del kept[:-MEDIANS_KEPT]
        if h.state != HEALTHY:
            old, h.state = h.state, HEALTHY
            return (rank, old, HEALTHY)
        return None

    def sweep(self, now: float) -> List[Tuple[int, str, str]]:
        """Fold silence into transitions: for each rank, age = now −
        last_beat; past ``timeout_s`` → suspected, past ``timeout_s +
        grace·period_s`` → dead.  Pure in (timestamps, now): sweeping
        twice at the same instant is a no-op, and sweep cadence never
        changes WHICH transitions happen, only how promptly they are
        observed."""
        cfg = self.config
        out: List[Tuple[int, str, str]] = []
        for rank in range(self.world):
            h = self.ranks[rank]
            age = now - h.last_beat
            h.missed = max(0, int(age // cfg.period_s))
            if age > cfg.confirm_s:
                target = DEAD
            elif age > cfg.timeout_s:
                target = SUSPECTED
            else:
                target = HEALTHY
            # silence only ever escalates; recovery is beat()'s job (a
            # sweep cannot invent a heartbeat)
            if STATE_CODES[target] > STATE_CODES[h.state]:
                out.append((rank, h.state, target))
                h.state = target
        return out

    # -- queries ---------------------------------------------------------------

    def state(self, rank: int) -> str:
        self._check_rank(rank)
        return self.ranks[rank].state

    def dead(self) -> List[int]:
        return [r for r, h in self.ranks.items() if h.state == DEAD]

    def rows(self, now: float) -> List[dict]:
        """The liveness table as data — dumped into the dispatch-trace
        extras on every epoch bump and exported as gauges."""
        return [self.ranks[r].row(now) for r in range(self.world)]

    def medians(self) -> Dict[int, float]:
        """Per-rank median of the recently reported step walltimes — the
        feed for the coordinator's slow-rank demotion rule
        (``ADAPCC_SLOW_RANK_FACTOR``), now carried by a real straggling
        process's own heartbeats instead of synthetic numbers."""
        return {
            r: float(np.median(vals))
            for r, vals in self._medians.items()
            if vals
        }

    def export_gauges(self, metrics, now: float) -> None:
        """Per-rank age / missed-count / state gauges into a
        :class:`~adapcc_tpu_torch.utils.observability.MetricsRegistry`."""
        if metrics is None:
            return
        for row in self.rows(now):
            r = row["rank"]
            metrics.gauge(f"liveness/rank{r}/age_s", row["age_s"])
            metrics.gauge(f"liveness/rank{r}/missed", row["missed"])
            metrics.gauge(
                f"liveness/rank{r}/state", STATE_CODES[row["state"]]
            )


__all__ = [
    "DEAD",
    "DEFAULT_HEARTBEAT_GRACE",
    "DEFAULT_HEARTBEAT_PERIOD_S",
    "HEALTHY",
    "HEARTBEAT_GRACE_ENV",
    "HEARTBEAT_PERIOD_ENV",
    "HEARTBEAT_TIMEOUT_ENV",
    "LivenessConfig",
    "LivenessTable",
    "MEDIANS_KEPT",
    "RankHealth",
    "STATE_CODES",
    "SUSPECTED",
]
