"""WorldView: the coordinator's explicit picture of the world.

A copy of :mod:`adapcc_tpu.elastic.worldview` (numpy only; importing the
reference module would load JAX through its package).

The reference coordinator hands out bare active *lists* per step
(rpc_server.py:48-96); everything downstream then re-derives who is dead,
who is merely slow, and whether anything changed since the last step.  The
elastic loop needs those distinctions first-class:

- **alive** — ranks still answering heartbeats; the set collectives
  continue with instead of hanging;
- **relays** — alive-but-slow ranks demoted to pure forwarders (the
  paper's straggler demotion): they stay on the data path, contribute the
  reduction identity, and keep receiving results;
- **epoch** — a monotone counter bumped on every membership change.  The
  epoch is the hot-swap token: compiled plans are installed per epoch, and
  a collective issued against a dead epoch raises a retryable
  :class:`~adapcc_tpu_torch.comm.engine.EpochMismatch` instead of running a
  stale schedule.

The slow-rank rule (:func:`slow_ranks_from_medians`) feeds on the per-rank
step medians the :class:`~adapcc_tpu.tuner.measure.DispatchTimer` pipeline
already collects — detection costs no new measurement.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import FrozenSet, Iterable, List, Mapping, Optional

import numpy as np

#: heartbeat timeout override for fault detection (seconds); default is the
#: coordinator's fault timeout (primitives.FAULT_TOLERANT_TIME_S)
HEARTBEAT_TIMEOUT_ENV = "ADAPCC_HEARTBEAT_TIMEOUT_S"

#: slow-rank demotion threshold: a rank whose step median exceeds
#: ``factor x`` the median of its peers' medians is demoted to a relay
SLOW_RANK_FACTOR_ENV = "ADAPCC_SLOW_RANK_FACTOR"

#: default demotion factor — 2x its peers is decisively a straggler, not
#: measurement noise (the tuner's hysteresis uses the same order of margin)
DEFAULT_SLOW_RANK_FACTOR = 2.0


def _env_float(name: str, default: float) -> float:
    """Loud parse of a float knob: a malformed value raises instead of
    silently running the default (the ADAPCC_MERGE_ROUNDS policy)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError as e:
        raise ValueError(f"{name}={raw!r}: expected a number") from e
    if value <= 0:
        raise ValueError(f"{name}={raw!r}: must be > 0")
    return value


def heartbeat_timeout_s(default: float) -> float:
    return _env_float(HEARTBEAT_TIMEOUT_ENV, default)


def slow_rank_factor(default: float = DEFAULT_SLOW_RANK_FACTOR) -> float:
    return _env_float(SLOW_RANK_FACTOR_ENV, default)


@dataclass(frozen=True)
class WorldView:
    """Immutable snapshot of the coordinator's world picture.

    Transitions return a NEW view with the epoch bumped when (and only
    when) membership actually changed — a no-op transition keeps the same
    epoch, so compiled plans are never invalidated for nothing.
    """

    world_size: int
    alive: FrozenSet[int]
    relays: FrozenSet[int]
    epoch: int = 0

    def __post_init__(self) -> None:
        bad = [r for r in self.alive | self.relays if not 0 <= r < self.world_size]
        if bad:
            raise ValueError(
                f"ranks {sorted(bad)} outside world [0, {self.world_size})"
            )
        if not self.relays <= self.alive:
            raise ValueError(
                f"relays {sorted(self.relays - self.alive)} are not alive; a "
                "dead rank cannot forward"
            )

    @classmethod
    def full(cls, world_size: int) -> "WorldView":
        return cls(
            world_size=world_size,
            alive=frozenset(range(world_size)),
            relays=frozenset(),
            epoch=0,
        )

    # -- queries ---------------------------------------------------------------

    @property
    def contributing(self) -> FrozenSet[int]:
        """Ranks whose data enters the reduction: alive and not demoted."""
        return self.alive - self.relays

    @property
    def dead(self) -> FrozenSet[int]:
        return frozenset(range(self.world_size)) - self.alive

    @property
    def degraded(self) -> bool:
        return bool(self.dead or self.relays)

    def active_list(self) -> List[int]:
        """The bare list legacy consumers (hook responses, engine
        ``active_gpus``) expect."""
        return sorted(self.contributing)

    def mask(self) -> np.ndarray:
        m = np.zeros((self.world_size,), dtype=bool)
        m[self.active_list()] = True
        return m

    def key(self):
        """Standby-plan cache key: membership without the epoch (the same
        degraded shape recurring at a later epoch reuses the same plan)."""
        return (self.alive, self.relays)

    # -- transitions -----------------------------------------------------------

    def _bump(self, alive: FrozenSet[int], relays: FrozenSet[int]) -> "WorldView":
        relays = relays & alive
        if alive == self.alive and relays == self.relays:
            return self
        return replace(self, alive=alive, relays=relays, epoch=self.epoch + 1)

    def with_down(self, ranks: Iterable[int]) -> "WorldView":
        down = frozenset(ranks)
        return self._bump(self.alive - down, self.relays - down)

    def with_alive(self, ranks: Iterable[int]) -> "WorldView":
        """Replace the alive set wholesale (the controller's status-0
        output: exactly the ranks that reported)."""
        alive = frozenset(ranks)
        return self._bump(alive, self.relays & alive)

    def with_relays(self, ranks: Iterable[int]) -> "WorldView":
        """Replace the relay set (the slow-rank rule's output)."""
        return self._bump(self.alive, frozenset(ranks) & self.alive)

    def with_recovered(self, ranks: Iterable[int]) -> "WorldView":
        up = frozenset(ranks)
        return self._bump(self.alive | up, self.relays - up)


def slow_ranks_from_medians(
    medians: Mapping[int, float],
    factor: Optional[float] = None,
    min_peers: int = 2,
) -> FrozenSet[int]:
    """The slow-rank demotion rule over per-rank step medians.

    A rank is slow when its median step time exceeds ``factor ×`` the
    median of the *other* ranks' medians — each rank is judged against its
    peers, so a uniformly slow world demotes nobody (there is no relay to
    forward through) and one straggler stands out immediately.  Fewer than
    ``min_peers`` peers means no judgement: a 1–2 rank sample cannot
    distinguish a straggler from noise.
    """
    if factor is None:
        factor = slow_rank_factor()
    if factor <= 1.0:
        raise ValueError(f"slow-rank factor must be > 1, got {factor}")
    items = {int(r): float(s) for r, s in medians.items() if s > 0}
    if len(items) <= min_peers:
        return frozenset()
    slow = set()
    for rank, median in items.items():
        peers = [s for r, s in items.items() if r != rank]
        if median > factor * float(np.median(peers)):
            slow.add(rank)
    return frozenset(slow)
