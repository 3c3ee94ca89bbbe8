"""Strategy ranking and degradation prediction on the simulated timeline.

The port of :mod:`adapcc_tpu.sim.rank`.  The synthesizer picks a schedule
before any collective runs on it, so candidates are ranked on the calibrated
α-β replay (the TACCL / SCCL offline-ranking move, on this package's
strategy IR).

Two prediction surfaces ride along:

- :func:`relay_latency` — the collective's cost under a relay mask (inactive
  ranks demoted to forwarders, dead edges pruned).  Shrinking the active set
  prunes a *subset* of edges, so predicted latency is monotonically
  non-increasing in mask size — the property the relay controller relies on
  when it decides that demoting a straggler can only help the collective.
- :func:`predict_degradation` — the straggler scenario: links touching slow
  ranks stretched by a slowdown factor, reported as a ratio to the healthy
  baseline.  The rent-or-buy coordinator compares this against the relay
  speed-up to choose demote-vs-wait.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple, Union

from adapcc_tpu_torch.sim.cost_model import (
    LinkCostModel,
    collective_lower_bound,
    optimality_gap,
)
from adapcc_tpu_torch.sim.replay import SimTimeline, simulate_strategy
from adapcc_tpu_torch.strategy.ir import Strategy

#: a candidate is a Strategy, a (label, Strategy) pair, or a (label,
#: SimTimeline) pair for schedules simulated through another adapter
#: (e.g. a flow-LP lowering)
Candidate = Union[Strategy, Tuple[str, Strategy], Tuple[str, SimTimeline]]


@dataclass
class RankedCandidate:
    label: str
    seconds: float
    strategy: Optional[Strategy]
    timeline: SimTimeline
    #: certified topology floor for this (collective, payload, participant
    #: set) and the candidate's distance above it — ``seconds/LB − 1``,
    #: non-negative whenever the bound holds (regression-pinned)
    lower_bound_s: Optional[float] = None
    optimality_gap: Optional[float] = None

    def to_row(self) -> dict:
        row = self.timeline.to_row()
        row["label"] = self.label
        if self.optimality_gap is not None:
            row["optimality_gap"] = round(self.optimality_gap, 6)
            row["lower_bound_us"] = round((self.lower_bound_s or 0.0) * 1e6, 3)
        return row


def _as_labeled(item: Candidate, index: int) -> Tuple[str, object]:
    if isinstance(item, Strategy):
        return f"{item.synthesis or 'candidate'}#{index}", item
    label, obj = item
    return label, obj


def rank_candidates(
    candidates: Sequence[Candidate],
    cost_model: LinkCostModel,
    nbytes: float,
    collective: str = "allreduce",
    active: Optional[Iterable[int]] = None,
    engine: Optional[str] = None,
) -> List[RankedCandidate]:
    """Simulate every candidate and return them fastest-first, each
    stamped with its certified ``optimality_gap`` against the topology's
    latency+bandwidth lower bound (SCCL's certification move: the ranking
    says how far from *optimal* the winner is, not just that it beat the
    pool).

    Ties break by input order (stable sort), so a caller listing its
    incumbent first keeps it on a tie — re-synthesis must not churn the
    compiled-program cache for a prediction-identical alternative.
    """
    if not candidates:
        raise ValueError("need at least one candidate to rank")
    active_list = list(active) if active is not None else None
    lower_cache: dict = {}
    out: List[RankedCandidate] = []
    for i, item in enumerate(candidates):
        label, obj = _as_labeled(item, i)
        if isinstance(obj, SimTimeline):
            timeline, strategy = obj, None
        else:
            timeline = simulate_strategy(
                obj, cost_model, nbytes, collective, active=active_list,
                keep_transfers=False, engine=engine,
            )
            strategy = obj
        # relay masks shrink the participant set: the floor certifies the
        # collective actually priced (p = |active|), not the full world
        p_eff = len(active_list) if active_list is not None else timeline.world
        lower = lower_cache.get(p_eff)
        if lower is None:
            lower = collective_lower_bound(
                cost_model, nbytes, collective, world=p_eff
            )
            lower_cache[p_eff] = lower
        out.append(
            RankedCandidate(
                label=label,
                seconds=timeline.seconds,
                strategy=strategy,
                timeline=timeline,
                lower_bound_s=lower,
                optimality_gap=optimality_gap(timeline.seconds, lower),
            )
        )
    out.sort(key=lambda c: c.seconds)
    return out


def relay_latency(
    strategy: Strategy,
    cost_model: LinkCostModel,
    nbytes: float,
    active: Iterable[int],
    collective: str = "allreduce",
    engine: Optional[str] = None,
) -> float:
    """Predicted latency with only ``active`` ranks contributing (everyone
    else a forwarding relay; dead edges pruned as the engine prunes them)."""
    return simulate_strategy(
        strategy, cost_model, nbytes, collective, active=active,
        keep_transfers=False, engine=engine,
    ).seconds


@dataclass
class DegradationReport:
    """Healthy vs degraded prediction for one straggler scenario."""

    healthy_seconds: float
    degraded_seconds: float
    #: latency with the slow ranks demoted to relays under the SAME degraded
    #: links — what the relay controller would actually run
    relay_seconds: float
    slow_ranks: Tuple[int, ...]
    slowdown: float

    @property
    def ratio(self) -> float:
        """Degraded / healthy; ≥ 1 by construction (slowdown ≥ 1)."""
        if self.healthy_seconds <= 0:
            return 1.0
        return self.degraded_seconds / self.healthy_seconds

    @property
    def relay_gain(self) -> float:
        """Degraded / relay-masked: >1 means demoting the stragglers is
        predicted to pay."""
        if self.relay_seconds <= 0:
            return 1.0
        return self.degraded_seconds / self.relay_seconds


def predict_degradation(
    strategy: Strategy,
    cost_model: LinkCostModel,
    nbytes: float,
    slow_ranks: Sequence[int],
    slowdown: float = 4.0,
    collective: str = "allreduce",
    engine: Optional[str] = None,
) -> DegradationReport:
    """Price a straggler scenario: every link touching a slow rank is
    ``slowdown``× more expensive.  Returns healthy, degraded, and
    degraded-with-relay-mask predictions — the three numbers the rent-or-buy
    decision needs."""
    degraded_model = cost_model.degraded(slow_ranks, slowdown)
    healthy = simulate_strategy(
        strategy, cost_model, nbytes, collective, keep_transfers=False,
        engine=engine,
    ).seconds
    degraded = simulate_strategy(
        strategy, degraded_model, nbytes, collective, keep_transfers=False,
        engine=engine,
    ).seconds
    active = sorted(set(range(strategy.world_size)) - set(slow_ranks))
    relay = simulate_strategy(
        strategy, degraded_model, nbytes, collective, active=active,
        keep_transfers=False, engine=engine,
    ).seconds
    return DegradationReport(
        healthy_seconds=healthy,
        degraded_seconds=degraded,
        relay_seconds=relay,
        slow_ranks=tuple(slow_ranks),
        slowdown=slowdown,
    )
