"""Standby plan cache: prepared degraded plans for hot failover (the port of
:mod:`adapcc_tpu.elastic.standby`).

For every plausible world shrink (each one-rank-down, each one-host-down) a
strategy is re-emitted over the alive subset (dead ranks pushed to prunable
leaf tails: relay masks are already in the IR), the candidate shapes are
sim-ranked on the calibrated α-β replay, and the top-k winners are warmed on
the live engine: one throwaway zeros dispatch a plan fills the engine's
prepared-plan cache (its round tables, segment sizes and pad values) under
the plan's key, so when the coordinator's WorldView shrinks the swap is a
dispatch-time cache-key switch (``cache_hit: true`` in the trace), not a
cold derivation.  Where the JAX package compiles a program, the port derives
host-side tables; the protocol is the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy, Tree


def degraded_scenarios(
    world: int,
    ips: Optional[Mapping[int, str]] = None,
    include_hosts: bool = True,
) -> List[Tuple[str, FrozenSet[int]]]:
    """The shrink shapes worth pre-compiling: every one-rank-down subset,
    plus (multi-host worlds) every one-host-down subset — the preemptible-
    pod failure units.  Labels are stable and deterministic."""
    if world < 2:
        return []
    everyone = frozenset(range(world))
    out: List[Tuple[str, FrozenSet[int]]] = [
        (f"rank{r}-down", everyone - {r}) for r in range(world)
    ]
    if include_hosts and ips:
        hosts: Dict[str, set] = {}
        for r in range(world):
            hosts.setdefault(ips.get(r, ""), set()).add(r)
        if len(hosts) > 1:
            for host, ranks in sorted(hosts.items()):
                if len(ranks) < world:  # never the whole world
                    out.append((f"host[{host}]-down", everyone - ranks))
    # the one-rank scenarios subsume single-rank hosts; dedup by subset
    seen: Dict[FrozenSet[int], str] = {}
    deduped = []
    for label, active in out:
        if active not in seen:
            seen[active] = label
            deduped.append((label, active))
    return deduped


def reemit_for_active(
    world: int,
    active: Iterable[int],
    ips: Optional[Mapping[int, str]] = None,
    num_trans: int = 1,
    shape: str = "ring",
    like: Optional[Strategy] = None,
) -> Strategy:
    """Re-emit a strategy over the alive subset.

    The IR requires trees to span the full world (relay masks are runtime
    state), so "over the alive subset" means: alive ranks form the working
    chain/heap, dead ranks hang off the tail as prunable leaf subtrees —
    :func:`adapcc_tpu_torch.comm.relay.prune_reduce_rounds` then drops every
    dead edge, and the simulated replay prices exactly the alive-only
    schedule.  Roots rotate over ALIVE ranks only: a dead root could never
    source a broadcast (the engine rejects that loudly).

    ``like`` carries the incumbent strategy's data-plane settings —
    synthesized ``chunk_bytes`` and ``wire_dtype`` — into the degraded
    plan: a failover must not silently downgrade the wire format or reset
    the ring granularity during exactly the window the fabric is already
    degraded.
    """
    act = sorted(set(int(r) for r in active))
    if not act:
        raise ValueError("cannot re-emit a strategy for an empty active set")
    bad = [r for r in act if not 0 <= r < world]
    if bad:
        raise ValueError(f"active ranks {bad} outside world [0, {world})")
    dead = [r for r in range(world) if r not in act]
    ips = dict(ips or {})
    trees: List[Tree] = []
    n = len(act)
    for t in range(max(1, num_trans)):
        order = [act[(t + i) % n] for i in range(n)] + dead
        children: Dict[int, List[int]] = {}
        if shape == "ring":
            for i in range(len(order) - 1):
                children[order[i]] = [order[i + 1]]
        elif shape == "binary":
            for i in range(len(order)):
                kids = [order[j] for j in (2 * i + 1, 2 * i + 2) if j < len(order)]
                if kids:
                    children[order[i]] = kids
        else:
            raise ValueError(f"unknown degraded shape {shape!r}")
        trees.append(Tree(order[0], children, ips))
    out = Strategy(
        trees, world, synthesis=f"degraded-{shape}", shares=None
    )
    if like is not None:
        out.chunk_bytes = like.chunk_bytes
        out.wire_dtype = like.wire_dtype
    return out


@dataclass
class StandbyPlan:
    """One pre-ranked degraded plan: the strategy to swap to when the
    world shrinks to ``active``."""

    label: str
    active: FrozenSet[int]
    strategy: Strategy
    predicted_s: float
    #: whether the engine's prepared-plan cache was pre-populated
    warmed: bool = False

    def to_row(self) -> dict:
        return {
            "label": self.label,
            "active": sorted(self.active),
            "strategy": self.strategy.synthesis,
            "pred_time_us": round(self.predicted_s * 1e6, 3),
            "warmed": self.warmed,
        }


class StandbyPlanCache:
    """Epoch-keyed standby plans over one :class:`CollectiveEngine`.

    Lifecycle::

        cache = StandbyPlanCache(engine, nbytes=grad_bytes)
        cache.build()                      # sim-rank every shrink scenario
        cache.warm(shape, dtype)           # prepare the top-k plans
        ...
        plan, epoch = cache.activate(worldview.alive)   # dispatch-time swap
        ...
        epoch = cache.restore_full()       # recovery: back to the base plan

    ``activate`` looks the alive set up in the cache; a hit swaps the
    engine's strategy under a fresh epoch with the prepared plans already
    warm.  A miss (an unanticipated multi-failure shape) re-emits on the
    spot — correct, but a cold derivation at the first dispatch, which the
    plan row records as ``warmed=False`` so the stall is attributable.

    ``device`` is where :meth:`warm` makes its zeros: the caller's, else the
    card (without CUDA and without a device, warming raises).
    """

    def __init__(
        self,
        engine,
        nbytes: float = 16 * 1024 * 1024,
        top_k: int = 4,
        cost_model=None,
        num_trans: Optional[int] = None,
        shapes: Sequence[str] = ("ring", "binary"),
        include_hosts: bool = True,
        sim_engine: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.engine = engine
        self.nbytes = float(nbytes)
        self.top_k = top_k
        self.shapes = tuple(shapes)
        self.include_hosts = include_hosts
        self.device = device
        #: replay engine for the scenario sweep (None → arg/env/auto funnel).
        #: ``build()`` prices O(world) scenarios × shapes; at large worlds
        #: the vectorized path's fingerprint-keyed column cache turns the
        #: sweep's repeated masks into re-prices
        self.sim_engine = sim_engine
        self.num_trans = (
            num_trans if num_trans is not None else engine.strategy.num_trans
        )
        if cost_model is None:
            from adapcc_tpu_torch.sim.calibrate import load_or_default

            cost_model = load_or_default(world=engine.world_size)
        self._ips = dict(engine.strategy.trees[0].ips or {})
        if cost_model.ips is None and self._ips:
            cost_model = cost_model.with_ips(self._ips)
        self.cost_model = cost_model
        #: base (full-world) strategy to restore on recovery
        self.base_strategy = engine.strategy
        self.plans: Dict[FrozenSet[int], StandbyPlan] = {}
        #: full-world CANDIDATE strategies warmed for the online
        #: re-adaptation loop, keyed by strategy
        #: fingerprint — the shrink plans above key by alive subset, but a
        #: re-ranked challenger keeps the whole world and only changes shape
        self.adaptive: Dict[str, StandbyPlan] = {}

    # -- construction ----------------------------------------------------------

    def _best_for(self, label: str, active: FrozenSet[int]) -> StandbyPlan:
        """Sim-rank the re-emitted candidate shapes for one shrink scenario
        on the degraded replay (dead edges pruned) and keep the fastest;
        ties break by shape order so "ring" survives a prediction-identical
        alternative (no plan churn for nothing)."""
        from adapcc_tpu_torch.sim.rank import relay_latency

        world = self.engine.world_size
        best: Optional[StandbyPlan] = None
        for shape in self.shapes:
            strategy = reemit_for_active(
                world, active, self._ips, self.num_trans, shape,
                like=self.base_strategy,
            )
            seconds = relay_latency(
                strategy, self.cost_model, self.nbytes, sorted(active),
                engine=self.sim_engine,
            )
            if best is None or seconds < best.predicted_s:
                best = StandbyPlan(label, active, strategy, seconds)
        assert best is not None  # self.shapes is never empty
        return best

    def build(self) -> List[StandbyPlan]:
        """Re-emit + sim-rank every shrink scenario; returns the plans
        fastest-first (the warm order)."""
        self.plans = {}
        for label, active in degraded_scenarios(
            self.engine.world_size, self._ips, self.include_hosts
        ):
            self.plans[active] = self._best_for(label, active)
        return self.ranked()

    def ranked(self) -> List[StandbyPlan]:
        return sorted(
            self.plans.values(), key=lambda p: (p.predicted_s, p.label)
        )

    # -- warming ---------------------------------------------------------------

    def _zeros(self, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros((self.engine.world_size,) + tuple(shape), dtype=dtype,
                           device=resolve_device(self.device))

    def _dispatch(self, primitives: Sequence[str], zeros: torch.Tensor, active: FrozenSet[int],
                  op: Optional[ReduceOp]) -> None:
        """One throwaway dispatch a primitive; ``op`` (None: each
        primitive's default) goes to the primitives that take one, since
        the op is part of a prepared plan's key."""
        for prim in primitives:
            kw = {"op": op} if op is not None and prim in ("all_reduce", "reduce") else {}
            getattr(self.engine, prim)(zeros, active_gpus=sorted(active), **kw)

    def warm(
        self,
        shape: Tuple[int, ...],
        dtype: torch.dtype = torch.float32,
        primitives: Sequence[str] = ("all_reduce",),
        top_k: Optional[int] = None,
        op: Optional[ReduceOp] = None,
    ) -> List[StandbyPlan]:
        """Prepare the top-k plans for a ``[world, *shape]`` payload: one
        throwaway zeros dispatch per (plan, primitive) under the temporarily
        swapped strategy fills the engine's prepared-plan cache under the
        standby fingerprint, and the engine's strategy is restored in a
        ``finally``.  After this a real failover's first dispatch is a cache
        hit (``cache_hit: true`` in the dispatch trace) when it has the
        warmed shape, dtype and ``op`` (the JAX package's warm takes no op:
        its primitives' default, SUM)."""
        if not self.plans:
            self.build()
        k = top_k if top_k is not None else self.top_k
        warmed = []
        engine = self.engine
        zeros = self._zeros(shape, dtype)
        for plan in self.ranked()[:k]:
            saved = engine.strategy
            engine.strategy = plan.strategy
            try:
                self._dispatch(primitives, zeros, plan.active, op)
            finally:
                engine.strategy = saved
            plan.warmed = True
            warmed.append(plan)
        return warmed

    def warm_strategy(
        self,
        strategy: Strategy,
        shape: Tuple[int, ...],
        dtype: torch.dtype = torch.float32,
        primitives: Sequence[str] = ("all_reduce",),
        label: Optional[str] = None,
        predicted_s: float = 0.0,
        op: Optional[ReduceOp] = None,
    ) -> StandbyPlan:
        """Prepare a full-world CANDIDATE strategy — the online re-adaptation
        half of this cache.

        Same temporary-swap warm as :meth:`warm`, but for an arbitrary
        re-ranked strategy instead of a shrink scenario: one throwaway
        zeros dispatch per primitive fills the engine's prepared-plan cache
        under the candidate's fingerprint, so a later :meth:`adopt` is a
        dispatch-time cache-key switch (``cache_hit: true`` on the first
        post-swap dispatch).  ``predicted_s`` records the sim-ranked steady
        state that nominated the candidate.
        """
        engine = self.engine
        if strategy.world_size != engine.world_size:
            raise ValueError(
                f"candidate strategy world {strategy.world_size} != engine "
                f"world {engine.world_size}"
            )
        active = frozenset(range(engine.world_size))
        plan = StandbyPlan(
            label or f"adapt-{strategy.fingerprint()[:8]}",
            active,
            strategy,
            float(predicted_s),
        )
        zeros = self._zeros(shape, dtype)
        saved = engine.strategy
        engine.strategy = strategy
        try:
            self._dispatch(primitives, zeros, active, op)
        finally:
            engine.strategy = saved
        plan.warmed = True
        self.adaptive[strategy.fingerprint()] = plan
        return plan

    def warm_leader_alternatives(
        self,
        shape: Tuple[int, ...],
        dtype: torch.dtype = torch.float32,
        primitives: Sequence[str] = ("all_reduce",),
    ) -> List[StandbyPlan]:
        """Per-LEVEL standby plans: when the engine's strategy is a composed
        two-level plan, prepare the composed plan for every leader schedule
        the inter-host level could re-solve to — so a drift-localized leader
        swap (:func:`adapcc_tpu_torch.strategy.hierarchy.resolve_leader_level`)
        is a dispatch-time cache hit even when it lands on the schedule the
        healthy solve did NOT pick.  The pod level is shared by
        construction (the variants differ only across leaders).  No-op on
        engines without a composed plan."""
        from adapcc_tpu_torch.strategy.hierarchy import (
            LEADER_ALGOS,
            leader_variant,
            plan_of,
        )

        plan = plan_of(self.engine.strategy)
        if plan is None:
            return []
        warmed: List[StandbyPlan] = []
        for algo in LEADER_ALGOS:
            if algo == plan.leader_algo:
                continue  # the incumbent's own program is already live
            variant = leader_variant(plan, algo)
            warmed.append(
                self.warm_strategy(
                    variant.strategy,
                    shape,
                    dtype,
                    primitives,
                    label=f"leader-{algo}",
                )
            )
        return warmed

    def adopt(self, strategy: Strategy) -> int:
        """Hot-swap the engine onto a candidate strategy under a fresh
        epoch (the adoption half of :meth:`warm_strategy`): one
        ``advance_epoch`` call — prepared plans stay cached under their
        fingerprints, so a warmed candidate's first dispatch replays warm.
        Returns the new epoch."""
        return self.engine.advance_epoch(strategy)

    # -- failover --------------------------------------------------------------

    def plan_for(self, active: Iterable[int]) -> StandbyPlan:
        key = frozenset(int(r) for r in active)
        hit = self.plans.get(key)
        if hit is not None:
            return hit
        # unanticipated shrink shape (multi-failure): re-emit on the spot —
        # correct but cold; the plan row says so
        plan = self._best_for(f"adhoc-{sorted(key)}", key)
        self.plans[key] = plan
        return plan

    def activate(self, active: Iterable[int]) -> Tuple[StandbyPlan, int]:
        """Swap the engine to the plan for ``active`` under a fresh epoch.
        Returns ``(plan, epoch)``; collectives in flight against the old
        epoch raise :class:`~adapcc_tpu_torch.comm.engine.EpochMismatch` and
        retry at the Communicator layer."""
        plan = self.plan_for(active)
        epoch = self.engine.advance_epoch(plan.strategy)
        return plan, epoch

    def restore_full(self) -> int:
        """Recovery: swap back to the base full-world strategy (its
        prepared plans never left the cache) under a fresh epoch."""
        return self.engine.advance_epoch(self.base_strategy)
