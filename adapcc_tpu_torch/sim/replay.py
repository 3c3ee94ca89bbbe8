"""Lower real engine inputs into simulated timelines (the port of
:mod:`adapcc_tpu.sim.replay`).

The adapters here consume exactly what the execution engine consumes — a
:class:`~adapcc_tpu_torch.strategy.ir.Strategy` (from ParTrees, the MILP solver,
or a parsed ``strategy.xml``), a ``compiler.ScheduleProgram``, an
active-rank set (relay masks from :mod:`adapcc_tpu_torch.comm.relay`) or a
fault plan, a congestion profile or a flow-LP solution — and return
predicted collective latency plus per-link utilization instead of running
the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from adapcc_tpu_torch.comm.relay import prune_broadcast_rounds, prune_reduce_rounds
from adapcc_tpu_torch.sim.cost_model import Link, LinkCostModel
from adapcc_tpu_torch.sim.events import EventSimulator, SimReport, Transfer, TreeSchedule
from adapcc_tpu_torch.sim.vector import lowered_columns, resolve_sim_engine, vector_run
from adapcc_tpu_torch.strategy.ir import CommRound, Strategy, Tree

#: collectives the replay layer knows how to lower from a tree strategy
COLLECTIVES = ("allreduce", "reduce", "broadcast")


@dataclass
class SimTimeline:
    """Predicted execution of one collective under one cost model."""

    seconds: float
    collective: str
    nbytes: float
    world: int
    report: SimReport
    strategy_label: str = ""
    #: stamped into every simulated artifact row so a reader can never
    #: mistake a model prediction for a measured number
    mode: str = "simulated"

    def per_link_utilization(self) -> Dict[Link, float]:
        return self.report.utilization()

    def algbw_gbps(self) -> float:
        """nccl-tests-style algorithm bandwidth for the simulated latency."""
        if self.seconds <= 0:
            return 0.0
        return self.nbytes / self.seconds / 1e9

    def to_row(self) -> dict:
        """One artifact row (the simulated analog of a busbw sweep row)."""
        return {
            "mode": self.mode,
            "collective": self.collective,
            "size_bytes": int(self.nbytes),
            "world": self.world,
            "pred_time_us": round(self.seconds * 1e6, 3),
            "algbw_gbps": round(self.algbw_gbps(), 6),
            "strategy": self.strategy_label,
        }


def _tree_rounds(
    tree: Tree, collective: str, active: Optional[FrozenSet[int]]
) -> List[CommRound]:
    """The same round lists the engine compiles, relay-pruned when a subset
    is active (dead edges carry nothing and are dropped pre-compilation)."""
    if collective == "allreduce":
        if active is None:
            return tree.reduce_rounds() + tree.broadcast_rounds()
        return prune_reduce_rounds(tree, active) + prune_broadcast_rounds(tree, active)
    if collective == "reduce":
        if active is None:
            return tree.reduce_rounds()
        return prune_reduce_rounds(tree, active)
    if collective == "broadcast":
        if active is None:
            return tree.broadcast_rounds()
        return prune_broadcast_rounds(tree, active)
    raise ValueError(
        f"unknown collective {collective!r}; expected one of {COLLECTIVES}"
    )


def lower_strategy(
    strategy: Strategy,
    nbytes: float,
    collective: str = "allreduce",
    active: Optional[Iterable[int]] = None,
) -> List[TreeSchedule]:
    """Strategy → per-tree schedules: payload split by tree shares
    (``1/num_trans`` unless the MILP optimized unequal shares), each tree
    chunked at its own granularity — the solver's per-tree c_m when the
    strategy carries one (``Strategy.chunk_bytes_for_tree``), else the
    global ``chunk_bytes`` — so a skewed share pipelines at a comparable
    depth instead of one oversized chunk."""
    act = frozenset(active) if active is not None else None
    schedules = []
    for i, (tree, share) in enumerate(
        zip(strategy.trees, strategy.tree_shares())
    ):
        schedules.append(
            TreeSchedule(
                rounds=_tree_rounds(tree, collective, act),
                nbytes=nbytes * share,
                chunk_bytes=strategy.chunk_bytes_for_tree(i),
                label=f"tree@{tree.root}",
            )
        )
    return schedules


def simulate_strategy(
    strategy: Strategy,
    cost_model: LinkCostModel,
    nbytes: float,
    collective: str = "allreduce",
    active: Optional[Iterable[int]] = None,
    keep_transfers: bool = True,
    engine: Optional[str] = None,
    keep_links: Optional[bool] = None,
) -> SimTimeline:
    """Predict one collective's latency under the cost model.

    ``active`` prices the relay scenario: inactive ranks stay on the data
    path as forwarders, edges whose source subtree holds no active rank are
    pruned — the same algebra the engine applies before compiling.

    THE replay chokepoint: every pricing path (ranking, fault/congestion
    replays, standby scenarios, benches) funnels through here, and the
    ``engine`` funnel (arg > ``ADAPCC_SIM_ENGINE`` > ``auto``) picks the
    per-transfer event oracle below :data:`~adapcc_tpu_torch.sim.vector.
    VECTOR_MIN_WORLD` ranks and the vectorized column replay above it —
    one pricing engine, parity-pinned, no second implementation to drift.
    ``keep_links`` opts the O(world) per-link busy map in or out (defaults:
    on for the event oracle, off for pod-scale vector replays); the
    vector path never keeps the per-transfer log.
    """
    resolved = resolve_sim_engine(engine, strategy.world_size)
    if resolved == "vector":
        report = vector_run(
            lowered_columns(strategy, collective, active),
            cost_model,
            nbytes,
            keep_links=bool(keep_links),
        )
    else:
        report = EventSimulator(
            cost_model,
            keep_transfers=keep_transfers,
            keep_links=True if keep_links is None else keep_links,
        ).run(lower_strategy(strategy, nbytes, collective, active))
    return SimTimeline(
        seconds=report.makespan,
        collective=collective,
        nbytes=nbytes,
        world=strategy.world_size,
        report=report,
        strategy_label=f"{strategy.synthesis or 'unnamed'} x{strategy.num_trans}",
    )


def simulate_program(
    program,
    cost_model: LinkCostModel,
    nbytes: float,
    keep_transfers: bool = True,
    engine: Optional[str] = None,
    keep_links: Optional[bool] = None,
) -> SimTimeline:
    """Replay a ``compiler.ScheduleProgram`` — the SAME object the engine's
    ``algo="ir"`` dispatch lowers and ``engine.schedule_program()`` returns,
    not a parallel description that can drift from it.

    The IR's rounds are barriers, so the replay is exact, not heuristic:
    per round, sends sharing a directed link serialize (their chunk bytes
    coalesce onto one transfer priced by ``cost_model.time_for``), distinct
    links run concurrently, and the round completes at its slowest link.
    Under a uniform cost model this reproduces
    :func:`~adapcc_tpu_torch.sim.cost_model.schedule_program_time` to the float —
    the cross-check ``tests/test_compiler.py`` pins — while a heterogeneous
    model (degraded links, two-level classes) prices each link at its own
    α/β.

    The same ``engine`` funnel as :func:`simulate_strategy` (arg >
    ``ADAPCC_SIM_ENGINE`` > ``auto``) applies: below
    :data:`~adapcc_tpu_torch.sim.vector.VECTOR_MIN_WORLD` ranks the per-round
    event loop below runs with its per-transfer log; above it the cached
    column replay (``vector.vector_program_run``) prices the program as
    numpy algebra, parity-pinned on the makespan, per-transfer log never
    kept.  ``keep_links`` defaults on for the event path and off for the
    vector path, like ``simulate_strategy``.
    """
    # optimized programs (span steps, fused codecs) replay through their
    # unit-step expansion — same bytes on the same links, and the
    # per-chunk transfer log keeps one chunk per row; the label below
    # stays the ORIGINAL program's name@fingerprint, because that is the
    # object the caller handed in and the engine lowers
    from adapcc_tpu_torch.compiler.verify import normalize_program

    label = f"program:{program.name}@{program.fingerprint()}"
    resolved = resolve_sim_engine(engine, program.world)
    program = normalize_program(program)
    if resolved == "vector":
        from adapcc_tpu_torch.sim.vector import program_columns, vector_program_run

        report = vector_program_run(
            program_columns(program),
            cost_model,
            nbytes,
            keep_links=bool(keep_links),
        )
        return SimTimeline(
            seconds=report.makespan,
            collective=program.collective,
            nbytes=nbytes,
            world=program.world,
            report=report,
            strategy_label=label,
        )
    seg = float(nbytes) / max(1, program.chunks)
    keep_link_busy = True if keep_links is None else bool(keep_links)
    transfers: List[Transfer] = []
    link_busy: Dict[Link, float] = {}
    clock = 0.0
    for round_idx, round_steps in enumerate(program.rounds):
        link_chunks: Dict[Link, List[int]] = {}
        for step in round_steps:
            if step.kind == "send":
                link_chunks.setdefault((step.rank, step.peer), []).append(step.chunk)
        if not link_chunks:
            continue
        round_end = clock
        for (src, dst), chunks in link_chunks.items():
            dur = cost_model.time_for(src, dst, seg * len(chunks))
            if keep_link_busy:
                link_busy[(src, dst)] = link_busy.get((src, dst), 0.0) + dur
            round_end = max(round_end, clock + dur)
            if keep_transfers:
                for chunk in chunks:
                    transfers.append(
                        Transfer(
                            tree=0,
                            round_idx=round_idx,
                            chunk=chunk,
                            src=src,
                            dst=dst,
                            nbytes=seg,
                            start=clock,
                            finish=clock + dur,
                        )
                    )
        clock = round_end
    report = SimReport(makespan=clock, transfers=transfers, link_busy=link_busy)
    return SimTimeline(
        seconds=clock,
        collective=program.collective,
        nbytes=nbytes,
        world=program.world,
        report=report,
        strategy_label=label,
    )


def simulate_reduce(strategy, cost_model, nbytes, **kwargs) -> SimTimeline:
    return simulate_strategy(strategy, cost_model, nbytes, "reduce", **kwargs)


def simulate_broadcast(strategy, cost_model, nbytes, **kwargs) -> SimTimeline:
    return simulate_strategy(strategy, cost_model, nbytes, "broadcast", **kwargs)


def simulate_xml(
    text_or_path: str,
    cost_model: LinkCostModel,
    nbytes: float,
    collective: str = "allreduce",
    **kwargs,
) -> SimTimeline:
    """Simulate a persisted ``strategy.xml`` — the artifact the reference's
    tinyxml2 reader and this repo's engine both consume."""
    from adapcc_tpu_torch.strategy.xml_io import parse_strategy_xml

    return simulate_strategy(
        parse_strategy_xml(text_or_path), cost_model, nbytes, collective, **kwargs
    )


@dataclass
class FaultStepRow:
    """One step of a fault-plan replay: the collective's predicted cost
    under that step's fault state, plus the transition costs stamped on
    the step where the world actually changed."""

    step: int
    epoch: int
    alive: Tuple[int, ...]
    relays: Tuple[int, ...]
    seconds: float
    #: world changed at this step (detection + swap were paid here)
    swapped: bool = False
    detection_s: float = 0.0
    swap_s: float = 0.0
    mode: str = "simulated"

    def to_row(self) -> dict:
        return {
            "mode": self.mode,
            "step": self.step,
            "epoch": self.epoch,
            "alive": list(self.alive),
            "relays": list(self.relays),
            "pred_time_us": round(self.seconds * 1e6, 3),
            "swapped": self.swapped,
            "detection_us": round(self.detection_s * 1e6, 3),
            "swap_us": round(self.swap_s * 1e6, 3),
        }


def simulate_fault_plan(
    strategy: Strategy,
    cost_model: LinkCostModel,
    nbytes: float,
    plan,
    steps: Optional[int] = None,
    collective: str = "allreduce",
    heartbeat_timeout_s: float = 1.0,
    standby_cached: bool = True,
    engine: Optional[str] = None,
) -> List[FaultStepRow]:
    """Replay a :class:`~adapcc_tpu_torch.elastic.faults.FaultPlan` through the
    event simulator: every step's collective is priced under that step's
    fault state — down ranks excluded and their edges relay-pruned, slow
    ranks demoted to relays on a degraded (slowed-link) cost model — and
    each world *transition* is stamped with the detection latency and the
    plan-swap stall from the failover cost terms.

    This is the CPU-exercisable twin of the live failover loop: the same
    plan injected at the coordinator funnel produces the same epochs, and
    these rows price what each epoch costs.  Deterministic — same plan,
    same calibration → byte-identical rows.
    """
    from adapcc_tpu_torch.sim.cost_model import (
        detection_latency_s,
        plan_swap_stall_s,
    )

    if plan.world != strategy.world_size:
        raise ValueError(
            f"fault plan world {plan.world} != strategy world "
            f"{strategy.world_size}"
        )
    n_steps = steps if steps is not None else plan.last_step() + 2
    rows: List[FaultStepRow] = []
    prev_state = None
    epoch = 0
    healthy_s: Optional[float] = None
    for step in range(n_steps):
        state = plan.state_at(step)
        slow = state.slow_map
        model = cost_model
        for rank, slowdown in sorted(slow.items()):
            model = model.degraded([rank], slowdown)
        contributing = sorted(
            set(range(plan.world)) - state.down - set(slow)
        ) or sorted(set(range(plan.world)) - state.down)
        active = None if state.healthy else contributing
        seconds = simulate_strategy(
            strategy, model, nbytes, collective, active=active,
            keep_transfers=False, engine=engine,
        ).seconds
        if healthy_s is None and state.healthy:
            healthy_s = seconds
        # a plan whose FIRST event lands at step 0 is still a transition
        # (from the implicit healthy world before training): its detection
        # + swap costs must be stamped, not silently dropped
        swapped = (
            state != prev_state
            if prev_state is not None
            else not state.healthy
        )
        rows.append(
            FaultStepRow(
                step=step,
                epoch=(epoch := epoch + 1) if swapped else epoch,
                alive=tuple(sorted(set(range(plan.world)) - state.down)),
                relays=tuple(sorted(slow)),
                seconds=seconds,
                swapped=swapped,
                detection_s=(
                    detection_latency_s(heartbeat_timeout_s, healthy_s or 0.0)
                    if swapped else 0.0
                ),
                swap_s=plan_swap_stall_s(standby_cached) if swapped else 0.0,
            )
        )
        prev_state = state
    return rows


@dataclass
class CongestionStepRow:
    """One step of a congestion-profile replay: the collective's predicted
    cost under that step's contended link classes, beside the healthy
    price."""

    step: int
    congested: bool
    factors: Tuple[Tuple[str, float], ...]  # sorted (class, factor) pairs
    seconds: float
    healthy_s: float
    mode: str = "simulated"

    @property
    def contention_ratio(self) -> float:
        return self.seconds / self.healthy_s if self.healthy_s > 0 else 1.0

    def to_row(self) -> dict:
        return {
            "mode": self.mode,
            "step": self.step,
            "congested": self.congested,
            "factors": {cls: f for cls, f in self.factors},
            "pred_time_us": round(self.seconds * 1e6, 3),
            "healthy_us": round(self.healthy_s * 1e6, 3),
            "contention_ratio": round(self.contention_ratio, 6),
        }


def simulate_congestion_profile(
    strategy: Strategy,
    cost_model: LinkCostModel,
    nbytes: float,
    profile,
    steps: Optional[int] = None,
    collective: str = "allreduce",
    engine: Optional[str] = None,
) -> List[CongestionStepRow]:
    """Replay a :class:`~adapcc_tpu_torch.sim.congestion.CongestionProfile`:
    every step's collective priced under that step's contended model (β
    scaled on each active window's class), beside the healthy price.  What
    each window costs a strategy that did not re-route; one replay a
    distinct set of factors."""
    if profile.world != strategy.world_size:
        raise ValueError(f"congestion profile world {profile.world} != strategy world {strategy.world_size}")
    n_steps = steps if steps is not None else profile.last_step() + 1
    healthy_s = simulate_strategy(strategy, cost_model, nbytes, collective, keep_transfers=False,
                                  engine=engine).seconds
    rows: List[CongestionStepRow] = []
    priced: Dict[Tuple[Tuple[str, float], ...], float] = {(): healthy_s}
    for step in range(n_steps):
        factors = profile.factors_at(step)
        fkey = tuple(sorted(factors.items()))
        seconds = priced.get(fkey)
        if seconds is None:
            seconds = simulate_strategy(strategy, cost_model.contended(factors), nbytes, collective,
                                        keep_transfers=False, engine=engine).seconds
            priced[fkey] = seconds
        rows.append(CongestionStepRow(step=step, congested=bool(factors), factors=fkey, seconds=seconds,
                                      healthy_s=healthy_s))
    return rows


def simulate_flow_broadcast(flow, cost_model: LinkCostModel, nbytes: float) -> SimTimeline:
    """Replay a :class:`~adapcc_tpu_torch.strategy.flow_lp.FlowSolution`.

    Each LP round's edge carries ``fraction × nbytes``; store-and-forward
    readiness replaces the tree order: a node forwards in round ``r`` only
    once earlier rounds delivered it the whole payload."""
    ready: Dict[int, float] = {flow.source: 0.0}
    link_free: Dict[Link, float] = {}
    egress_free: Dict[int, float] = {}
    ingress_free: Dict[int, float] = {}
    link_busy: Dict[Link, float] = {}
    transfers: List[Transfer] = []
    makespan = 0.0
    recv_frac: Dict[int, float] = {}   # cumulative payload fraction received
    recv_last: Dict[int, float] = {}   # latest counted arrival per node
    for r, flows in enumerate(flow.rounds):
        # heavier flows first within a round (FlowSolution.comm_rounds' order)
        landed: List[Tuple[int, float, float]] = []
        for (src, dst), frac in sorted(flows.items(), key=lambda kv: -kv[1]):
            if src not in ready:
                # an alternate optimum's flow from a node holding nothing
                continue
            start = max(ready[src], link_free.get((src, dst), 0.0), egress_free.get(src, 0.0),
                        ingress_free.get(dst, 0.0))
            dur = cost_model.time_for(src, dst, frac * nbytes)
            finish = start + dur
            link_free[(src, dst)] = finish
            egress_free[src] = finish
            ingress_free[dst] = finish
            link_busy[(src, dst)] = link_busy.get((src, dst), 0.0) + dur
            landed.append((dst, frac, finish))
            makespan = max(makespan, finish)
            transfers.append(Transfer(tree=0, round_idx=r, chunk=0, src=src, dst=dst, nbytes=frac * nbytes,
                                      start=start, finish=finish))
        # deliveries count for the next round; a node is ready once its
        # receipts cover the payload, and a node already holding it is never
        # delayed by a redundant delivery
        for dst, frac, t in landed:
            if dst in ready:
                continue
            recv_frac[dst] = recv_frac.get(dst, 0.0) + frac
            recv_last[dst] = max(recv_last.get(dst, 0.0), t)
            if recv_frac[dst] >= 1.0 - 1e-9:
                ready[dst] = recv_last[dst]
    report = SimReport(makespan=makespan, transfers=transfers, link_busy=link_busy)
    return SimTimeline(seconds=report.makespan, collective="broadcast", nbytes=nbytes, world=flow.num_nodes,
                       report=report, strategy_label="flow-lp")
