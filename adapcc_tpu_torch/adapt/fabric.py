"""Multi-tenant QoS: prioritized jobs sharing one fabric (the port of
:mod:`adapcc_tpu.adapt.fabric`).

The schedule that wins a clean-network benchmark can be the one that starves
a neighbour on a shared link.  This module is the two-job harness that makes
the trade a printed number:

- every :class:`FabricJob` carries a priority (``ADAPCC_JOB_PRIORITY``:
  ``high`` | ``low``, a typo raises), its own
  :class:`~adapcc_tpu_torch.elastic.worldview.WorldView` and
  :class:`~adapcc_tpu_torch.coordinator.logic.CoordinatorLogic`, and its own
  :class:`~adapcc_tpu_torch.strategy.synthesizer.Synthesizer` over the shared
  ip table;
- :meth:`SharedFabric.plan` assigns strategies in priority order, ranking
  each job under a model in which every link a higher-priority job occupies
  is contended by the share penalty (β × penalty), so a low-priority job's
  winner avoids the high-priority job's links instead of fighting for them;
- the :class:`FabricPlan` prices the fairness/throughput frontier: each
  job's steady state under coordinated sharing against the uncoordinated
  baseline (every job takes the clean-network winner), with Jain's fairness
  index and aggregate throughput.  One model gives one frontier row, byte
  for byte.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from adapcc_tpu_torch.sim.cost_model import Link, LinkCostModel, contended_coeffs
from adapcc_tpu_torch.strategy.ir import Strategy, Tree

#: the per-job priority env: which tenant yields on a shared link
JOB_PRIORITY_ENV = "ADAPCC_JOB_PRIORITY"

JOB_PRIORITIES = ("high", "low")

#: the bandwidth penalty each user of a shared link pays (two lockstep
#: collectives on one wire each see half of it)
DEFAULT_SHARE_PENALTY = 2.0


def job_priority(explicit: Optional[str] = None) -> str:
    """``ADAPCC_JOB_PRIORITY`` > ``explicit`` > "high" (an undeclared job
    never yields); a malformed value raises."""
    env = os.environ.get(JOB_PRIORITY_ENV)
    value = env if env is not None and env.strip() else explicit
    if value is None:
        return "high"
    prio = str(value).strip().lower()
    if prio not in JOB_PRIORITIES:
        raise ValueError(f"{JOB_PRIORITY_ENV}={value!r}: expected one of {'|'.join(JOB_PRIORITIES)}")
    return prio


# --------------------------------------------------------------------------- #
# link occupancy
# --------------------------------------------------------------------------- #

def strategy_links(strategy: Strategy) -> FrozenSet[Link]:
    """Every directed link a strategy's trees occupy: reduce runs child →
    parent and broadcast parent → child, so a tree edge claims both."""
    links: set = set()
    for tree in strategy.trees:
        for child, parent in tree.parent.items():
            links.add((parent, child))
            links.add((child, parent))
    return frozenset(links)


def hot_links(strategy: Strategy, model: LinkCostModel, band: float = 0.5) -> FrozenSet[Link]:
    """The strategy's bottleneck links: occupied links whose 1 MiB cost is
    within ``band`` of the dearest occupied link's (where a lockstep
    schedule is paced)."""
    if not 0.0 < band <= 1.0:
        raise ValueError(f"band must be in (0, 1], got {band}")
    links = strategy_links(strategy)
    if not links:
        return frozenset()
    probe = 1 << 20
    cost = {link: model.coeffs(*link).time(probe) for link in links}
    top = max(cost.values())
    return frozenset(link for link, c in cost.items() if c >= band * top)


def contend_links(model: LinkCostModel, links: Sequence[Link], factor: float) -> LinkCostModel:
    """A copy of ``model`` with the named directed links contended by
    ``factor`` (β scaled, α intact), as per-link entries, which every
    pricing pass prefers over class means."""
    if factor < 1.0:
        raise ValueError(f"share factor must be >= 1, got {factor}")
    contended = dict(model.links)
    for link in links:
        contended[link] = contended_coeffs(model.coeffs(*link), factor)
    return LinkCostModel(model.world, links=contended, classes=model.classes, ips=model.ips,
                         source=f"{model.source}+shared[{len(set(links))}links]")


# --------------------------------------------------------------------------- #
# jobs
# --------------------------------------------------------------------------- #

@dataclass
class FabricJob:
    """One tenant: a named job with a priority, its own worldview and
    coordinator logic over the shared topology, and its own synthesizer."""

    name: str
    priority: str = "high"
    nbytes: int = 16 << 20
    degree: int = 1
    worldview: object = None
    coordinator: object = None
    synthesizer: object = None

    def __post_init__(self) -> None:
        if self.priority not in JOB_PRIORITIES:
            raise ValueError(f"job {self.name!r}: unknown priority {self.priority!r}; expected one of "
                             f"{JOB_PRIORITIES}")
        if self.nbytes < 1:
            raise ValueError(f"job {self.name!r}: nbytes must be >= 1")


@dataclass
class JobAssignment:
    """One job's strategy and its priced steady states."""

    job: FabricJob
    label: str
    strategy: Strategy
    #: the steady state on the model it was ranked under
    ranked_s: float
    #: the steady state under the final shared fabric
    shared_s: float = 0.0
    #: the steady state alone on the clean fabric
    alone_s: float = 0.0
    yielded_links: int = 0

    def to_row(self) -> dict:
        return {
            "job": self.job.name,
            "priority": self.job.priority,
            "strategy": self.label,
            "pred_us": round(self.shared_s * 1e6, 3),
            "alone_us": round(self.alone_s * 1e6, 3),
            "slowdown": round(self.shared_s / self.alone_s if self.alone_s > 0 else 1.0, 6),
            "yielded_links": self.yielded_links,
        }


@dataclass
class FabricPlan:
    """The planned fabric: the assignments and the frontier row."""

    assignments: List[JobAssignment]
    share_penalty: float
    coordinated: bool
    #: directed links more than one job's strategy uses
    shared_links: FrozenSet[Link] = frozenset()

    def job(self, name: str) -> JobAssignment:
        for a in self.assignments:
            if a.job.name == name:
                return a
        raise KeyError(f"no job {name!r} in this fabric plan")

    def fairness(self) -> float:
        """Jain's index over the jobs' sharing efficiencies (alone ÷ shared,
        each in (0, 1])."""
        xs = [a.alone_s / a.shared_s if a.shared_s > 0 else 1.0 for a in self.assignments]
        n = len(xs)
        if n == 0:
            return 1.0
        s = sum(xs)
        sq = sum(x * x for x in xs)
        return (s * s) / (n * sq) if sq > 0 else 1.0

    def throughput_gbps(self) -> float:
        """Aggregate throughput in gigabits/s: Σ payload ÷ steady state × 8."""
        return sum(a.job.nbytes * 8.0 / a.shared_s / 1e9 for a in self.assignments if a.shared_s > 0)

    def to_row(self) -> dict:
        return {
            "coordinated": self.coordinated,
            "share_penalty": self.share_penalty,
            "shared_links": len(self.shared_links),
            "fairness": round(self.fairness(), 6),
            "throughput_gbps": round(self.throughput_gbps(), 6),
            "jobs": [a.to_row() for a in self.assignments],
        }


# --------------------------------------------------------------------------- #
# the shared fabric
# --------------------------------------------------------------------------- #

def _priority_order(jobs: Sequence[FabricJob]) -> List[FabricJob]:
    """High first; ties keep registration order."""
    return sorted(jobs, key=lambda j: JOB_PRIORITIES.index(j.priority))


def _rotated_chain(world: int, start: int, ips: Dict[int, str]) -> Strategy:
    """A chain rotated to start at ``start``: the rotation moves which host
    boundary the chain crosses, the freedom a yielding job needs."""
    order = [(start + i) % world for i in range(world)]
    children: Dict[int, List[int]] = {order[i]: [order[i + 1]] for i in range(world - 1)}
    s = Strategy([Tree(order[0], children, ips)], world)
    s.synthesis = f"ring@{start}"
    return s


class SharedFabric:
    """One simulated topology, several prioritized tenants (module doc)."""

    def __init__(self, model: LinkCostModel, ip_table: Sequence[str],
                 share_penalty: float = DEFAULT_SHARE_PENALTY) -> None:
        if len(ip_table) != model.world:
            raise ValueError(f"ip table has {len(ip_table)} entries for a world-{model.world} model")
        if share_penalty < 1.0:
            raise ValueError(f"share_penalty must be >= 1, got {share_penalty}")
        self.ip_table = list(ip_table)
        self.ips = {r: ip for r, ip in enumerate(self.ip_table)}
        self.model = model if model.ips is not None else model.with_ips(self.ips)
        self.share_penalty = float(share_penalty)
        self.jobs: List[FabricJob] = []

    @property
    def world(self) -> int:
        return self.model.world

    def add_job(self, name: str, priority: Optional[str] = None, nbytes: int = 16 << 20,
                degree: int = 1) -> FabricJob:
        """Register a tenant.  An explicit ``priority`` wins; only an unset
        one resolves through :func:`job_priority` (the env is a per-process
        knob, and a harness registering both tenants in one process must not
        have it set both)."""
        from adapcc_tpu_torch.coordinator.logic import CoordinatorLogic
        from adapcc_tpu_torch.elastic.worldview import WorldView
        from adapcc_tpu_torch.strategy.synthesizer import Synthesizer

        if any(j.name == name for j in self.jobs):
            raise ValueError(f"job {name!r} already registered")
        job = FabricJob(
            name=name,
            priority=str(priority).strip().lower() if priority is not None else job_priority(),
            nbytes=int(nbytes),
            degree=max(1, int(degree)),
            worldview=WorldView.full(self.world),
            coordinator=CoordinatorLogic(self.world),
            synthesizer=Synthesizer(None, self.ip_table),
        )
        self.jobs.append(job)
        return job

    def _candidates(self, job: FabricJob) -> List[Tuple[str, Strategy]]:
        """The job's synthesizer's shapes and a chain rotated to each host
        boundary (cross-host edges the other tenants may not occupy)."""
        bw, lat = self.model.to_graphs()
        cands = list(job.synthesizer.candidates(job.degree, bw, lat))
        starts = sorted({r for r in range(self.world) if r == 0 or self.ip_table[r - 1] != self.ip_table[r]})
        for start in starts:
            s = _rotated_chain(self.world, start, self.ips)
            cands.append((s.synthesis, s))
        return cands

    def plan(self, coordinated: bool = True) -> FabricPlan:
        """Assign every job a strategy.  ``coordinated`` ranks each job
        under the higher-priority tenants' occupancy (contended by the share
        penalty); otherwise each takes the clean model's winner."""
        if not self.jobs:
            raise ValueError("no jobs registered on this fabric")
        from adapcc_tpu_torch import sim

        assignments: List[JobAssignment] = []
        occupied: set = set()
        for job in _priority_order(self.jobs):
            if coordinated and occupied:
                ranked_model = contend_links(self.model, sorted(occupied), self.share_penalty)
            else:
                ranked_model = self.model
            ranked = sim.rank_candidates(self._candidates(job), ranked_model, job.nbytes, "allreduce")
            winner = ranked[0]
            assignments.append(JobAssignment(job=job, label=winner.label, strategy=winner.strategy,
                                             ranked_s=winner.seconds,
                                             yielded_links=len(occupied) if coordinated else 0))
            occupied |= strategy_links(winner.strategy)
        # the final shared fabric: each link contended by its user count
        use_count: Dict[Link, int] = {}
        for a in assignments:
            for link in strategy_links(a.strategy):
                use_count[link] = use_count.get(link, 0) + 1
        shared = frozenset(link for link, n in use_count.items() if n > 1)
        shared_model = self.model
        for n_users in sorted({n for n in use_count.values() if n > 1}):
            links = [link for link, n in use_count.items() if n == n_users]
            shared_model = contend_links(shared_model, sorted(links),
                                         1.0 + (self.share_penalty - 1.0) * (n_users - 1))
        for a in assignments:
            a.alone_s = sim.simulate_strategy(a.strategy, self.model, a.job.nbytes, "allreduce",
                                              keep_transfers=False).seconds
            a.shared_s = sim.simulate_strategy(a.strategy, shared_model, a.job.nbytes, "allreduce",
                                               keep_transfers=False).seconds
        return FabricPlan(assignments=assignments, share_penalty=self.share_penalty, coordinated=coordinated,
                          shared_links=shared)

    def frontier(self) -> dict:
        """The fairness/throughput frontier row: the coordinated plan
        against the uncoordinated one."""
        coord = self.plan(coordinated=True)
        unco = self.plan(coordinated=False)
        row = {
            "mode": "simulated",
            "world": self.world,
            "share_penalty": self.share_penalty,
            "coordinated": coord.to_row(),
            "uncoordinated": unco.to_row(),
        }
        highs_c = [a for a in coord.assignments if a.job.priority == "high"]
        highs_u = {a.job.name: a for a in unco.assignments}
        # a fabric with no high-priority tenant makes no claim
        row["high_priority_wins"] = bool(highs_c) and all(
            a.shared_s < highs_u[a.job.name].shared_s or a.shared_s == a.alone_s for a in highs_c)
        return row
