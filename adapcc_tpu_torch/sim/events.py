"""Discrete-event replay of schedule-IR communication rounds (the port of
:mod:`adapcc_tpu.sim.events`).

Replays the same round lists the compiled engine executes
(:meth:`Tree.reduce_rounds` / :meth:`Tree.broadcast_rounds`, relay-pruned
variants from :mod:`adapcc_tpu_torch.comm.relay`, flow-LP lowerings) against a
:class:`~adapcc_tpu_torch.sim.cost_model.LinkCostModel`, producing a predicted
timeline instead of moving bytes.

Modeled resources and constraints:

- **data dependencies** — an edge ``(s → d)`` in round ``r`` starts only
  once ``s`` holds that chunk's data (delivered by earlier rounds; round
  lists are dependency-ordered by construction, ``ir._pack_rounds``);
- **link contention** — transfers sharing a directed link serialize (the
  physical wire is busy);
- **port contention** — a rank sends at most one transfer at a time and
  receives at most one at a time (each ``CommRound`` is a partial
  permutation, so contention arises only *across* rounds, chunks, and
  trees — exactly where the engine's merged-round coloring overlaps work);
- **chunk pipelining** — each tree's payload splits into ``chunk_bytes``
  chunks that flow through the rounds independently (the reference's
  per-chunk recv→reduce→send pipeline, allreduce.cu:628-646), so chunk
  ``c+1`` rides round ``r`` while chunk ``c`` is in round ``r+1``;
- **merged-tree round coloring** — round ``r`` of every tree shares one
  color, mirroring the engine's merged multi-tree executor: parallel trees
  progress in lockstep colors and contend for shared links.

Events are processed color-major / chunk-minor, which is a valid
topological order of the dependency DAG: every transfer's inputs are
already placed when it is priced, so greedy resource assignment yields
consistent (if FIFO-tie-broken) timestamps without a full event queue.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from adapcc_tpu_torch.strategy.ir import CommRound
from adapcc_tpu_torch.sim.cost_model import Link, LinkCostModel


@dataclass(frozen=True)
class Transfer:
    """One simulated point-to-point send."""

    tree: int
    round_idx: int
    chunk: int
    src: int
    dst: int
    nbytes: float
    start: float
    finish: float


@dataclass
class TreeSchedule:
    """One tree's dependency-ordered rounds plus the payload they carry."""

    rounds: List[CommRound]
    nbytes: float
    chunk_bytes: float = 4 * 1024 * 1024
    label: str = ""

    def num_chunks(self) -> int:
        if self.nbytes <= 0 or self.chunk_bytes <= 0:
            return 1
        return max(1, int(-(-self.nbytes // self.chunk_bytes)))


@dataclass
class SimReport:
    """Replay output: makespan + the full transfer timeline.

    At large worlds the per-link map (``link_busy``, O(world) entries per
    timeline) and the per-transfer log are opt-in; ``class_busy`` — busy
    seconds aggregated per ICI/DCN link class, O(#classes) — is the
    always-on accounting surface a 100k-rank ranking can afford to hold
    per candidate.
    """

    makespan: float
    transfers: List[Transfer] = field(default_factory=list)
    link_busy: Dict[Link, float] = field(default_factory=dict)
    #: busy seconds aggregated per link class (always bounded: one entry
    #: per class in use, never per link)
    class_busy: Dict[str, float] = field(default_factory=dict)

    def utilization(self) -> Dict[Link, float]:
        """Busy fraction per directed link over the makespan (empty when
        the replay ran with the per-link map opted out)."""
        if self.makespan <= 0:
            return {link: 0.0 for link in self.link_busy}
        return {
            link: busy / self.makespan for link, busy in self.link_busy.items()
        }

    def class_utilization(self) -> Dict[str, float]:
        """Aggregate busy seconds per link class over the makespan — the
        world-size-independent utilization surface.  Note this sums busy
        time across every link of the class, so values exceed 1.0 as soon
        as the class has concurrent links (it is a parallelism measure,
        not a single-wire fraction)."""
        if self.makespan <= 0:
            return {cls: 0.0 for cls in self.class_busy}
        return {
            cls: busy / self.makespan for cls, busy in self.class_busy.items()
        }

    def bytes_moved(self) -> float:
        return sum(t.nbytes for t in self.transfers)


class EventSimulator:
    """Replays :class:`TreeSchedule` lists against a link cost model."""

    def __init__(
        self,
        cost_model: LinkCostModel,
        keep_transfers: bool = True,
        keep_links: bool = True,
    ):
        self.cost_model = cost_model
        #: large-world rankings don't need the per-transfer log; dropping it
        #: keeps a 1000-tree × 1000-chunk replay in constant memory
        self.keep_transfers = keep_transfers
        #: the per-link busy map is O(world) per report; opting out leaves
        #: only the per-class aggregation in the returned SimReport
        self.keep_links = keep_links

    def run(self, schedules: Sequence[TreeSchedule]) -> SimReport:
        link_free: Dict[Link, float] = {}
        egress_free: Dict[int, float] = {}
        ingress_free: Dict[int, float] = {}
        link_busy: Dict[Link, float] = {}
        transfers: List[Transfer] = []
        makespan = 0.0

        # per (tree, chunk): rank → time at which the rank holds this
        # chunk's current partial value
        ready: List[List[Dict[int, float]]] = [
            [dict() for _ in range(s.num_chunks())] for s in schedules
        ]
        chunk_sizes = [
            s.nbytes / s.num_chunks() if s.num_chunks() else 0.0
            for s in schedules
        ]

        colors = max((len(s.rounds) for s in schedules), default=0)
        for color in range(colors):
            for t, sched in enumerate(schedules):
                if color >= len(sched.rounds):
                    continue
                rnd = sched.rounds[color]
                for chunk in range(sched.num_chunks()):
                    chunk_ready = ready[t][chunk]
                    for src, dst in rnd.edges:
                        start = max(
                            chunk_ready.get(src, 0.0),
                            link_free.get((src, dst), 0.0),
                            egress_free.get(src, 0.0),
                            ingress_free.get(dst, 0.0),
                        )
                        dur = self.cost_model.time_for(
                            src, dst, chunk_sizes[t]
                        )
                        finish = start + dur
                        link_free[(src, dst)] = finish
                        egress_free[src] = finish
                        ingress_free[dst] = finish
                        link_busy[(src, dst)] = (
                            link_busy.get((src, dst), 0.0) + dur
                        )
                        chunk_ready[dst] = max(chunk_ready.get(dst, 0.0), finish)
                        makespan = max(makespan, finish)
                        if self.keep_transfers:
                            transfers.append(
                                Transfer(
                                    tree=t,
                                    round_idx=color,
                                    chunk=chunk,
                                    src=src,
                                    dst=dst,
                                    nbytes=chunk_sizes[t],
                                    start=start,
                                    finish=finish,
                                )
                            )
        class_busy: Dict[str, float] = {}
        for (src, dst), busy in link_busy.items():
            cls = self.cost_model.link_class_of(src, dst)
            class_busy[cls] = class_busy.get(cls, 0.0) + busy
        return SimReport(
            makespan=makespan,
            transfers=transfers,
            link_busy=link_busy if self.keep_links else {},
            class_busy=class_busy,
        )
