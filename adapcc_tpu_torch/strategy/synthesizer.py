"""Strategy synthesizer: the policy switch over ParTrees and the fixed shapes.

The port of :mod:`adapcc_tpu.strategy.synthesizer`, which mirrors the
reference's policy dispatch (gurobi/synthesizer.py:44-62): the default
heuristic is ParTrees; ``milp`` is the exact formulation
(:mod:`adapcc_tpu_torch.strategy.solver`); ``ring`` and ``binary`` are fixed
shapes that need no profile; ``hier`` synthesizes the two-level plan of a
multi-host world (:mod:`adapcc_tpu_torch.strategy.hierarchy`); ``sim-rank``
synthesizes every cheap candidate (ParTrees, ring, binary) and commits to the
one the calibrated α-β replay (:mod:`adapcc_tpu_torch.sim`) predicts fastest,
with the wire codec priced on its bottleneck link.  :meth:`Synthesizer.
resynthesize` re-runs that ranking online under a corrected model.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.strategy.partrees import ParTrees
from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml


class Synthesizer:
    """Generates a communication strategy from profiled lat/bw matrices."""

    def __init__(self, strategy_file: Optional[str], ip_table: Sequence[str], policy: str = "par-trees"):
        self.strategy_file = strategy_file
        self.ip_table = list(ip_table)
        self.policy = policy

    def generate_strategy(
        self,
        prim: int,
        parallel_degree: int,
        transmission_size: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
        local_rank0_list: Optional[Sequence[int]] = None,
    ) -> int:
        """Synthesize + persist the strategy XML; returns chunk bytes.

        The persisted ``chunk_bytes`` is clamped to the transmission size it
        pipelines (a chunk larger than the payload is just the payload); the
        XML carries it, so the artifact alone determines execution."""
        strategy = self.synthesize(
            prim, parallel_degree, transmission_size, bandwidth_graph, latency_graph, local_rank0_list
        )
        if transmission_size and transmission_size > 0:
            strategy.chunk_bytes = max(1, min(strategy.chunk_bytes, int(transmission_size)))
        if self.strategy_file:
            emit_strategy_xml(strategy, self.strategy_file)
        return strategy.chunk_bytes

    def synthesize(
        self,
        prim: int,
        parallel_degree: int,
        transmission_size: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
        local_rank0_list: Optional[Sequence[int]] = None,
    ) -> Strategy:
        world = len(self.ip_table)
        if local_rank0_list is None:
            local_rank0_list = _infer_local_rank0s(self.ip_table)

        if self.policy == "par-trees":
            return ParTrees().synthesize(
                self.ip_table, local_rank0_list, parallel_degree, bandwidth_graph, latency_graph
            )
        if self.policy == "milp":
            from adapcc_tpu_torch.strategy.solver import MilpSolver

            return MilpSolver().synthesize(
                self.ip_table, local_rank0_list, prim, parallel_degree, transmission_size,
                bandwidth_graph, latency_graph,
            )
        if self.policy == "sim-rank":
            return self._sim_ranked(prim, parallel_degree, transmission_size, bandwidth_graph, latency_graph,
                                    local_rank0_list)
        if self.policy == "hier":
            return self._hierarchical(parallel_degree, transmission_size, bandwidth_graph, latency_graph)
        ips = {r: ip for r, ip in enumerate(self.ip_table)}
        if self.policy == "ring":
            s = Strategy.ring(world, max(1, parallel_degree), ips)
        elif self.policy == "binary":
            s = Strategy.binary(world, max(1, parallel_degree), ips)
        else:
            raise ValueError(f"unknown synthesis policy {self.policy!r}")
        s.synthesis = self.policy
        return s

    def _hierarchical(self, parallel_degree: int, transmission_size: int, bandwidth_graph,
                      latency_graph) -> Strategy:
        """The ``hier`` policy: the sketch from the ip table
        (``ADAPCC_HIER_SKETCH`` overrides, malformed → loud), each level
        solved against its link class's α-β costs, the two-level plan
        composed.  A flat (single-pod) world raises: a flat shape under the
        ``hier`` label would be a lie."""
        from adapcc_tpu_torch.strategy import hierarchy

        world = len(self.ip_table)
        sketch = hierarchy.resolve_sketch(world, self.ip_table)
        if sketch is None:
            raise ValueError(
                f"policy 'hier' needs a multi-pod hierarchy, but the {world}-rank ip table resolves to a single "
                f"pod / flat world; use a flat policy, or pin {hierarchy.HIER_SKETCH_ENV}"
            )
        usable = bandwidth_graph is not None and latency_graph is not None and len(bandwidth_graph) == world
        model = hierarchy.model_from_graphs(
            sketch, bandwidth_graph if usable else None, latency_graph if usable else None,
        )
        nbytes = transmission_size if transmission_size and transmission_size > 0 else DEFAULT_CHUNK_BYTES
        plan = hierarchy.synthesize_two_level(sketch, model, nbytes=nbytes, num_trans=max(1, parallel_degree))
        return plan.strategy

    # -- the simulated ranking pass --------------------------------------------

    def candidates(
        self,
        parallel_degree: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
        local_rank0_list: Optional[Sequence[int]] = None,
    ) -> List[Tuple[str, Strategy]]:
        """Every cheap candidate shape, ParTrees first so a predicted tie
        keeps the default heuristic.  A ParTrees failure (a degenerate
        topology) leaves the fixed shapes to compete and says so on
        stderr."""
        world = len(self.ip_table)
        if local_rank0_list is None:
            local_rank0_list = _infer_local_rank0s(self.ip_table)
        ips = {r: ip for r, ip in enumerate(self.ip_table)}
        degree = max(1, parallel_degree)
        out: List[Tuple[str, Strategy]] = []
        try:
            out.append(("par-trees", ParTrees().synthesize(
                self.ip_table, local_rank0_list, degree, bandwidth_graph, latency_graph)))
        except Exception as e:  # noqa: BLE001
            print(f"[synthesizer] par-trees candidate dropped: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        out.append(("ring", Strategy.ring(world, degree, ips)))
        out.append(("binary", Strategy.binary(world, degree, ips)))
        return out

    def rank(
        self,
        candidates: Sequence[Tuple[str, Strategy]],
        nbytes: int,
        bandwidth_graph: Optional[Sequence[Sequence[float]]] = None,
        latency_graph: Optional[Sequence[Sequence[float]]] = None,
        collective: str = "allreduce",
        model=None,
        engine: Optional[str] = None,
    ):
        """Labeled candidates fastest-first on the α-β replay
        (:class:`~adapcc_tpu_torch.sim.rank.RankedCandidate` rows, each with
        its optimality gap), under ``model``, else the profiled matrices,
        else the calibration artifact or the defaults."""
        from adapcc_tpu_torch import sim

        if model is None:
            model = self._cost_model(bandwidth_graph, latency_graph)
        return sim.rank_candidates(list(candidates), model, max(1, int(nbytes)), collective, engine=engine)

    def resynthesize(
        self,
        model,
        nbytes: int,
        parallel_degree: int = 1,
        incumbent: Optional[Strategy] = None,
        collective: str = "allreduce",
        provenance: str = "adapt-rerank",
        engine: Optional[str] = None,
    ):
        """The online re-rank under a drift-corrected (or transiently
        contended) cost model: the candidate pool synthesized from the
        model's own matrices (so ParTrees routes on the corrected network),
        ranked on its replay, and the winner's wire codec re-priced on its
        corrected bottleneck edge.  ``incumbent`` is listed first, so a tie
        keeps the executing strategy.  ``provenance`` goes into the winner's
        synthesis label (``adapt-rerank`` for a re-calibration,
        ``congestion-reroute`` for a transient re-route).  Returns the whole
        ranked list; the caller gates adoption.  Host work only."""
        bw, lat = model.to_graphs()
        cands: List[Tuple[str, Strategy]] = []
        if incumbent is not None:
            cands.append(("incumbent", incumbent))
        cands.extend(self.candidates(parallel_degree, bw, lat))
        ranked = self.rank(cands, nbytes, collective=collective, model=model, engine=engine)
        winner = ranked[0]
        if winner.strategy is not None and winner.strategy is not incumbent:
            winner.strategy.synthesis = f"{winner.label}+{provenance}"
            winner.strategy.wire_dtype = self._choose_wire_dtype(winner.strategy, nbytes, bw, lat)
        return ranked

    def _cost_model(self, bandwidth_graph, latency_graph):
        import numpy as np

        from adapcc_tpu_torch.sim.calibrate import load_or_default
        from adapcc_tpu_torch.sim.cost_model import LinkCostModel

        world = len(self.ip_table)
        ips = {r: ip for r, ip in enumerate(self.ip_table)}
        if bandwidth_graph is not None and latency_graph is not None:
            bw = np.asarray(bandwidth_graph, dtype=float)
            lat = np.asarray(latency_graph, dtype=float)
            if bw.shape == (world, world) and (bw > 0).any():
                return LinkCostModel.from_matrices(lat, bw, ips, source="profile-graphs")
        model = load_or_default(world=world)
        if model.ips is None:
            # the fallback still prices cross-host edges as DCN
            model = model.with_ips(ips)
        return model

    def _sim_ranked(self, prim: int, parallel_degree: int, transmission_size: int, bandwidth_graph,
                    latency_graph, local_rank0_list) -> Strategy:
        """The ``sim-rank`` policy: rank on the primitive being synthesized
        (the scatter/gather family on allreduce, the superset schedule),
        label the winner ``<shape>+sim-rank`` and price its codec."""
        from adapcc_tpu_torch.primitives import BROADCAST, REDUCE

        collective = {REDUCE: "reduce", BROADCAST: "broadcast"}.get(prim, "allreduce")
        nbytes = transmission_size if transmission_size > 0 else DEFAULT_CHUNK_BYTES
        ranked = self.rank(self.candidates(parallel_degree, bandwidth_graph, latency_graph, local_rank0_list),
                           nbytes, bandwidth_graph, latency_graph, collective=collective)
        winner = ranked[0]
        winner.strategy.synthesis = f"{winner.label}+sim-rank"
        winner.strategy.wire_dtype = self._choose_wire_dtype(winner.strategy, nbytes, bandwidth_graph, latency_graph)
        return winner.strategy

    def _choose_wire_dtype(self, strategy: Strategy, nbytes: int, bandwidth_graph, latency_graph) -> str:
        """The cheapest wire codec on the strategy's bottleneck link (a
        lockstep schedule advances at its slowest edge); the choice rides
        the strategy XML."""
        from adapcc_tpu_torch.sim.cost_model import choose_wire_dtype

        model = self._cost_model(bandwidth_graph, latency_graph)
        edges = [(parent, child) for tree in strategy.trees for child, parent in tree.parent.items()]
        if not edges:  # world 1: nothing crosses a wire
            return "off"
        bottleneck = max((model.coeffs(s, d) for s, d in edges), key=lambda c: c.time(1 << 20))
        choice, _ = choose_wire_dtype(strategy.world_size, max(1, int(nbytes)), bottleneck)
        return choice


def _infer_local_rank0s(ip_table: Sequence[str]) -> List[int]:
    """First rank of each run of equal ips is that host's master."""
    masters = []
    for r, ip in enumerate(ip_table):
        if r == 0 or ip_table[r - 1] != ip:
            masters.append(r)
    return masters
