"""Strategy synthesizer: the policy switch over ParTrees and the fixed shapes.

The port of :mod:`adapcc_tpu.strategy.synthesizer`, which mirrors the
reference's policy dispatch (gurobi/synthesizer.py:44-62): the default
heuristic is ParTrees; ``milp`` is the exact formulation
(:mod:`adapcc_tpu_torch.strategy.solver`); ``ring`` and ``binary`` are fixed
shapes that need no profile; ``hier`` synthesizes the two-level plan of a
multi-host world (:mod:`adapcc_tpu_torch.strategy.hierarchy`).  The
simulated ranking pass (``sim-rank``) raises until the simulator slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES, not_ported
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.strategy.partrees import ParTrees
from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml

#: the policies of the JAX package that wait for a later slice, and that slice
_WAITING_POLICIES = {
    "sim-rank": ("the simulated ranking policy", "the simulator slice (sim/)"),
}


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
        if self.policy in _WAITING_POLICIES:
            raise not_ported(*_WAITING_POLICIES[self.policy])
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


def _infer_local_rank0s(ip_table: Sequence[str]) -> List[int]:
    """First rank of each run of equal ips is that host's master."""
    masters = []
    for r, ip in enumerate(ip_table):
        if r == 0 or ip_table[r - 1] != ip:
            masters.append(r)
    return masters
