"""Strategy synthesizer: the policy switch over ParTrees and the fixed shapes.

The port of :mod:`adapcc_tpu.strategy.synthesizer`, which mirrors the
reference's policy dispatch (gurobi/synthesizer.py:44-62): the default
heuristic is ParTrees; ``ring`` and ``binary`` are fixed shapes that need no
profile.  The exact MILP formulation (``milp``), the simulated ranking pass
(``sim-rank``) and the two-level policy (``hier``) raise until the slices
that bring ``strategy/solver.py``, ``sim/`` and ``strategy/hierarchy.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from adapcc_tpu_torch.primitives import not_ported
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.strategy.partrees import ParTrees
from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml

#: the policies of the JAX package that wait for a later slice, and that slice
_WAITING_POLICIES = {
    "milp": ("the MILP synthesis policy", "the solver slice (strategy/solver.py)"),
    "sim-rank": ("the simulated ranking policy", "the simulator slice (sim/)"),
    "hier": ("the two-level synthesis policy", "the two-level plane slice (strategy/hierarchy.py)"),
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
        if self.policy in _WAITING_POLICIES:
            raise not_ported(*_WAITING_POLICIES[self.policy])
        ips = {r: ip for r, ip in enumerate(self.ip_table)}
        if self.policy == "ring":
            s = Strategy.ring(world, max(1, parallel_degree), ips)
        elif self.policy == "binary":
            s = Strategy.binary(world, max(1, parallel_degree), ips)
        else:
            raise ValueError(f"unknown synthesis policy {self.policy!r}")
        s.synthesis = self.policy
        return s


def _infer_local_rank0s(ip_table: Sequence[str]) -> List[int]:
    """First rank of each run of equal ips is that host's master."""
    masters = []
    for r, ip in enumerate(ip_table):
        if r == 0 or ip_table[r - 1] != ip:
            masters.append(r)
    return masters
