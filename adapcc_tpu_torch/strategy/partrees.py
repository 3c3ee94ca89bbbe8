"""ParTrees: parallel-spanning-tree strategy synthesis from profiled matrices.

Re-implements the reference heuristic (gurobi/trees.py, described in
SURVEY.md §2.2 P7): per-host "master" ranks (local-rank-0s) are sorted by the
bandwidth–delay product of their outbound inter-host link, an array-heap
binary tree is built over the masters, the master list is rotated once per
parallel transmission for root diversity, and each master's intra-host ranks
hang beneath it as a chain (the reference's "Chain policy",
gurobi/trees.py:85-88).  On TPU "intra-host" means same ICI domain and
"inter-host" means DCN, so the chain rides the fast mesh while the binary
tree spans the slow links.

A whole copy of :mod:`adapcc_tpu.strategy.partrees` (importing the reference
module would load JAX through its package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.strategy.ir import Strategy, Tree
from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml


@dataclass
class _Master:
    rank: int
    ip: str
    group: List[int]  # all ranks on this host, master first
    bandwidth: float
    latency: float

    @property
    def bdp(self) -> float:
        return self.bandwidth * self.latency


def _host_groups(ip_table: Sequence[str], masters: Sequence[int]) -> Dict[int, List[int]]:
    """Consecutive ranks sharing the master's ip form its host group.

    A group also ends at the next master: two masters can share an ip (one
    server exposing two nics in the logical graph), and their groups must not
    overlap.
    """
    master_set = set(masters)
    groups: Dict[int, List[int]] = {}
    for m in masters:
        group = [m]
        r = m + 1
        while r < len(ip_table) and ip_table[r] == ip_table[m] and r not in master_set:
            group.append(r)
            r += 1
        groups[m] = group
    return groups


def _attach_chains(
    children: Dict[int, List[int]], masters: Sequence[int], groups: Dict[int, List[int]]
) -> None:
    """Chain policy: hang each master's intra-host ranks beneath it as a chain
    whose head is the master's *first* child, so the sibling index (staging
    priority) favors the fast local edge (reference gurobi/trees.py:85-88)."""
    for m in masters:
        chain = groups[m][1:]
        if not chain:
            continue
        kids = children.setdefault(m, [])
        kids.insert(0, chain[0])
        for a, b in zip(chain, chain[1:]):
            children.setdefault(a, []).append(b)


def _heap_tree_edges(order: Sequence[int]) -> Dict[int, List[int]]:
    """Array-heap binary tree: element i parents elements 2i+1 and 2i+2."""
    children: Dict[int, List[int]] = {}
    for i, rank in enumerate(order):
        kids = [order[j] for j in (2 * i + 1, 2 * i + 2) if j < len(order)]
        if kids:
            children[rank] = kids
    return children


class ParTrees:
    """Heuristic synthesizer (default policy, reference synthesizer.py:44-52)."""

    def optimize(
        self,
        ip_table: Sequence[str],
        local_rank0_list: Sequence[int],
        prim: int,
        parallel_degree: int,
        transmission_size: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
        strategy_file: Optional[str] = None,
    ) -> int:
        """Synthesize the strategy, optionally write it as XML, and return the
        chunk size in bytes (same signature shape as the reference so the
        control plane swaps policies freely)."""
        strategy = self.synthesize(
            ip_table,
            local_rank0_list,
            parallel_degree,
            bandwidth_graph,
            latency_graph,
        )
        if strategy_file:
            emit_strategy_xml(strategy, strategy_file)
        return strategy.chunk_bytes

    def synthesize(
        self,
        ip_table: Sequence[str],
        local_rank0_list: Sequence[int],
        parallel_degree: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
    ) -> Strategy:
        world = len(ip_table)
        groups = _host_groups(ip_table, local_rank0_list)

        masters: List[_Master] = []
        for m in local_rank0_list:
            # probe target: the first rank of the "next" host around the ring,
            # i.e. this master's representative outbound inter-host link
            peer = (m + len(groups[m])) % world
            masters.append(
                _Master(
                    rank=m,
                    ip=ip_table[m],
                    group=groups[m],
                    bandwidth=bandwidth_graph[m][peer],
                    latency=latency_graph[m][peer],
                )
            )
        # best-provisioned master first: it becomes the first tree's root
        masters.sort(key=lambda n: n.bdp, reverse=True)

        degree = min(len(masters), max(1, parallel_degree))
        ips = {r: ip_table[r] for r in range(world)}

        trees: List[Tree] = []
        rotation = list(masters)
        for t in range(degree):
            if t > 0:
                rotation = rotation[1:] + rotation[:1]
            trees.append(self._build_tree(rotation, groups, ips))
        return Strategy(trees, world, DEFAULT_CHUNK_BYTES, synthesis="partrees")

    @staticmethod
    def _build_tree(
        masters: Sequence[_Master],
        groups: Dict[int, List[int]],
        ips: Dict[int, str],
    ) -> Tree:
        order = [m.rank for m in masters]
        children = _heap_tree_edges(order)
        _attach_chains(children, order, groups)
        return Tree(order[0], children, ips)
