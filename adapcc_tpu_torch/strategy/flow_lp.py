"""Multi-round broadcast flow LP over arbitrary connectivity graphs (the port
of :mod:`adapcc_tpu.strategy.flow_lp`, on the same
``scipy.optimize.linprog`` (HiGHS) call, so one graph gives one solution in
both packages).

The reference's CVXPY study (gurobi/code-gen/cvxpy-broadcast-multi-round.py)
formulates broadcast as a multi-round flow problem in which a node forwards
only what it received in earlier rounds.  Here it is a **multicast commodity
LP** (unit data from ``source`` over ``R`` rounds): one unit commodity per
receiver ``d``, all sharing each edge's transmissions:

    variables  f[d, e, r] ≥ 0   commodity-d data on edge e in round r
               x[e, r]    ≥ 0   physical transmission on e in round r
               T[r]       ≥ 0   duration of round r
    foreach d, e, r:    f[d, e, r] ≤ x[e, r]                     (multicast)
    foreach e, r:       x[e, r] ≤ bandwidth[e] · T[r]            (capacity)
    foreach d, v≠src, r: Σ_{r'≤r} Σ_out f[d, ·, r'] ≤ Σ_{r'<r} Σ_in f[d, ·, r']
                                         (store and forward)
    foreach d:          Σ_r (Σ_in − Σ_out) f[d, ·, r] at d ≥ 1   (delivery)
    minimize   Σ_r T[r]                                          (makespan)

Delivery counts net inflow, so data bounced round a cycle cancels.  The
schedule lowers from the commodity flows (per edge and round, the largest
over commodities), never from ``x``, which alternate optima may park on
edges that carry nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]


@dataclass
class FlowSolution:
    """The LP's output: per-round edge flows and round durations."""

    num_nodes: int
    source: int
    #: per round, the largest commodity flow on each edge
    rounds: List[Dict[Edge, float]]
    durations: List[float]
    makespan: float

    def comm_rounds(self, threshold: float = 1e-6):
        """Lower to schedule-IR rounds (edges carrying more than
        ``threshold``).  A ``CommRound`` is a partial permutation, so an LP
        round that fans out is split greedily into as many sub-rounds as its
        fan degree needs, heavier flows first."""
        from adapcc_tpu_torch.strategy.ir import CommRound

        out = []
        for flows in self.rounds:
            remaining = sorted(((f, e) for e, f in flows.items() if f > threshold), reverse=True)
            while remaining:
                srcs, dsts, batch, deferred = set(), set(), [], []
                for f, (u, v) in remaining:
                    if u in srcs or v in dsts:
                        deferred.append((f, (u, v)))
                    else:
                        srcs.add(u)
                        dsts.add(v)
                        batch.append((u, v))
                out.append(CommRound(edges=tuple(sorted(batch))))
                remaining = deferred
        return out


def _bfs_depths(n: int, out_neighbors: List[List[int]], source: int) -> List[int]:
    depth = [-1] * n
    depth[source] = 0
    frontier = [source]
    while frontier:
        nxt = []
        for u in frontier:
            for v in out_neighbors[u]:
                if depth[v] < 0:
                    depth[v] = depth[u] + 1
                    nxt.append(v)
        frontier = nxt
    return depth


def solve_broadcast_lp(
    num_nodes: int,
    edges: Sequence[Edge],
    bandwidth: Sequence[float],
    source: int = 0,
    num_rounds: int = 0,
) -> FlowSolution:
    """Solve the multicast broadcast LP; raises if it is infeasible.

    ``edges`` are directed (pass both directions for a full-duplex link).
    ``num_rounds=0`` takes the larger of the source's eccentricity and
    ⌈log2 n⌉ + 1."""
    from scipy.optimize import linprog

    n, E = num_nodes, len(edges)
    if not 0 <= source < n:
        raise ValueError(f"source {source} outside [0, {n})")
    if len(bandwidth) != E:
        raise ValueError("bandwidth list must match edges")
    if len(set(edges)) != E:
        raise ValueError("duplicate directed edges; merge parallel links into one edge with summed bandwidth")
    bad = [e for e in edges if not (0 <= e[0] < n and 0 <= e[1] < n) or e[0] == e[1]]
    if bad:
        raise ValueError(f"edges outside [0, {n}) or self-loops: {bad}")

    in_edges: List[List[int]] = [[] for _ in range(n)]
    out_edges: List[List[int]] = [[] for _ in range(n)]
    out_neighbors: List[List[int]] = [[] for _ in range(n)]
    for e, (u, v) in enumerate(edges):
        out_edges[u].append(e)
        in_edges[v].append(e)
        out_neighbors[u].append(v)

    depths = _bfs_depths(n, out_neighbors, source)
    unreachable = [v for v in range(n) if depths[v] < 0]
    if unreachable:
        raise ValueError(f"broadcast LP infeasible: nodes {unreachable} unreachable from {source}")
    if num_rounds:
        R = num_rounds
    else:
        R = max(max(depths), max(1, int(np.ceil(np.log2(max(n, 2))))) + 1)

    receivers = [v for v in range(n) if v != source]
    D = len(receivers)

    # variables: f[d, e, r] (D·E·R), x[e, r] (E·R), T[r] (R)
    nf = D * E * R
    nx = E * R
    nvar = nf + nx + R

    def fi(d: int, e: int, r: int) -> int:
        return (d * R + r) * E + e

    def xi(e: int, r: int) -> int:
        return nf + r * E + e

    c = np.zeros(nvar)
    c[nf + nx:] = 1.0  # minimize Σ T_r

    A_ub: List[np.ndarray] = []
    b_ub: List[float] = []

    for r in range(R):
        for e in range(E):
            # capacity: x[e,r] − bw[e]·T[r] ≤ 0
            row = np.zeros(nvar)
            row[xi(e, r)] = 1.0
            row[nf + nx + r] = -bandwidth[e]
            A_ub.append(row)
            b_ub.append(0.0)
            # multicast: each commodity rides the shared transmission
            for d in range(D):
                row = np.zeros(nvar)
                row[fi(d, e, r)] = 1.0
                row[xi(e, r)] = -1.0
                A_ub.append(row)
                b_ub.append(0.0)

    # store and forward, cumulative: what v sent through round r is bounded
    # by what it received before round r (never for the source)
    for d in range(D):
        for v in range(n):
            if v == source:
                continue
            for r in range(R):
                row = np.zeros(nvar)
                for rp in range(r + 1):
                    for e in out_edges[v]:
                        row[fi(d, e, rp)] = 1.0
                for rp in range(r):
                    for e in in_edges[v]:
                        row[fi(d, e, rp)] -= 1.0
                A_ub.append(row)
                b_ub.append(0.0)

    # delivery: net inflow of commodity d at its receiver ≥ 1
    for d, dest in enumerate(receivers):
        row = np.zeros(nvar)
        for r in range(R):
            for e in in_edges[dest]:
                row[fi(d, e, r)] -= 1.0
            for e in out_edges[dest]:
                row[fi(d, e, r)] += 1.0
        A_ub.append(row)
        b_ub.append(-1.0)

    res = linprog(c, A_ub=np.array(A_ub), b_ub=np.array(b_ub), bounds=[(0, None)] * nvar, method="highs")
    if not res.success:
        raise ValueError(f"broadcast LP infeasible: {res.message}")

    sol = res.x
    rounds = []
    for r in range(R):
        flows: Dict[Edge, float] = {}
        for e in range(E):
            need = max((sol[fi(d, e, r)] for d in range(D)), default=0.0)
            if need > 1e-9:
                flows[edges[e]] = float(need)
        rounds.append(flows)
    durations = [float(t) for t in sol[nf + nx:]]
    return FlowSolution(num_nodes=n, source=source, rounds=rounds, durations=durations,
                        makespan=float(sum(durations)))
