"""MILP strategy solver (``scipy.optimize.milp``/HiGHS in place of the
reference's Gurobi model).

The port of :mod:`adapcc_tpu.strategy.solver`, a copy.  The reference
formulates synthesis as a MILP with binary root-assignment variables,
per-tree tensor shares, routing/flow variables and a pipeline-aware makespan
objective (gurobi/solver.py:143-208).  This keeps the decisions that matter,
which masters root the parallel trees and how the tensor is split across
them, and solves them exactly:

    min  T
    s.t. Σ_g x_mg = 1                       each tree m picks one root
         Σ_m x_mg ≤ 1                       root diversity
         Σ_m s_m = 1                        tensor fully covered
         T ≥ lat_g·x_mg + size·k_g·s_m − M·(1−x_mg)   per (m, g)

where, for a candidate root g, ``lat_g`` is the summed per-level latency and
``k_g`` the summed per-level bottleneck inverse bandwidth of the heap tree
rooted at g.  Tree shapes follow the ParTrees chain+heap construction; the
MILP chooses roots, shares and (up to ``ROUTING_MILP_MAX_MASTERS`` masters)
the inter-host edges.  ``scipy`` is imported inside the solves only, so
importing the port does not load it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from adapcc_tpu_torch.primitives import (
    ALLTOALL,
    BOARDCAST,
    DEFAULT_CHUNK_BYTES,
    REDUCE,
)
from adapcc_tpu_torch.strategy.ir import Strategy, Tree
from adapcc_tpu_torch.strategy.partrees import (
    ParTrees,
    _attach_chains,
    _heap_tree_edges,
    _host_groups,
)


def _edge_lat_invbw(
    prim: int,
    lat: "np.ndarray",
    inv_bw: "np.ndarray",
    i: int,
    j: int,
    load: float = 1.0,
):
    """Effective (latency, 1/bandwidth·load) of tree edge ``i parents j``.

    The reference differentiates per-primitive link loads N_mij
    (gurobi/solver.py:143-176): broadcast traffic rides parent→child once,
    reduce rides child→parent once (aggregation keeps it one payload on a
    tree), allreduce serializes both directions, and alltoall carries one
    distinct flow per destination behind the edge (``load`` = that
    multiplicity; each flow is 1/n of the payload, scaled by the caller).
    """
    if prim == BOARDCAST:
        return lat[i][j], inv_bw[i][j]
    if prim == REDUCE:
        return lat[j][i], inv_bw[j][i]
    if prim == ALLTOALL:
        # per-pair payloads cross in both directions; multiplicity = load
        return lat[i][j] + lat[j][i], (inv_bw[i][j] + inv_bw[j][i]) * load
    # ALLREDUCE (and anything tree-shaped by default): reduce up + broadcast
    # down, each direction carrying the tree's share once
    return lat[i][j] + lat[j][i], inv_bw[i][j] + inv_bw[j][i]


def _subtree_sizes(children: Dict[int, List[int]], root: int) -> Dict[int, int]:
    sizes: Dict[int, int] = {}
    order: List[int] = []
    stack = [root]
    while stack:
        r = stack.pop()
        order.append(r)
        stack.extend(children.get(r, ()))
    for r in reversed(order):
        sizes[r] = 1 + sum(sizes[c] for c in children.get(r, ()))
    return sizes


def _tree_cost_coeffs(
    order: Sequence[int],
    bw: Sequence[Sequence[float]],
    lat: Sequence[Sequence[float]],
    prim: int = -1,
):
    """(summed per-level latency, summed per-level max 1/bw·load) for the
    heap tree over ``order``, with the per-primitive edge model of
    :func:`_edge_lat_invbw`."""
    children = _heap_tree_edges(order)
    n = len(order)
    sizes = _subtree_sizes(children, order[0])
    lat_m = np.asarray(lat, dtype=float)
    bw_m = np.asarray(bw, dtype=float)
    inv_bw = 1.0 / np.maximum(bw_m, 1e-9)
    depth = {order[0]: 0}
    levels: Dict[int, List[tuple]] = {}
    stack = [order[0]]
    while stack:
        p = stack.pop()
        for c in children.get(p, ()):
            depth[c] = depth[p] + 1
            levels.setdefault(depth[c], []).append((p, c))
            stack.append(c)
    lat_sum, inv_bw_sum = 0.0, 0.0
    for lvl in sorted(levels):
        edges = levels[lvl]
        costs = [
            _edge_lat_invbw(
                prim, lat_m, inv_bw, p, c,
                load=sizes[c] / n if prim == ALLTOALL else 1.0,
            )
            for p, c in edges
        ]
        lat_sum += max(l for l, _ in costs)
        inv_bw_sum += max(k for _, k in costs)
    return lat_sum, inv_bw_sum


def modeled_makespan(
    strategy,
    masters: Sequence[int],
    prim: int,
    transmission_size: int,
    bandwidth_graph: Sequence[Sequence[float]],
    latency_graph: Sequence[Sequence[float]],
) -> float:
    """The routing MILP's pipeline-aware bottleneck objective, evaluated on
    *any* synthesized strategy: max over used trees and their inter-master
    edges of ``lat + size·(1/bw·load)·share`` (reference objective
    gurobi/solver.py:190-208).  Puts the heuristic and the solver on one
    scale — the property that justifies the solver's existence is
    ``makespan(milp) ≤ makespan(partrees)`` on the same profile.

    The MAX across trees assumes parallel transmissions run concurrently —
    true in the reference via per-tree pthread pairs (allreduce.cu:735-742)
    and true here via the merged-round executor (engine._run_merged), which
    combines all trees' round-k edges into shared ppermutes.  Under the
    sequential fallback (single tree, skewed shares, or
    ADAPCC_MERGE_ROUNDS=0) tree times ADD instead, and this objective is a
    lower bound rather than an estimate.
    """
    bw = np.asarray(bandwidth_graph, dtype=float)
    lat = np.asarray(latency_graph, dtype=float)
    inv_bw = 1.0 / np.maximum(bw, 1e-9)
    mset = set(masters)
    n = len(masters)
    size = float(max(transmission_size, 1))
    worst = 0.0
    for tree, share in zip(strategy.trees, strategy.tree_shares()):
        if share <= 0.0:
            continue
        # project to the inter-master edges (chains are intra-host, not
        # modeled by the routing MILP) and count masters behind each edge
        # for the ALLTOALL flow multiplicity
        mchildren = {
            p: [c for c in cs if c in mset]
            for p, cs in tree.children.items()
            if p in mset
        }
        sizes = _subtree_sizes(mchildren, tree.root) if tree.root in mset else {}
        for p, cs in mchildren.items():
            for c in cs:
                load = sizes.get(c, 1) / n if prim == ALLTOALL else 1.0
                l, k = _edge_lat_invbw(prim, lat, inv_bw, p, c, load=load)
                worst = max(worst, l + size * k * share)
    return worst


#: above this many masters the routing MILP (O(M·n²) binaries) is skipped in
#: favor of the rotation model, which only chooses roots and shares
ROUTING_MILP_MAX_MASTERS = 12

#: branch-and-bound budget for the routing MILP; on timeout HiGHS reports
#: failure and synthesis falls back to the rotation model, bounding the
#: topology-reconstruction stall a hard instance could cause
ROUTING_MILP_TIME_LIMIT_S = 10.0

#: candidate-space pruning for the routing MILP: only the top-k masters by
#: BDP (bandwidth·delay over their inter-master links — ParTrees' master
#: ranking) may root a tree, and each master considers only its
#: ``ROUTING_MILP_PARENT_CANDIDATES`` cheapest upstream edges (plus the
#: best-BDP master, which stays a universal parent so an arborescence always
#: exists): the candidate graph keeps every edge the optimum uses, so the
#: optimal makespan is the unpruned one at a fraction of the search.  An
#: infeasible pruned instance (adversarial profile) retries unpruned within
#: the time limit before falling back to the rotation model.
ROUTING_MILP_ROOT_CANDIDATES = 4
ROUTING_MILP_PARENT_CANDIDATES = 3

#: wall-time budget the pruned synthesis is expected to meet at pod scale
#: (world=64)
MILP_SYNTH_BUDGET_S = 1.0


def per_tree_chunk_bytes(
    shares: Sequence[float], transmission_size: int
) -> List[int]:
    """The solver's per-tree chunk output (reference c_m, gurobi/
    solver.py:211): each tree pipelines its segment at the default chunk,
    clamped to the segment's own share of the payload — a tree carrying a
    sliver must not run a single over-sized chunk with no pipeline at all."""
    size = max(1, int(transmission_size))
    return [
        max(1, min(DEFAULT_CHUNK_BYTES, int(math.ceil(size * s))))
        for s in shares
    ]


class MilpSolver:
    def synthesize(
        self,
        ip_table: Sequence[str],
        local_rank0_list: Sequence[int],
        prim: int,
        parallel_degree: int,
        transmission_size: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
    ) -> Strategy:
        """Routing MILP when the master count permits, else the rotation
        model; both fall back to ParTrees on solver failure.  The routing
        instance is pruned (top-k roots by BDP + k-cheapest parent
        candidates); a *provably infeasible* pruned instance retries
        unpruned inside ``_synthesize_routing`` — a timeout does NOT retry,
        so the reconstruction stall stays bounded by one time limit."""
        if 1 < len(local_rank0_list) <= ROUTING_MILP_MAX_MASTERS:
            strategy = self._synthesize_routing(
                ip_table, local_rank0_list, prim, parallel_degree,
                transmission_size, bandwidth_graph, latency_graph,
            )
            if strategy is not None:
                return strategy
        return self._synthesize_rotation(
            ip_table, local_rank0_list, prim, parallel_degree,
            transmission_size, bandwidth_graph, latency_graph,
        )

    # -- full routing formulation (reference solver.py x_ijf + flow) -----------

    def _synthesize_routing(
        self,
        ip_table: Sequence[str],
        local_rank0_list: Sequence[int],
        prim: int,
        parallel_degree: int,
        transmission_size: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
        prune: bool = True,
    ) -> "Strategy | None":
        """Choose the actual inter-host tree edges, not just the root.

        Per tree m over the n masters:

            r[m,g]   binary   g roots tree m        (Σ_g r = 1; Σ_m r_mg ≤ 1)
            e[m,i,j] binary   i parents j           (Σ_i e_mij = 1 − r_mj)
            f[m,i,j] ≥ 0      flow, conservation    (in − out = 1 − n·r_mj)
                              f ≤ (n−1)·e           (flow rides chosen edges)
            s[m] ≥ 0          tensor share          (Σ s = 1; a share may be
                              0 — that tree then carries nothing)
            u[m]     binary   tree m is used        (s_m ≤ u_m)
            T ≥ lat·e + size·k·s_m − M_ij(1−e) − M_ij(1−u_m)   per (m,i,j)

        The flow system forces each tree to be a spanning arborescence (the
        reference's flow-conservation big-M constraints, solver.py:143-176);
        the per-edge T bound is the pipeline-aware bottleneck objective
        (chunks pipeline, so completion tracks the slowest active link;
        solver.py:190-208).  The ``u`` gate keeps a zero-share tree's edges
        from bounding T (its latencies would otherwise inflate the optimum).
        ``(lat, k)`` per edge follow the per-primitive link-load model of
        :func:`_edge_lat_invbw` (reference N_mij, solver.py:143-176); for
        ALLTOALL the multiplicity is the flow variable itself (number of
        destinations behind the edge) with shares pinned uniform so the term
        stays linear.  ``M_ij`` is per-edge (the edge's own worst cost) —
        one global M derived from a near-dead profiled link would dwarf
        every real coefficient and let tolerance-sized violations erase the
        objective.  Returns None when HiGHS fails or times out.
        """
        from scipy.optimize import Bounds, LinearConstraint, milp
        from scipy.sparse import csr_matrix

        world = len(ip_table)
        masters = list(local_rank0_list)
        n = len(masters)
        m_trees = min(max(1, parallel_degree), n)
        size = float(max(transmission_size, 1))
        bw = np.asarray(bandwidth_graph, dtype=float)
        lat = np.asarray(latency_graph, dtype=float)

        # variable layout per tree m: r[g] (n), e[i,j] (n²), f[i,j] (n²);
        # then s[m] (m_trees), u[m] (m_trees) and T
        per_tree = n + 2 * n * n
        nvar = m_trees * per_tree + 2 * m_trees + 1
        Ti = nvar - 1

        def ri(m, g):
            return m * per_tree + g

        def ei(m, i, j):
            return m * per_tree + n + i * n + j

        def fi(m, i, j):
            return m * per_tree + n + n * n + i * n + j

        def si(m):
            return m_trees * per_tree + m

        def ui(m):
            return m_trees * per_tree + m_trees + m

        c = np.zeros(nvar)
        c[Ti] = 1.0

        # sparse triplet assembly: dense length-nvar rows would be almost all
        # zeros at the size guard
        rows_i: List[int] = []
        cols: List[int] = []
        vals: List[float] = []
        lb: List[float] = []
        ub: List[float] = []

        def add(entries, lo, hi):
            r = len(lb)
            for col, val in entries:
                rows_i.append(r)
                cols.append(col)
                vals.append(val)
            lb.append(lo)
            ub.append(hi)

        for m in range(m_trees):
            # one root
            add([(ri(m, g), 1.0) for g in range(n)], 1.0, 1.0)
            for j in range(n):
                # parent count: Σ_i e[i,j] + r[j] = 1
                add(
                    [(ri(m, j), 1.0)]
                    + [(ei(m, i, j), 1.0) for i in range(n) if i != j],
                    1.0, 1.0,
                )
                # flow conservation: Σ_i f[i,j] − Σ_k f[j,k] = 1 − n·r[j]
                add(
                    [(ri(m, j), float(n))]
                    + [(fi(m, i, j), 1.0) for i in range(n) if i != j]
                    + [(fi(m, j, k), -1.0) for k in range(n) if k != j],
                    1.0, 1.0,
                )
            for i in range(n):
                for j in range(n):
                    if i != j:
                        # flow rides chosen edges: f ≤ (n−1)·e
                        add(
                            [(fi(m, i, j), 1.0), (ei(m, i, j), -(n - 1.0))],
                            -np.inf, 0.0,
                        )

        # root diversity across trees
        for g in range(n):
            add([(ri(m, g), 1.0) for m in range(m_trees)], 0.0, 1.0)

        # shares cover the tensor; a tree's share only counts when it is used
        add([(si(m), 1.0) for m in range(m_trees)], 1.0, 1.0)
        for m in range(m_trees):
            add([(si(m), 1.0), (ui(m), -1.0)], -np.inf, 0.0)

        # pipeline-aware bottleneck with per-primitive link loads
        # (_edge_lat_invbw; reference N_mij solver.py:143-176):
        #   T ≥ lat·e + size·k·s − M_ij(1−e) − M_ij(1−u)
        # with the big-M per edge (that edge's own worst-case cost).  For
        # ALLTOALL the bandwidth term rides the flow variable (multiplicity =
        # destinations behind the edge, each a 1/n payload) with shares
        # pinned uniform so the product stays linear.
        is_a2a = prim == ALLTOALL
        lat_mx = np.zeros((n, n))
        inv_bw = np.zeros((n, n))
        for a in range(n):
            for b in range(n):
                if a != b:
                    lat_mx[a][b] = lat[masters[a]][masters[b]]
                    inv_bw[a][b] = 1.0 / max(bw[masters[a]][masters[b]], 1e-9)

        # candidate-space pruning (see ROUTING_MILP_ROOT_CANDIDATES): rank
        # masters by BDP over their inter-master links, keep the top-k as
        # root candidates, and give each child only its k cheapest upstream
        # edges plus the best-BDP master.  Variables outside the candidate
        # graph are fixed to 0 through their bounds, which shrinks the
        # branch-and-bound tree without touching the constraint structure.
        roots_ok = set(range(n))
        parent_ok = {j: set(i for i in range(n) if i != j) for j in range(n)}
        if prune and n > 2:
            bdp = sorted(
                (
                    (
                        sum(
                            bw[masters[i]][masters[j]] * lat[masters[i]][masters[j]]
                            for j in range(n)
                            if j != i
                        ),
                        -i,
                    )
                    for i in range(n)
                ),
                reverse=True,
            )
            ranked = [-neg for _, neg in bdp]
            k_roots = max(m_trees, ROUTING_MILP_ROOT_CANDIDATES)
            roots_ok = set(ranked[:k_roots])
            best = ranked[0]
            for j in range(n):
                costs = []
                for i in range(n):
                    if i == j:
                        continue
                    lat_e, k_e = _edge_lat_invbw(prim, lat_mx, inv_bw, i, j)
                    costs.append((lat_e + size * k_e, i))
                costs.sort()
                keep = {i for _, i in costs[:ROUTING_MILP_PARENT_CANDIDATES]}
                keep.add(best)
                keep.discard(j)
                parent_ok[j] = keep
        for m in range(m_trees):
            for i in range(n):
                for j in range(n):
                    if i == j:
                        continue
                    lat_eff, k_eff = _edge_lat_invbw(prim, lat_mx, inv_bw, i, j)
                    if is_a2a:
                        per_flow = size * k_eff / (n * m_trees)
                        m_ij = lat_eff + per_flow * (n - 1.0) + 1.0
                        add(
                            [
                                (Ti, 1.0),
                                (ei(m, i, j), -(lat_eff + m_ij)),
                                (fi(m, i, j), -per_flow),
                                (ui(m), -m_ij),
                            ],
                            -2.0 * m_ij, np.inf,
                        )
                    else:
                        m_ij = lat_eff + size * k_eff + 1.0
                        add(
                            [
                                (Ti, 1.0),
                                (ei(m, i, j), -(lat_eff + m_ij)),
                                (si(m), -size * k_eff),
                                (ui(m), -m_ij),
                            ],
                            -2.0 * m_ij, np.inf,
                        )

        integrality = np.zeros(nvar)
        bounds_lb = np.zeros(nvar)
        bounds_ub = np.full(nvar, np.inf)
        for m in range(m_trees):
            integrality[ui(m)] = 1
            bounds_ub[ui(m)] = 1.0
            if is_a2a:
                # alltoall payloads are per-pair, not a shardable tensor:
                # every tree carries an equal slice of the pairs
                bounds_lb[si(m)] = bounds_ub[si(m)] = 1.0 / m_trees
            for g in range(n):
                integrality[ri(m, g)] = 1
                bounds_ub[ri(m, g)] = 1.0 if g in roots_ok else 0.0
            for i in range(n):
                for j in range(n):
                    integrality[ei(m, i, j)] = 1
                    allowed = i != j and i in parent_ok[j]
                    bounds_ub[ei(m, i, j)] = 1.0 if allowed else 0.0
                    bounds_ub[fi(m, i, j)] = float(n - 1) if allowed else 0.0

        A = csr_matrix(
            (vals, (rows_i, cols)), shape=(len(lb), nvar), dtype=float
        )
        res = milp(
            c=c,
            constraints=LinearConstraint(A, np.array(lb), np.array(ub)),
            integrality=integrality,
            bounds=Bounds(bounds_lb, bounds_ub),
            options={"time_limit": ROUTING_MILP_TIME_LIMIT_S},
        )
        if not res.success or res.x is None:
            # status 2 = proven infeasible: only then can pruning itself be
            # the culprit, so retry once with the full candidate space.  A
            # timeout (status 1) must NOT retry — the unpruned instance is
            # strictly harder, and the reconstruction stall is documented
            # as bounded by one ROUTING_MILP_TIME_LIMIT_S
            if prune and getattr(res, "status", None) == 2:
                return self._synthesize_routing(
                    ip_table, local_rank0_list, prim, parallel_degree,
                    transmission_size, bandwidth_graph, latency_graph,
                    prune=False,
                )
            return None

        groups = _host_groups(ip_table, masters)
        ips = {r: ip for r, ip in enumerate(ip_table)}
        trees: List[Tree] = []
        shares: List[float] = []
        for m in range(m_trees):
            children: Dict[int, List[int]] = {}
            root = masters[int(np.argmax([res.x[ri(m, g)] for g in range(n)]))]
            for i in range(n):
                for j in range(n):
                    if i != j and res.x[ei(m, i, j)] > 0.5:
                        children.setdefault(masters[i], []).append(masters[j])
            _attach_chains(children, masters, groups)
            trees.append(Tree(root, children, ips))
            shares.append(float(res.x[si(m)]))
        return Strategy(
            trees, world, DEFAULT_CHUNK_BYTES, shares=shares,
            synthesis="milp-routing",
            tree_chunk_bytes=per_tree_chunk_bytes(shares, transmission_size),
        )

    # -- rotation formulation (roots + shares over ParTrees shapes) ------------

    def _synthesize_rotation(
        self,
        ip_table: Sequence[str],
        local_rank0_list: Sequence[int],
        prim: int,
        parallel_degree: int,
        transmission_size: int,
        bandwidth_graph: Sequence[Sequence[float]],
        latency_graph: Sequence[Sequence[float]],
    ) -> Strategy:
        from scipy.optimize import LinearConstraint, milp

        world = len(ip_table)
        masters = list(local_rank0_list)
        n = len(masters)
        m_trees = min(max(1, parallel_degree), n)
        size = float(max(transmission_size, 1))

        # candidate tree per root: ring rotation of masters starting at g
        rotations = {
            g: [masters[(i + k) % n] for k in range(n)] for i, g in enumerate(masters)
        }
        lat_c = np.zeros(n)
        bw_c = np.zeros(n)
        for i, g in enumerate(masters):
            lat_c[i], bw_c[i] = _tree_cost_coeffs(
                rotations[g], bandwidth_graph, latency_graph, prim
            )

        # variables: x[m,g] (n*m_trees binaries), s[m], u[m] (m_trees each), T
        nx = m_trees * n
        nvar = nx + 2 * m_trees + 1
        xi = lambda m, g: m * n + g
        si = lambda m: nx + m
        ui = lambda m: nx + m_trees + m
        Ti = nvar - 1

        c = np.zeros(nvar)
        c[Ti] = 1.0

        A_rows, lb, ub = [], [], []

        for m in range(m_trees):  # Σ_g x_mg = 1
            row = np.zeros(nvar)
            for g in range(n):
                row[xi(m, g)] = 1.0
            A_rows.append(row); lb.append(1.0); ub.append(1.0)
        for g in range(n):  # Σ_m x_mg ≤ 1
            row = np.zeros(nvar)
            for m in range(m_trees):
                row[xi(m, g)] = 1.0
            A_rows.append(row); lb.append(0.0); ub.append(1.0)
        row = np.zeros(nvar)  # Σ_m s_m = 1
        for m in range(m_trees):
            row[si(m)] = 1.0
        A_rows.append(row); lb.append(1.0); ub.append(1.0)
        for m in range(m_trees):  # s_m ≤ u_m (share only on used trees)
            row = np.zeros(nvar)
            row[si(m)] = 1.0
            row[ui(m)] = -1.0
            A_rows.append(row); lb.append(-np.inf); ub.append(0.0)

        big_m = float(lat_c.max() + size * bw_c.max()) + 1.0
        # T ≥ lat_g·x + size·k_g·s − M(1−x) − M(1−u): an unused (share-0)
        # tree's rotation latency must not bound T (same gate as the routing
        # formulation)
        for m in range(m_trees):
            for g in range(n):
                row = np.zeros(nvar)
                row[Ti] = 1.0
                row[xi(m, g)] = -(lat_c[g] + big_m)
                row[si(m)] = -size * bw_c[g]
                row[ui(m)] = -big_m
                A_rows.append(row); lb.append(-2.0 * big_m); ub.append(np.inf)

        integrality = np.zeros(nvar)
        integrality[:nx] = 1
        bounds_lb = np.zeros(nvar)
        bounds_ub = np.full(nvar, np.inf)
        bounds_ub[:nx] = 1.0
        for m in range(m_trees):
            integrality[ui(m)] = 1
            bounds_ub[ui(m)] = 1.0
            if prim == ALLTOALL:
                # same invariant as the routing formulation: alltoall
                # payloads are per-pair, not a shardable tensor — shares
                # stay uniform (the per-flow cost model assumes it)
                bounds_lb[si(m)] = bounds_ub[si(m)] = 1.0 / m_trees

        from scipy.optimize import Bounds

        res = milp(
            c=c,
            constraints=LinearConstraint(np.array(A_rows), np.array(lb), np.array(ub)),
            integrality=integrality,
            bounds=Bounds(bounds_lb, bounds_ub),
        )
        if not res.success:
            # solver hiccup → fall back to the heuristic, and say so in the
            # strategy provenance
            fallback = ParTrees().synthesize(
                ip_table, local_rank0_list, parallel_degree, bandwidth_graph, latency_graph
            )
            fallback.synthesis = "partrees-fallback"
            return fallback

        groups = _host_groups(ip_table, masters)
        ips = {r: ip for r, ip in enumerate(ip_table)}
        trees: List[Tree] = []
        shares: List[float] = []
        for m in range(m_trees):
            g = int(np.argmax(res.x[m * n : (m + 1) * n]))
            order = rotations[masters[g]]
            children = _heap_tree_edges(order)
            _attach_chains(children, order, groups)
            trees.append(Tree(order[0], children, ips))
            shares.append(float(res.x[si(m)]))
        return Strategy(
            trees, world, DEFAULT_CHUNK_BYTES, shares=shares,
            synthesis="milp-rotation",
            tree_chunk_bytes=per_tree_chunk_bytes(shares, transmission_size),
        )
