"""Hierarchical (inter-host × intra-host) strategy synthesis: a sketch of
the layout, then one solve a level.

The port of :mod:`adapcc_tpu.strategy.hierarchy`, a copy: host code on the
port's cost model (:mod:`adapcc_tpu_torch.sim.cost_model`, the H100's
defaults) and calibration.  A communication sketch (TACCL) names the ``pods
× pod_size`` layout, from the ip table or pinned by ``ADAPCC_HIER_SKETCH``
(malformed → loud); each level is solved alone against its link class's α-β
costs: the intra-host level (the JAX package's ``ICI``: NVLink inside a
node here) picks the pod schedule (the RS/AG split, which leaves
``1/pod_size`` of the payload to the slow level, or the replicate-first
fixed schedule), the inter-host level (``DCN``: the network between nodes)
the leaders' schedule (a binomial tree or the segmented leader ring).  The
levels compose into a slice-hierarchical :class:`~adapcc_tpu_torch.strategy.
ir.Strategy` (pod members chained under their leader, leaders wired by the
leader-level trees) that ``comm/two_level.py`` executes and the strategy
XML carries (``<trees hier=…>``).
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.strategy.ir import Strategy, Tree

#: env override pinning the sketch ("<pods>x<pod_size>", e.g. "4x8"); wins
#: over the ip-table-derived layout.  Malformed → loud error (the
#: ADAPCC_RING_CHUNK_BYTES precedent: a typo'd sketch silently falling back
#: to the flat plane would invalidate exactly the A/B it was set for).
HIER_SKETCH_ENV = "ADAPCC_HIER_SKETCH"

#: intra-pod schedule candidates: "rs-ag" (reduce-scatter the payload over
#: ICI so DCN carries 1/pod_size of it, all-gather after the leader level)
#: vs "replicate" (the incumbent fixed schedule: slice-local psum, DCN
#: carries the full payload — cheaper only when α dominates)
POD_ALGOS = ("rs-ag", "replicate")

#: cross-pod leader schedule candidates: "tree" (binomial over leaders —
#: log2(P) rounds of the full chunk, latency-optimal) vs "rs-ag" (segmented
#: leader ring — 2(P−1) rounds of chunk/P, bandwidth-optimal)
LEADER_ALGOS = ("tree", "rs-ag")


@dataclass(frozen=True)
class HierarchySketch:
    """The two-level layout: ``num_pods`` pods of ``pod_size`` ranks each,
    flat rank ``r`` at pod ``r // pod_size``, lane ``r % pod_size``; the
    pod leader is lane 0 (the local-rank-0 master convention)."""

    num_pods: int
    pod_size: int
    #: real per-rank ips when the sketch came from an ip table; synthetic
    #: ``pod-<p>`` labels otherwise
    ip_table: Optional[Tuple[str, ...]] = None

    def __post_init__(self) -> None:
        if self.num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {self.num_pods}")
        if self.pod_size < 2:
            raise ValueError(
                f"pod_size must be >= 2, got {self.pod_size}: a pod of one "
                "rank has no ICI level — use the flat plane"
            )
        if self.ip_table is not None and len(self.ip_table) != self.world:
            raise ValueError(
                f"ip table has {len(self.ip_table)} entries for a "
                f"{self.num_pods}x{self.pod_size} sketch (world {self.world})"
            )

    @property
    def world(self) -> int:
        return self.num_pods * self.pod_size

    def leader(self, pod: int) -> int:
        return pod * self.pod_size

    @property
    def leaders(self) -> List[int]:
        return [self.leader(p) for p in range(self.num_pods)]

    def pod_of(self, rank: int) -> int:
        return rank // self.pod_size

    def lane_of(self, rank: int) -> int:
        return rank % self.pod_size

    def ips(self) -> Dict[int, str]:
        if self.ip_table is not None:
            return {r: ip for r, ip in enumerate(self.ip_table)}
        return {r: f"pod-{self.pod_of(r)}" for r in range(self.world)}

    @classmethod
    def from_ip_table(cls, ip_table: Sequence[str]) -> "HierarchySketch":
        """Derive the sketch from a rank→ip table: each run of equal ips is
        one pod.  Loud rejection of layouts the two-level mesh cannot
        carry: ragged pods (unequal run lengths), a host appearing in two
        non-contiguous runs, and pods of one rank (no ICI level)."""
        ips = list(ip_table)
        if not ips:
            raise ValueError("cannot derive a hierarchy sketch from an empty ip table")
        runs: List[Tuple[str, int]] = []
        for ip in ips:
            if runs and runs[-1][0] == ip:
                runs[-1] = (ip, runs[-1][1] + 1)
            else:
                runs.append((ip, 1))
        seen: Dict[str, int] = {}
        for i, (ip, _) in enumerate(runs):
            if ip in seen:
                raise ValueError(
                    f"host {ip!r} appears in two non-contiguous rank runs "
                    f"(runs {seen[ip]} and {i}): the sketch needs contiguous "
                    "pods — fix the ip table's rank order"
                )
            seen[ip] = i
        sizes = {n for _, n in runs}
        if len(sizes) > 1:
            raise ValueError(
                f"ragged host layout {[(ip, n) for ip, n in runs]}: every pod "
                "must have the same rank count for a two-level sketch"
            )
        pod_size = runs[0][1]
        if pod_size < 2:
            raise ValueError(
                "every host holds a single rank: there is no ICI level to "
                "sketch — use the flat plane"
            )
        return cls(len(runs), pod_size, ip_table=tuple(ips))


def sketch_from_env(world: Optional[int] = None) -> Optional[HierarchySketch]:
    """The ``ADAPCC_HIER_SKETCH`` override, validated: None when unset,
    loud on a malformed spelling or a world mismatch."""
    raw = os.environ.get(HIER_SKETCH_ENV)
    if raw is None or not raw.strip():
        return None
    m = re.fullmatch(r"([1-9]\d*)x([1-9]\d*)", raw.strip().lower())
    if not m:
        raise ValueError(
            f"{HIER_SKETCH_ENV}={raw!r}: expected '<pods>x<pod_size>' "
            "(e.g. 4x8)"
        )
    pods, pod_size = int(m.group(1)), int(m.group(2))
    if world is not None and pods * pod_size != world:
        raise ValueError(
            f"{HIER_SKETCH_ENV}={raw!r} describes {pods * pod_size} ranks "
            f"but the world is {world}"
        )
    if pod_size < 2:
        raise ValueError(
            f"{HIER_SKETCH_ENV}={raw!r}: pod_size must be >= 2 (a pod of "
            "one rank has no ICI level)"
        )
    if pods < 2:
        return None  # single pod: the degenerate case IS the flat plane
    return HierarchySketch(pods, pod_size)


def resolve_sketch(
    world: Optional[int] = None, ip_table: Optional[Sequence[str]] = None
) -> Optional[HierarchySketch]:
    """The sketch in force: env override > ip-table-derived > None.

    Returns None exactly when the world is flat (single pod, or nothing to
    derive from) — the callers' cue to fall back to the flat plane.
    Malformed env values and ragged ip tables raise (never a silent flat
    fallback)."""
    env = sketch_from_env(world)
    if env is not None:
        return env
    if os.environ.get(HIER_SKETCH_ENV, "").strip():
        return None  # env said "1xN": explicitly the flat plane
    if ip_table is None:
        return None
    sketch = HierarchySketch.from_ip_table(ip_table)
    return sketch if sketch.num_pods >= 2 else None


def model_from_graphs(
    sketch: HierarchySketch,
    bandwidth_graph: Optional[Sequence[Sequence[float]]] = None,
    latency_graph: Optional[Sequence[Sequence[float]]] = None,
):
    """An O(num_pods) class-coefficient fit from profiled matrices — the
    sketch-aware twin of ``LinkCostModel.from_matrices``, whose full
    per-link fit is O(world²) and would alone blow the synthesis budget at
    pod-cluster scale.  The sketch names which probe pairs matter: one
    intra-pod edge per pod (ICI class) and each leader's ring-successor
    edge (DCN class).  ``None`` matrices fall back to the persisted
    calibration / synthetic defaults."""
    from adapcc_tpu_torch.sim.calibrate import load_or_default
    from adapcc_tpu_torch.sim.cost_model import (
        BANDWIDTH_PROBE_BYTES,
        DCN,
        ICI,
        LATENCY_PROBE_BYTES,
        LinkCostModel,
        fit_alpha_beta,
    )

    if bandwidth_graph is None or latency_graph is None:
        return load_or_default(world=sketch.world).with_ips(sketch.ips())
    if len(bandwidth_graph) != sketch.world or len(latency_graph) != sketch.world:
        raise ValueError(
            f"profile matrices are {len(bandwidth_graph)}-rank but the "
            f"sketch world is {sketch.world}"
        )

    def probe_points(s: int, d: int) -> List[Tuple[float, float]]:
        pts: List[Tuple[float, float]] = []
        lat, bw = float(latency_graph[s][d]), float(bandwidth_graph[s][d])
        if lat > 0:
            pts.append((LATENCY_PROBE_BYTES, lat))
        if bw > 0:
            pts.append(
                (BANDWIDTH_PROBE_BYTES, BANDWIDTH_PROBE_BYTES / (bw * 1e9))
            )
        return pts

    ici_pts: List[Tuple[float, float]] = []
    dcn_pts: List[Tuple[float, float]] = []
    for pod in range(sketch.num_pods):
        lead = sketch.leader(pod)
        ici_pts.extend(probe_points(lead, lead + 1))
        nxt = sketch.leader((pod + 1) % sketch.num_pods)
        if nxt != lead:
            dcn_pts.extend(probe_points(lead, nxt))
    classes = {}
    if ici_pts:
        classes[ICI] = fit_alpha_beta(ici_pts)
    if dcn_pts:
        classes[DCN] = fit_alpha_beta(dcn_pts)
    return LinkCostModel(
        sketch.world, classes=classes, ips=sketch.ips(),
        source="hier-sketch-probes",
    )


# --------------------------------------------------------------------------- #
# per-level solve
# --------------------------------------------------------------------------- #

@dataclass
class LevelSolve:
    """One level's solve: the winning schedule, the priced candidate field,
    and the host walltime the solve cost (the number the synthesis-scale
    curve records)."""

    level: str                      #: "ici" | "dcn"
    algo: str
    predicted_s: float
    candidates: Dict[str, float]
    solve_s: float

    def to_row(self) -> dict:
        return {
            "level": self.level,
            "algo": self.algo,
            "pred_us": round(self.predicted_s * 1e6, 3),
            "candidates_us": {
                k: round(v * 1e6, 3) for k, v in self.candidates.items()
            },
            "solve_ms": round(self.solve_s * 1e3, 4),
        }


def solve_leader_level(
    num_pods: int, dcn, chunk_bytes: float
) -> LevelSolve:
    """DCN level: price the cross-leader allreduce of one ``chunk_bytes``
    payload per candidate (O(num_pods) arithmetic, no world-sized state)
    and keep the cheapest; ties keep "tree" (candidate order)."""
    from adapcc_tpu_torch.sim.cost_model import two_level_leader_time

    t0 = time.perf_counter()
    times = {
        algo: two_level_leader_time(num_pods, chunk_bytes, dcn, algo)
        for algo in LEADER_ALGOS
    }
    algo = min(LEADER_ALGOS, key=lambda a: times[a])
    return LevelSolve("dcn", algo, times[algo], times, time.perf_counter() - t0)


def solve_pod_level(
    sketch: HierarchySketch, ici, dcn, nbytes: float
) -> Tuple[LevelSolve, LevelSolve]:
    """ICI level: choose between the RS/AG split (DCN carries ``nbytes /
    pod_size``) and the replicate-first fixed schedule (DCN carries the
    full payload), each composed with its own best leader-level solve —
    the pod algorithm decides the DCN volume, so the two levels are priced
    jointly but *solved* independently (O(pod) + O(num_pods)).  Returns
    ``(pod_solve, leader_solve_of_the_winner)``."""
    from adapcc_tpu_torch.sim.cost_model import two_level_allreduce_time

    leaders = {
        "rs-ag": solve_leader_level(
            sketch.num_pods, dcn, nbytes / sketch.pod_size
        ),
        "replicate": solve_leader_level(sketch.num_pods, dcn, nbytes),
    }
    t0 = time.perf_counter()
    times = {
        pod_algo: two_level_allreduce_time(
            sketch.num_pods, sketch.pod_size, nbytes, ici, dcn,
            pod_algo=pod_algo, leader_algo=leaders[pod_algo].algo,
        )
        for pod_algo in POD_ALGOS
    }
    algo = min(POD_ALGOS, key=lambda a: times[a])
    pod = LevelSolve("ici", algo, times[algo], times, time.perf_counter() - t0)
    return pod, leaders[algo]


# --------------------------------------------------------------------------- #
# composition: per-level solves → one slice-hierarchical Strategy
# --------------------------------------------------------------------------- #

@dataclass
class TwoLevelPlan:
    """The synthesized two-level plan: the sketch, both level solves, the
    leader-level strategy (trees over pod indices — what the DCN rounds
    execute), and the composed full-world :class:`Strategy`."""

    sketch: HierarchySketch
    pod_algo: str                   #: "rs-ag" | "replicate"
    leader_algo: str                #: "tree" | "rs-ag"
    leader_strategy: Strategy       #: world = num_pods (pod indices)
    strategy: Strategy = field(repr=False)
    predicted_s: float = 0.0
    ici_solve: Optional[LevelSolve] = None
    dcn_solve: Optional[LevelSolve] = None
    #: total synthesis walltime (solves + composition)
    solve_s: float = 0.0
    #: which levels this plan re-solved: "both" at synthesis, "dcn" when a
    #: DCN drift re-solved only the leader level (pod level kept warm)
    resolved_level: str = "both"
    #: the flat lockstep ring's predicted time on the same payload (the
    #: hierarchy-blind comparator) and which arm the pod-count-aware
    #: crossover chose — stamped at synthesis so bench rows are artifacts
    flat_pred_s: float = 0.0
    chosen_vs_flat: str = "two_level"

    def to_row(self) -> dict:
        return {
            "pods": self.sketch.num_pods,
            "pod_size": self.sketch.pod_size,
            "world": self.sketch.world,
            "pod_algo": self.pod_algo,
            "leader_algo": self.leader_algo,
            "pred_us": round(self.predicted_s * 1e6, 3),
            "pred_flat_us": round(self.flat_pred_s * 1e6, 3),
            "chosen": self.chosen_vs_flat,
            "solve_ms": round(self.solve_s * 1e3, 4),
            "resolved_level": self.resolved_level,
            "levels": [
                s.to_row() for s in (self.ici_solve, self.dcn_solve) if s
            ],
        }


def attach_plan(strategy: Strategy, plan: TwoLevelPlan) -> Strategy:
    """Carry the plan on the composed strategy (the engine's dispatch cue:
    a strategy with a plan executes the composed RS→AR→AG phases instead
    of the fixed replicate-first schedule)."""
    strategy._two_level_plan = plan
    return strategy


def plan_of(strategy: Strategy) -> Optional[TwoLevelPlan]:
    return getattr(strategy, "_two_level_plan", None)


def _compose_trees(
    sketch: HierarchySketch, leader_strategy: Strategy, ips: Dict[int, str]
) -> List[Tree]:
    """Lower each leader tree (over pod indices) to a full-world tree: pod
    leaders keep the leader tree's edges, every pod's remaining lanes chain
    under their leader (the ParTrees chain policy — the chain head is the
    leader's FIRST child so the fast local edge gets staging priority).
    Slice-hierarchical by construction: exactly one inbound inter-pod edge
    per non-root pod, so ``comm.two_level.slice_tree`` accepts it."""
    P, I = sketch.num_pods, sketch.pod_size
    trees: List[Tree] = []
    for lt in leader_strategy.trees:
        children: Dict[int, List[int]] = {}
        for pod, kids in lt.children.items():
            children[sketch.leader(pod)] = [sketch.leader(c) for c in kids]
        for pod in range(P):
            head = sketch.leader(pod)
            members = list(range(head + 1, head + I))
            kids = children.setdefault(head, [])
            kids.insert(0, members[0])
            for a, b in zip(members, members[1:]):
                children.setdefault(a, []).append(b)
        trees.append(Tree(sketch.leader(lt.root), children, ips))
    return trees


def leader_projection(strategy: Strategy, sketch: HierarchySketch) -> Strategy:
    """Collapse a composed strategy back to its leader-level trees (pure
    arithmetic — the twin of ``comm.two_level.slice_tree`` over pods, used
    by the XML reattach path and the structural tests).  Rejects trees
    that are not slice-hierarchical, loudly."""
    trees: List[Tree] = []
    for tree in strategy.trees:
        inbound: Dict[int, int] = {}
        children: Dict[int, List[int]] = {}
        for c, p in tree.parent.items():
            pp, pc = sketch.pod_of(p), sketch.pod_of(c)
            if pp == pc:
                continue
            if pc in inbound:
                raise ValueError(
                    f"pod {pc} has two inbound inter-pod edges (from "
                    f"{inbound[pc]} and {pp}); strategy is not "
                    "slice-hierarchical"
                )
            inbound[pc] = pp
            children.setdefault(pp, []).append(pc)
        root = sketch.pod_of(tree.root)
        lt = Tree(root, children)
        missing = set(range(sketch.num_pods)) - lt.ranks
        if missing:
            raise ValueError(
                f"pods {sorted(missing)} unreachable in the leader tree"
            )
        trees.append(lt)
    return Strategy(trees, sketch.num_pods, synthesis="leader-projection")


def synthesize_two_level(
    sketch: HierarchySketch,
    model=None,
    nbytes: int = 16 << 20,
    num_trans: int = 1,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> TwoLevelPlan:
    """Sketch → per-level solve → composed :class:`Strategy` (module doc).

    ``model`` is a :class:`~adapcc_tpu.sim.cost_model.LinkCostModel`
    (default: the persisted calibration artifact / synthetic defaults) —
    only its ICI/DCN *class* coefficients are read, so synthesis never
    touches world² state.  The composed strategy carries the plan
    (:func:`plan_of`) and the sketch survives the strategy XML.
    """
    from adapcc_tpu_torch.sim.cost_model import DCN, ICI, choose_two_level

    if sketch.num_pods < 2:
        raise ValueError(
            f"two-level synthesis needs >= 2 pods, got {sketch.num_pods}: "
            "a single-pod world is the flat plane"
        )
    t0 = time.perf_counter()
    if model is None:
        from adapcc_tpu_torch.sim.calibrate import load_or_default

        model = load_or_default(world=sketch.world)
    ici, dcn = model.classes[ICI], model.classes[DCN]
    pod_solve, dcn_solve = solve_pod_level(sketch, ici, dcn, float(nbytes))
    chosen_vs_flat, vs_flat = choose_two_level(
        sketch.num_pods, sketch.pod_size, float(nbytes), ici, dcn
    )
    degree = min(max(1, num_trans), sketch.num_pods)
    if dcn_solve.algo == "tree":
        leader_strategy = Strategy.binary(sketch.num_pods, degree)
    else:
        # the segmented leader ring's IR spelling is the rotated chain —
        # the two-level plane runs it as a reduce-scatter and an all-gather
        # across the slices
        leader_strategy = Strategy.ring(sketch.num_pods, degree)
    strategy = Strategy(
        _compose_trees(sketch, leader_strategy, sketch.ips()),
        sketch.world,
        chunk_bytes,
        synthesis="two-level",
    )
    plan = TwoLevelPlan(
        sketch=sketch,
        pod_algo=pod_solve.algo,
        leader_algo=dcn_solve.algo,
        leader_strategy=leader_strategy,
        strategy=strategy,
        predicted_s=pod_solve.predicted_s,
        ici_solve=pod_solve,
        dcn_solve=dcn_solve,
        solve_s=time.perf_counter() - t0,
        flat_pred_s=vs_flat["flat"],
        chosen_vs_flat=chosen_vs_flat,
    )
    attach_plan(strategy, plan)
    return plan


def resolve_leader_level(
    plan: TwoLevelPlan, model, nbytes: Optional[int] = None
) -> TwoLevelPlan:
    """Re-solve ONLY the DCN level under a (drift-corrected) ``model`` —
    the drift-localization half of the closed loop:
    a DCN degradation says nothing about the ICI level, so the pod
    algorithm (and every pod-level compiled program keyed by it) stays
    warm; only the leader schedule is re-priced and re-composed.

    Returns a fresh plan with ``resolved_level="dcn"`` and the pod solve
    carried over verbatim (``ici_solve`` object identity preserved — the
    tests pin that no pod-level work re-ran)."""
    from adapcc_tpu_torch.sim.cost_model import DCN, two_level_allreduce_time, ICI

    t0 = time.perf_counter()
    sketch = plan.sketch
    n = float(nbytes) if nbytes is not None else float(16 << 20)
    dcn = model.classes[DCN]
    ici = model.classes[ICI]
    chunk = n / sketch.pod_size if plan.pod_algo == "rs-ag" else n
    dcn_solve = solve_leader_level(sketch.num_pods, dcn, chunk)
    degree = plan.leader_strategy.num_trans
    if dcn_solve.algo == "tree":
        leader_strategy = Strategy.binary(sketch.num_pods, degree)
    else:
        leader_strategy = Strategy.ring(sketch.num_pods, degree)
    strategy = Strategy(
        _compose_trees(sketch, leader_strategy, sketch.ips()),
        sketch.world,
        plan.strategy.chunk_bytes,
        synthesis="two-level",
    )
    strategy.wire_dtype = plan.strategy.wire_dtype
    new = TwoLevelPlan(
        sketch=sketch,
        pod_algo=plan.pod_algo,
        leader_algo=dcn_solve.algo,
        leader_strategy=leader_strategy,
        strategy=strategy,
        predicted_s=two_level_allreduce_time(
            sketch.num_pods, sketch.pod_size, n, ici, dcn,
            pod_algo=plan.pod_algo, leader_algo=dcn_solve.algo,
        ),
        ici_solve=plan.ici_solve,   # NOT re-solved: the pod level is warm
        dcn_solve=dcn_solve,
        solve_s=time.perf_counter() - t0,
        resolved_level="dcn",
    )
    attach_plan(strategy, new)
    return new


def leader_variant(plan: TwoLevelPlan, leader_algo: str) -> TwoLevelPlan:
    """The composed plan with a FORCED leader schedule (no solve) — the
    per-level standby shape: every schedule the DCN level could re-solve
    to is constructible ahead of the drift that wants it."""
    if leader_algo not in LEADER_ALGOS:
        raise ValueError(
            f"unknown leader algo {leader_algo!r}; expected one of "
            f"{LEADER_ALGOS}"
        )
    if leader_algo == plan.leader_algo:
        return plan
    sketch = plan.sketch
    degree = plan.leader_strategy.num_trans
    leader_strategy = (
        Strategy.binary(sketch.num_pods, degree)
        if leader_algo == "tree"
        else Strategy.ring(sketch.num_pods, degree)
    )
    strategy = Strategy(
        _compose_trees(sketch, leader_strategy, sketch.ips()),
        sketch.world,
        plan.strategy.chunk_bytes,
        synthesis="two-level",
    )
    strategy.wire_dtype = plan.strategy.wire_dtype
    variant = TwoLevelPlan(
        sketch=sketch,
        pod_algo=plan.pod_algo,
        leader_algo=leader_algo,
        leader_strategy=leader_strategy,
        strategy=strategy,
        ici_solve=plan.ici_solve,
        dcn_solve=None,          # forced, not solved
        # honest provenance: this variant was FORCED for standby warming,
        # not drift-resolved — a trace reading "dcn" here would fake a
        # leader re-solve that never happened
        resolved_level="forced",
    )
    attach_plan(strategy, variant)
    return variant


def plan_from_strategy(
    strategy: Strategy,
    sketch: HierarchySketch,
    pod_algo: str,
    leader_algo: str,
) -> TwoLevelPlan:
    """Reconstruct the plan for a composed strategy whose sketch rode an
    artifact (the strategy-XML reattach path): the leader level IS the
    composed trees' pod projection, so nothing beyond the three stamped
    attributes is needed."""
    if pod_algo not in POD_ALGOS:
        raise ValueError(
            f"unknown pod algo {pod_algo!r}; expected one of {POD_ALGOS}"
        )
    if leader_algo not in LEADER_ALGOS:
        raise ValueError(
            f"unknown leader algo {leader_algo!r}; expected one of "
            f"{LEADER_ALGOS}"
        )
    if strategy.world_size != sketch.world:
        raise ValueError(
            f"strategy world {strategy.world_size} != sketch world "
            f"{sketch.world}"
        )
    plan = TwoLevelPlan(
        sketch=sketch,
        pod_algo=pod_algo,
        leader_algo=leader_algo,
        leader_strategy=leader_projection(strategy, sketch),
        strategy=strategy,
    )
    attach_plan(strategy, plan)
    return plan
