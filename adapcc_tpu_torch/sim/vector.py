"""Vectorized round-synchronous replay: the large-world fast path (the port
of :mod:`adapcc_tpu.sim.vector`).

The discrete-event oracle (:class:`adapcc_tpu_torch.sim.events.EventSimulator`)
places one transfer per Python loop iteration — exact, but O(colors ×
trees × chunks × edges) interpreter work, which caps it at worlds of a
few hundred.  This module replays the SAME greedy placement as numpy
array algebra over per-round (src, dst, link, link-class) columns, so a
world=131072 strategy prices in seconds instead of hours.

Why the algebra is exact (not an approximation): within one lowered
round the edges form a *matching* — ``ir._pack_rounds`` packs
dependency-ordered edges so that per round, sources are distinct,
destinations are distinct, and no rank both sends and receives (an edge
out of a rank is always packed strictly after every edge into it).
Under the event simulator's resource model (per-link, per-egress-port,
per-ingress-port free times plus per-(tree, chunk) readiness), matched
edges never read a resource another edge in the same batch wrote, so a
whole round column places in one ``np.maximum`` chain — bitwise equal
to the sequential loop, because ``max`` is order-independent and the
single ``start + dur`` addition is the same operation.  Rounds that are
NOT matchings (hand-built ``CommRound``s, foreign lowerings) fall back
to exact sequential *waves* within the same engine — never a silent
approximation.

Two caches make re-pricing incremental (the hot loop of
``adapt/controller.py`` re-ranks, ``sim/congestion.py`` window replays,
and ``StandbyPlanCache`` scenario sweeps):

- **structure** — the lowered columns are cached per (strategy
  fingerprint, chunking spec, collective, relay mask), so pricing a
  strategy under a drifted/contended/degraded model never re-lowers
  trees or re-prunes relay masks;
- **class membership** — each column's ICI/DCN split is a cached host-id
  comparison, so a correction that touches one link class re-prices as
  one ``np.where`` over the affected columns (β vector swap), not a
  per-edge Python walk.  Per-link overrides (degraded links, per-link
  calibration fits) patch the class vectors sparsely.

Engine selection is funneled through ``ADAPCC_SIM_ENGINE``
(``auto`` | ``event`` | ``vector``; a malformed value raises).  ``auto`` — the default — keeps small worlds on
the event oracle and switches to this path at
:data:`VECTOR_MIN_WORLD` ranks.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

from adapcc_tpu_torch.sim.cost_model import DCN, ICI, Link, LinkCostModel
from adapcc_tpu_torch.sim.events import SimReport
from adapcc_tpu_torch.strategy.ir import Strategy

#: env knob selecting the replay engine; malformed → loud ValueError
SIM_ENGINE_ENV = "ADAPCC_SIM_ENGINE"

#: the engines ``ADAPCC_SIM_ENGINE`` (and the ``engine=`` kwargs) accept
SIM_ENGINES = ("auto", "event", "vector")

#: ``auto`` switches from the event oracle to the vectorized path at this
#: world size — below it the per-transfer loop is already sub-millisecond
#: and keeps its per-transfer log; above it interpreter overhead dominates
VECTOR_MIN_WORLD = 256


def resolve_sim_engine(engine: Optional[str], world: int) -> str:
    """``engine`` arg > ``ADAPCC_SIM_ENGINE`` env > ``auto``; returns the
    concrete engine (``"event"`` or ``"vector"``), never ``"auto"``."""
    raw = engine
    if raw is None:
        raw = os.environ.get(SIM_ENGINE_ENV, "").strip() or "auto"
    choice = str(raw).strip().lower()
    if choice not in SIM_ENGINES:
        raise ValueError(
            f"the {SIM_ENGINE_ENV} replay engine must be one of "
            f"{SIM_ENGINES}, got {raw!r}"
        )
    if choice == "auto":
        return "vector" if world >= VECTOR_MIN_WORLD else "event"
    return choice


# --------------------------------------------------------------------------- #
# lowered column structure
# --------------------------------------------------------------------------- #


@dataclass
class RoundCols:
    """One lowered round as columns: parallel (src, dst, link-id) arrays."""

    srcs: np.ndarray  # int64 (E,)
    dsts: np.ndarray  # int64 (E,)
    eidx: np.ndarray  # int64 (E,) — indices into the structure's link table
    #: True when the round is a matching (distinct srcs, distinct dsts,
    #: no rank both sends and receives) — the batched placement is exact
    matching: bool
    #: exact sequential fallback for non-matching rounds: index arrays
    #: into the round's columns, each wave internally conflict-free
    waves: Optional[List[np.ndarray]] = None


@dataclass
class TreeCols:
    """One tree's lowered rounds plus its share of the payload."""

    rounds: List[RoundCols]
    share: float
    chunk_bytes: float
    label: str = ""


class _LinkTable:
    """Shared link-table behavior for column structures: the directed-link
    vocabulary plus the cached rank → host-id vectors the class-membership
    pricing uses.  Subclasses provide ``world``, ``link_srcs``,
    ``link_dsts``, ``link_pos`` and a ``_host_ids`` OrderedDict field."""

    @property
    def num_links(self) -> int:
        return len(self.link_srcs)

    def host_ids(self, ips: Optional[Dict[int, str]]) -> Optional[np.ndarray]:
        """Rank → integer host id under ``ips`` (None → one flat domain),
        cached per ip-table object: the class-membership half of a pricing
        never recomputes across re-prices under the same layout."""
        if ips is None:
            return None
        key = id(ips)
        hit = self._host_ids.get(key)
        if hit is not None and hit[0] is ips:
            self._host_ids.move_to_end(key)
            return hit[1]
        token: Dict[object, int] = {}
        out = np.empty(self.world, dtype=np.int64)
        for r in range(self.world):
            ip = ips.get(r)
            out[r] = token.setdefault(ip, len(token))
        self._host_ids[key] = (ips, out)
        while len(self._host_ids) > 8:
            self._host_ids.popitem(last=False)
        return out


@dataclass
class LoweredColumns(_LinkTable):
    """A strategy lowered once into numpy columns, re-priced many times."""

    world: int
    trees: List[TreeCols]
    #: global directed-link table: link ``i`` is (link_srcs[i], link_dsts[i])
    link_srcs: np.ndarray
    link_dsts: np.ndarray
    link_pos: Dict[Link, int]
    strategy_label: str = ""
    #: per-ips-table host-id vectors, keyed by ``id(ips)`` with a strong
    #: reference to the keyed object so the id can never be recycled
    _host_ids: "OrderedDict[int, Tuple[object, np.ndarray]]" = field(
        default_factory=OrderedDict, repr=False
    )


def _split_waves(
    srcs: np.ndarray, dsts: np.ndarray
) -> List[np.ndarray]:
    """Split a non-matching round into sequential, internally conflict-free
    waves, preserving edge order.  Edge ``j`` must start a new wave when it
    READS state an earlier edge in the wave WROTE: its src in the wave's
    srcs (egress) or dsts (readiness/ingress chains), or its dst in the
    wave's dsts (ingress)."""
    waves: List[List[int]] = []
    wave_srcs: set = set()
    wave_dsts: set = set()
    for j, (s, d) in enumerate(zip(srcs.tolist(), dsts.tolist())):
        if not waves or s in wave_srcs or s in wave_dsts or d in wave_dsts:
            waves.append([])
            wave_srcs, wave_dsts = set(), set()
        waves[-1].append(j)
        wave_srcs.add(s)
        wave_dsts.add(d)
    return [np.asarray(w, dtype=np.int64) for w in waves]


def lower_columns(
    strategy: Strategy,
    collective: str = "allreduce",
    active: Optional[Iterable[int]] = None,
) -> LoweredColumns:
    """Lower a strategy (relay-pruned under ``active``) into column arrays.

    Uncached — callers on a re-pricing loop want :func:`lowered_columns`.
    """
    from adapcc_tpu_torch.sim.replay import _tree_rounds  # deferred: replay imports us

    act = frozenset(active) if active is not None else None
    link_pos: Dict[Link, int] = {}
    trees: List[TreeCols] = []
    for i, (tree, share) in enumerate(
        zip(strategy.trees, strategy.tree_shares())
    ):
        rounds: List[RoundCols] = []
        for rnd in _tree_rounds(tree, collective, act):
            if not rnd.edges:
                continue
            srcs = np.fromiter((e[0] for e in rnd.edges), dtype=np.int64)
            dsts = np.fromiter((e[1] for e in rnd.edges), dtype=np.int64)
            eidx = np.fromiter(
                (
                    link_pos.setdefault((int(s), int(d)), len(link_pos))
                    for s, d in rnd.edges
                ),
                dtype=np.int64,
            )
            sset, dset = set(srcs.tolist()), set(dsts.tolist())
            matching = (
                len(sset) == len(srcs)
                and len(dset) == len(dsts)
                and not (sset & dset)
            )
            rounds.append(
                RoundCols(
                    srcs=srcs,
                    dsts=dsts,
                    eidx=eidx,
                    matching=matching,
                    waves=None if matching else _split_waves(srcs, dsts),
                )
            )
        trees.append(
            TreeCols(
                rounds=rounds,
                share=share,
                chunk_bytes=float(strategy.chunk_bytes_for_tree(i)),
                label=f"tree@{tree.root}",
            )
        )
    link_srcs = np.fromiter((s for s, _ in link_pos), dtype=np.int64)
    link_dsts = np.fromiter((d for _, d in link_pos), dtype=np.int64)
    return LoweredColumns(
        world=strategy.world_size,
        trees=trees,
        link_srcs=link_srcs,
        link_dsts=link_dsts,
        link_pos=link_pos,
        strategy_label=(
            f"{strategy.synthesis or 'unnamed'} x{strategy.num_trans}"
        ),
    )


#: (fingerprint, chunking spec, collective, mask) → LoweredColumns.
#: fingerprint covers world + tree structure; the chunking spec rides in
#: the key because two strategies can share trees but pipeline differently.
_LOWERING_CACHE: "OrderedDict[tuple, LoweredColumns]" = OrderedDict()
_LOWERING_CACHE_MAX = 64
_LOWERING_CACHE_STATS = {"hits": 0, "misses": 0}


def _lowering_key(
    strategy: Strategy, collective: str, act: Optional[FrozenSet[int]]
) -> tuple:
    return (
        strategy.fingerprint(),
        strategy.chunk_bytes,
        tuple(strategy.tree_chunk_bytes or ()),
        tuple(strategy.shares or ()),
        collective,
        act,
    )


def lowered_columns(
    strategy: Strategy,
    collective: str = "allreduce",
    active: Optional[Iterable[int]] = None,
) -> LoweredColumns:
    """:func:`lower_columns` behind the module LRU — the incremental
    re-pricing entry point: a controller correction, congestion window, or
    standby scenario that re-prices an already-seen (strategy, collective,
    mask) pays only the column algebra, never the lowering."""
    act = frozenset(active) if active is not None else None
    key = _lowering_key(strategy, collective, act)
    hit = _LOWERING_CACHE.get(key)
    if hit is not None:
        _LOWERING_CACHE_STATS["hits"] += 1
        _LOWERING_CACHE.move_to_end(key)
        return hit
    _LOWERING_CACHE_STATS["misses"] += 1
    cols = lower_columns(strategy, collective, act)
    _LOWERING_CACHE[key] = cols
    while len(_LOWERING_CACHE) > _LOWERING_CACHE_MAX:
        _LOWERING_CACHE.popitem(last=False)
    return cols


def clear_lowering_cache() -> None:
    """Drop cached lowered columns (tests pin cold-vs-warm equivalence)."""
    _LOWERING_CACHE.clear()
    _LOWERING_CACHE_STATS["hits"] = _LOWERING_CACHE_STATS["misses"] = 0


def lowering_cache_info() -> Dict[str, int]:
    return {
        "entries": len(_LOWERING_CACHE),
        "max": _LOWERING_CACHE_MAX,
        "hits": _LOWERING_CACHE_STATS["hits"],
        "misses": _LOWERING_CACHE_STATS["misses"],
    }


# --------------------------------------------------------------------------- #
# ScheduleProgram columns: the IR-replay twin of the strategy lowering
# --------------------------------------------------------------------------- #


@dataclass
class ProgramRoundCols:
    """One IR round as columns: one entry per *distinct directed link*,
    with the number of chunks that coalesce onto it (the event loop's
    ``seg * len(chunks)`` serialization rule, pre-grouped)."""

    srcs: np.ndarray    # int64 (E,)
    dsts: np.ndarray    # int64 (E,)
    eidx: np.ndarray    # int64 (E,) — indices into the link table
    counts: np.ndarray  # float64 (E,) — chunks coalesced per link


@dataclass
class ProgramColumns(_LinkTable):
    """A ``compiler.ScheduleProgram`` lowered once into per-round link
    columns, re-priced many times (the pipeline-sweep / large-stage-count
    workload).  Rounds with no sends are dropped — they cost nothing in
    the event loop too."""

    world: int
    chunks: int
    rounds: List[ProgramRoundCols]
    link_srcs: np.ndarray
    link_dsts: np.ndarray
    link_pos: Dict[Link, int]
    label: str = ""
    _host_ids: "OrderedDict[int, Tuple[object, np.ndarray]]" = field(
        default_factory=OrderedDict, repr=False
    )


def lower_program_columns(program) -> ProgramColumns:
    """Group each round's sends by directed link into numpy columns."""
    link_pos: Dict[Link, int] = {}
    rounds: List[ProgramRoundCols] = []
    for rnd in program.rounds:
        per_link: "OrderedDict[Link, int]" = OrderedDict()
        for step in rnd:
            if step.kind == "send":
                link = (step.rank, step.peer)
                per_link[link] = per_link.get(link, 0) + 1
        if not per_link:
            continue
        E = len(per_link)
        srcs = np.empty(E, dtype=np.int64)
        dsts = np.empty(E, dtype=np.int64)
        eidx = np.empty(E, dtype=np.int64)
        counts = np.empty(E, dtype=np.float64)
        for j, (link, count) in enumerate(per_link.items()):
            pos = link_pos.get(link)
            if pos is None:
                pos = link_pos[link] = len(link_pos)
            srcs[j], dsts[j] = link
            eidx[j] = pos
            counts[j] = float(count)
        rounds.append(ProgramRoundCols(srcs, dsts, eidx, counts))
    link_srcs = np.array([l[0] for l in link_pos], dtype=np.int64)
    link_dsts = np.array([l[1] for l in link_pos], dtype=np.int64)
    return ProgramColumns(
        world=program.world,
        chunks=program.chunks,
        rounds=rounds,
        link_srcs=link_srcs,
        link_dsts=link_dsts,
        link_pos=link_pos,
        label=f"program:{program.name}@{program.fingerprint()}",
    )


#: program fingerprint → ProgramColumns (the program is immutable, so the
#: fingerprint alone keys the structure — no chunking spec or mask axis)
_PROGRAM_CACHE: "OrderedDict[str, ProgramColumns]" = OrderedDict()
_PROGRAM_CACHE_MAX = 64
_PROGRAM_CACHE_STATS = {"hits": 0, "misses": 0}


def program_columns(program) -> ProgramColumns:
    """:func:`lower_program_columns` behind the module LRU — re-pricing a
    pipeline program across a (stages × microbatches) sweep pays the
    grouping walk once per program."""
    key = program.fingerprint()
    hit = _PROGRAM_CACHE.get(key)
    if hit is not None:
        _PROGRAM_CACHE_STATS["hits"] += 1
        _PROGRAM_CACHE.move_to_end(key)
        return hit
    _PROGRAM_CACHE_STATS["misses"] += 1
    cols = lower_program_columns(program)
    _PROGRAM_CACHE[key] = cols
    while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
        _PROGRAM_CACHE.popitem(last=False)
    return cols


def clear_program_cache() -> None:
    """Drop cached program columns (tests pin cold-vs-warm equivalence)."""
    _PROGRAM_CACHE.clear()
    _PROGRAM_CACHE_STATS["hits"] = _PROGRAM_CACHE_STATS["misses"] = 0


def program_cache_info() -> Dict[str, int]:
    return {
        "entries": len(_PROGRAM_CACHE),
        "max": _PROGRAM_CACHE_MAX,
        "hits": _PROGRAM_CACHE_STATS["hits"],
        "misses": _PROGRAM_CACHE_STATS["misses"],
    }


def vector_program_run(
    cols: ProgramColumns,
    model: LinkCostModel,
    nbytes: float,
    keep_links: bool = False,
) -> SimReport:
    """Replay program columns under ``model`` — the numpy twin of
    ``replay.simulate_program``'s event loop, bitwise equal on the
    makespan: per round each link's coalesced transfer costs
    ``α + β·(seg·count)`` (the identical float expression), distinct
    links run concurrently, and the round-barrier advance
    ``clock + max(durs)`` is the same operation as the event loop's
    ``max(clock + dur_i)`` because addition is monotone.  The
    per-transfer log is never kept on this path (that is what the event
    oracle is for); per-link busy is opt-in via ``keep_links``.
    """
    alpha, beta, cls_vec = _link_coeff_vectors(cols, model)
    seg = float(nbytes) / max(1, cols.chunks)
    busy = np.zeros(cols.num_links)
    clock = 0.0
    for rc in cols.rounds:
        durs = alpha[rc.eidx] + beta[rc.eidx] * (seg * rc.counts)
        busy[rc.eidx] += durs
        clock = clock + float(durs.max())

    class_busy: Dict[str, float] = {}
    if cols.num_links:
        class_busy[ICI] = float(busy[~cls_vec].sum())
        if bool(cls_vec.any()):
            class_busy[DCN] = float(busy[cls_vec].sum())
    link_busy: Dict[Link, float] = {}
    if keep_links:
        link_busy = {
            (int(s), int(d)): float(b)
            for s, d, b in zip(cols.link_srcs, cols.link_dsts, busy)
        }
    return SimReport(
        makespan=clock,
        transfers=[],
        link_busy=link_busy,
        class_busy=class_busy,
    )


# --------------------------------------------------------------------------- #
# pricing: per-link α/β vectors under one cost model
# --------------------------------------------------------------------------- #


def _link_coeff_vectors(
    cols: LoweredColumns, model: LinkCostModel
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(α, β, class-id) vectors over the structure's link table.

    Class coefficients broadcast over the cached host-id comparison (the
    one-``np.where`` re-price); per-link overrides — degraded links,
    per-link calibration fits — patch sparsely, O(#overrides)."""
    host = cols.host_ids(model.ips)
    n = cols.num_links
    ici, dcn = model.classes[ICI], model.classes[DCN]
    if host is None:
        cls = np.zeros(n, dtype=bool)  # everything ICI: one flat domain
        alpha = np.full(n, ici.alpha)
        beta = np.full(n, ici.beta)
    else:
        cls = host[cols.link_srcs] != host[cols.link_dsts]
        alpha = np.where(cls, dcn.alpha, ici.alpha)
        beta = np.where(cls, dcn.beta, ici.beta)
    if model.links:
        pos = cols.link_pos
        for link, c in model.links.items():
            p = pos.get(link)
            if p is not None:
                alpha[p] = c.alpha
                beta[p] = c.beta
    return alpha, beta, cls


# --------------------------------------------------------------------------- #
# the replay itself
# --------------------------------------------------------------------------- #


def vector_run(
    cols: LoweredColumns,
    model: LinkCostModel,
    nbytes: float,
    keep_links: bool = False,
) -> SimReport:
    """Replay lowered columns under ``model`` — the numpy twin of
    :meth:`EventSimulator.run`, same greedy placement, same timestamps.

    Returns a :class:`SimReport` with per-link-class busy aggregation
    (O(#classes), world-size-independent); the full per-link busy map is
    opt-in via ``keep_links`` — a 100k-rank replay must not hold a
    world-sized dict per candidate.  The per-transfer log is never kept
    on this path (that is what the event oracle is for).
    """
    alpha, beta, cls_vec = _link_coeff_vectors(cols, model)

    # per-tree chunking, exactly TreeSchedule.num_chunks's rule
    num_chunks: List[int] = []
    chunk_size: List[float] = []
    for tc in cols.trees:
        tb = nbytes * tc.share
        if tb <= 0 or tc.chunk_bytes <= 0:
            c = 1
        else:
            c = max(1, int(-(-tb // tc.chunk_bytes)))
        num_chunks.append(c)
        chunk_size.append(tb / c if c else 0.0)

    link_free = np.zeros(cols.num_links)
    busy = np.zeros(cols.num_links)
    egress = np.zeros(cols.world)
    ingress = np.zeros(cols.world)
    ready = [
        np.zeros((num_chunks[t], cols.world)) for t in range(len(cols.trees))
    ]
    makespan = 0.0

    colors = max((len(tc.rounds) for tc in cols.trees), default=0)
    for color in range(colors):
        for t, tc in enumerate(cols.trees):
            if color >= len(tc.rounds):
                continue
            rc = tc.rounds[color]
            csize = chunk_size[t]
            C = num_chunks[t]
            if rc.matching and len(rc.srcs) == 1:
                # chains produce single-edge rounds; scalar placement
                # avoids per-call numpy overhead on 1-element arrays
                s = int(rc.srcs[0])
                d = int(rc.dsts[0])
                e = int(rc.eidx[0])
                dur = float(alpha[e]) + float(beta[e]) * csize
                fprev = max(
                    float(link_free[e]), float(egress[s]), float(ingress[d])
                )
                rt = ready[t]
                for c in range(C):
                    fprev = max(float(rt[c, s]), fprev) + dur
                    if fprev > rt[c, d]:
                        rt[c, d] = fprev
                link_free[e] = fprev
                egress[s] = fprev
                ingress[d] = fprev
                busy[e] += dur * C
                if fprev > makespan:
                    makespan = fprev
            elif rc.matching:
                durs = alpha[rc.eidx] + beta[rc.eidx] * csize
                fprev = np.maximum(
                    np.maximum(link_free[rc.eidx], egress[rc.srcs]),
                    ingress[rc.dsts],
                )
                rt = ready[t]
                block = rt[:, rc.srcs]  # (C, E) gather — a copy
                if C == 1:
                    fprev = np.maximum(block[0], fprev) + durs
                    rt[0, rc.dsts] = np.maximum(rt[0, rc.dsts], fprev)
                else:
                    out = np.empty((C, len(durs)))
                    for c in range(C):
                        fprev = np.maximum(block[c], fprev) + durs
                        out[c] = fprev
                    rt[:, rc.dsts] = np.maximum(rt[:, rc.dsts], out)
                link_free[rc.eidx] = fprev
                egress[rc.srcs] = fprev
                ingress[rc.dsts] = fprev
                busy[rc.eidx] += durs * C
                m = float(fprev.max())
                if m > makespan:
                    makespan = m
            else:
                # exact sequential waves, chunk-major like the event loop
                rt = ready[t]
                for c in range(C):
                    row = rt[c]
                    for widx in rc.waves:
                        ws = rc.srcs[widx]
                        wd = rc.dsts[widx]
                        we = rc.eidx[widx]
                        wdur = alpha[we] + beta[we] * csize
                        fin = (
                            np.maximum(
                                np.maximum(row[ws], link_free[we]),
                                np.maximum(egress[ws], ingress[wd]),
                            )
                            + wdur
                        )
                        row[wd] = np.maximum(row[wd], fin)
                        link_free[we] = fin
                        egress[ws] = fin
                        ingress[wd] = fin
                        busy[we] += wdur
                        m = float(fin.max())
                        if m > makespan:
                            makespan = m

    class_busy: Dict[str, float] = {}
    if cols.num_links:
        ici_busy = float(busy[~cls_vec].sum())
        dcn_busy = float(busy[cls_vec].sum())
        class_busy[ICI] = ici_busy
        if bool(cls_vec.any()):
            class_busy[DCN] = dcn_busy
    link_busy: Dict[Link, float] = {}
    if keep_links:
        link_busy = {
            (int(s), int(d)): float(b)
            for s, d, b in zip(cols.link_srcs, cols.link_dsts, busy)
        }
    return SimReport(
        makespan=makespan,
        transfers=[],
        link_busy=link_busy,
        class_busy=class_busy,
    )
