"""Plan selection: α-β prior + measured posterior + bounded exploration.

The port of :mod:`adapcc_tpu.tuner.policy`, rule for rule: the same cells,
the same seeded exploration, the same trajectory for the same database.
For one ``(primitive, payload)`` request the policy builds the candidate
grid (ring staging granularities from the port's own planner,
:func:`plan_ring_schedule`, crossed with the wire-codec registry) and picks
a cell by three rules, in order:

1. **Explore** (epsilon-greedy, bounded): while any cell has fewer than
   ``trial_budget`` samples, a coin flip with probability ``epsilon``
   returns the least-sampled cell.  Once every cell has met its budget,
   exploration stops for good.
2. **Exploit**: cells with at least ``min_samples`` measurements rank by
   their database median (the posterior); with nothing measured the cost
   model (:mod:`adapcc_tpu_torch.sim.cost_model`) prices the grid (the
   prior).  The posterior replaces the prior wholesale: measured medians
   of different cells compare, model-vs-measurement deltas do not.
3. **Hysteresis**: the previous winner (the incumbent) keeps the slot
   unless a challenger beats its median by ``hysteresis_margin`` over at
   least ``hysteresis_min_samples`` samples, so one lucky dispatch does not
   flap the executed plan (TACCL's stability argument, PAPERS.md).

The key vocabulary (``vmem``, ``hbm-stream``, ``quant-ring``, ``xla``,
``hook``, ...) is the JAX package's, so a database moves between the two:
``vmem`` is the ring path whose chunks are one stage each (K1a, K5a),
``hbm-stream`` the one that streams them in tiles (K1b, K5b), and ``xla``
the engine's flat fast path (``torch_fused`` here).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from adapcc_tpu_torch.tuner.db import (
    TuningDatabase,
    TuningKey,
    TuningStats,
    size_bucket,
)

#: default ring staging grid, from latency-bound small tiles to
#: near-whole-payload staging
DEFAULT_CHUNK_GRID = (256 << 10, 1 << 20, 4 << 20, 16 << 20)

#: tail-aware scoring: "median" ranks measured cells by
#: their robust median (the historical default), "p99" by the nearest-rank
#: 99th percentile over the cell's bounded sample window — the objective
#: the serving plane keys on, where a strategy that wins the median but
#: fattens the tail loses (The Big Send-off, PAPERS.md)
TUNER_OBJECTIVE_ENV = "ADAPCC_TUNER_OBJECTIVE"

TUNER_OBJECTIVES = ("median", "p99")


def resolve_tuner_objective(explicit: Optional[str] = None) -> str:
    """The scoring objective in force: ``ADAPCC_TUNER_OBJECTIVE`` env >
    the caller's explicit value > "median".  Malformed values raise — a
    typo'd ``p95`` silently ranking by medians would invalidate the tail
    claim the run was meant to make (the ADAPCC_MERGE_ROUNDS policy)."""
    env = os.environ.get(TUNER_OBJECTIVE_ENV)
    value = env if env is not None and env.strip() else explicit
    if value is None:
        return "median"
    objective = value.strip().lower()
    if objective not in TUNER_OBJECTIVES:
        raise ValueError(
            f"{TUNER_OBJECTIVE_ENV}={value!r}: expected one of "
            f"{'|'.join(TUNER_OBJECTIVES)}"
        )
    return objective

#: cells with fewer samples than this rank by the prior, not their median
DEFAULT_MIN_SAMPLES = 2

#: per-cell sample budget the explorer fills before going quiet
DEFAULT_TRIAL_BUDGET = 8

#: probability one choose() call explores while the budget is unfilled
DEFAULT_EPSILON = 0.25

#: a challenger must beat the incumbent median by this fraction
DEFAULT_HYSTERESIS_MARGIN = 0.05

#: ... over at least this many samples
DEFAULT_HYSTERESIS_MIN_SAMPLES = 3

#: paths with no chunk knob store 0 in the key's chunk_bytes slot
NO_CHUNK = 0

#: the unfused quant ring (wire_dtype != "off"): one cell a codec
QUANT_PATH = "quant-ring"

#: latency-plane algorithm cells (``comm/latency.py``): recursive
#: halving/doubling and the binomial tree, keyed in the path slot
RD_PATH = "rd"
TREE_PATH = "tree"
ALGO_PATHS = (RD_PATH, TREE_PATH)

#: selector spelling of a path slot: rd/tree cells name their algorithm,
#: every other path (vmem/hbm-stream/quant-ring) is the ring plane
ALGO_OF_PATH = {RD_PATH: "rd", TREE_PATH: "tree"}

#: the flat all-to-all: the one static cell of the ``all_to_all`` primitive
A2A_XLA_PATH = "xla"

#: the composed two-level allreduce: a record-mode engine on a two-level
#: world times composed dispatches into this cell
TWO_LEVEL_PATH = "two-level"

#: the schedule-program executor (``engine.all_reduce(algo="ir")``): a
#: record-mode engine times a dispatch into ``ir`` where the optimizer
#: passes left the program as it was and into ``ir-opt`` where they
#: rewrote it (two executables, two cells), the key's wire_dtype slot
#: holding the program's codec.  IR cells join a grid only when ``algos``
#: names "ir" and a recorded cell exists, so the default grids stay as
#: they were
IR_PATH = "ir"
IR_OPT_PATH = "ir-opt"

#: the engine's flat fast path (``engine.all_reduce`` unmasked: one torch
#: reduction over the rows, trace impl ``torch_fused``; JAX's psum) as an
#: allreduce cell, the baseline that entry point's algorithm cells compete
#: against.  It joins a grid only when ``algos`` names "xla";
#: ``ring_allreduce`` never offers it
XLA_PATH = "xla"

#: the trace impl of that fast path
TORCH_FUSED_IMPL = "torch_fused"

#: gradient-hook dispatches (``DDPTrainer(tune=True)``): the knobs are the
#: wire codec and the overlap schedule (in the key's path slot, see
#: :func:`hook_path`)
HOOK_PATH = "hook"

#: overlap schedules a ddp_step cell can carry; mirrors
#: ``ddp/overlap.py::OVERLAP_MODES`` (a test pins the two together)
HOOK_OVERLAP_MODES = ("off", "bucket", "microbatch")


def hook_path(overlap: str = "off") -> str:
    """The ``TuningKey.path`` spelling of a ddp_step cell's overlap
    schedule: ``"hook"`` for the baseline (unchanged from the pre-overlap
    schema, so existing databases keep their samples), ``"hook-<mode>"``
    for an overlapped schedule."""
    if overlap not in HOOK_OVERLAP_MODES:
        raise ValueError(
            f"overlap={overlap!r}: expected one of {HOOK_OVERLAP_MODES}"
        )
    return HOOK_PATH if overlap == "off" else f"{HOOK_PATH}-{overlap}"


def hook_overlap_of(path: str) -> str:
    """Inverse of :func:`hook_path`; loud on a non-hook path."""
    if path == HOOK_PATH:
        return "off"
    prefix = HOOK_PATH + "-"
    if path.startswith(prefix) and path[len(prefix):] in HOOK_OVERLAP_MODES:
        return path[len(prefix):]
    raise ValueError(
        f"path={path!r} is not a ddp_step hook cell (expected "
        f"{HOOK_PATH!r} or {prefix}<{'|'.join(HOOK_OVERLAP_MODES[1:])}>)"
    )


def _is_hook_path(path: str) -> bool:
    return path == HOOK_PATH or path.startswith(HOOK_PATH + "-")


#: pipelined-step dispatches (``pipe_step`` cells recorded by
#: ``PipelineExecutor``): the knob is the tick schedule, in the key's path
#: slot as the hook's overlap modes are; the key's chunk_bytes slot carries
#: the microbatch count (there is no chunk knob)
PIPE_PATH = "pipe"

#: schedules a pipe_step cell can carry; mirrors
#: ``adapcc_tpu_torch.pipe.schedule.PIPE_SCHEDULES`` (a test pins the two
#: together: an import here would tie the tuner to the pipeline package)
PIPE_SCHEDULE_MODES = ("gpipe", "1f1b")


def pipe_path(schedule: str) -> str:
    """The ``TuningKey.path`` spelling of a pipe_step cell's schedule:
    always ``"pipe-<schedule>"`` (no bare cell predates it)."""
    if schedule not in PIPE_SCHEDULE_MODES:
        raise ValueError(
            f"schedule={schedule!r}: expected one of {PIPE_SCHEDULE_MODES}"
        )
    return f"{PIPE_PATH}-{schedule}"


def pipe_schedule_of(path: str) -> str:
    """Inverse of :func:`pipe_path`; loud on a non-pipe path."""
    prefix = PIPE_PATH + "-"
    if path.startswith(prefix) and path[len(prefix):] in PIPE_SCHEDULE_MODES:
        return path[len(prefix):]
    raise ValueError(
        f"path={path!r} is not a pipe_step cell (expected "
        f"{prefix}<{'|'.join(PIPE_SCHEDULE_MODES)}>)"
    )


@dataclass(frozen=True)
class TunedPlan:
    """What the policy committed for one dispatch.

    ``source`` is part of the observable contract (the engine records it in
    the dispatch trace): ``measured`` = the database median picked it,
    ``prior`` = the cost model picked it (nothing measured yet),
    ``explore`` = an under-sampled cell is being filled.
    """

    key: TuningKey
    source: str                    #: "measured" | "prior" | "explore"
    expected_s: float              #: the score that won (objective or prior)
    #: scoring objective the decision ranked measured cells by
    #: (:data:`TUNER_OBJECTIVES`) — part of the trace payload so a tail
    #: claim can be audited against the mode that actually decided
    objective: str = "median"
    #: execution hint for cells whose persistent key carries no chunk: a
    #: vmem cell is keyed chunk_bytes=0 (the knob is inert there — every
    #: budget ≥ the payload runs the identical program), but the engine
    #: still needs a concrete budget that RESOLVES to the vmem path
    exec_chunk_bytes: Optional[int] = None

    @property
    def chunk_bytes(self) -> Optional[int]:
        """Staging granularity to pass down, or None when the chosen path
        has no chunk knob (quantized ring / hook)."""
        if self.key.chunk_bytes > 0:
            return self.key.chunk_bytes
        return self.exec_chunk_bytes

    @property
    def wire_dtype(self) -> str:
        return self.key.wire_dtype

    def trace_extra(self, applied: bool = True) -> Dict[str, object]:
        """The ``tuner=`` payload for the dispatch trace: what was chosen,
        why, and whether precedence let it run (``applied=False`` = an env
        var or explicit argument overrode the tuner)."""
        return {
            "chosen": {
                "chunk_bytes": self.key.chunk_bytes,
                "wire_dtype": self.key.wire_dtype,
                "path": self.key.path,
            },
            "source": self.source,
            "objective": self.objective,
            "applied": bool(applied),
        }


class TuningPolicy:
    """Ranks candidate plan cells for one fabric (world + topology)."""

    def __init__(
        self,
        db: TuningDatabase,
        world: int,
        topology: str,
        chunk_grid: Sequence[int] = DEFAULT_CHUNK_GRID,
        wire_dtypes: Optional[Sequence[str]] = None,
        epsilon: float = DEFAULT_EPSILON,
        trial_budget: int = DEFAULT_TRIAL_BUDGET,
        min_samples: int = DEFAULT_MIN_SAMPLES,
        hysteresis_margin: float = DEFAULT_HYSTERESIS_MARGIN,
        hysteresis_min_samples: int = DEFAULT_HYSTERESIS_MIN_SAMPLES,
        cost_model=None,
        seed: int = 0,
        fused_paths: Optional[bool] = None,
        objective: Optional[str] = None,
    ) -> None:
        if not 0.0 <= epsilon <= 1.0:
            raise ValueError(f"epsilon must be in [0, 1], got {epsilon}")
        if trial_budget < 1:
            raise ValueError(f"trial_budget must be >= 1, got {trial_budget}")
        if hysteresis_margin < 0:
            raise ValueError(
                f"hysteresis_margin must be >= 0, got {hysteresis_margin}"
            )
        self.db = db
        self.world = int(world)
        self.topology = topology
        self.chunk_grid = tuple(sorted({int(c) for c in chunk_grid}))
        if any(c <= 0 for c in self.chunk_grid):
            raise ValueError(f"chunk grid must be positive, got {chunk_grid}")
        if wire_dtypes is None:
            from adapcc_tpu_torch.quant import codec_names

            wire_dtypes = codec_names()
        self.wire_dtypes = tuple(wire_dtypes)
        self.epsilon = float(epsilon)
        self.trial_budget = int(trial_budget)
        self.min_samples = int(min_samples)
        self.hysteresis_margin = float(hysteresis_margin)
        self.hysteresis_min_samples = int(hysteresis_min_samples)
        #: scoring objective for MEASURED cells (env > explicit > median,
        #: resolved once at construction — an engine rebuild picks up a
        #: changed env, a running policy never flips mid-decision).  The
        #: prior is untouched: the α-β model predicts one deterministic
        #: time, so objectives only diverge once samples exist.
        self.objective = resolve_tuner_objective(objective)
        self._cost_model = cost_model
        #: whether fused wire cells (codec inside the ring kernels K5a/K5b) join
        #: the grid: None = probe the data plane (a cell must never claim a
        #: path the engine would not run, or the explorer pins on it
        #: forever); True/False force it — the tune-replay synthetic
        #: surface forces True so the artifact shows fused cells on any
        #: build
        self.fused_paths = fused_paths
        # deterministic exploration: a seeded PRNG, not wall-clock entropy —
        # two identical runs explore the same cells in the same order
        self._rng = random.Random(seed)
        #: hysteresis state: (primitive, size_bucket) → incumbent key
        self._incumbent: Dict[Tuple[str, int], TuningKey] = {}
        #: lazily computed sim crossover (ring vs recursive doubling) that
        #: gates the algorithm axis: None = not yet computed
        self._algo_crossover: Optional[float] = None

    # -- candidate grid --------------------------------------------------------

    def _pinned_wire_dtype(self) -> Optional[str]:
        """The ``ADAPCC_WIRE_DTYPE`` pin, or None when unset.  Under a pin
        every dispatch executes the pinned codec regardless of what the
        policy chooses, so cells of any other codec could never accrue
        samples — the grid must collapse to the pinned axis value (the
        ADAPCC_RING_CHUNK_BYTES collapse, codec flavor)."""
        from adapcc_tpu_torch.quant.codec import WIRE_DTYPE_ENV, resolve_wire_dtype

        env = os.environ.get(WIRE_DTYPE_ENV)
        if env is None or not env.strip():
            return None
        return resolve_wire_dtype(None)  # validated; loud on a typo

    def _fused_paths_available(self, dtype, wire_dtype: str) -> bool:
        """Whether fused (chunk × codec) cells may join the grid for this
        payload: forced by :attr:`fused_paths` when set, otherwise probed
        against the data plane's own support funnel."""
        if self.fused_paths is not None:
            return bool(self.fused_paths)
        from adapcc_tpu_torch.comm.ring import fused_ring_dispatch_reason

        try:
            return fused_ring_dispatch_reason(_torch_dtype(dtype), wire_dtype) is None
        except ValueError:
            # ADAPCC_FUSED_WIRE=on with an unsupportable combo: the
            # dispatch itself will fail loudly; no cell for it
            return False

    def algo_crossover_bytes(self) -> float:
        """The sim crossover (ring vs recursive doubling) on THIS policy's
        cost model, cached — the one number both the candidate-grid gate
        and the engine's ``auto`` selector consult, so an injected custom
        calibration can never make the tuner offer rd cells at sizes the
        engine's own crossover would refuse (or vice versa)."""
        if self._algo_crossover is None:
            from adapcc_tpu_torch.sim.cost_model import (
                allreduce_crossover_bytes,
                bottleneck_ring_coeffs,
            )

            coeffs = bottleneck_ring_coeffs(self._model(), max(2, self.world))
            self._algo_crossover = allreduce_crossover_bytes(
                self.world, coeffs
            )
        return self._algo_crossover

    def _sub_crossover(self, nbytes: int) -> bool:
        """Whether this payload's size bucket sits at or below the sim
        crossover (ring vs recursive doubling) — the gate that admits the
        algorithm axis into the grid.  Bucket-granular on purpose: every
        payload in one bucket must see the same candidate set, or samples
        and choices within a bucket would rank different grids."""
        x = self.algo_crossover_bytes()
        if x <= 0.0:
            return False
        if x == float("inf"):
            return True
        return size_bucket(nbytes) <= size_bucket(max(1, int(x)))

    def candidates(
        self,
        primitive: str,
        nbytes: int,
        dtype: str = "float32",
        wire_dtypes: Optional[Sequence[str]] = None,
        overlap_modes: Optional[Sequence[str]] = None,
        algos: Optional[Sequence[str]] = None,
    ) -> List[TuningKey]:
        """The plan cells competing for this dispatch.

        Ring primitives cross the chunk grid (``wire_dtype="off"``, path
        from the kernel's own planner so a cell can never claim a path the
        data plane would not run) with, per non-"off" codec, one unfused
        quant-ring cell (no staging knob) plus — where the fused kernels
        can run — fused cells over the same chunk grid, so chunk_bytes ×
        wire_dtype × path compete on measured medians.  ``allreduce``
        additionally carries the **algorithm axis** for sub-crossover size
        buckets: one recursive-doubling and one
        binomial-tree cell (:data:`RD_PATH`/:data:`TREE_PATH` in the path
        slot, no chunk knob, fp32 wire), gated on the latency plane's own
        support funnel.  ``ddp_step`` carries the codec axis crossed with
        the overlap-schedule axis (:data:`HOOK_OVERLAP_MODES`, encoded via
        :func:`hook_path`) — the hook's allreduce is not chunk-steered.
        ``all_to_all`` (the MoE dispatch/combine shuffle) has one flat
        cell plus whatever the database already measured for the bucket —
        the engine's dispatches are timed and traced like every other
        collective even while the axis has a single knobless cell.

        ``wire_dtypes`` narrows the codec axis for this call (default: the
        policy's full registry) — a caller whose configuration cannot
        legally run a codec (error-feedback forbids "off") must exclude it
        here, or the explorer pins on a cell that can never accrue samples.
        An ``ADAPCC_WIRE_DTYPE`` pin collapses the codec axis outright
        (every dispatch executes the pin; other codecs' cells would
        starve).  ``overlap_modes`` narrows the ddp_step overlap axis the
        same way (a trainer without gradient accumulation cannot compile
        the microbatch pipeline).  ``algos`` narrows the algorithm axis:
        an ``ADAPCC_COLL_ALGO`` pin (or an explicit ``algo=`` argument at
        the engine) collapses it — a pinned ``rd`` dispatch can never
        execute a ring cell, so offering one would starve the explorer;
        under a single-algorithm pin the crossover gate stands down (the
        pinned cell must exist at every size the engine dispatches).
        """
        if wire_dtypes is None:
            wire_dtypes = self.wire_dtypes
        pin = self._pinned_wire_dtype()
        if pin is not None:
            wire_dtypes = (pin,)
        allowed_algos = (
            ("ring",) + ALGO_PATHS if algos is None else tuple(algos)
        )
        bucket = size_bucket(nbytes)
        cells: List[TuningKey] = []
        if (
            primitive == "allreduce"
            and "xla" in allowed_algos
            and "off" in wire_dtypes
        ):
            # the fast path's baseline cell, FIRST so a predicted tie keeps
            # the flat collective (see XLA_PATH)
            cells.append(
                TuningKey(
                    primitive, bucket, self.world, self.topology,
                    XLA_PATH, NO_CHUNK, "off",
                )
            )
        if primitive == "all_to_all":
            cells.append(
                TuningKey(
                    primitive, bucket, self.world, self.topology,
                    A2A_XLA_PATH, NO_CHUNK, "off",
                )
            )
            # measured cells beyond the static grid compete (e.g. the
            # two-level hierarchical exchange the engine records on a
            # (dcn, ici) mesh)
            for known in self.db.keys():
                if (
                    known.primitive == primitive
                    and known.size_bucket == bucket
                    and known.world == self.world
                    and known.topology == self.topology
                    and known not in cells
                ):
                    cells.append(known)
            return cells
        if primitive == "ddp_step":
            modes = (
                HOOK_OVERLAP_MODES if overlap_modes is None
                else tuple(overlap_modes)
            )
            for overlap in modes:
                for wd in wire_dtypes:
                    cells.append(
                        TuningKey(
                            primitive, bucket, self.world, self.topology,
                            hook_path(overlap), NO_CHUNK, wd,
                        )
                    )
            return cells
        nelems = max(1, int(nbytes)) // max(
            1, _itemsize(dtype)
        )
        if "off" in wire_dtypes and "ring" in allowed_algos:
            seen_planned = set()
            for chunk in self.chunk_grid:
                plan = plan_ring_schedule(nelems, dtype, self.world, chunk)
                # several budgets can resolve to the identical executed plan
                # (every vmem-path budget does — and under an
                # ADAPCC_RING_CHUNK_BYTES pin, every budget does); duplicate
                # cells would split one physical configuration's samples
                # across keys.  Cells are keyed by the PLANNER-RESOLVED
                # budget (``plan.chunk_bytes``, exactly what the engine keys
                # live recordings with) — vmem by 0, the budget being inert
                # there — so a record-mode run's samples always land where
                # choose() looks, env pin or not
                planned = (plan.path, plan.stage_bytes)
                if planned in seen_planned:
                    continue
                seen_planned.add(planned)
                cells.append(
                    TuningKey(
                        primitive, bucket, self.world, self.topology,
                        plan.path,
                        NO_CHUNK if plan.path == "vmem" else int(plan.chunk_bytes),
                        "off",
                    )
                )
        if primitive == "allreduce":
            # the algorithm axis: recursive doubling and
            # the binomial tree join the grid for sub-crossover buckets —
            # where the log2(p) α term can actually win — gated on the
            # latency plane's own support funnel (rd needs a power-of-two
            # world).  Under a single-algorithm pin (algos collapsed by
            # the engine) the crossover gate stands down: the pinned cell
            # must exist wherever the engine dispatches it.
            from adapcc_tpu_torch.comm.latency import latency_algo_unsupported_reason

            for path in ALGO_PATHS:
                if path not in allowed_algos or "off" not in wire_dtypes:
                    continue
                if latency_algo_unsupported_reason(self.world, path) is not None:
                    continue
                if "ring" in allowed_algos and not self._sub_crossover(nbytes):
                    continue
                cells.append(
                    TuningKey(
                        primitive, bucket, self.world, self.topology,
                        path, NO_CHUNK, "off",
                    )
                )
        # measured cells OUTSIDE the grid still compete in exploitation: a
        # record-only run under a pinned or solver-assigned chunk (any
        # budget not in the grid) produced honest medians for a plan the
        # data plane actually ran — ignoring them would re-explore cells
        # the world already paid to measure.  Fused off-grid cells compete
        # too, but only where the data plane can still run them (a cell
        # the dispatch would reroute around would starve forever); a cell
        # of a narrowed-out algorithm never re-enters (the pin the caller
        # declared means the engine would override it every time)
        for known in self.db.keys():
            if (
                known.primitive == primitive
                and known.size_bucket == bucket
                and known.world == self.world
                and known.topology == self.topology
                and known.wire_dtype in wire_dtypes
                and known.path != QUANT_PATH
                and known not in cells
                and (
                    known.path
                    if known.path in ALGO_PATHS or known.path == IR_PATH
                    # the opt cell is the same algo="ir" entry point —
                    # which executable runs is the engine's ADAPCC_IR_OPT
                    # resolution, not a selector choice
                    else (
                        "ir" if known.path == IR_OPT_PATH
                        else ("xla" if known.path == XLA_PATH else "ring")
                    )
                ) in allowed_algos
                and (
                    known.wire_dtype == "off"
                    or self._fused_paths_available(dtype, known.wire_dtype)
                )
            ):
                cells.append(known)
        if primitive == "allreduce" and "ring" in allowed_algos:
            # only allreduce has an unfused quant ring; the fused
            # cells speak every ring primitive but compete
            # on the tuner's one steered primitive.  ADAPCC_FUSED_WIRE=on
            # prunes the unfused cells outright — under "on" the engine
            # refuses to run them, so offering them would starve the
            # explorer (the mirror of "off" pruning the fused cells)
            from adapcc_tpu_torch.comm.ring import resolve_fused_wire

            fused_only = resolve_fused_wire() == "on"
            for wd in wire_dtypes:
                if wd == "off":
                    continue
                if self._fused_paths_available(dtype, wd):
                    seen_planned = set()
                    for chunk in self.chunk_grid:
                        plan = plan_ring_schedule(
                            nelems, dtype, self.world, chunk, wire_dtype=wd
                        )
                        planned = (plan.path, plan.stage_bytes)
                        if planned in seen_planned:
                            continue
                        seen_planned.add(planned)
                        cells.append(
                            TuningKey(
                                primitive, bucket, self.world, self.topology,
                                plan.path,
                                NO_CHUNK if plan.path == "vmem"
                                else int(plan.chunk_bytes),
                                wd,
                            )
                        )
                if not fused_only:
                    cells.append(
                        TuningKey(
                            primitive, bucket, self.world, self.topology,
                            QUANT_PATH, NO_CHUNK, wd,
                        )
                    )
        return cells

    # -- prior -----------------------------------------------------------------

    def _model(self):
        if self._cost_model is None:
            from adapcc_tpu_torch.sim.calibrate import load_or_default

            self._cost_model = load_or_default(world=self.world)
        return self._cost_model

    def prior_time(self, key: TuningKey, nbytes: int) -> float:
        """Model-predicted seconds for one cell: the cost model's term for
        the cell's path (:mod:`adapcc_tpu_torch.sim.cost_model`), at the
        module's card defaults (HBM rate, codec rate) in force now."""
        from adapcc_tpu_torch.sim import cost_model
        from adapcc_tpu_torch.sim.cost_model import (
            all_to_all_time,
            binomial_tree_time,
            bottleneck_ring_coeffs,
            fused_quantized_ring_allreduce_time,
            quantized_ring_allreduce_time,
            recursive_doubling_allreduce_time,
            ring_allreduce_time,
            staged_ring_allreduce_time,
        )

        model = self._model()
        world = max(2, self.world)
        coeffs = bottleneck_ring_coeffs(model, world)
        if key.primitive == "all_to_all":
            return all_to_all_time(world, float(nbytes), coeffs)
        if key.path == RD_PATH:
            return recursive_doubling_allreduce_time(
                world, float(nbytes), coeffs
            )
        if key.path == TREE_PATH:
            # a tree allreduce is two single-shot phases: reduce + broadcast
            return 2.0 * binomial_tree_time(world, float(nbytes), coeffs)
        if key.path in (IR_PATH, IR_OPT_PATH):
            # IR cells carry no program handle in the key, so the prior is
            # the segmented-ring floor every program meets or beats; a
            # recorded cell's median supersedes it
            return ring_allreduce_time(world, float(nbytes), coeffs, chunks=world)
        if key.primitive == "allreduce" and key.path == XLA_PATH:
            # the flat collective is priced as the bandwidth-optimal
            # ring: the classic ring term
            return quantized_ring_allreduce_time(
                world, float(nbytes), coeffs, "off"
            )
        if _is_hook_path(key.path):
            # hook cells: the comm term only (the step's compute is shared
            # across every cell, so it cancels in the ranking).  Overlap
            # variants price identically to their codec's baseline cell on
            # purpose: "off" wins the tie by candidate order, so an overlap
            # schedule is adopted ONLY when measured step medians beat the
            # incumbent, never from the model alone
            return quantized_ring_allreduce_time(
                world, float(nbytes), coeffs, key.wire_dtype
            )
        if key.wire_dtype != "off" and key.path == QUANT_PATH:
            return quantized_ring_allreduce_time(
                world, float(nbytes), coeffs, key.wire_dtype
            )
        nelems = max(1, int(nbytes)) // 4
        wire = key.wire_dtype
        plan = plan_ring_schedule(
            nelems, "float32", world,
            key.chunk_bytes if key.chunk_bytes > 0 else None,
            wire_dtype=wire,
        )
        if key.path == "vmem" and plan.path != "vmem":
            # a vmem cell is keyed chunk_bytes=0; realize it with a budget
            # covering the whole padded payload
            plan = plan_ring_schedule(
                nelems, "float32", world, plan.padded_bytes, wire_dtype=wire,
            )
        hbm = float("inf") if plan.path == "vmem" else cost_model.DEFAULT_HBM_BYTES_PER_S
        if wire != "off":
            # fused cells: codec inside the staged kernels, priced by the
            # overlapped per-tile term
            return fused_quantized_ring_allreduce_time(
                world, float(nbytes), coeffs, plan.stage_bytes, wire,
                hbm_bytes_per_s=hbm,
            )
        return staged_ring_allreduce_time(
            world, float(nbytes), coeffs, plan.stage_bytes,
            hbm_bytes_per_s=hbm,
        )

    # -- selection -------------------------------------------------------------

    def _stat_score(self, stats: TuningStats) -> float:
        """The measured scalar the objective ranks cells by: the robust
        median (default) or the tail percentile (``p99``)
        — where a cell that wins the median but fattens the tail
        loses.  One spelling for exploit, hysteresis, and rank_only, so
        the adoption gate and the ranking can never judge by different
        numbers."""
        return stats.p99_s if self.objective == "p99" else stats.median_s

    def _score(self, key: TuningKey, nbytes: int) -> Tuple[float, bool]:
        """(seconds, measured?) — the objective score when the cell has
        enough samples, the model prior otherwise."""
        stats = self.db.stats(key)
        if stats is not None and stats.count >= self.min_samples:
            return self._stat_score(stats), True
        return self.prior_time(key, nbytes), False

    def _exec_chunk(self, key: TuningKey, nbytes: int, dtype: str) -> Optional[int]:
        """Execution budget for a vmem cell (keyed chunk_bytes=0, fused or
        not): the smallest grid budget the planner resolves to the vmem
        path, so applying the plan actually runs the cell that was
        ranked."""
        if key.path != "vmem" or key.chunk_bytes > 0:
            return None
        nelems = max(1, int(nbytes)) // max(1, _itemsize(dtype))
        for chunk in self.chunk_grid:
            if plan_ring_schedule(nelems, dtype, self.world, chunk).path == "vmem":
                return int(chunk)
        return None

    def _plan(
        self, key: TuningKey, source: str, expected_s: float,
        nbytes: int, dtype: str,
    ) -> TunedPlan:
        return TunedPlan(
            key=key, source=source, expected_s=expected_s,
            objective=self.objective,
            exec_chunk_bytes=self._exec_chunk(key, nbytes, dtype),
        )

    def _best(
        self, cells: Sequence[TuningKey], nbytes: int
    ) -> Tuple[TuningKey, float, str]:
        """Exploitation ranking shared by :meth:`choose` and
        :meth:`rank_only`: measured cells by the objective score (median
        or p99); with nothing measured, the sim prior over the whole
        grid."""
        measured = {
            c: self.db.stats(c)
            for c in cells
            if self.db.count(c) >= self.min_samples
        }
        if measured:
            best = min(
                measured,
                key=lambda c: (self._stat_score(measured[c]), cells.index(c)),
            )
            return best, self._stat_score(measured[best]), "measured"
        priors = {c: self.prior_time(c, nbytes) for c in cells}
        best = min(cells, key=lambda c: (priors[c], cells.index(c)))
        return best, priors[best], "prior"

    def rank_only(
        self,
        primitive: str,
        nbytes: int,
        dtype: str = "float32",
        wire_dtypes: Optional[Sequence[str]] = None,
        overlap_modes: Optional[Sequence[str]] = None,
        algos: Optional[Sequence[str]] = None,
    ) -> TunedPlan:
        """Side-effect-free exploitation view of :meth:`choose`: rank the
        grid by measured median (prior fallback) WITHOUT exploration,
        incumbent mutation, or RNG advance.

        For callers that can only *honor* a decision, never realize
        arbitrary cells — ``engine.all_reduce``'s algorithm arbitration:
        the xla/schedule plane cannot execute or time a chunk/codec cell,
        so an exploring choose() there would return count-0 cells whose
        trial budget can never drain (explorer starvation), and its
        incumbent writes would flap the REAL dispatcher's hysteresis."""
        cells = self.candidates(
            primitive, nbytes, dtype, wire_dtypes, overlap_modes, algos
        )
        if not cells:
            raise ValueError(
                f"no candidate cells for primitive={primitive!r} "
                f"(chunk grid {self.chunk_grid})"
            )
        best, best_s, best_src = self._best(cells, nbytes)
        return self._plan(best, best_src, best_s, nbytes, dtype)

    def choose(
        self,
        primitive: str,
        nbytes: int,
        dtype: str = "float32",
        wire_dtypes: Optional[Sequence[str]] = None,
        overlap_modes: Optional[Sequence[str]] = None,
        algos: Optional[Sequence[str]] = None,
    ) -> TunedPlan:
        """Commit a plan cell for one dispatch (see module docstring).

        ``wire_dtypes`` narrows the codec axis, ``overlap_modes`` the
        ddp_step overlap axis, ``algos`` the allreduce algorithm axis (see
        :meth:`candidates`)."""
        cells = self.candidates(
            primitive, nbytes, dtype, wire_dtypes, overlap_modes, algos
        )
        if not cells:
            raise ValueError(
                f"no candidate cells for primitive={primitive!r} "
                f"(chunk grid {self.chunk_grid}, codecs "
                f"{wire_dtypes if wire_dtypes is not None else self.wire_dtypes})"
            )
        # 1. bounded exploration
        under = [c for c in cells if self.db.count(c) < self.trial_budget]
        if under and self._rng.random() < self.epsilon:
            cell = min(under, key=lambda c: (self.db.count(c), cells.index(c)))
            return self._plan(
                cell, "explore", self._score(cell, nbytes)[0], nbytes, dtype
            )
        # 2. posterior over prior
        best, best_s, best_src = self._best(cells, nbytes)
        # 3. hysteresis against the incumbent
        group = (primitive, size_bucket(nbytes))
        incumbent = self._incumbent.get(group)
        if incumbent is not None and incumbent in cells and incumbent != best:
            inc_s, inc_measured = self._score(incumbent, nbytes)
            challenger_stats = self.db.stats(best)
            promotes = (
                best_src == "measured"
                and challenger_stats is not None
                and challenger_stats.count >= self.hysteresis_min_samples
                and best_s < inc_s * (1.0 - self.hysteresis_margin)
            )
            if not promotes:
                return self._plan(
                    incumbent,
                    "measured" if inc_measured else "prior",
                    inc_s, nbytes, dtype,
                )
        self._incumbent[group] = best
        return self._plan(best, best_src, best_s, nbytes, dtype)

    def incumbent(self, primitive: str, nbytes: int) -> Optional[TuningKey]:
        return self._incumbent.get((primitive, size_bucket(nbytes)))

    def reset(self) -> None:
        """Drop hysteresis state (re-adaptation: a re-profiled fabric should
        re-decide from the database, not from the previous incumbency)."""
        self._incumbent.clear()


def _torch_dtype(dtype) -> torch.dtype:
    """A dtype name (``"float32"``, the tuner's key vocabulary) or a
    ``torch.dtype`` as the ``torch.dtype`` the port's ring planner takes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _itemsize(dtype) -> int:
    return _torch_dtype(dtype).itemsize


def plan_ring_schedule(nelems: int, dtype, world: int, chunk_bytes=None, wire_dtype: str = "off"):
    """The port's ring planner (``comm/ring.py``) on a dtype name or a
    ``torch.dtype``: the one place the policy meets the data plane's
    geometry, so a cell never claims a path the engine would not run."""
    from adapcc_tpu_torch.comm.ring import plan_ring_schedule as plan

    return plan(nelems, _torch_dtype(dtype), world, chunk_bytes, wire_dtype=wire_dtype)
