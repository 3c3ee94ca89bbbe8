"""Static pipeline schedules: GPipe and 1F1B tick tables + IR emission.

The port of :mod:`adapcc_tpu.pipe.schedule`: the tick tables, programs,
fingerprints and messages equal JAX's.

A pipeline schedule here is a **static structure**, not a runtime policy:
:func:`pipeline_schedule` lays every forward/backward microbatch task of
every stage onto a global tick grid (one task per stage per tick, rounds
aligned so a hop produced at tick ``t`` is consumed no earlier than tick
``t+1``), and everything downstream reads that one table —

- the executor (:mod:`adapcc_tpu_torch.pipe.executor`) interprets it tick by
  tick, so what runs is exactly what was priced;
- :func:`pipeline_program` re-emits the per-tick stage hops as a
  ``collective="pipeline"`` :class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram`
  so ``compiler/verify.py`` certifies delivery/matching/deadlock-freedom
  and ``sim/replay.simulate_program`` replays the same object;
- the measured properties (:attr:`PipelineSchedule.bubble_fraction`,
  :attr:`PipelineSchedule.stash_high_water`) are derived from the table,
  and the closed forms in ``sim/cost_model`` are pinned against them.

Both schedules run the same ``2·(m + s − 1)`` ticks (fill/drain bubble
``(s−1)/(m+s−1)``); they differ in *memory*: GPipe runs all forwards
before any backward, so every stage stashes ``m`` in-flight activations,
while 1F1B caps stage ``s`` at ``min(m, stages − s)`` by draining one
backward per steady-state forward (the Megatron-LM non-interleaved
schedule, PAPERS.md).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from adapcc_tpu_torch.compiler.ir import ScheduleProgram, Step

#: the closed set of schedules; anything else is a construction error
PIPE_SCHEDULES = ("gpipe", "1f1b")

#: env override for the schedule axis (docs/PIPELINE.md, docs/OPERATIONS.md)
PIPE_SCHEDULE_ENV = "ADAPCC_PIPE_SCHEDULE"

DEFAULT_PIPE_SCHEDULE = "1f1b"

#: tuner key vocabulary for pipeline step cells (mirrors
#: ``tuner/policy.pipe_path`` — drift pinned by a test)
PIPE_PRIMITIVE = "pipe_step"


@dataclass(frozen=True)
class PipeTask:
    """One unit of stage work: ``kind`` is ``"fwd"`` or ``"bwd"``, ``mb``
    the microbatch index."""

    kind: str
    mb: int

    def __post_init__(self) -> None:
        if self.kind not in ("fwd", "bwd"):
            raise ValueError(f"unknown task kind {self.kind!r}")


@dataclass(frozen=True)
class PipelineSchedule:
    """One tick table: ``ticks[t][s]`` is stage ``s``'s task at tick ``t``
    (or ``None`` — a bubble slot)."""

    kind: str
    stages: int
    microbatches: int
    ticks: Tuple[Tuple[Optional[PipeTask], ...], ...]

    @property
    def num_ticks(self) -> int:
        return len(self.ticks)

    @property
    def bubble_fraction(self) -> float:
        """Measured idle fraction of the tick grid: each stage does
        ``2·m`` tasks over ``num_ticks`` slots.  Equals the closed form
        ``(s−1)/(m+s−1)`` for both schedules (pinned in tests)."""
        return 1.0 - (2.0 * self.microbatches) / float(self.num_ticks)

    @property
    def stash_high_water(self) -> Tuple[int, ...]:
        """Per-stage peak count of in-flight activations (forwards run
        minus backwards run, maximized over ticks) — the memory axis that
        separates 1F1B from GPipe."""
        peaks = []
        for s in range(self.stages):
            live = peak = 0
            for row in self.ticks:
                task = row[s]
                if task is None:
                    continue
                live += 1 if task.kind == "fwd" else -1
                peak = max(peak, live)
            peaks.append(peak)
        return tuple(peaks)

    def tasks_for_stage(self, s: int) -> List[Tuple[int, PipeTask]]:
        """``(tick, task)`` pairs for stage ``s`` in execution order."""
        return [(t, row[s]) for t, row in enumerate(self.ticks) if row[s]]


def _stage_order(kind: str, stages: int, microbatches: int, s: int) -> List[PipeTask]:
    """Stage ``s``'s local task order (deps are enforced by the tick sim)."""
    fwd = [PipeTask("fwd", m) for m in range(microbatches)]
    bwd = [PipeTask("bwd", m) for m in range(microbatches)]
    if kind == "gpipe":
        return fwd + bwd
    # 1f1b: warmup forwards, steady one-forward-one-backward, cooldown
    warmup = min(microbatches, stages - 1 - s)
    order: List[PipeTask] = fwd[:warmup]
    steady = microbatches - warmup
    for i in range(steady):
        order.append(fwd[warmup + i])
        order.append(bwd[i])
    order.extend(bwd[steady:])
    return order


def pipeline_schedule(
    stages: int, microbatches: int, kind: str = DEFAULT_PIPE_SCHEDULE
) -> PipelineSchedule:
    """Lay ``kind``'s per-stage task orders onto the global tick grid.

    Greedy list scheduling under the dependency rules — ``fwd(s, m)``
    needs ``fwd(s−1, m)`` from a strictly earlier tick, ``bwd(s, m)``
    needs ``fwd(s, m)`` and (for non-last stages) ``bwd(s+1, m)`` from
    strictly earlier ticks, one task per stage per tick.  Deterministic;
    loud on malformed shape or an (impossible) stall.
    """
    if kind not in PIPE_SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {kind!r}; expected one of "
            f"{PIPE_SCHEDULES}"
        )
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    orders = [
        _stage_order(kind, stages, microbatches, s) for s in range(stages)
    ]
    cursor = [0] * stages
    done_fwd: set = set()  # (stage, mb) completed in an earlier tick
    done_bwd: set = set()
    ticks: List[Tuple[Optional[PipeTask], ...]] = []
    while any(cursor[s] < len(orders[s]) for s in range(stages)):
        row: List[Optional[PipeTask]] = [None] * stages
        for s in range(stages):
            if cursor[s] >= len(orders[s]):
                continue
            task = orders[s][cursor[s]]
            if task.kind == "fwd":
                ready = s == 0 or (s - 1, task.mb) in done_fwd
            else:
                ready = (s, task.mb) in done_fwd and (
                    s == stages - 1 or (s + 1, task.mb) in done_bwd
                )
            if ready:
                row[s] = task
        if not any(row):
            raise RuntimeError(
                f"pipeline schedule {kind!r} stalled at tick {len(ticks)} "
                f"(stages={stages}, microbatches={microbatches}) — "
                "dependency cycle in the stage orders"
            )
        for s, task in enumerate(row):
            if task is None:
                continue
            cursor[s] += 1
            (done_fwd if task.kind == "fwd" else done_bwd).add((s, task.mb))
        ticks.append(tuple(row))
    return PipelineSchedule(
        kind=kind, stages=stages, microbatches=microbatches, ticks=tuple(ticks)
    )


def pipeline_program(
    schedule: PipelineSchedule,
    *,
    world: Optional[int] = None,
    tied_embedding: bool = False,
    name: Optional[str] = None,
) -> ScheduleProgram:
    """Re-emit ``schedule``'s stage hops as a verifiable ``pipeline``
    :class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram`.

    Chunk ``m`` is microbatch ``m``'s forward activation (source stage 0,
    sink the last stage); chunk ``microbatches + m`` its backward
    gradient (routed the other way); with ``tied_embedding`` one extra
    chunk carries the Megatron-style head-embedding gradient from the
    last stage back to stage 0 after the drain.  One IR round per tick
    that moves data — a task at tick ``t`` sends in round ``t``'s
    barrier, and its consumer computes at a later tick, so matching holds
    by construction and ``verify_program`` certifies deadlock-freedom of
    the emitted table.
    """
    s_count, m_count = schedule.stages, schedule.microbatches
    if s_count < 2:
        raise ValueError(
            "a single-stage pipeline has no hops to compile into a program"
        )
    w = s_count if world is None else int(world)
    if w < s_count:
        raise ValueError(
            f"world {w} cannot host {s_count} stages (one rank per stage)"
        )
    chunks = 2 * m_count + (1 if tied_embedding else 0)
    sources = [0] * m_count + [s_count - 1] * m_count
    sinks = [s_count - 1] * m_count + [0] * m_count
    if tied_embedding:
        sources.append(s_count - 1)
        sinks.append(0)

    rounds: List[Tuple[Step, ...]] = []
    for row in schedule.ticks:
        msgs: List[Step] = []
        for s, task in enumerate(row):
            if task is None:
                continue
            if task.kind == "fwd" and s < s_count - 1:
                src, dst, chunk = s, s + 1, task.mb
            elif task.kind == "bwd" and s > 0:
                src, dst, chunk = s, s - 1, m_count + task.mb
            else:
                continue  # last-stage fwd / stage-0 bwd produce no hop
            msgs.extend(
                (
                    Step("send", rank=src, chunk=chunk, peer=dst),
                    Step("recv", rank=dst, chunk=chunk, peer=src),
                    Step("copy", rank=dst, chunk=chunk),
                )
            )
        if msgs:
            rounds.append(tuple(msgs))
    if tied_embedding:
        tie = chunks - 1
        rounds.append(
            (
                Step("send", rank=s_count - 1, chunk=tie, peer=0),
                Step("recv", rank=0, chunk=tie, peer=s_count - 1),
                Step("copy", rank=0, chunk=tie),
            )
        )
    return ScheduleProgram(
        name=name or f"pipe_{schedule.kind}_s{s_count}m{m_count}",
        world=w,
        chunks=chunks,
        rounds=tuple(rounds),
        collective="pipeline",
        chunk_sources=tuple(sources),
        chunk_sinks=tuple(sinks),
    )


def resolve_pipe_schedule(
    explicit: Optional[str] = None,
    *,
    tuner_db=None,
    world: int = 0,
    microbatches: int = 0,
    hop_bytes: int = 0,
    topology: str = "",
) -> str:
    """Resolve the schedule axis: env > arg > tuner > default.

    ``ADAPCC_PIPE_SCHEDULE`` wins outright (malformed → loud, the repo-wide
    env contract); then an explicit argument; then — when a
    :class:`~adapcc_tpu_torch.tuner.db.TuningDatabase` and the cell coordinates
    are given — the measured ``pipe_step`` cell with the best median;
    finally :data:`DEFAULT_PIPE_SCHEDULE`.
    """
    env = os.environ.get(PIPE_SCHEDULE_ENV)
    if env is not None:
        val = env.strip().lower()
        if val not in PIPE_SCHEDULES:
            raise ValueError(
                f"{PIPE_SCHEDULE_ENV}={env!r}: expected one of "
                f"{PIPE_SCHEDULES} (docs/PIPELINE.md)"
            )
        return val
    if explicit is not None:
        if explicit not in PIPE_SCHEDULES:
            raise ValueError(
                f"pipe schedule {explicit!r}: expected one of {PIPE_SCHEDULES}"
            )
        return explicit
    if tuner_db is not None and world > 0 and microbatches > 0:
        from adapcc_tpu_torch.tuner.db import TuningKey, size_bucket
        from adapcc_tpu_torch.tuner.policy import pipe_path

        best, best_t = None, float("inf")
        for sched in PIPE_SCHEDULES:
            key = TuningKey(
                primitive=PIPE_PRIMITIVE,
                size_bucket=size_bucket(int(hop_bytes)),
                world=int(world),
                topology=topology,
                path=pipe_path(sched),
                chunk_bytes=int(microbatches),
                wire_dtype="off",
            )
            st = tuner_db.stats(key)
            if st is not None and st.median_s < best_t:
                best, best_t = sched, st.median_s
        if best is not None:
            return best
    return DEFAULT_PIPE_SCHEDULE
