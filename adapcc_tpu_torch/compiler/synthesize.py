"""Schedules only the IR can express: the port of
:mod:`adapcc_tpu.compiler.synthesize` (a copy).

:func:`pipelined_allreduce_program` is a bidirectional pipelined ring.  The
payload splits into ``2·world`` chunks; the first ``world`` travel clockwise
(rank → rank+1), the other ``world`` counter-clockwise, each direction its
own segmented reduce-scatter and all-gather walk.  Every rank sends two
chunks a round, one each way, which a ``CommRound`` (one send per rank) cannot
hold.  On a full-duplex fabric the two directions use disjoint links, so
each of the ``2(w−1)`` rounds moves ``n/(2w)`` bytes a link:
``T = 2(w−1)·(α + β·n/(2w))`` (``sim/cost_model.schedule_program_time``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from adapcc_tpu_torch.compiler.builders import _message
from adapcc_tpu_torch.compiler.ir import ScheduleProgram, Step


def _ring_direction_rounds(world: int, direction: int, chunk_base: int, codec: Optional[str]) -> List[List[Step]]:
    """One direction's segmented ring walk over its ``world`` chunks, the
    chunk indices offset by ``chunk_base``: ``direction=+1`` ships local
    chunk ``(s − r) mod w`` to ``s+1`` in reduce-scatter round ``r`` and
    ``(s + 1 − r) mod w`` in all-gather round ``r``; ``−1`` mirrors both."""
    w = world
    rounds: List[List[Step]] = []
    for r in range(w - 1):
        steps: List[Step] = []
        for s in range(w):
            local = (s - r) % w if direction > 0 else (s + r) % w
            steps.extend(_message(s, (s + direction) % w, chunk_base + local, "reduce", codec))
        rounds.append(steps)
    for r in range(w - 1):
        steps = []
        for s in range(w):
            local = (s + 1 - r) % w if direction > 0 else (s - 1 + r) % w
            steps.extend(_message(s, (s + direction) % w, chunk_base + local, "copy"))
        rounds.append(steps)
    return rounds


def pipelined_allreduce_program(world: int, wire_dtype: str = "off") -> ScheduleProgram:
    """The bidirectional ``2w``-chunk pipelined ring allreduce (module doc)."""
    if world < 2:
        raise ValueError(
            f"the pipelined ring needs world >= 2, got {world} (at world=1 "
            "there is nothing to pipeline — use any builder program)"
        )
    codec = wire_dtype if wire_dtype != "off" else None
    cw = _ring_direction_rounds(world, +1, 0, codec)
    ccw = _ring_direction_rounds(world, -1, world, codec)
    rounds: Tuple[Tuple[Step, ...], ...] = tuple(tuple(a + b) for a, b in zip(cw, ccw))
    return ScheduleProgram(
        name=f"pipelined-bidir-w{world}", world=world, chunks=2 * world, rounds=rounds, wire_dtype=wire_dtype,
    )
