"""Static verifier of a :class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram`:
the port of :mod:`adapcc_tpu.compiler.verify` (a copy).

Every program is certified before it runs (the engine verifies once per
fingerprint).  Verification is an abstract interpretation over contribution
sets: chunk ``c`` on rank ``r`` carries the set of ranks whose input has been
folded into it.  Each check rejects with the offending ``(rank, round,
chunk)`` named, in the JAX package's words:

1. **matching**: every ``recv`` has exactly one same-round ``send`` with
   mirrored endpoints (otherwise a deadlock), every ``send`` a ``recv`` (an
   unreceived send is a dropped contribution), no duplicate message on one
   (src, dst, chunk) edge in a round;
2. **consumption**: each recv is consumed by exactly one same-round
   ``reduce`` or ``copy``; a reduce/copy with no recv feeding it, or a second
   recv landing on one (rank, chunk) in a round, is rejected;
3. **no double-reduce**: a reduce whose incoming contribution set meets the
   local one would fold some rank's input in twice;
4. **codec pairing**: an ``encode`` wraps a same-round send whose receiver
   ``decode``\\ s with the same codec; a ``decode`` needs an encoded message;
5. **delivery**: after the last round every non-relay rank holds, for every
   chunk, exactly the full contributor set.

``collective="pipeline"`` programs run the same interpretation with routed
initial and final states (chunk ``c`` starts at ``chunk_sources[c]`` only,
a hop forwards only what its sender holds at round entry, and
``chunk_sinks[c]`` ends holding exactly the source's contribution).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Tuple

from adapcc_tpu_torch.compiler.ir import ScheduleProgram, Step


class ScheduleVerificationError(ValueError):
    """A program failed static verification; the message names the
    offending step as ``(rank=…, round=…, chunk=…)``."""


def _fail(round_idx: int, step: Step, why: str) -> None:
    raise ScheduleVerificationError(
        f"invalid schedule step at (rank={step.rank}, round={round_idx}, "
        f"chunk={step.chunk}): {step.describe()}: {why}"
    )


def normalize_program(program: ScheduleProgram) -> ScheduleProgram:
    """The unit-step, unfused view of an optimized program: ``span`` steps
    expand to one step a chunk, and a fused ``send``/``recv`` carrying a
    ``codec`` to the ``encode``/``send`` and ``recv``/``decode`` pairs.  A
    program already in that form comes back as the same object."""
    changed = False
    rounds: List[tuple] = []
    for rnd in program.rounds:
        steps: List[Step] = []
        for step in rnd:
            units = (
                [step] if step.span == 1 else [
                    Step(step.kind, step.rank, step.chunk + i, peer=step.peer, codec=step.codec)
                    for i in range(step.span)
                ]
            )
            for unit in units:
                if unit.kind == "send" and unit.codec is not None:
                    steps.append(Step("encode", unit.rank, unit.chunk, codec=unit.codec))
                    steps.append(Step("send", unit.rank, unit.chunk, peer=unit.peer))
                    changed = True
                elif unit.kind == "recv" and unit.codec is not None:
                    steps.append(Step("recv", unit.rank, unit.chunk, peer=unit.peer))
                    steps.append(Step("decode", unit.rank, unit.chunk, codec=unit.codec))
                    changed = True
                else:
                    steps.append(unit)
            changed = changed or len(units) > 1
        rounds.append(tuple(steps))
    if not changed:
        return program
    return dataclasses.replace(program, rounds=tuple(rounds), applied_passes=(), block_size=None)


def verify_program(program: ScheduleProgram) -> None:
    """Certify ``program`` or raise :class:`ScheduleVerificationError`."""
    program = normalize_program(program)
    contributors = frozenset(program.contributors())
    pipeline = program.collective == "pipeline"
    # state[rank][chunk]: the ranks folded in; relays start empty
    if pipeline:
        state: List[List[FrozenSet[int]]] = [
            [frozenset((r,)) if program.chunk_sources[c] == r else frozenset()
             for c in range(program.chunks)]
            for r in range(program.world)
        ]
    else:
        state = [
            [frozenset((r,)) if r in contributors else frozenset() for _ in range(program.chunks)]
            for r in range(program.world)
        ]

    for i, rnd in enumerate(program.rounds):
        sends: Dict[Tuple[int, int, int], Step] = {}  # (src, dst, chunk)
        recvs: Dict[Tuple[int, int, int], Step] = {}
        consumers: Dict[Tuple[int, int], List[Step]] = {}  # (rank, chunk)
        encodes: Dict[Tuple[int, int], Step] = {}
        decodes: Dict[Tuple[int, int], Step] = {}
        for step in rnd:
            if step.kind == "send":
                edge = (step.rank, step.peer, step.chunk)
                if edge in sends:
                    _fail(i, step, "duplicate send on this (src, dst, chunk) edge")
                sends[edge] = step
            elif step.kind == "recv":
                edge = (step.peer, step.rank, step.chunk)
                if edge in recvs:
                    _fail(i, step, "duplicate recv on this (src, dst, chunk) edge")
                recvs[edge] = step
            elif step.kind in ("reduce", "copy"):
                consumers.setdefault((step.rank, step.chunk), []).append(step)
            elif step.kind == "encode":
                if (step.rank, step.chunk) in encodes:
                    _fail(i, step, "duplicate encode for this (rank, chunk)")
                encodes[(step.rank, step.chunk)] = step
            elif step.kind == "decode":
                if (step.rank, step.chunk) in decodes:
                    _fail(i, step, "duplicate decode for this (rank, chunk)")
                decodes[(step.rank, step.chunk)] = step

        # 1. send <-> recv bijection inside the barrier round
        for edge, step in recvs.items():
            if edge not in sends:
                _fail(
                    i, step,
                    f"no matching send from rank {step.peer} in round {i} — "
                    "rounds are barriers, so this recv can never be "
                    "satisfied (deadlock)",
                )
        for edge, step in sends.items():
            if edge not in recvs:
                _fail(
                    i, step,
                    f"no matching recv at rank {step.peer} in round {i} — "
                    "the sent contribution would be dropped",
                )

        # 2. one recv per (rank, chunk), consumed exactly once
        landing: Dict[Tuple[int, int], Tuple[int, Step]] = {}
        for (src, dst, chunk), step in recvs.items():
            if (dst, chunk) in landing:
                _fail(
                    i, step,
                    "a second recv lands on this (rank, chunk) in one round; "
                    "the combine order would be ambiguous",
                )
            landing[(dst, chunk)] = (src, step)
        for key, steps in consumers.items():
            if len(steps) > 1:
                _fail(i, steps[1], "chunk consumed twice in one round (double-reduce)")
            if key not in landing:
                _fail(i, steps[0], "consumes no received value (no recv feeds it)")
        for key, (src, step) in landing.items():
            if key not in consumers:
                _fail(i, step, "received value is never consumed (missing reduce/copy)")

        # 4. codec pairing rides the matched messages
        for (rank, chunk), step in encodes.items():
            edge = next((e for e in sends if e[0] == rank and e[2] == chunk), None)
            if edge is None:
                _fail(i, step, "encode wraps no same-round send")
            send = sends[edge]
            dec = decodes.get((send.peer, chunk))
            if dec is None:
                _fail(
                    i, step,
                    f"orphaned encode: receiver rank {send.peer} has no "
                    f"matching decode in round {i}",
                )
            if dec.codec != step.codec:
                _fail(i, dec, f"decode codec {dec.codec!r} does not match encode codec {step.codec!r}")
        for (rank, chunk), step in decodes.items():
            if (rank, chunk) not in landing:
                _fail(i, step, "decode with no incoming message")
            src, _ = landing[(rank, chunk)]
            if (src, chunk) not in encodes:
                _fail(i, step, f"decode of an unencoded message from rank {src}")

        # 3. dataflow: sends read round-entry state; reduce unions disjoint
        # contribution sets; copy overwrites
        entry = [list(row) for row in state]
        if pipeline:
            for (src, _dst, chunk), step in sends.items():
                if not entry[src][chunk]:
                    _fail(
                        i, step,
                        f"sends chunk {chunk} before holding it — the "
                        f"payload (source rank "
                        f"{program.chunk_sources[chunk]}) has not reached "
                        f"rank {src} by round {i}",
                    )
        for (dst, chunk), (src, _step) in landing.items():
            incoming = entry[src][chunk]
            consumer = consumers[(dst, chunk)][0]
            if consumer.kind == "copy":
                state[dst][chunk] = incoming
            else:  # reduce
                dup = state[dst][chunk] & incoming
                if dup:
                    _fail(
                        i, consumer,
                        f"double-reduce: contributions {sorted(dup)} are already folded into this chunk",
                    )
                state[dst][chunk] = state[dst][chunk] | incoming

    # 5. delivery
    if pipeline:
        for c in range(program.chunks):
            src, sink = program.chunk_sources[c], program.chunk_sinks[c]
            want = frozenset((src,))
            if state[sink][c] != want:
                raise ScheduleVerificationError(
                    f"undelivered chunk at (rank={sink}, "
                    f"round={program.num_rounds - 1}, chunk={c}): sink holds "
                    f"{sorted(state[sink][c])}, expected the source payload "
                    f"from rank {src}"
                )
        return
    for r in program.contributors():
        for c in range(program.chunks):
            if state[r][c] != contributors:
                missing = sorted(contributors - state[r][c])
                raise ScheduleVerificationError(
                    f"undelivered chunk at (rank={r}, round={program.num_rounds - 1}, "
                    f"chunk={c}): final contributions {sorted(state[r][c])} "
                    f"are missing ranks {missing}"
                )
