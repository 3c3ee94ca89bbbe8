"""Chunk-granular collective schedule IR: the port of
:mod:`adapcc_tpu.compiler.ir` (a copy: importing the reference module would
load JAX through its package).

- a :class:`ScheduleProgram` is a list of **rounds**; a round is a list of
  typed :class:`Step`\\ s (``send``/``recv``/``reduce``/``copy``/``encode``/
  ``decode``) over ``chunks`` named chunk buffers replicated on every rank;
- rounds are barriers: every ``send`` reads its rank's *round-entry* buffer
  state, and its matching ``recv`` sits in the same round (a recv whose send
  lands later is a deadlock, which the verifier rejects);
- each ``recv`` is consumed by exactly one same-round ``reduce`` (combine
  into the local chunk) or ``copy`` (overwrite the local chunk);
- ``encode``/``decode`` mark a send/recv pair whose wire value takes the
  named codec's quantize→dequantize round trip (``quant/codec.py``);
- ``relays`` names ranks that forward traffic without contributing input or
  needing delivery (the AdapCC relay mask, here a program property).

A round is not constrained to a partial permutation: a rank may send several
chunks to several peers in one round.  The lowering (``compiler/lower.py``)
colors a round's messages into partial permutations; the IR stays at the
algorithm's own granularity, which is what lets it express schedules such as
the bidirectional pipelined ring (``compiler/synthesize.py``).

:meth:`ScheduleProgram.fingerprint` hashes the same text as the JAX
package's, so a program's fingerprint (a tuning-database and dispatch-trace
key) is one string in both packages.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

#: the closed set of step kinds; anything else is a construction error
STEP_KINDS = ("send", "recv", "reduce", "copy", "encode", "decode")

#: collectives a program may declare: ``allreduce`` lowers through
#: ``compiler/lower.py``; ``pipeline`` names point-to-point stage-hop
#: programs (each chunk one payload routed from a source rank to a sink
#: rank), verified and priced through the same object
PROGRAM_COLLECTIVES = ("allreduce", "pipeline")


@dataclass(frozen=True)
class Step:
    """One typed step of one rank in one round.

    ``peer`` is the destination rank of a ``send`` and the source rank of a
    ``recv``; ``codec`` names the wire codec of an ``encode``/``decode``
    step, or, after the ``fuse_codec`` pass, of the ``send``/``recv`` pair
    itself (the codec's transport arrays cross the wire).  ``span`` widens
    the step to the chunk range ``[chunk, chunk + span)``, the form the
    ``coalesce`` pass emits; the verifier expands it back to unit steps.
    """

    kind: str
    rank: int
    chunk: int
    peer: Optional[int] = None
    codec: Optional[str] = None
    span: int = 1

    def __post_init__(self) -> None:
        if self.kind not in STEP_KINDS:
            raise ValueError(f"unknown step kind {self.kind!r}; expected one of {STEP_KINDS}")
        if self.kind in ("send", "recv") and self.peer is None:
            raise ValueError(f"{self.kind} step at rank {self.rank} needs a peer")
        if self.kind in ("encode", "decode") and not self.codec:
            raise ValueError(f"{self.kind} step at rank {self.rank} needs a codec")
        if self.span < 1:
            raise ValueError(f"{self.kind} step at rank {self.rank}: span must be >= 1, got {self.span}")

    def describe(self) -> str:
        """The spelling verifier rejections use."""
        bits = f"{self.kind}(rank={self.rank}, chunk={self.chunk}"
        if self.span != 1:
            bits += f", span={self.span}"
        if self.peer is not None:
            bits += f", peer={self.peer}"
        if self.codec is not None:
            bits += f", codec={self.codec}"
        return bits + ")"


@dataclass(frozen=True)
class ScheduleProgram:
    """One collective schedule: the object the builders emit, the verifier
    certifies, the cost model prices (``sim/cost_model.
    schedule_program_time``) and the lowering executes."""

    name: str
    world: int
    chunks: int
    rounds: Tuple[Tuple[Step, ...], ...]
    collective: str = "allreduce"
    #: wire codec annotation; "off" = the payload dtype end to end
    wire_dtype: str = "off"
    #: ranks that forward without contributing input or needing delivery
    relays: Tuple[int, ...] = ()
    #: ``pipeline`` programs only: each chunk's origin and destination rank
    chunk_sources: Tuple[int, ...] = ()
    chunk_sinks: Tuple[int, ...] = ()
    #: the block size the fused block codec runs with (set by ``fuse_codec``)
    block_size: Optional[int] = None
    #: optimizer passes that rewrote this program, in application order
    applied_passes: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.collective not in PROGRAM_COLLECTIVES:
            raise ValueError(f"unknown collective {self.collective!r}; expected one of {PROGRAM_COLLECTIVES}")
        object.__setattr__(self, "rounds", tuple(tuple(rnd) for rnd in self.rounds))
        object.__setattr__(self, "relays", tuple(sorted(set(self.relays))))
        for r in self.relays:
            if not (0 <= r < self.world):
                raise ValueError(f"relay rank {r} out of range [0, {self.world})")
        if len(self.relays) >= self.world:
            raise ValueError("every rank is a relay: nothing contributes")
        object.__setattr__(self, "chunk_sources", tuple(self.chunk_sources))
        object.__setattr__(self, "chunk_sinks", tuple(self.chunk_sinks))
        if self.collective == "pipeline":
            if len(self.chunk_sources) != self.chunks or len(self.chunk_sinks) != self.chunks:
                raise ValueError(
                    "pipeline programs route each chunk point-to-point: "
                    f"need chunk_sources/chunk_sinks of length {self.chunks}, "
                    f"got {len(self.chunk_sources)}/{len(self.chunk_sinks)}"
                )
            if self.relays:
                raise ValueError(
                    "pipeline programs have no relays: intermediate stages "
                    "are named by the per-chunk hop steps themselves"
                )
            for label, ranks in (("chunk_sources", self.chunk_sources), ("chunk_sinks", self.chunk_sinks)):
                for c, r in enumerate(ranks):
                    if not (0 <= r < self.world):
                        raise ValueError(f"{label}[{c}] = {r} out of range [0, {self.world})")
        elif self.chunk_sources or self.chunk_sinks:
            raise ValueError(
                "chunk_sources/chunk_sinks are pipeline-program routing "
                f"metadata; collective {self.collective!r} does not take them"
            )
        object.__setattr__(self, "applied_passes", tuple(self.applied_passes))
        if self.block_size is not None and self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        for i, rnd in enumerate(self.rounds):
            for step in rnd:
                if not (0 <= step.rank < self.world):
                    raise ValueError(f"round {i}: {step.describe()} rank out of range [0, {self.world})")
                if step.peer is not None and not (0 <= step.peer < self.world):
                    raise ValueError(f"round {i}: {step.describe()} peer out of range [0, {self.world})")
                if not (0 <= step.chunk < self.chunks):
                    raise ValueError(f"round {i}: {step.describe()} chunk out of range [0, {self.chunks})")
                if step.chunk + step.span > self.chunks:
                    raise ValueError(
                        f"round {i}: {step.describe()} span reaches past the last chunk (chunks={self.chunks})"
                    )

    # -- queries ---------------------------------------------------------------

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    def contributors(self) -> Tuple[int, ...]:
        """Ranks that contribute input and need delivery (non-relays)."""
        relay = set(self.relays)
        return tuple(r for r in range(self.world) if r not in relay)

    def steps(self) -> Iterator[Tuple[int, Step]]:
        for i, rnd in enumerate(self.rounds):
            for step in rnd:
                yield i, step

    def total_sends(self) -> int:
        return sum(1 for _, s in self.steps() if s.kind == "send")

    def fingerprint(self) -> str:
        """Stable structural hash (memoized: the program is immutable), the
        JAX package's text hashed the same way."""
        cached = self.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        h = hashlib.sha256()
        h.update(
            f"{self.name}|{self.world}|{self.chunks}|{self.collective}|"
            f"{self.wire_dtype}|{self.relays}".encode()
        )
        if self.chunk_sources or self.chunk_sinks:
            # only when present, so collective programs keep their hashes
            h.update(f"|{self.chunk_sources}|{self.chunk_sinks}".encode())
        if self.block_size is not None or self.applied_passes:
            # optimizer provenance (same rule): an optimized program and its
            # naive source never share a key
            h.update(f"|b{self.block_size}|{self.applied_passes}".encode())
        for i, rnd in enumerate(self.rounds):
            h.update(f"r{i}".encode())
            for s in rnd:
                h.update(f"{s.kind},{s.rank},{s.chunk},{s.peer},{s.codec}".encode())
                if s.span != 1:
                    h.update(f",x{s.span}".encode())
                h.update(b";")
        fp = h.hexdigest()[:16]
        self.__dict__["_fingerprint"] = fp
        return fp

    def __repr__(self) -> str:
        return (
            f"ScheduleProgram(name={self.name!r}, world={self.world}, "
            f"chunks={self.chunks}, rounds={self.num_rounds}, "
            f"wire_dtype={self.wire_dtype!r}, fingerprint={self.fingerprint()})"
        )
