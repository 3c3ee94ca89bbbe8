"""Optimizer passes over a :class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram`:
the port of :mod:`adapcc_tpu.compiler.optimize` (a copy).

- ``dce``: a ``copy`` delivered to a relay whose value is never read again
  (no later send from that (rank, chunk), no later reduce into it) is wire
  traffic with no observer; its message goes.  Runs to a fixpoint.
- ``fuse_codec``: encode→send and recv→decode groups become fused wire ops
  (the ``codec`` on the send/recv pair), so the executor ships the codec's
  transport arrays instead of a locally round-tripped payload; the program
  takes the codec's block size.
- ``coalesce``: unit messages of one round with the same (src, dst, consumer
  kind, codec) and contiguous chunks merge into one ``span`` step, so the
  executor moves them as one transfer (rd at world 8: 14 dispatches → 6).

The passes apply in that order (``PASS_NAMES``), each verified on the way in
and out.  ``ADAPCC_IR_OPT`` (off | on | a comma list of pass names, default
on) selects them; a malformed value raises.  A pass that changes nothing
returns its input, so an already-optimal program keeps its identity and
fingerprint; only real rewrites stamp ``applied_passes``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from adapcc_tpu_torch.compiler.ir import ScheduleProgram, Step

#: the env knob of the pipeline: "off" | "on" | a comma list of passes
IR_OPT_ENV = "ADAPCC_IR_OPT"

#: registered passes in canonical application order
PASS_NAMES = ("dce", "fuse_codec", "coalesce")


def resolve_ir_opt(value: Optional[str] = None) -> Tuple[str, ...]:
    """The passes in force: ``ADAPCC_IR_OPT`` > the argument > ``on`` (every
    pass), in canonical order; a malformed value raises."""
    env = os.environ.get(IR_OPT_ENV)
    raw = env if env is not None and env.strip() else value
    if raw is None:
        raw = "on"
    v = str(raw).strip().lower()
    if v == "off":
        return ()
    if v == "on":
        return PASS_NAMES
    names = [p.strip() for p in v.split(",") if p.strip()]
    bad = [p for p in names if p not in PASS_NAMES]
    if bad or not names:
        raise ValueError(
            f"{IR_OPT_ENV}/ir_opt={raw!r}: expected off|on or a comma list "
            f"drawn from {'|'.join(PASS_NAMES)}"
        )
    return tuple(p for p in PASS_NAMES if p in names)


# --------------------------------------------------------------------------- #
# round parsing shared by the passes: unit message groups
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class _Message:
    """One unit message of a round: send/recv and consumer, with either the
    encode/decode pair or a fused wire codec."""

    src: int
    dst: int
    chunk: int
    action: str                      # "reduce" | "copy"
    fused_codec: Optional[str]       # codec on the send/recv steps
    legacy_codec: Optional[str]      # codec on encode/decode steps

    def steps(self, span: int = 1) -> List[Step]:
        out: List[Step] = []
        if self.legacy_codec is not None:
            out.append(Step("encode", self.src, self.chunk, codec=self.legacy_codec, span=span))
        out.append(Step("send", self.src, self.chunk, peer=self.dst, codec=self.fused_codec, span=span))
        out.append(Step("recv", self.dst, self.chunk, peer=self.src, codec=self.fused_codec, span=span))
        if self.legacy_codec is not None:
            out.append(Step("decode", self.dst, self.chunk, codec=self.legacy_codec, span=span))
        out.append(Step(self.action, self.dst, self.chunk, span=span))
        return out


def _parse_round(rnd: Sequence[Step]) -> Optional[List[_Message]]:
    """A round as unit messages, or None where it does not decompose cleanly
    (span steps already there, orphan steps): a pass skips what it cannot
    prove."""
    sends: Dict[Tuple[int, int], Step] = {}
    recvs: Dict[Tuple[int, int], Step] = {}
    consumers: Dict[Tuple[int, int], Step] = {}
    encodes: Dict[Tuple[int, int], Step] = {}
    decodes: Dict[Tuple[int, int], Step] = {}
    order: List[Tuple[int, int, int]] = []  # (src, dst, chunk) in send order
    for step in rnd:
        if step.span != 1:
            return None
        key = (step.rank, step.chunk)
        if step.kind == "send":
            if key in sends:
                return None
            sends[key] = step
            order.append((step.rank, step.peer, step.chunk))
        elif step.kind == "recv":
            if key in recvs:
                return None
            recvs[key] = step
        elif step.kind in ("reduce", "copy"):
            if key in consumers:
                return None
            consumers[key] = step
        elif step.kind == "encode":
            encodes[key] = step
        elif step.kind == "decode":
            decodes[key] = step
    messages: List[_Message] = []
    used = 0
    for src, dst, chunk in order:
        send = sends[(src, chunk)]
        recv = recvs.get((dst, chunk))
        consumer = consumers.get((dst, chunk))
        if recv is None or recv.peer != src or consumer is None:
            return None
        enc = encodes.get((src, chunk))
        dec = decodes.get((dst, chunk))
        if (enc is None) != (dec is None):
            return None
        if send.codec != recv.codec:
            return None
        messages.append(_Message(
            src=src, dst=dst, chunk=chunk, action=consumer.kind, fused_codec=send.codec,
            legacy_codec=enc.codec if enc is not None else None,
        ))
        used += 3 + (2 if enc is not None else 0)
    if used != len(rnd):
        return None  # orphan steps: leave the round untouched
    return messages


def _rebuild(program: ScheduleProgram, rounds: List[Tuple[Step, ...]], **overrides) -> ScheduleProgram:
    return dataclasses.replace(program, rounds=tuple(rounds), **overrides)


# --------------------------------------------------------------------------- #
# the passes
# --------------------------------------------------------------------------- #


def dce_pass(program: ScheduleProgram) -> ScheduleProgram:
    """Dead-copy elimination under relay masks; identity without relays."""
    if not program.relays:
        return program
    relays = set(program.relays)
    parsed = [_parse_round(rnd) for rnd in program.rounds]
    changed = False
    while True:
        # a read of (rank, chunk): a send from it, or a reduce into it
        dead: List[Tuple[int, _Message]] = []
        for i, messages in enumerate(parsed):
            if messages is None:
                continue
            for m in messages:
                if m.action != "copy" or m.dst not in relays:
                    continue
                read_later = False
                for j in range(i + 1, len(parsed)):
                    later = parsed[j]
                    if later is None:
                        read_later = True  # an unparsed round: assume a read
                        break
                    for n in later:
                        if (n.src == m.dst and n.chunk == m.chunk) or (
                            n.dst == m.dst and n.chunk == m.chunk and n.action == "reduce"
                        ):
                            read_later = True
                            break
                    if read_later:
                        break
                if not read_later:
                    dead.append((i, m))
        if not dead:
            break
        changed = True
        for i, m in dead:
            parsed[i].remove(m)
    if not changed:
        return program
    rounds: List[Tuple[Step, ...]] = []
    for i, messages in enumerate(parsed):
        if messages is None:
            rounds.append(program.rounds[i])
        else:
            steps: List[Step] = []
            for m in messages:
                steps.extend(m.steps())
            if steps:
                rounds.append(tuple(steps))
    return _rebuild(program, rounds)


def fuse_codec_pass(program: ScheduleProgram) -> ScheduleProgram:
    """Encode→send / recv→decode groups into codec-carrying wire ops;
    identity on a program with no encode/decode step."""
    if not any(s.kind in ("encode", "decode") for _, s in program.steps()):
        return program
    changed = False
    rounds: List[Tuple[Step, ...]] = []
    for rnd in program.rounds:
        messages = _parse_round(rnd)
        if messages is None or not any(m.legacy_codec for m in messages):
            rounds.append(rnd)
            continue
        steps: List[Step] = []
        for m in messages:
            if m.legacy_codec is not None:
                m = dataclasses.replace(m, fused_codec=m.legacy_codec, legacy_codec=None)
                changed = True
            steps.extend(m.steps())
        rounds.append(tuple(steps))
    if not changed:
        return program
    from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE

    # the fused wire runs the codec's block math on the transport path: the
    # block size is part of what executes, and of the fingerprint
    return _rebuild(program, rounds, block_size=DEFAULT_BLOCK_SIZE)


def coalesce_pass(program: ScheduleProgram) -> ScheduleProgram:
    """Contiguous same-(src, dst, action, codec) unit messages of a round
    into span steps; identity where no round has a run to merge."""
    changed = False
    rounds: List[Tuple[Step, ...]] = []
    for rnd in program.rounds:
        messages = _parse_round(rnd)
        if messages is None:
            rounds.append(rnd)
            continue
        groups: Dict[Tuple, List[_Message]] = {}
        order: List[Tuple] = []
        for m in messages:
            key = (m.src, m.dst, m.action, m.fused_codec, m.legacy_codec)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(m)
        steps: List[Step] = []
        round_changed = False
        for key in order:
            run = sorted(groups[key], key=lambda m: m.chunk)
            i = 0
            while i < len(run):
                j = i
                while j + 1 < len(run) and run[j + 1].chunk == run[j].chunk + 1:
                    j += 1
                span = j - i + 1
                steps.extend(run[i].steps(span=span))
                if span > 1:
                    round_changed = True
                i = j + 1
        if round_changed:
            changed = True
            rounds.append(tuple(steps))
        else:
            rounds.append(rnd)
    if not changed:
        return program
    return _rebuild(program, rounds)


#: the pass registry: name -> program-to-program rewrite
PASSES: Dict[str, Callable[[ScheduleProgram], ScheduleProgram]] = {
    "dce": dce_pass,
    "fuse_codec": fuse_codec_pass,
    "coalesce": coalesce_pass,
}

_PassSpec = Union[str, Tuple[str, Callable[[ScheduleProgram], ScheduleProgram]]]


def optimize_program(program: ScheduleProgram, passes: Optional[Sequence[_PassSpec]] = None) -> ScheduleProgram:
    """Verify ``program``, apply each pass and verify its output, stamping
    ``applied_passes`` with the passes that rewrote it.  ``passes=None``
    resolves them from ``ADAPCC_IR_OPT``; an explicit sequence names
    registered passes or gives ``(name, callable)`` pairs.  Returns the
    input object where nothing rewrites."""
    from adapcc_tpu_torch.compiler.verify import verify_program

    resolved: List[Tuple[str, Callable]] = []
    for p in (resolve_ir_opt() if passes is None else passes):
        if isinstance(p, str):
            if p not in PASSES:
                raise ValueError(f"unknown optimizer pass {p!r}; registered passes: {'|'.join(PASS_NAMES)}")
            resolved.append((p, PASSES[p]))
        else:
            name, fn = p
            resolved.append((str(name), fn))
    verify_program(program)  # never rewrite an invalid program
    out = program
    for name, fn in resolved:
        nxt = fn(out)
        if nxt is out or nxt == out:
            continue
        nxt = dataclasses.replace(nxt, applied_passes=out.applied_passes + (name,))
        verify_program(nxt)  # a broken rewrite dies here
        out = nxt
    return out
