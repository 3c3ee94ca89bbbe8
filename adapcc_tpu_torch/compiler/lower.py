"""The one lowering of a :class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram`:
the port of :mod:`adapcc_tpu.compiler.lower`.

Every verified program runs through this module, ring, recursive doubling,
binomial tree, the composed two-level plan and any synthesized schedule
alike.  The color plan is the JAX package's, copied: each round's messages
are greedily colored, in step order, into partial permutations (distinct
sources, distinct destinations, one row count and one fused codec a color),
and each color is one transfer a wire array.  The dispatch count
(:func:`dispatch_count`) is a static property of that plan.

Two executors share one core (:func:`_run_rounds`):

- :func:`execute_program_stacked` runs ``x[world, ...]`` on one device (the
  card, or the CPU for a CPU tensor): a color's transfer is a move between
  rows, a gather of the sources' chunk rows and a commit into the
  destinations';
- :func:`execute_program_shard` runs this rank's ``x`` over a process group
  (gloo on the CPU, NCCL on the card): a color is one ``batch_isend_irecv``
  a wire array, posted only by ranks with an edge in it, so the count in
  the trace is the count issued.

The semantics are JAX's, op for op:

- the payload flattens and zero-pads to ``chunks × seg``, one row a chunk;
- every send of a round reads the round's entry state: the executor
  gathers the wires of every color of a round before it commits any, so a
  chunk shipped and overwritten in one round ships its old value (only the
  shipped rows are copied, never the whole buffer);
- a ``reduce`` combines ``(local, received)``; a ``copy`` overwrites;
- relays enter with the reduction identity (``0``; ``-inf``, or an
  integer's ``iinfo.min``, for MAX) and do not count in AVG's divisor,
  ``len(program.contributors())``; AVG divides in IEEE by a tensor on the
  result's device (an integer sum to float32), where JAX under ``jit``
  multiplies by the float32 reciprocal (an ulp off in some elements);
- an ``encode``/``decode`` pair applies the program's codec round trip to
  the wire value; a fused codec (the ``fuse_codec`` pass) ships the codec's
  transport arrays (int8: codes and scales, two transfers a color), the
  value cast to float32 before the int8 encode and decoded back to the
  payload dtype.  Both encode each chunk row on its own, so a ragged last
  block stays inside its row and the fused wire value equals the unfused
  one bit for bit.  A reduce after a fused decode may differ from JAX's
  compiled program by an ulp, where XLA contracts the dequantize multiply
  into the add.

On a two-level world, :func:`two_level_color_axes` classifies each color as
intra-slice or member-aligned cross-slice and refuses, naming the round, a
program that does not decompose; the stacked executor then runs it on the
card's rows.  The per-rank two-level executor needs lane and slice
subgroups and comes with the per-process slice.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adapcc_tpu_torch.compiler.ir import ScheduleProgram
from adapcc_tpu_torch.primitives import ReduceOp, not_ported
from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE, get_codec, quantize_int8

#: transfers a color and fused codec: each of the codec's transport arrays
#: (``WireCodec.encode``'s tuple) is one; a codec not named ships one
_WIRE_ARRAYS = {"int8": 2}


def _identity_value(op: ReduceOp, dtype: torch.dtype):
    if op is ReduceOp.MAX:
        return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
    return 0


class _Color:
    """One partial permutation of one round: the per-rank tables of one
    transfer and its commit.  ``k`` chunk rows ride a pair; every pair of a
    color ships the same ``k`` under the same fused codec."""

    __slots__ = (
        "world", "k", "codec", "perm", "send_rows", "dst_rows", "copy_row",
        "is_src", "is_dst", "encoded", "any_encoded",
    )

    def __init__(self, world: int, k: int, codec: Optional[str]) -> None:
        self.world = world
        self.k = k
        self.codec = codec
        self.perm: List[Tuple[int, int]] = []
        self.send_rows = np.zeros((world, k), dtype=np.int32)
        self.dst_rows = np.zeros((world, k), dtype=np.int32)
        self.copy_row = np.zeros((world, k), dtype=bool)
        self.is_src = np.zeros(world, dtype=bool)
        self.is_dst = np.zeros(world, dtype=bool)
        self.encoded = np.zeros((world, k), dtype=bool)
        self.any_encoded = False

    def can_take(self, src: int, dst: int, k: int, codec: Optional[str]) -> bool:
        return not self.is_src[src] and not self.is_dst[dst] and self.k == k and self.codec == codec

    def take(self, src: int, dst: int, rows: Sequence[int], copy: Sequence[bool], encoded: Sequence[bool]) -> None:
        self.perm.append((src, dst))
        self.send_rows[src] = rows
        self.is_src[src] = True
        self.dst_rows[dst] = rows
        self.is_dst[dst] = True
        self.copy_row[dst] = copy
        self.encoded[src] = encoded
        self.any_encoded = self.any_encoded or any(encoded)

    def dispatches(self) -> int:
        """Transfers this color issues: one a wire array."""
        if self.codec is None:
            return 1
        return _WIRE_ARRAYS.get(self.codec, 1)


def _color_rounds(program: ScheduleProgram) -> List[List[_Color]]:
    """Greedy-color every round's messages into partial permutations, in
    step order (memoized on the program, which is immutable)."""
    cached = program.__dict__.get("_lowering_colors")
    if cached is not None:
        return cached
    plan: List[List[_Color]] = []
    for rnd in program.rounds:
        sends = []
        consumers = {}
        encodes = set()
        for step in rnd:
            if step.kind == "send":
                sends.append(step)
            elif step.kind in ("reduce", "copy"):
                for i in range(step.span):
                    consumers[(step.rank, step.chunk + i)] = step.kind
            elif step.kind == "encode":
                for i in range(step.span):
                    encodes.add((step.rank, step.chunk + i))
        colors: List[_Color] = []
        for step in sends:
            src, dst = step.rank, step.peer
            rows = list(range(step.chunk, step.chunk + step.span))
            copy = [consumers.get((dst, c)) == "copy" for c in rows]
            encoded = [(src, c) in encodes for c in rows]
            k = len(rows)
            for col in colors:
                if col.can_take(src, dst, k, step.codec):
                    col.take(src, dst, rows, copy, encoded)
                    break
            else:
                col = _Color(program.world, k, step.codec)
                col.take(src, dst, rows, copy, encoded)
                colors.append(col)
        plan.append(colors)
    program.__dict__["_lowering_colors"] = plan
    return plan


def round_dispatch_counts(program: ScheduleProgram) -> List[int]:
    """Transfers per round, from the color plan alone."""
    return [sum(col.dispatches() for col in colors) for colors in _color_rounds(program)]


def dispatch_count(program: ScheduleProgram) -> int:
    """Total transfers the program issues: the number the optimizer shrinks,
    stamped in the dispatch trace and priced by ``schedule_program_time(...,
    per_dispatch_s=...)``."""
    return sum(round_dispatch_counts(program))


# --------------------------------------------------------------------------- #
# the wire codec, one chunk row at a time
# --------------------------------------------------------------------------- #


def _encode_rows(name: str, rows: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, ...]:
    """``codec.encode`` of each row of ``rows [r, seg]`` on its own, batched:
    int8 cuts every row into its own blocks (a ragged last block padded
    inside its row), so codes are ``[r, nblocks, block]`` and scales ``[r,
    nblocks]``."""
    if name == "int8":
        r, seg = rows.shape
        nblocks = -(-seg // block_size) if seg else 1
        x = rows.to(torch.float32)
        if nblocks * block_size != seg:
            x = torch.nn.functional.pad(x, (0, nblocks * block_size - seg))
        q, scales = quantize_int8(x.reshape(-1), block_size)
        return q.view(r, nblocks, block_size), scales.view(r, nblocks)
    if name == "bf16":
        return (rows.to(torch.bfloat16),)
    if name == "off":
        return (rows,)
    codec = get_codec(name)
    return tuple(torch.stack(parts) for parts in zip(*(codec.encode(row, block_size) for row in rows)))


def _decode_rows(name: str, arrays: Sequence[torch.Tensor], seg: int, block_size: int) -> torch.Tensor:
    """Inverse of :func:`_encode_rows`: ``[r, seg]`` float32 (``off``: the
    payload dtype)."""
    if name == "int8":
        q, scales = arrays
        return (q.to(torch.float32) * scales[..., None]).reshape(q.shape[0], -1)[:, :seg]
    if name == "bf16":
        return arrays[0].to(torch.float32)
    if name == "off":
        return arrays[0]
    codec = get_codec(name)
    return torch.stack([codec.decode(parts, seg, block_size) for parts in zip(*arrays)])


def _wire_like(name: Optional[str], k: int, seg: int, block_size: int, dtype: torch.dtype,
               device: torch.device) -> List[torch.Tensor]:
    """Empty tensors of the shapes one pair's transport arrays take."""
    if name == "int8":
        nblocks = -(-seg // block_size) if seg else 1
        return [torch.empty((k, nblocks, block_size), dtype=torch.int8, device=device),
                torch.empty((k, nblocks), dtype=torch.float32, device=device)]
    probe = _encode_rows(name or "off", torch.zeros((k, seg), dtype=dtype, device=device), block_size)
    return [torch.empty_like(a) for a in probe]


def _apply_codec(wire: torch.Tensor, encoded, name: str, block_size: int) -> torch.Tensor:
    """The unfused form: the wire value of each ``encoded`` row takes the
    codec's round trip (``encoded``: True for every row, else a bool mask)."""
    if name == "off":
        return wire
    applied = _decode_rows(name, _encode_rows(name, wire, block_size), wire.shape[1], block_size).to(wire.dtype)
    if encoded is True:
        return applied
    return torch.where(encoded[:, None], applied, wire)


def _run_rounds(program: ScheduleProgram, seg: int, dtype: torch.dtype, gather: Callable, ship: Callable,
                commit: Callable) -> None:
    """The shared executor core: for each round, every color's wire from the
    round's entry state (``gather(ri, ci, col) -> (wire, encoded)``, ``wire``
    None where this form sends nothing), then color by color its transfer
    (``ship(col, arrays) -> arrays``, None where nothing arrives) and its
    commit (``commit(ri, ci, col, received)``)."""
    codec = program.wire_dtype if program.wire_dtype != "off" else None
    block_size = program.block_size or DEFAULT_BLOCK_SIZE
    for ri, colors in enumerate(_color_rounds(program)):
        wires = []
        for ci, col in enumerate(colors):
            wire, encoded = gather(ri, ci, col)
            if wire is not None and encoded is not None and codec is not None:
                wire = _apply_codec(wire, encoded, codec, block_size)
            wires.append(wire)
        for ci, (col, wire) in enumerate(zip(colors, wires)):
            if col.codec is not None:
                arrays = None if wire is None else _encode_rows(col.codec, wire, block_size)
                got = ship(col, arrays)
                recvd = None if got is None else _decode_rows(col.codec, got, seg, block_size).to(dtype)
            else:
                got = ship(col, None if wire is None else (wire,))
                recvd = None if got is None else got[0]
            if recvd is not None:
                commit(ri, ci, col, recvd)


def _layout(n: int, chunks: int) -> Tuple[int, int]:
    seg = -(-n // chunks)
    return seg, chunks * seg - n


def _avg(acc: torch.Tensor, program: ScheduleProgram, op: ReduceOp) -> torch.Tensor:
    """AVG's one division by the contributors, in IEEE, by a tensor on the
    result's device (an integer sum to float32)."""
    if op is not ReduceOp.AVG:
        return acc
    count = len(program.contributors())
    if acc.is_floating_point():
        return acc.div_(torch.full((), count, dtype=acc.dtype, device=acc.device))
    return acc / torch.full((), count, dtype=acc.dtype, device=acc.device)


# --------------------------------------------------------------------------- #
# the stacked form: every rank's row on one device
# --------------------------------------------------------------------------- #


class _StackedColor:
    """One color's row moves over the stacked ``[world · chunks, seg]``
    buffer: source and destination row indices pair by pair, the rows a
    commit adopts and those it combines, and the encoded rows."""

    __slots__ = ("src", "dst", "copy", "reduce", "encoded")

    def __init__(self, col: _Color, chunks: int, device: torch.device) -> None:
        src, dst, copy, enc = [], [], [], []
        for s, d in col.perm:
            src.extend(s * chunks + int(r) for r in col.send_rows[s])
            dst.extend(d * chunks + int(r) for r in col.dst_rows[d])
            copy.extend(bool(c) for c in col.copy_row[d])
            enc.extend(bool(e) for e in col.encoded[s])

        def index(rows: List[int]) -> torch.Tensor:
            return torch.tensor(rows, dtype=torch.long, device=device)

        self.src = index(src)
        self.dst = index(dst)
        # (positions in the wire, destination rows) of the adopted and the
        # combined rows; the whole wire where a color is all one or the other
        self.copy = self.reduce = None
        if all(copy):
            self.copy = (None, self.dst)
        elif not any(copy):
            self.reduce = (None, self.dst)
        else:
            pos_c = [i for i, c in enumerate(copy) if c]
            pos_r = [i for i, c in enumerate(copy) if not c]
            self.copy = (index(pos_c), index([dst[i] for i in pos_c]))
            self.reduce = (index(pos_r), index([dst[i] for i in pos_r]))
        self.encoded = None if not any(enc) else True if all(enc) else torch.tensor(enc, device=device)


def _stacked_plan(program: ScheduleProgram, device: torch.device) -> List[List[_StackedColor]]:
    """The color plan as row indices on ``device`` (memoized per device)."""
    key = ("_stacked_colors", str(device))
    cached = program.__dict__.get(key)
    if cached is None:
        cached = [[_StackedColor(col, program.chunks, device) for col in colors]
                  for colors in _color_rounds(program)]
        program.__dict__[key] = cached
    return cached


def execute_program_stacked(x: torch.Tensor, program: ScheduleProgram, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Run ``program`` over the rows of ``x [world, ...]`` (row ``r`` rank
    ``r``'s contribution) on ``x``'s device; returns every rank's result as
    a new ``[world, ...]`` tensor (float32 for an integer AVG).  The caller
    has verified the program (the engine does, once per fingerprint)."""
    world = program.world
    if x.dim() == 0 or x.shape[0] != world:
        raise ValueError(f"program {program.name!r} is for world {world}, got a stacked tensor of shape "
                         f"{tuple(x.shape)}")
    chunks = program.chunks
    flat = x.reshape(world, -1)
    n = flat.shape[1]
    seg, pad = _layout(n, chunks)
    if pad:
        acc = flat.new_zeros((world, chunks * seg))
        acc[:, :n].copy_(flat)
    else:
        acc = flat.clone(memory_format=torch.contiguous_format)
    for r in program.relays:
        acc[r].fill_(_identity_value(op, acc.dtype))
    rows = acc.view(world * chunks, seg)
    plan = _stacked_plan(program, x.device)

    def gather(ri: int, ci: int, col: _Color):
        moves = plan[ri][ci]
        return rows.index_select(0, moves.src), moves.encoded

    def commit(ri: int, ci: int, col: _Color, recvd: torch.Tensor) -> None:
        moves = plan[ri][ci]
        if moves.copy is not None:
            pos, dst = moves.copy
            rows.index_copy_(0, dst, recvd if pos is None else recvd.index_select(0, pos))
        if moves.reduce is not None:
            pos, dst = moves.reduce
            part = recvd if pos is None else recvd.index_select(0, pos)
            if op is ReduceOp.MAX:
                rows.index_copy_(0, dst, torch.maximum(rows.index_select(0, dst), part))
            else:
                rows.index_add_(0, dst, part)  # local + received, one rounding

    # the wire's p-th pair lands on the p-th pair's destination rows
    _run_rounds(program, seg, acc.dtype, gather, lambda col, arrays: arrays, commit)
    out = _avg(acc, program, op)
    if pad:
        return out[:, :n].reshape(x.shape)
    return out.view(x.shape)


# --------------------------------------------------------------------------- #
# the per-rank form: this rank's payload over a process group
# --------------------------------------------------------------------------- #


def _contiguous_run(rows: np.ndarray) -> Optional[int]:
    """The first row where ``rows`` is one contiguous run (every builder's
    and the coalesce pass's messages are), else None."""
    lo = int(rows[0])
    return lo if all(int(r) == lo + i for i, r in enumerate(rows)) else None


def execute_program_shard(x: torch.Tensor, program: ScheduleProgram, group=None,
                          op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Run ``program`` on this rank's payload ``x`` over ``group`` (None: the
    default group); returns this rank's result as a new tensor in ``x``'s
    shape (float32 for an integer AVG).  Each color posts one
    ``batch_isend_irecv`` a wire array on the ranks with an edge in it; every
    rank walks the same static plan, colors in order.  The caller has
    verified the program."""
    import torch.distributed as dist

    from adapcc_tpu_torch.comm.engine import _exchange, _peers, _warm

    world = dist.get_world_size(group)
    if program.world != world:
        raise ValueError(f"program {program.name!r} is for world {program.world}, the group has {world} ranks")
    _warm(group, x.device)
    me = dist.get_rank(group)
    chunks = program.chunks
    flat = x.reshape(-1)
    n = flat.numel()
    seg, pad = _layout(n, chunks)
    acc = flat.new_zeros(chunks * seg)
    acc[:n].copy_(flat)
    if me in program.relays:
        acc.fill_(_identity_value(op, acc.dtype))
    acc = acc.view(chunks, seg)
    block_size = program.block_size or DEFAULT_BLOCK_SIZE

    def rows_of(rows: np.ndarray) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``acc[rows]``: a view, or a gathered copy and its index."""
        lo = _contiguous_run(rows)
        if lo is not None:
            return acc[lo:lo + len(rows)], None
        index = torch.as_tensor(rows.astype(np.int64), device=acc.device)
        return acc.index_select(0, index), index

    def gather(ri: int, ci: int, col: _Color):
        if not col.is_src[me]:
            return None, None
        enc = col.encoded[me]
        encoded = None if not enc.any() else True if enc.all() else torch.as_tensor(enc, device=acc.device)
        wire, index = rows_of(col.send_rows[me])
        return (wire.clone() if index is None else wire), encoded

    def ship(col: _Color, arrays):
        dst, src = _peers(col.perm, me)
        if dst is None and src is None:
            return None  # no edge in this color: post nothing
        likes = (_wire_like(col.codec, col.k, seg, block_size, acc.dtype, acc.device) if src is not None
                 else [None] * col.dispatches())
        sends = arrays if arrays is not None else [None] * len(likes)
        got = [_exchange(None if a is None else a.contiguous(), dst, src, like, group)
               for a, like in zip(sends, likes)]
        return None if src is None else got

    def commit(ri: int, ci: int, col: _Color, recvd: torch.Tensor) -> None:
        cur, index = rows_of(col.dst_rows[me])
        copy = col.copy_row[me]
        if copy.all():
            new = recvd
        else:
            new = torch.maximum(cur, recvd) if op is ReduceOp.MAX else cur + recvd
            if copy.any():
                new = torch.where(torch.as_tensor(copy, device=acc.device)[:, None], recvd, new)
        if index is None:
            cur.copy_(new)
        else:
            acc.index_copy_(0, index, new)

    _run_rounds(program, seg, acc.dtype, gather, ship, commit)
    out = _avg(acc, program, op).reshape(-1)
    return out[:n].reshape(x.shape) if pad else out.view(x.shape)


def allreduce_per_shard(program: ScheduleProgram, group=None, op: ReduceOp = ReduceOp.SUM):
    """The engine-facing per-rank callable in the stacked ``[1, *payload]``
    convention (``x[0]`` is this rank's payload)."""

    def per_shard(x: torch.Tensor) -> torch.Tensor:
        return execute_program_shard(x[0], program, group, op)[None]

    return per_shard


# --------------------------------------------------------------------------- #
# two-level worlds
# --------------------------------------------------------------------------- #


def _partial_permutation(pairs: List[Tuple[int, int]]) -> Optional[List[Tuple[int, int]]]:
    """The deduplicated pairs as a partial permutation, or None where
    sources or destinations collide."""
    uniq = sorted(set(pairs))
    if len({s for s, _ in uniq}) != len(uniq):
        return None
    if len({d for _, d in uniq}) != len(uniq):
        return None
    return uniq


def two_level_color_axes(
    program: ScheduleProgram, num_slices: int, ici_size: int
) -> List[List[Tuple[str, List[Tuple[int, int]]]]]:
    """Classify every color of ``program`` on a ``(dcn, ici)`` world: per
    round, per color, ``("ici", member_perm)`` where every pair stays in its
    slice and the member-level projection is one partial permutation, or
    ``("dcn", slice_perm)`` where every pair joins the same member across
    slices.  A color that is neither raises, naming the round: the program
    does not decompose onto the hierarchy.  Memoized per (program, shape)."""
    key = ("_two_level_axes", num_slices, ici_size)
    cached = program.__dict__.get(key)
    if cached is not None:
        return cached
    if program.world != num_slices * ici_size:
        raise ValueError(
            f"program {program.name!r} is for world {program.world}, the "
            f"(dcn, ici) mesh is {num_slices}x{ici_size}"
        )
    plan: List[List[Tuple[str, List[Tuple[int, int]]]]] = []
    for ri, colors in enumerate(_color_rounds(program)):
        out: List[Tuple[str, List[Tuple[int, int]]]] = []
        for col in colors:
            intra = all(s // ici_size == d // ici_size for s, d in col.perm)
            cross = all(s % ici_size == d % ici_size for s, d in col.perm)
            if intra:
                axis_perm = _partial_permutation([(s % ici_size, d % ici_size) for s, d in col.perm])
                if axis_perm is not None:
                    out.append(("ici", axis_perm))
                    continue
            if cross:
                axis_perm = _partial_permutation([(s // ici_size, d // ici_size) for s, d in col.perm])
                if axis_perm is not None:
                    out.append(("dcn", axis_perm))
                    continue
            raise ValueError(
                f"program {program.name!r} round {ri} has a transfer group "
                "that is neither intra-pod nor member-aligned cross-pod: "
                "it does not decompose onto the (dcn, ici) mesh — run it "
                "on a flat mesh, or build a two-level program "
                "(compiler.two_level_allreduce_program)"
            )
        plan.append(out)
    program.__dict__[key] = plan
    return plan


def execute_program_two_level_shard(x: torch.Tensor, program: ScheduleProgram, num_slices: int, ici_size: int,
                                    lane_group=None, slice_group=None, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """This rank's program on a two-level world, each color over its lane or
    its slice subgroup: the program is classified (and refused where it
    does not decompose) first, then this raises, as the subgroups come with
    the per-process slice."""
    two_level_color_axes(program, num_slices, ici_size)
    raise not_ported("the per-rank two-level IR executor (lane and slice subgroups)",
                     "the per-process slice (ROADMAP §1 item 2)")


def allreduce_per_shard_two_level(program: ScheduleProgram, num_slices: int, ici_size: int, lane_group=None,
                                  slice_group=None, op: ReduceOp = ReduceOp.SUM):
    """The engine-facing two-level per-rank callable (``[1, *payload]``)."""

    def per_shard(x: torch.Tensor) -> torch.Tensor:
        return execute_program_two_level_shard(x[0], program, num_slices, ici_size, lane_group, slice_group, op)[None]

    return per_shard
