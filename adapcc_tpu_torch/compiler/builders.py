"""Builders of the hand-written planes as :class:`ScheduleProgram`\\ s: the
port of :mod:`adapcc_tpu.compiler.builders` (a copy).

Each builder mirrors the combine structure of the plane it stands for, so
the IR executor gives that plane's bits where the plane is itself a
deterministic schedule:

- :func:`program_from_strategy`: one chunk per tree, reduce rounds aligned by
  index across trees, then the broadcast rounds (for ``Strategy.ring(w,
  num_trans=w)`` the segmented ring; the merged schedule plane's structure);
- :func:`ring_allreduce_program`: that segmented ring by name;
- :func:`rd_allreduce_program`: recursive halving/doubling at world-chunk
  granularity, ``comm/latency.py``'s keep-half convention and
  ``combine(keep, received)`` operand order;
- :func:`tree_allreduce_program`: the binomial tree from the same round
  tables ``comm/latency.py`` runs;
- :func:`two_level_allreduce_program`: ring reduce-scatter inside each pod,
  a per-chunk cross-pod binomial allreduce, ring all-gather inside the pod.

A program with ``wire_dtype != "off"`` carries encode/decode steps on every
reduce-phase message; broadcast-phase copies ship the combined value
unencoded.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from adapcc_tpu_torch.compiler.ir import ScheduleProgram, Step


def _message(src: int, dst: int, chunk: int, action: str, codec: Optional[str] = None) -> Tuple[Step, ...]:
    """One message's steps: send/recv and the consumer, with the
    encode/decode pair when a codec rides the wire."""
    steps: List[Step] = []
    if codec is not None:
        steps.append(Step("encode", src, chunk, codec=codec))
    steps.append(Step("send", src, chunk, peer=dst))
    steps.append(Step("recv", dst, chunk, peer=src))
    if codec is not None:
        steps.append(Step("decode", dst, chunk, codec=codec))
    steps.append(Step(action, dst, chunk))
    return tuple(steps)


def program_from_strategy(strategy, name: Optional[str] = None) -> ScheduleProgram:
    """A :class:`~adapcc_tpu_torch.strategy.ir.Strategy` as a program:
    chunk ``t`` is tree ``t``'s segment, the trees' reduce rounds aligned by
    index, then their broadcast rounds."""
    wire = strategy.wire_dtype if strategy.wire_dtype != "off" else None
    reduce_rounds = [t.reduce_rounds() for t in strategy.trees]
    broadcast_rounds = [t.broadcast_rounds() for t in strategy.trees]
    rounds: List[Tuple[Step, ...]] = []
    for per_tree, action, codec in ((reduce_rounds, "reduce", wire), (broadcast_rounds, "copy", None)):
        depth = max((len(r) for r in per_tree), default=0)
        for i in range(depth):
            steps: List[Step] = []
            for t, tree_rounds in enumerate(per_tree):
                if i < len(tree_rounds):
                    for src, dst in tree_rounds[i].edges:
                        steps.extend(_message(src, dst, t, action, codec))
            if steps:
                rounds.append(tuple(steps))
    return ScheduleProgram(
        name=name or f"strategy-{strategy.synthesis or 'custom'}-w{strategy.world_size}",
        world=strategy.world_size,
        chunks=len(strategy.trees),
        rounds=tuple(rounds),
        wire_dtype=strategy.wire_dtype,
    )


def ring_allreduce_program(world: int, wire_dtype: str = "off") -> ScheduleProgram:
    """The segmented ring: ``Strategy.ring(world, num_trans=world)`` through
    :func:`program_from_strategy`, ``2(w−1)`` full-ring rounds of one chunk
    each."""
    from adapcc_tpu_torch.strategy.ir import Strategy

    strategy = Strategy.ring(world, num_trans=max(1, world))
    strategy.wire_dtype = wire_dtype
    return program_from_strategy(strategy, name=f"ring-seg-w{world}")


def rd_allreduce_program(world: int, wire_dtype: str = "off") -> ScheduleProgram:
    """Recursive halving/doubling at world-chunk granularity (power-of-two
    worlds only): at distance ``d`` rank ``me`` keeps the bit-``(me // d) %
    2`` half of its active range and ships the other half to ``me ^ d``,
    which reduces ``(keep, received)``; doubling walks back with copies."""
    if world < 1 or world & (world - 1):
        raise ValueError(f"rd program needs a power-of-two world, got {world}")
    codec = wire_dtype if wire_dtype != "off" else None
    rounds: List[Tuple[Step, ...]] = []
    ranges = [(0, world) for _ in range(world)]
    d = world // 2
    while d >= 1:
        steps: List[Step] = []
        new_ranges = list(ranges)
        for me in range(world):
            lo, hi = ranges[me]
            mid = (lo + hi) // 2
            partner = me ^ d
            if (me // d) % 2 == 0:
                keep, ship = (lo, mid), (mid, hi)
            else:
                keep, ship = (mid, hi), (lo, mid)
            for c in range(*ship):
                steps.extend(_message(me, partner, c, "reduce", codec))
            new_ranges[me] = keep
        ranges = new_ranges
        rounds.append(tuple(steps))
        d //= 2
    d = 1
    while d < world:
        steps = []
        new_ranges = list(ranges)
        for me in range(world):
            lo, hi = ranges[me]
            partner = me ^ d
            for c in range(lo, hi):
                steps.extend(_message(me, partner, c, "copy"))
            plo, phi = ranges[partner]
            new_ranges[me] = (min(lo, plo), max(hi, phi))
        ranges = new_ranges
        rounds.append(tuple(steps))
        d *= 2
    return ScheduleProgram(
        name=f"rd-w{world}", world=world, chunks=max(1, world), rounds=tuple(rounds), wire_dtype=wire_dtype,
    )


def tree_allreduce_program(world: int, wire_dtype: str = "off") -> ScheduleProgram:
    """The binomial tree rooted at 0: one chunk, reduce up then broadcast
    down, in ``comm/latency.py``'s edge order."""
    from adapcc_tpu_torch.comm.latency import _binomial_rounds, _tree_round_tables

    codec = wire_dtype if wire_dtype != "off" else None
    rounds: List[Tuple[Step, ...]] = []
    distances = _binomial_rounds(world)
    for d in distances:
        perm, _ = _tree_round_tables(world, d, 0, up=True)
        steps: List[Step] = []
        for src, dst in perm:
            steps.extend(_message(src, dst, 0, "reduce", codec))
        if steps:
            rounds.append(tuple(steps))
    for d in reversed(distances):
        perm, _ = _tree_round_tables(world, d, 0, up=False)
        steps = []
        for src, dst in perm:
            steps.extend(_message(src, dst, 0, "copy"))
        if steps:
            rounds.append(tuple(steps))
    return ScheduleProgram(
        name=f"tree-binomial-w{world}", world=world, chunks=1, rounds=tuple(rounds), wire_dtype=wire_dtype,
    )


def two_level_allreduce_program(pods: int, pod_size: int, wire_dtype: str = "off") -> ScheduleProgram:
    """The composed hierarchical plan as one flat-world program: rank ``p·S +
    i`` is member ``i`` of pod ``p``, the payload ``S = pod_size`` chunks;
    ring reduce-scatter inside each pod (``S − 1`` rounds, member ``i`` ends
    owning chunk ``(i + 1) % S``), a binomial allreduce of each chunk among
    its owners across pods, ring all-gather inside each pod.  The cross-pod
    legs carry ``1/S`` of the payload."""
    from adapcc_tpu_torch.comm.latency import _binomial_rounds, _tree_round_tables

    if pods < 1 or pod_size < 1:
        raise ValueError(f"need pods >= 1 and pod_size >= 1, got {pods}x{pod_size}")
    world = pods * pod_size
    S = pod_size
    codec = wire_dtype if wire_dtype != "off" else None
    rounds: List[Tuple[Step, ...]] = []

    def member(p: int, i: int) -> int:
        return p * S + i

    # phase 1: ring reduce-scatter within each pod; round r, member i ships
    # chunk (i - r) mod S to member (i + 1) mod S
    for r in range(S - 1):
        steps: List[Step] = []
        for p in range(pods):
            for i in range(S):
                c = (i - r) % S
                steps.extend(_message(member(p, i), member(p, (i + 1) % S), c, "reduce", codec))
        if steps:
            rounds.append(tuple(steps))
    owner = {c: (c - 1) % S for c in range(S)}
    # phase 2: cross-pod binomial allreduce per chunk among its owners
    distances = _binomial_rounds(pods)
    for d in distances:
        perm, _ = _tree_round_tables(pods, d, 0, up=True)
        steps = []
        for src_pod, dst_pod in perm:
            for c in range(S):
                steps.extend(_message(member(src_pod, owner[c]), member(dst_pod, owner[c]), c, "reduce", codec))
        if steps:
            rounds.append(tuple(steps))
    for d in reversed(distances):
        perm, _ = _tree_round_tables(pods, d, 0, up=False)
        steps = []
        for src_pod, dst_pod in perm:
            for c in range(S):
                steps.extend(_message(member(src_pod, owner[c]), member(dst_pod, owner[c]), c, "copy"))
        if steps:
            rounds.append(tuple(steps))
    # phase 3: ring all-gather within each pod; round r, member i forwards
    # chunk (i + 1 - r) mod S to member (i + 1) mod S
    for r in range(S - 1):
        steps = []
        for p in range(pods):
            for i in range(S):
                c = (i + 1 - r) % S
                steps.extend(_message(member(p, i), member(p, (i + 1) % S), c, "copy"))
        if steps:
            rounds.append(tuple(steps))
    return ScheduleProgram(
        name=f"two-level-{pods}x{S}", world=world, chunks=max(1, S), rounds=tuple(rounds), wire_dtype=wire_dtype,
    )
