"""Strategy trees and their lowering to communication rounds: the port of
:mod:`adapcc_tpu.strategy.ir` (a copy: importing the reference module would
load JAX through its package).

A strategy is ``num_trans`` spanning trees of ranks (the reference's
parallel transmissions, strategy/*.xml) plus the rank→ip map of each tree.
Each tree lowers to a static list of **communication rounds**, every round a
partial permutation (distinct sources, distinct destinations): the reduction
up the tree and the broadcast down it.  The engine's schedule plane runs one
round as a gather of the sources' rows and a combine into the destinations'
rows (stacked), or as one ``batch_isend_irecv`` (per rank).

:meth:`Strategy.schedule_program` gives the strategy as a chunk-granular
:class:`~adapcc_tpu_torch.compiler.ir.ScheduleProgram`, the form the
engine's ``algo="ir"`` runs.  Not ported: the native lowering of pod-scale
trees (the pure-Python lowering gives the same rounds).
"""

from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.quant.codec import get_codec


@dataclass(frozen=True)
class CommRound:
    """One communication round: ``edges`` are ``(src, dst)`` pairs with all
    sources distinct and all destinations distinct."""

    edges: Tuple[Tuple[int, int], ...]

    def __post_init__(self) -> None:
        srcs = [s for s, _ in self.edges]
        dsts = [d for _, d in self.edges]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"round is not a partial permutation: {self.edges}")

    @property
    def sources(self) -> Tuple[int, ...]:
        return tuple(s for s, _ in self.edges)

    @property
    def destinations(self) -> Tuple[int, ...]:
        return tuple(d for _, d in self.edges)


class Tree:
    """One spanning tree of ranks: parent/children maps and rank→ip."""

    def __init__(
        self,
        root: int,
        children: Dict[int, List[int]],
        ips: Optional[Dict[int, str]] = None,
    ) -> None:
        self.root = root
        self.children: Dict[int, List[int]] = {r: list(c) for r, c in children.items()}
        self.ips: Dict[int, str] = dict(ips or {})
        self.parent: Dict[int, int] = {}
        for p, cs in self.children.items():
            for c in cs:
                if c in self.parent:
                    raise ValueError(f"rank {c} has two parents in tree rooted at {root}")
                self.parent[c] = p
        seen = set()
        stack = [root]
        while stack:
            r = stack.pop()
            if r in seen:
                raise ValueError(f"cycle through rank {r} in tree rooted at {root}")
            seen.add(r)
            stack.extend(self.children.get(r, ()))
        dangling = set(self.parent) - seen
        if dangling:
            raise ValueError(f"ranks {sorted(dangling)} unreachable from root {root}")
        self.ranks = frozenset(seen)
        self._reduce_rounds: Optional[List[CommRound]] = None
        self._broadcast_rounds: Optional[List[CommRound]] = None

    # -- structure queries -----------------------------------------------------

    def precedents(self, rank: int) -> List[int]:
        """Children of ``rank``: who sends to it during reduce."""
        return list(self.children.get(rank, ()))

    def subsequent(self, rank: int) -> Optional[int]:
        """Parent of ``rank``: where it sends during reduce; None at the root."""
        return self.parent.get(rank)

    def sibling_index(self, rank: int) -> int:
        """Position among the parent's children (the reference's siblingIdx)."""
        p = self.parent.get(rank)
        return 0 if p is None else self.children[p].index(rank)

    def subtree(self, rank: int) -> frozenset:
        out = set()
        stack = [rank]
        while stack:
            r = stack.pop()
            out.add(r)
            stack.extend(self.children.get(r, ()))
        return frozenset(out)

    def height(self, rank: int) -> int:
        heights: Dict[int, int] = {}
        for r in self._postorder(rank):
            heights[r] = 1 + max((heights[c] for c in self.children.get(r, ())), default=-1)
        return heights[rank]

    def depth(self, rank: int) -> int:
        d = 0
        while rank != self.root:
            rank = self.parent[rank]
            d += 1
        return d

    def is_cross_host(self, src: int, dst: int) -> bool:
        """Whether an edge crosses hosts (its two ranks' ips differ)."""
        return self.ips.get(src) != self.ips.get(dst)

    def _postorder(self, start: int) -> List[int]:
        """Iterative post-order (children before parent) from ``start``."""
        order: List[int] = []
        stack: List[Tuple[int, bool]] = [(start, False)]
        while stack:
            r, done = stack.pop()
            if done:
                order.append(r)
                continue
            stack.append((r, True))
            for c in reversed(self.children.get(r, ())):
                stack.append((c, False))
        return order

    # -- lowering to rounds ----------------------------------------------------

    def reduce_rounds(self) -> List[CommRound]:
        """Rounds of child→parent sends: a rank sends to its parent only
        after all its children have sent to it; siblings sending to one
        parent are staggered across rounds."""
        if self._reduce_rounds is None:
            edges = [(r, self.parent[r]) for r in self._postorder(self.root) if r != self.root]
            self._reduce_rounds = _pack_rounds(edges)
        return list(self._reduce_rounds)

    def broadcast_rounds(self) -> List[CommRound]:
        """Rounds of parent→child sends: a rank forwards only after it has
        received from its own parent."""
        if self._broadcast_rounds is None:
            order: List[int] = []
            queue = deque([self.root])
            while queue:
                r = queue.popleft()
                if r != self.root:
                    order.append(r)
                queue.extend(self.children.get(r, ()))
            self._broadcast_rounds = _pack_rounds([(self.parent[r], r) for r in order])
        return list(self._broadcast_rounds)

    def __repr__(self) -> str:
        return f"Tree(root={self.root}, ranks={sorted(self.ranks)})"


def _pack_rounds(edges: Sequence[Tuple[int, int]]) -> List[CommRound]:
    """Greedy pack dependency-ordered edges into partial-permutation rounds:
    edge ``(s, d)`` goes to the earliest round after every packed edge into
    ``s`` in which neither ``s`` sends nor ``d`` receives."""
    rounds: List[List[Tuple[int, int]]] = []
    round_srcs: List[set] = []
    round_dsts: List[set] = []
    landed: Dict[int, int] = {}  # dst -> last round in which it received
    for s, d in edges:
        r = landed[s] + 1 if s in landed else 0
        while r < len(rounds) and (s in round_srcs[r] or d in round_dsts[r]):
            r += 1
        while r >= len(rounds):
            rounds.append([])
            round_srcs.append(set())
            round_dsts.append(set())
        rounds[r].append((s, d))
        round_srcs[r].add(s)
        round_dsts[r].add(d)
        landed[d] = max(landed.get(d, -1), r)
    return [CommRound(tuple(es)) for es in rounds]


#: (fingerprint, wire_dtype, synthesis, name) -> the strategy's program
_PROGRAM_CACHE: Dict[tuple, object] = {}


@dataclass
class Strategy:
    """``num_trans`` parallel spanning trees over ``world_size`` ranks; the
    payload is split across the trees by ``shares`` (equal when None)."""

    trees: List[Tree]
    world_size: int
    #: staging granularity in bytes (the solver's chunk size; the ring
    #: engine's default when a call names none)
    chunk_bytes: int = DEFAULT_CHUNK_BYTES
    #: fraction of the payload each tree carries (the MILP solver's s_m);
    #: None = equal split
    shares: Optional[List[float]] = None
    #: per-tree chunk granularity in bytes (the solver's c_m); None = every
    #: tree at ``chunk_bytes``
    tree_chunk_bytes: Optional[List[int]] = None
    #: which formulation produced this strategy ("ring", "binary", ...)
    synthesis: Optional[str] = None
    #: wire codec of the data plane: a name in the codec registry
    #: (quant/codec.py; "off" ships the payload dtype)
    wire_dtype: str = "off"

    def __post_init__(self) -> None:
        if not self.trees:
            raise ValueError("strategy needs at least one tree")
        for t in self.trees:
            missing = set(range(self.world_size)) - t.ranks
            if missing:
                raise ValueError(f"tree rooted at {t.root} is missing ranks {sorted(missing)}")
        if self.shares is not None:
            if len(self.shares) != len(self.trees):
                raise ValueError("shares must have one entry per tree")
            total = sum(self.shares)
            if total <= 0:
                raise ValueError("shares must sum to a positive value")
            self.shares = [s / total for s in self.shares]
        if self.tree_chunk_bytes is not None:
            if len(self.tree_chunk_bytes) != len(self.trees):
                raise ValueError("tree_chunk_bytes must have one entry per tree")
            bad = [c for c in self.tree_chunk_bytes if c <= 0]
            if bad:
                raise ValueError(f"tree_chunk_bytes must be positive, got {bad}")
        # a codec no engine can decode dies here, not at the first collective
        get_codec(self.wire_dtype)

    def chunk_bytes_for_tree(self, index: int) -> int:
        """Tree ``index``'s chunk granularity: its own when set, else the
        strategy's."""
        if self.tree_chunk_bytes is not None:
            return self.tree_chunk_bytes[index]
        return self.chunk_bytes

    def tree_shares(self) -> List[float]:
        if self.shares is not None:
            return list(self.shares)
        return [1.0 / len(self.trees)] * len(self.trees)

    @property
    def num_trans(self) -> int:
        return len(self.trees)

    def fingerprint(self) -> str:
        """Stable hash of the tree structure (memoized: trees do not change
        after construction)."""
        cached = self.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        h = hashlib.sha256()
        h.update(str(self.world_size).encode())
        for t in self.trees:
            h.update(repr(sorted((p, tuple(c)) for p, c in t.children.items())).encode())
            h.update(str(t.root).encode())
        self.__dict__["_fingerprint"] = fp = h.hexdigest()[:16]
        return fp

    def schedule_program(self, name: Optional[str] = None):
        """This strategy as a ``compiler.ScheduleProgram``: chunk ``t`` is
        tree ``t``'s segment, reduce rounds aligned by index across trees,
        then the broadcast rounds (``compiler.program_from_strategy``).

        Memoized per (structural fingerprint, wire_dtype, synthesis, name),
        so repeated ``algo="ir"`` dispatches reuse one program object;
        whether this call hit the memo is left on
        ``_last_program_cache_hit`` for the engine's trace."""
        from adapcc_tpu_torch.compiler.builders import program_from_strategy

        # synthesis is in the key: the derived name spells it
        key = (self.fingerprint(), self.wire_dtype, self.synthesis, name)
        program = _PROGRAM_CACHE.get(key)
        self.__dict__["_last_program_cache_hit"] = program is not None
        if program is None:
            program = program_from_strategy(self, name=name)
            _PROGRAM_CACHE[key] = program
        return program

    @staticmethod
    def ring(world_size: int, num_trans: int = 1, ips: Optional[Dict[int, str]] = None) -> "Strategy":
        """Chain strategy: tree t is the chain rooted at rank t (the
        reference's intra-node Chain policy, gurobi/trees.py:85-88)."""
        trees = []
        for t in range(num_trans):
            order = [(t + i) % world_size for i in range(world_size)]
            children = {order[i]: [order[i + 1]] for i in range(world_size - 1)}
            trees.append(Tree(order[0], children, ips))
        return Strategy(trees, world_size, synthesis="ring")

    @staticmethod
    def binary(world_size: int, num_trans: int = 1, ips: Optional[Dict[int, str]] = None) -> "Strategy":
        """Array-heap binary trees rotated per transmission for root
        diversity (gurobi/trees.py:110-139)."""
        trees = []
        for t in range(num_trans):
            order = [(t + i) % world_size for i in range(world_size)]
            children: Dict[int, List[int]] = {}
            for i in range(world_size):
                kids = [order[j] for j in (2 * i + 1, 2 * i + 2) if j < world_size]
                if kids:
                    children[order[i]] = kids
            trees.append(Tree(order[0], children, ips))
        return Strategy(trees, world_size, synthesis="binary")
