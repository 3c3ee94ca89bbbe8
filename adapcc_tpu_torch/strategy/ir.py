"""Strategy trees: the part of :mod:`adapcc_tpu.strategy.ir` the gradient
hook reads.

A strategy is ``num_trans`` spanning trees of ranks (the reference's
parallel transmissions, strategy/*.xml) plus the rank→ip map of each tree.
The hook needs only the trees' ips (one host group or several), the world
size and the wire codec; the ring engine reads ``chunk_bytes`` as its
default staging granularity.  The round lowering, fingerprints and schedule
programs come with the engine's strategy-tree plane in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.quant.codec import get_codec


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


@dataclass
class Strategy:
    """``num_trans`` parallel spanning trees over ``world_size`` ranks."""

    trees: List[Tree]
    world_size: int
    #: ring staging granularity in bytes (the solver's chunk size; the ring
    #: engine's default when a call names none)
    chunk_bytes: int = DEFAULT_CHUNK_BYTES
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
        # a codec no engine can decode dies here, not at the first collective
        get_codec(self.wire_dtype)

    @staticmethod
    def ring(world_size: int, num_trans: int = 1, ips: Optional[Dict[int, str]] = None) -> "Strategy":
        """Chain strategy: tree t is the chain rooted at rank t (the
        reference's intra-node Chain policy, gurobi/trees.py:85-88)."""
        trees = []
        for t in range(num_trans):
            order = [(t + i) % world_size for i in range(world_size)]
            children = {order[i]: [order[i + 1]] for i in range(world_size - 1)}
            trees.append(Tree(order[0], children, ips))
        return Strategy(trees, world_size)
