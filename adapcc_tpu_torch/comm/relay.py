"""Relay-control role algebra: the port of :mod:`adapcc_tpu.comm.relay` (a
copy: importing the reference module would load JAX through its package).

Any subset of ranks can run a collective while the inactive ranks
("relays") stay on the data path as pure forwarders.  The reference's native
controller gates each stage of its chunk pipeline with four booleans per
rank per tree, ``<hasRecv, hasLocal, hasKernel, hasSend>``
(csrc/control.cu:27-87).  Here they are a pure function of (tree, active
set), used two ways:

1. **schedule pruning**: edges whose source subtree holds no active rank
   carry nothing and can be dropped (``getActiveRecvs``, control.cu:89-101);
2. **runtime masking**: the engine keeps every edge and inactive ranks
   contribute the reduction identity instead; the roles are what masking
   must preserve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List

from adapcc_tpu_torch.strategy.ir import CommRound, Tree


@dataclass(frozen=True)
class RelayRole:
    """Per-rank pipeline gates for one tree under one active set."""

    has_recv: bool    # some precedent subtree holds an active rank
    has_local: bool   # this rank's own contribution participates
    has_kernel: bool  # a reduction is needed (vs pure forwarding)
    has_send: bool    # must push (partial) results toward the root


def subtree_active(tree: Tree, rank: int, active: FrozenSet[int]) -> bool:
    return bool(tree.subtree(rank) & active)


def live_ranks(tree: Tree, active: FrozenSet[int]) -> FrozenSet[int]:
    """Ranks whose subtree holds an active rank, in one bottom-up pass."""
    live = set()
    for r in tree._postorder(tree.root):
        if r in active or any(c in live for c in tree.children.get(r, ())):
            live.add(r)
    return frozenset(live)


def active_recvs(tree: Tree, rank: int, active: FrozenSet[int]) -> List[int]:
    """Children whose subtrees still carry live data (control.cu:89-101)."""
    return [c for c in tree.precedents(rank) if subtree_active(tree, c, active)]


def compute_role(tree: Tree, rank: int, active: FrozenSet[int]) -> RelayRole:
    recvs = active_recvs(tree, rank, active)
    has_local = rank in active
    has_recv = bool(recvs)
    # a reduction is needed only where two or more live inputs meet
    has_kernel = has_recv and len(recvs) + (1 if has_local else 0) >= 2
    # nothing live at or below this rank: nothing to send; roots never send
    has_send = rank != tree.root and subtree_active(tree, rank, active)
    return RelayRole(has_recv, has_local, has_kernel, has_send)


def compute_roles(tree: Tree, active: Iterable[int]) -> Dict[int, RelayRole]:
    act = frozenset(active)
    return {r: compute_role(tree, r, act) for r in sorted(tree.ranks)}


# --------------------------------------------------------------------------- #
# schedule pruning
# --------------------------------------------------------------------------- #


def prune_reduce_rounds(tree: Tree, active: Iterable[int]) -> List[CommRound]:
    """Reduce rounds without dead edges: an up-edge ``(c → p)`` carries data
    iff ``subtree(c)`` holds an active rank; relays with live subtrees keep
    forwarding (hasKernel=false, hasSend=true)."""
    live = live_ranks(tree, frozenset(active))
    rounds = []
    for rnd in tree.reduce_rounds():
        kept = tuple((s, d) for s, d in rnd.edges if s in live)
        if kept:
            rounds.append(CommRound(kept))
    return rounds


def prune_broadcast_rounds(tree: Tree, active: Iterable[int]) -> List[CommRound]:
    """Broadcast rounds that deliver the result everywhere it is needed: a
    down-edge is dead only when its destination's subtree holds no active
    rank (relays forward downstream, boardcast.cu:255-305)."""
    live = live_ranks(tree, frozenset(active))
    rounds = []
    for rnd in tree.broadcast_rounds():
        kept = tuple((s, d) for s, d in rnd.edges if d in live)
        if kept:
            rounds.append(CommRound(kept))
    return rounds
