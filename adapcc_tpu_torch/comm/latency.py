"""The latency plane's host half: the algorithm selector's vocabulary and
its support funnel.

The port of the host part of :mod:`adapcc_tpu.comm.latency`.  The plan
tuner's candidate grid consults :func:`latency_algo_unsupported_reason` as
the JAX package's does, so a grid never offers a cell the data plane would
refuse.  The executors themselves (recursive halving/doubling, binomial
trees) come with the latency-plane slice: until then the engine raises on
an ``rd`` or ``tree`` pin and its tuner consults are narrowed to the ring
(``algos=("ring",)``).
"""

from __future__ import annotations

import os
from typing import Optional

#: the selector's vocabulary: ``auto`` = size-adaptive, the rest pin a plane
COLL_ALGOS = ("auto", "ring", "rd", "tree", "ir")

#: env override of the collective algorithm (env > argument > tuner > crossover)
COLL_ALGO_ENV = "ADAPCC_COLL_ALGO"


def resolve_coll_algo(algo: Optional[str] = None) -> Optional[str]:
    """The algorithm in force: ``ADAPCC_COLL_ALGO`` > the argument > None
    (the caller's default).  A malformed value raises."""
    env = os.environ.get(COLL_ALGO_ENV)
    value = env if env is not None and env.strip() else algo
    if value is None:
        return None
    v = str(value).strip().lower()
    if v not in COLL_ALGOS:
        raise ValueError(f"{COLL_ALGO_ENV}/algo={value!r}: expected one of {'|'.join(COLL_ALGOS)}")
    return v


#: primitives with a latency-plane variant and the algorithms each speaks
_LATENCY_PRIMITIVE_ALGOS = {
    "allreduce": ("rd", "tree"),
    "reduce_scatter": ("rd",),
    "all_gather": ("rd",),
}


def latency_algo_unsupported_reason(
    world: int, algo: str, two_level: bool = False, primitive: str = "allreduce",
) -> Optional[str]:
    """Why the latency plane cannot run ``algo`` for ``primitive`` on this
    world, or None when it can: the one funnel the dispatches, the
    selector and the tuner's grid share."""
    if algo not in ("rd", "tree"):
        raise ValueError(f"algo={algo!r} is not a latency-plane algorithm ('rd'|'tree')")
    allowed = _LATENCY_PRIMITIVE_ALGOS.get(primitive)
    if allowed is None:
        return f"primitive {primitive!r} has no latency-plane variant (only {sorted(_LATENCY_PRIMITIVE_ALGOS)})"
    if algo not in allowed:
        return (
            f"{primitive} has no {algo!r} variant: binomial trees are rooted phases only allreduce "
            "composes — reduce_scatter/all_gather speak the recursive halving/doubling ('rd') half"
        )
    if two_level:
        return "two-level (dcn, ici) worlds route through the hierarchical schedule; the latency plane needs a flat ranks mesh"
    if algo == "rd" and world & (world - 1):
        return (
            f"recursive doubling pairs ranks by XOR and needs a power-of-two world, got {world}; the cost "
            "model prices the fold-in, the data plane rejects it"
        )
    return None
