"""The reduction operator: a copy of :class:`adapcc_tpu.primitives.ReduceOp`
(importing that module would load JAX through the reference package)."""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    """Reduction operator for reduce-style collectives (the reference's
    sum/avg/max kernels, csrc/trans.cu:10-56)."""

    SUM = "sum"
    AVG = "avg"
    MAX = "max"
