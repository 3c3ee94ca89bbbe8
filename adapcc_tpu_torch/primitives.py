"""Primitives shared by the port: copies of the pieces of
:mod:`adapcc_tpu.primitives` it needs (importing that module would load JAX
through the reference package), and the error every unported option raises."""

from __future__ import annotations

import enum

#: default ring staging granularity in bytes (the reference's 4 MB chunk)
DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024

#: buckets above this many bytes pipeline at ``DEFAULT_CHUNK_BYTES``, smaller
#: ones at a quarter of their size (the reference's chunk heuristic,
#: commu.py:401-403)
CHUNK_HEURISTIC_THRESHOLD = 10 * 1024 * 1024


class ReduceOp(enum.Enum):
    """Reduction operator for reduce-style collectives (the reference's
    sum/avg/max kernels, csrc/trans.cu:10-56)."""

    SUM = "sum"
    AVG = "avg"
    MAX = "max"


def not_ported(what: str, slice_: str) -> NotImplementedError:
    """The error an option of the JAX package raises until its slice lands."""
    return NotImplementedError(f"{what} is not ported yet: it comes with {slice_}")
