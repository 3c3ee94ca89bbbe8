"""Primitives shared by the port: copies of the pieces of
:mod:`adapcc_tpu.primitives` it needs (importing that module would load JAX
through the reference package), and the error every unported option raises."""

from __future__ import annotations

import enum

# --- primitive ids (reference trans.h:27-36 / commu.py:28-35) -----------------
ALLREDUCE = 0
REDUCE = 1
BOARDCAST = 2  # reference spelling, kept for API compat
BROADCAST = 2
ALLGATHER = 3
ALLTOALL = 4
REDUCESCATTER = 5
DETECT = 6
PROFILE = 7

#: entry_point value meaning "skip the detect/profile bootstrap entirely"
SKIP_BOOTSTRAP = -1

#: default ring staging granularity in bytes (the reference's 4 MB chunk)
DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024

#: buckets above this many bytes pipeline at ``DEFAULT_CHUNK_BYTES``, smaller
#: ones at a quarter of their size (the reference's chunk heuristic,
#: commu.py:401-403)
CHUNK_HEURISTIC_THRESHOLD = 10 * 1024 * 1024


#: coordinator defaults (reference proto/rpc_server.py:27-46)
RELAY_THRESHOLD_S = 0.1
TIME_SLOT_DURATION_S = 0.005
FAULT_TOLERANT_TIME_S = 10.0
COORDINATOR_PORT = 50051


class ReduceOp(enum.Enum):
    """Reduction operator for reduce-style collectives (the reference's
    sum/avg/max kernels, csrc/trans.cu:10-56)."""

    SUM = "sum"
    AVG = "avg"
    MAX = "max"


def not_ported(what: str, slice_: str) -> NotImplementedError:
    """The error an option of the JAX package raises until its slice lands."""
    return NotImplementedError(f"{what} is not ported yet: it comes with {slice_}")
