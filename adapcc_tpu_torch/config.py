"""Runtime configuration: the flag contract of the reference launcher.

The port of :mod:`adapcc_tpu.config` (a copy: importing the reference module
would load JAX through its package).  The reference forwards a fixed flag set
to every rank's training script (launcher.py:19-32 → train_ddp.py:60-69):
port, entry_point, strategy_file, logical_graph, parallel_degree,
profile_freq.  ``CommArgs`` carries the same contract and accepts any
argparse-style namespace using those names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from adapcc_tpu_torch.primitives import COORDINATOR_PORT, DEFAULT_CHUNK_BYTES, SKIP_BOOTSTRAP


@dataclass
class CommArgs:
    port: int = COORDINATOR_PORT
    strategy_file: str = "topology/strategy.xml"
    logical_graph: str = "topology/logical_graph.xml"
    entry_point: int = SKIP_BOOTSTRAP
    parallel_degree: int = 1
    profile_freq: int = 0
    #: directory holding the XML/CSV topology artifacts
    topology_dir: str = "topology"
    #: synthesis policy: par-trees | milp | ring | binary | hier (sim-rank
    #: comes with the simulator slice)
    policy: str = "par-trees"
    #: an unmasked allreduce takes the flat one-call path instead of the
    #: tree rounds
    use_xla_fastpath: bool = True
    default_chunk_bytes: int = DEFAULT_CHUNK_BYTES

    @classmethod
    def from_namespace(cls, ns: Any) -> "CommArgs":
        """Build from an argparse namespace using reference flag names;
        unknown fields keep their defaults."""
        kwargs = {}
        for f in cls.__dataclass_fields__:
            if hasattr(ns, f) and getattr(ns, f) is not None:
                kwargs[f] = getattr(ns, f)
        return cls(**kwargs)
