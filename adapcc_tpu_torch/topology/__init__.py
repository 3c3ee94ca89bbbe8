"""Topology detection and network profiling (the port of
:mod:`adapcc_tpu.topology`; the variability monitor comes with the
adaptation slice)."""

from adapcc_tpu_torch.topology.detect import detect_topology, dump_detected_topology, gather_detect_graph
from adapcc_tpu_torch.topology.profile import NetworkProfiler, gather_topo_profile

__all__ = [
    "detect_topology",
    "dump_detected_topology",
    "gather_detect_graph",
    "NetworkProfiler",
    "gather_topo_profile",
]
