"""Topology detection, network profiling and the variability monitor (the
port of :mod:`adapcc_tpu.topology`)."""

from adapcc_tpu_torch.topology.detect import detect_topology, dump_detected_topology, gather_detect_graph
from adapcc_tpu_torch.topology.profile import NetworkProfiler, gather_topo_profile
from adapcc_tpu_torch.topology.variability import VariabilityMonitor, detect_drift, load_trace

__all__ = [
    "detect_topology",
    "dump_detected_topology",
    "gather_detect_graph",
    "NetworkProfiler",
    "gather_topo_profile",
    "VariabilityMonitor",
    "detect_drift",
    "load_trace",
]
