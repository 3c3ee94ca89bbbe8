"""Topology detection: the logical cluster graph of the collective world.

The port of :mod:`adapcc_tpu.topology.detect`.  The reference times NUMA
loopback, PCIe contention and NIC affinity to find its topology
(csrc/detect.cu:70-361); the JAX package reads it off device metadata, and
the port off the world's rank → process map: the host analog of a rank is
its ip-table label (``comm/mesh.py::world_ip_table``) and its nic the owning
process, the counterpart of the JAX package's ``_device_slice``.  The
artifact contract is the reference's: a per-host detected-topology XML
(``topo_detect_<rank>.xml``, detect.cu:367-424) and a merge into the logical
graph XML that drives profiling and synthesis (``_gather_detect_graph``,
commu.py:207-244).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

from adapcc_tpu_torch.strategy.xml_io import (
    LogicalGraph,
    ServerEntry,
    emit_logical_graph_xml,
    parse_logical_graph_xml,
)


def _processes(ip_table: Sequence[str], processes: Optional[Sequence[int]]) -> List[int]:
    if processes is None:
        return [0] * len(ip_table)
    if len(processes) != len(ip_table):
        raise ValueError(f"{len(processes)} process indices for an ip table of {len(ip_table)} ranks")
    return list(processes)


def detect_topology(
    ip_table: Sequence[str],
    processes: Optional[Sequence[int]] = None,
    version: str = "tpu-detected",
) -> LogicalGraph:
    """Logical graph of the world: one server entry per (ip label, owning
    process), ranks in world order.  ``processes`` is the rank → process
    map (None: one process holds every rank)."""
    procs = _processes(ip_table, processes)
    buckets: Dict[tuple, List[int]] = {}
    for rank, ip in enumerate(ip_table):
        buckets.setdefault((ip, procs[rank]), []).append(rank)

    graph = LogicalGraph(version=version)
    ordered = sorted(buckets.items(), key=lambda kv: min(kv[1]))
    for sid, ((ip, proc), ranks) in enumerate(ordered):
        graph.servers.append(ServerEntry(server_id=sid, ip=ip, nic_id=proc, gpus=sorted(ranks)))
    return graph


def dump_detected_topology(
    ip_table: Sequence[str],
    out_dir: str,
    processes: Optional[Sequence[int]] = None,
    process_index: Optional[int] = None,
) -> List[str]:
    """Write per-host detected-topology XML files: every host's shard, or
    only those ``process_index`` owns (the analog of each node's local-rank-0
    dumping ``topo_detect_<rank>.xml``)."""
    os.makedirs(out_dir, exist_ok=True)
    procs = _processes(ip_table, processes)
    graph = detect_topology(ip_table, procs)
    written = []
    for s in graph.servers:
        if process_index is not None and procs[min(s.gpus)] != process_index:
            continue
        shard = LogicalGraph(servers=[s], version=graph.version)
        path = os.path.join(out_dir, f"topo_detect_{min(s.gpus)}.xml")
        emit_logical_graph_xml(shard, path)
        written.append(path)
    return written


def gather_detect_graph(topology_dir: str, out_path: Optional[str] = None) -> LogicalGraph:
    """Merge per-host ``topo_detect_*.xml`` shards into one logical graph
    (analog of the reference's xmltodict merge, commu.py:207-244)."""
    servers: List[ServerEntry] = []
    for path in sorted(glob.glob(os.path.join(topology_dir, "topo_detect_*.xml"))):
        shard = parse_logical_graph_xml(path)
        servers.extend(shard.servers)
    servers.sort(key=lambda s: min(s.gpus) if s.gpus else 0)
    for sid, s in enumerate(servers):
        s.server_id = sid
    graph = LogicalGraph(servers=servers, version="tpu-gathered")
    if out_path:
        emit_logical_graph_xml(graph, out_path)
    return graph
