"""The port's bootstrap planes held against the JAX package's: topology
detection (ip table, logical graph XML and its per-host shards), the network
profiler's artifacts, and strategy synthesis, whose XML must be the JAX
package's byte for byte on the same profile.

The profiles are timings, so each synthesis runs both synthesizers on one
CSV: the JAX profiler's own on the 8-device CPU mesh, and a hand-written
skewed profile over four two-rank hosts.  The JAX package is imported inside
the functions that use it.
"""

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm.mesh import World, world_ip_table, world_processes
from adapcc_tpu_torch.primitives import ALLREDUCE, DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.strategy import xml_io
from adapcc_tpu_torch.strategy.synthesizer import Synthesizer, _infer_local_rank0s
from adapcc_tpu_torch.topology import detect, profile

#: four hosts of two ranks each, outbound links skewed so that the masters'
#: bandwidth-delay products order them 6, 2, 4, 0
SKEW_IPS = ["10.0.0.1", "10.0.0.1", "10.0.0.2", "10.0.0.2", "10.0.0.3", "10.0.0.3", "10.0.0.4", "10.0.0.4"]
SKEW_MASTER_BW = {0: 5.0, 2: 40.0, 4: 20.0, 6: 80.0}


def _skewed_profile(path):
    """A ``topo_profile`` CSV: intra-host links fast, each master's link to
    the next host as ``SKEW_MASTER_BW``, the rest slow."""
    world = len(SKEW_IPS)
    with open(path, "w") as f:
        for s in range(world):
            for d in range(world):
                if s == d:
                    continue
                if SKEW_IPS[s] == SKEW_IPS[d]:
                    bw, lat = 300.0, 2e-6
                elif s in SKEW_MASTER_BW and d == (s + 2) % world:
                    bw, lat = SKEW_MASTER_BW[s], 1e-5 * (1 + s)
                else:
                    bw, lat = 10.0 + s + 0.5 * d, 3e-5
                f.write(f"{s},{d},lat,{lat:.9f}\n{s},{d},bw,{bw:.6f}\n")


@pytest.fixture(scope="module")
def jax_profile_dir(tmp_path_factory, mesh8):
    """The JAX package's profiler CSV on the 8-device CPU mesh."""
    from adapcc_tpu.topology.profile import NetworkProfiler as JaxProfiler

    out = tmp_path_factory.mktemp("jax_profile")
    JaxProfiler(mesh8).dump(str(out), rank=0)
    return out


def test_ip_table_and_logical_graph_match_jax(mesh4, mesh8, tmp_path):
    from adapcc_tpu.comm.mesh import mesh_ip_table
    from adapcc_tpu.strategy.xml_io import emit_logical_graph_xml as jax_emit_graph
    from adapcc_tpu.topology import detect as jax_detect

    for mesh in (mesh4, mesh8):
        world = mesh.devices.size
        table = world_ip_table(world)
        assert table == mesh_ip_table(mesh)
        port_xml = xml_io.emit_logical_graph_xml(detect.detect_topology(table))
        assert port_xml == jax_emit_graph(jax_detect.detect_topology(mesh))
        # per-host shards, then the merged graph: the same files
        for side, dump in (("port", lambda d: detect.dump_detected_topology(table, d)),
                           ("jax", lambda d: jax_detect.dump_detected_topology(mesh, d))):
            (tmp_path / f"{side}{world}").mkdir()
            dump(str(tmp_path / f"{side}{world}"))
        port_dir, jax_dir = tmp_path / f"port{world}", tmp_path / f"jax{world}"
        assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())
        for p in port_dir.iterdir():
            assert p.read_bytes() == (jax_dir / p.name).read_bytes()
        detect.gather_detect_graph(str(port_dir), str(port_dir / "lg.xml"))
        jax_detect.gather_detect_graph(str(jax_dir), str(jax_dir / "lg.xml"))
        assert (port_dir / "lg.xml").read_bytes() == (jax_dir / "lg.xml").read_bytes()


def test_multi_process_world_labels_each_rank_by_its_process():
    """One process a rank: rank r is "process-r" and its own host, as a
    multi-process JAX mesh of one device a process labels it."""
    world = World(rank=1, world_size=3, device=torch.device("cpu"))
    assert world_processes(3, world) == [0, 1, 2]
    table = world_ip_table(3, world)
    assert table == ["process-0", "process-1", "process-2"]
    graph = detect.detect_topology(table, world_processes(3, world))
    assert [(s.ip, s.nic_id, s.gpus) for s in graph.servers] == [(f"process-{r}", r, [r]) for r in range(3)]
    assert graph.local_rank0_list() == [0, 1, 2] == _infer_local_rank0s(table)
    # one process holding every row owns them all, whatever its group
    assert world_ip_table(3, World(0, 1, torch.device("cpu"))) == ["process-0"] * 3
    with pytest.raises(ValueError, match="one process holds every rank"):
        world_processes(4, world)


def _synth_cases():
    cases = []
    for source in ("jax-profiler", "skewed"):
        for policy, degree in (("par-trees", 1), ("par-trees", 2), ("ring", 2), ("binary", 2)):
            for size in (DEFAULT_CHUNK_BYTES, 1000):
                cases.append((source, policy, degree, size))
    return cases


@pytest.mark.parametrize("source,policy,degree,size", _synth_cases())
def test_synthesized_strategy_xml_is_byte_identical(source, policy, degree, size, tmp_path, jax_profile_dir):
    """The port's Synthesizer on the JAX one's inputs writes the same bytes
    and returns the same chunk size; the logical graph's local-rank-0 list
    and the inferred one both feed it."""
    from adapcc_tpu.strategy.synthesizer import Synthesizer as JaxSynthesizer
    from adapcc_tpu.topology.profile import gather_topo_profile as jax_gather

    if source == "skewed":
        _skewed_profile(tmp_path / "topo_profile_0")
        topo, ips = tmp_path, SKEW_IPS
    else:
        topo, ips = jax_profile_dir, world_ip_table(8)
    lat, bw = profile.gather_topo_profile(str(topo), 8)
    jlat, jbw = jax_gather(str(topo), 8)
    assert np.array_equal(lat, jlat) and np.array_equal(bw, jbw)
    graph_rank0s = detect.detect_topology(ips).local_rank0_list()
    for rank0s in (None, graph_rank0s):
        port_file, jax_file = tmp_path / "port.xml", tmp_path / "jax.xml"
        got = Synthesizer(str(port_file), ips, policy).generate_strategy(ALLREDUCE, degree, size, bw, lat, rank0s)
        want = JaxSynthesizer(str(jax_file), ips, policy).generate_strategy(ALLREDUCE, degree, size, jbw, jlat,
                                                                            rank0s)
        assert got == want
        assert port_file.read_bytes() == jax_file.read_bytes()
    if source == "skewed" and policy == "par-trees":
        roots = [t.root for t in xml_io.parse_strategy_xml(str(port_file)).trees]
        assert roots == [6, 2][:degree]  # best-provisioned master first, then rotated


def test_strategy_xml_crosses_between_the_parsers(tmp_path):
    """JAX's parser reads the port's synthesized XML and the port's reads
    JAX's: the same trees, chunk and provenance."""
    from adapcc_tpu.strategy.synthesizer import Synthesizer as JaxSynthesizer
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jax_parse

    _skewed_profile(tmp_path / "topo_profile_0")
    lat, bw = profile.gather_topo_profile(str(tmp_path), 8)
    Synthesizer(str(tmp_path / "port.xml"), SKEW_IPS).generate_strategy(ALLREDUCE, 2, 4096, bw, lat)
    JaxSynthesizer(str(tmp_path / "jax.xml"), SKEW_IPS).generate_strategy(ALLREDUCE, 2, 4096, bw, lat)
    for port, ref in ((xml_io.parse_strategy_xml(str(tmp_path / "jax.xml")), jax_parse(str(tmp_path / "port.xml"))),
                      (xml_io.parse_strategy_xml(str(tmp_path / "port.xml")), jax_parse(str(tmp_path / "jax.xml")))):
        assert (port.world_size, port.chunk_bytes, port.synthesis, port.num_trans) == (
            ref.world_size, ref.chunk_bytes, ref.synthesis, ref.num_trans) == (8, 4096, "partrees", 2)
        for t, r in zip(port.trees, ref.trees, strict=True):
            assert (t.root, t.children, t.ips) == (r.root, r.children, r.ips)


def test_synthesizer_policies_that_wait_raise():
    ips = world_ip_table(4)
    bw = np.ones((4, 4)) - np.eye(4)
    # sim-rank runs now (tests/test_torch_sim.py holds its XML against JAX's)
    assert Synthesizer(None, ips, "sim-rank").synthesize(ALLREDUCE, 1, 0, bw, bw).synthesis.endswith("+sim-rank")
    # milp and hier run now (tests/test_torch_solver.py,
    # tests/test_torch_two_level.py); hier refuses a one-host world
    with pytest.raises(ValueError, match="needs a multi-pod hierarchy"):
        Synthesizer(None, ips, "hier").generate_strategy(ALLREDUCE, 1, 0, bw, bw)
    with pytest.raises(ValueError, match="unknown synthesis policy"):
        Synthesizer(None, ips, "rings").generate_strategy(ALLREDUCE, 1, 0, bw, bw)


def test_profiler_probe_matrices_and_csv(tmp_path):
    """The offset-o probe moves row r to row (r + o) % world; the matrices
    cover every off-diagonal pair; the CSV is the JAX package's format, read
    back alike by both gatherers."""
    from adapcc_tpu.topology.profile import LATENCY_PROBE_FLOATS as JAX_LAT_FLOATS
    from adapcc_tpu.topology.profile import BANDWIDTH_PROBE_FLOATS as JAX_BW_FLOATS
    from adapcc_tpu.topology.profile import bandwidth_gbps as jax_bandwidth_gbps
    from adapcc_tpu.topology.profile import gather_topo_profile as jax_gather

    assert (profile.LATENCY_PROBE_FLOATS, profile.BANDWIDTH_PROBE_FLOATS) == (JAX_LAT_FLOATS, JAX_BW_FLOATS)
    for nbytes, seconds in ((4 << 20, 1e-3), (256, 0.0), (1, 3.3e-7)):
        assert profile.bandwidth_gbps(nbytes, seconds) == jax_bandwidth_gbps(nbytes, seconds)
    prof = profile.NetworkProfiler(5, device="cpu", iters=1)
    for offset in range(1, 6):
        shift, x = prof._offset_shift_fn(offset, 3)
        x.copy_(torch.arange(15, dtype=torch.float32).reshape(5, 3))
        moved = shift()
        for r in range(5):
            assert torch.equal(moved[(r + offset) % 5], x[r])
    lat, bw = prof.profile()
    off = ~np.eye(5, dtype=bool)
    assert (lat[off] > 0).all() and (bw[off] > 0).all()
    assert not lat[~off].any() and not bw[~off].any()
    path = prof.dump(str(tmp_path), rank=0)
    rows = open(path).read().splitlines()
    assert len(rows) == 2 * 5 * 4 and all(len(r.split(",")) == 4 for r in rows)
    got, want = profile.gather_topo_profile(str(tmp_path), 5), jax_gather(str(tmp_path), 5)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert profile.NetworkProfiler(1, device="cpu").profile()[1].shape == (1, 1)
