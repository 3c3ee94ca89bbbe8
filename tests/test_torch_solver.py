"""The port's MILP strategy solver and ``milp`` policy held against the JAX
package's: the same profiles give the same strategy XML byte for byte (the
routing formulation up to ``ROUTING_MILP_MAX_MASTERS`` masters and the
rotation formulation), the modeled makespan and the per-tree chunks equal to
the float.  Both packages call the same ``scipy.optimize.milp`` (HiGHS) on
the same matrices."""

import numpy as np
import pytest

from adapcc_tpu_torch.primitives import ALLREDUCE, ALLTOALL, BOARDCAST, REDUCE
from adapcc_tpu_torch.strategy import solver
from adapcc_tpu_torch.strategy.synthesizer import Synthesizer
from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml


def _profile(hosts, per_host, seed):
    """A multi-host profile with seeded spread: fast links inside a host,
    slow and uneven ones between (GB/s, seconds)."""
    rng = np.random.default_rng(seed)
    world = hosts * per_host
    same = np.array([[r // per_host == c // per_host for c in range(world)] for r in range(world)])
    bw = np.where(same, 300.0, 20.0 + 30.0 * rng.random((world, world))) * (1 - np.eye(world))
    lat = np.where(same, 3e-6, 1e-5 + 3e-5 * rng.random((world, world))) * (1 - np.eye(world))
    ips = [f"h{r // per_host}" for r in range(world)]
    return ips, bw.tolist(), lat.tolist()


#: (hosts, ranks a host, profile seed, primitive, parallel degree, bytes)
CASES = [(2, 4, 0, ALLREDUCE, 2, 64 << 20), (4, 4, 1, ALLREDUCE, 2, 16 << 20), (4, 2, 2, BOARDCAST, 3, 1 << 20),
         (4, 2, 3, REDUCE, 1, 4096), (3, 2, 4, ALLTOALL, 2, 8 << 20)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-prim{c[3]}-deg{c[4]}")
def test_milp_policy_matches_jax_byte_for_byte(case, tmp_path):
    from adapcc_tpu.strategy import solver as jsolver
    from adapcc_tpu.strategy.synthesizer import Synthesizer as JSynth

    hosts, per_host, seed, prim, degree, nbytes = case
    ips, bw, lat = _profile(hosts, per_host, seed)
    port_xml, jax_xml = tmp_path / "p.xml", tmp_path / "j.xml"
    assert Synthesizer(str(port_xml), ips, "milp").generate_strategy(prim, degree, nbytes, bw, lat) == \
        JSynth(str(jax_xml), ips, "milp").generate_strategy(prim, degree, nbytes, bw, lat)
    assert port_xml.read_bytes() == jax_xml.read_bytes()
    assert b'synthesis="milp-routing"' in port_xml.read_bytes()
    # the rotation formulation (masters past the routing cap) on the same profile
    masters = list(range(0, hosts * per_host, per_host))
    port_s = solver.MilpSolver()._synthesize_rotation(ips, masters, prim, degree, nbytes, bw, lat)
    jax_s = jsolver.MilpSolver()._synthesize_rotation(ips, masters, prim, degree, nbytes, bw, lat)
    from adapcc_tpu.strategy.xml_io import emit_strategy_xml as jemit

    assert emit_strategy_xml(port_s) == jemit(jax_s) and port_s.synthesis == "milp-rotation"
    for s, js in ((port_s, jax_s),):
        assert solver.modeled_makespan(s, masters, prim, nbytes, bw, lat) == \
            jsolver.modeled_makespan(js, masters, prim, nbytes, bw, lat)


def test_solver_helpers_and_constants_equal_jax():
    from adapcc_tpu.strategy import solver as jsolver

    for shares, size in (([0.5, 0.5], 64 << 20), ([0.9, 0.05, 0.05], 1 << 20), ([1.0], 100)):
        assert solver.per_tree_chunk_bytes(shares, size) == jsolver.per_tree_chunk_bytes(shares, size)
    for name in ("ROUTING_MILP_MAX_MASTERS", "ROUTING_MILP_TIME_LIMIT_S", "ROUTING_MILP_ROOT_CANDIDATES",
                 "ROUTING_MILP_PARENT_CANDIDATES", "MILP_SYNTH_BUDGET_S"):
        assert getattr(solver, name) == getattr(jsolver, name), name
    ips, bw, lat = _profile(2, 4, 5)
    # one host: no master edge to route; the rotation model over one master
    s = Synthesizer(None, ["h"] * 4, "milp").synthesize(ALLREDUCE, 2, 4096, [r[:4] for r in bw[:4]],
                                                         [r[:4] for r in lat[:4]])
    assert s.world_size == 4 and s.synthesis == "milp-rotation"
