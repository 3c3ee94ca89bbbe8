"""The port's two-level plane and hierarchical synthesis held against the
JAX package's.

- The stacked two-level plane (``CollectiveEngine(8, ..., num_slices=k)``)
  against the JAX engine on a ``("dcn", "ici")`` mesh of the 8 CPU devices,
  at 2 × 4 and 4 × 2: allreduce (the projected schedule, merged and not, and
  the composed plan with both leader algorithms), reduce, broadcast,
  all-gather, all-to-all and reduce-scatter, with and without a relay, SUM,
  AVG and MAX.  A payload's first half is integer-valued float32 (any add
  order gives the same sum: bit for bit), its second half random float32
  (XLA's ``psum`` inside a slice adds in its own order: within rtol 1e-5,
  with an absolute floor of 1e-5 for sums that cancel); data movements and
  int32 bit for bit.
- ``slice_tree``'s and the layout's rejections; the two-level pricing equal
  to the float; ``synthesize_two_level``, the ``hier`` policy and the
  ``<trees hier=...>`` artifact byte for byte the JAX package's; the sketch
  env's rejections with JAX's messages; the Communicator's two-level world.
"""

import pathlib

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import two_level
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.sim import cost_model
from adapcc_tpu_torch.strategy import hierarchy
from adapcc_tpu_torch.strategy.ir import Strategy, Tree
from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml, parse_strategy_xml
from adapcc_tpu_torch.utils.observability import CollectiveTrace

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "strategy"
RTOL = ATOL = 1e-5
LAYOUTS = ((2, 4), (4, 2))
RELAY = [0, 1, 2, 4, 5, 6, 7]  # rank 3 a relay


def _jax_mesh(slices, ici):
    import jax

    from adapcc_tpu.comm.two_level import build_two_level_mesh

    return build_two_level_mesh(slices, ici, devices=jax.devices()[:8])


def _profile(slices, ici):
    """A two-level profile: fast links inside a slice, slow between."""
    world = slices * ici
    same = np.array([[r // ici == c // ici for c in range(world)] for r in range(world)])
    bw = np.where(same, 300.0, 25.0) * (1 - np.eye(world))
    lat = np.where(same, 3e-6, 2.5e-5) * (1 - np.eye(world))
    return bw.tolist(), lat.tolist()


def _plans(slices, ici, num_trans=2):
    """The port's and JAX's synthesized plans on one profile."""
    from adapcc_tpu.strategy import hierarchy as jh

    bw, lat = _profile(slices, ici)
    out = []
    for h in (hierarchy, jh):
        sk = h.HierarchySketch(slices, ici)
        out.append(h.synthesize_two_level(sk, h.model_from_graphs(sk, bw, lat), nbytes=1 << 20, num_trans=num_trans))
    return out


def _strategies(slices, ici):
    """Strategy cases by id: (port, JAX, merged on the two-level plane)."""
    from adapcc_tpu.strategy import ir as jir
    from adapcc_tpu.strategy import xml_io as jxml

    pp, jp = _plans(slices, ici)
    cases = {"composed-trees": (Strategy(pp.strategy.trees, 8), jir.Strategy(jp.strategy.trees, 8), True),
             "ring8-one-tree": (Strategy.ring(8), jir.Strategy.ring(8), False)}
    if slices == 2:
        cases["4-4_1xml"] = (parse_strategy_xml(str(FIXTURES / "4-4_1.xml")),
                             jxml.parse_strategy_xml(str(FIXTURES / "4-4_1.xml")), True)
    return cases


def _payload(shape, seed, dtype="float32"):
    """``[8, 2, *shape]``: integer-valued then random float32 (int32: both
    halves integers)."""
    rng = np.random.default_rng(seed)
    x = np.empty((8, 2) + shape, np.float32)
    x[:, 0] = np.round(rng.normal(size=(8,) + shape) * 8) + 0.0  # no -0.0: its sum's sign is order-bound
    x[:, 1] = rng.normal(size=(8,) + shape) * 3
    return np.round(x * 10).astype(np.int32) if dtype == "int32" else x


def _check(got, want, exact_all=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    if exact_all or got.dtype != np.float32:
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        return
    g, w = got.reshape(8, 2, -1), want.reshape(8, 2, -1)
    assert np.array_equal(g[:, 0].view(np.uint8), w[:, 0].view(np.uint8))
    np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=RTOL, atol=ATOL)


def _engines(slices, ici, port_s, jax_s, **kw):
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.utils.observability import CollectiveTrace as JTrace

    return (CollectiveEngine(8, port_s, trace=CollectiveTrace(), num_slices=slices, **kw),
            JEngine(_jax_mesh(slices, ici), jax_s, trace=JTrace(), **kw))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lt: f"{lt[0]}x{lt[1]}")
def test_two_level_plane_matches_jax(layout, monkeypatch):
    import jax.numpy as jnp

    from adapcc_tpu.primitives import ReduceOp as JOp

    slices, ici = layout
    for sid, (port_s, jax_s, merged) in _strategies(slices, ici).items():
        merge_env = "1" if merged else "0"
        monkeypatch.setenv("ADAPCC_MERGE_ROUNDS", merge_env)
        port, ref = _engines(slices, ici, port_s, jax_s, use_xla_fastpath=False)
        cover = [("all_reduce", "float32", "SUM", None), ("all_reduce", "float32", "AVG", RELAY),
                 ("all_reduce", "float32", "MAX", RELAY), ("all_reduce", "int32", "AVG", RELAY),
                 ("reduce", "float32", "AVG", RELAY), ("reduce", "float32", "MAX", None),
                 ("broadcast", "float32", None, None)]
        for i, (prim, dtype, op, active) in enumerate(cover):
            x = _payload((37,), 10 + i, dtype)
            kw = {} if op is None else {"op": getattr(ReduceOp, op)}
            jkw = {} if op is None else {"op": getattr(JOp, op)}
            if prim == "broadcast":
                got, want = port.broadcast(torch.from_numpy(x)), ref.broadcast(jnp.asarray(x))
            else:
                got = getattr(port, prim)(torch.from_numpy(x), active_gpus=active, **kw)
                want = getattr(ref, prim)(jnp.asarray(x), active_gpus=active, **jkw)
            _check(got, want)
            pe = port.trace.events()[-1]
            assert (pe.impl, pe.extra["merged"]) == ("schedule", merged), (sid, prim)
    # the data movements and the scatter (no strategy in them)
    x = _payload((8,), 30)
    _check(port.all_gather(torch.from_numpy(x), RELAY), ref.all_gather(jnp.asarray(x), RELAY), exact_all=True)
    a2a = _payload((8, 5), 31).reshape(8, 8, 2, 5)
    _check(port.all_to_all(torch.from_numpy(a2a), RELAY), ref.all_to_all(jnp.asarray(a2a), RELAY), exact_all=True)
    for op, active in (("SUM", None), ("AVG", RELAY)):
        x = _payload((8,), 32).reshape(8, -1)
        got = port.reduce_scatter(torch.from_numpy(x), active_gpus=active, op=getattr(ReduceOp, op))
        want = np.asarray(ref.reduce_scatter(jnp.asarray(x), active_gpus=active, op=getattr(JOp, op)))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert [e.impl for e in port.trace.events()[-4:]] == ["two_level"] * 4
    with pytest.raises(ValueError, match="ring_allreduce needs a flat ranks mesh"):
        port.ring_allreduce(torch.ones(8, 4))
    with pytest.raises(ValueError, match="two-level"):
        port.all_reduce(torch.ones(8, 4), algo="rd")
    # the unmasked fast path is the flat reduction, under its own label
    port, ref = _engines(slices, ici, Strategy.ring(8), _strategies(slices, ici)["ring8-one-tree"][1])
    x = _payload((37,), 40)
    _check(port.all_reduce(torch.from_numpy(x)), ref.all_reduce(jnp.asarray(x)))
    assert port.trace.events()[-1].impl == "torch_fused" and ref.trace.events()[-1].impl == "xla"


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lt: f"{lt[0]}x{lt[1]}")
def test_composed_plan_matches_jax(layout):
    """The composed plan (RS in the slice, the leaders' allreduce by tree or
    segmented ring, AG in the slice) against JAX's, SUM and AVG with a
    relay; MAX and a ring pin ride the projected schedule."""
    import jax.numpy as jnp

    from adapcc_tpu.primitives import ReduceOp as JOp
    from adapcc_tpu.strategy import hierarchy as jh

    slices, ici = layout
    pp, jp = _plans(slices, ici)
    assert pp.pod_algo == jp.pod_algo == "rs-ag"
    for leader in ("tree", "rs-ag"):
        pv, jv = hierarchy.leader_variant(pp, leader), jh.leader_variant(jp, leader)
        port, ref = _engines(slices, ici, pv.strategy, jv.strategy)
        for i, (op, active) in enumerate((("SUM", None), ("AVG", RELAY))):
            x = _payload((5, 7), 50 + i)  # 140 a rank: padded to the world
            got = port.all_reduce(torch.from_numpy(x), active_gpus=active, op=getattr(ReduceOp, op))
            want = ref.all_reduce(jnp.asarray(x), active_gpus=active, op=getattr(JOp, op))
            _check(got, want)
            pe, je = port.trace.events()[-1], ref.trace.events()[-1]
            assert pe.impl == "two_level[composed]" == je.impl
            assert pe.extra["hier"] == je.extra["hier"] and pe.extra["hier"]["leader_algo"] == leader
            assert pe.extra["algo"] == "two-level"
        port.all_reduce(torch.ones(8, 4), active_gpus=RELAY, op=ReduceOp.MAX)
        port.all_reduce(torch.ones(8, 4), active_gpus=RELAY, algo="ring")
        assert [e.impl for e in port.trace.events()[-2:]] == ["schedule", "schedule"]
    with pytest.raises(ValueError, match="SUM/AVG only"):
        two_level.allreduce_two_level_composed_stacked(torch.ones(8, 2), torch.ones(8, dtype=torch.bool), pp,
                                                       slices, ici, ReduceOp.MAX)


def test_layout_and_slice_tree_rejections_like_jax():
    from adapcc_tpu.comm import two_level as jtl
    from adapcc_tpu.strategy.ir import Tree as JTree

    assert two_level.build_two_level_mesh(2, world_size=8) == two_level.TwoLevelMesh(2, 4)
    assert not two_level.is_two_level(two_level.build_two_level_mesh(1, 4))
    for args, kwargs, match in (((0,), {"world_size": 8}, "num_slices must be >= 1"),
                                ((2, 1), {}, "ici_size must be >= 2"),
                                ((3,), {"world_size": 8}, "do not split into 3 slices"),
                                ((8,), {"world_size": 8}, "ici_size=1")):
        with pytest.raises(ValueError, match=match):
            two_level.build_two_level_mesh(*args, **kwargs)
    with pytest.raises(ValueError, match="do not split"):
        CollectiveEngine(8, Strategy.ring(8), num_slices=3)
    rank_slice = two_level.mesh_rank_slice(2, 4)
    assert rank_slice == jtl.mesh_rank_slice(2, 4)
    # two inbound inter-slice edges; an unreachable slice
    for children in ({0: [1, 4], 1: [2, 3, 5], 4: [6], 6: [7]}, {0: [1, 2, 3]}):
        msgs = []
        for tl, tree_cls in ((two_level, Tree), (jtl, JTree)):
            with pytest.raises(ValueError) as err:
                tl.slice_tree(tree_cls(0, children), rank_slice, 2)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    # the plane's own entry points are the engine's dispatches
    x, mask = torch.from_numpy(_payload((9,), 70)), torch.tensor([r != 3 for r in range(8)])
    eng = CollectiveEngine(8, parse_strategy_xml(str(FIXTURES / "4-4_1.xml")), num_slices=2, use_xla_fastpath=False)
    assert torch.equal(two_level.allreduce_two_level_stacked(x, mask, eng.strategy, 2, 4, ReduceOp.AVG),
                       eng.all_reduce(x, active_gpus=RELAY, op=ReduceOp.AVG))
    assert torch.equal(two_level.reduce_two_level_stacked(x, mask, eng.strategy, 2, 4, ReduceOp.MAX),
                       eng.reduce(x, active_gpus=RELAY, op=ReduceOp.MAX))
    assert torch.equal(two_level.broadcast_two_level_stacked(x, eng.strategy, 2, 4), eng.broadcast(x))
    st = two_level.slice_tree(Strategy.ring(8).trees[0], rank_slice, 2)
    jst = jtl.slice_tree(JTree(0, {r: [r + 1] for r in range(7)}), rank_slice, 2)
    assert (st.root, st.children) == (jst.root, jst.children) == (0, {0: [1]})


def test_two_level_pricing_equals_jax_to_the_float():
    from adapcc_tpu.sim import cost_model as jcm

    grid = [(2, 4), (4, 8), (3, 2), (16, 4), (64, 8)]
    coeffs = [(3e-6, 1 / 300e9, 2.5e-5, 1 / 25e9), (38.861e-6, 1 / 450e9, 38.861e-6, 1 / 50e9), (1e-6, 0.0, 1e-3, 1e-9)]
    for a1, b1, a2, b2 in coeffs:
        pi, pd = cost_model.LinkCoeffs(a1, b1), cost_model.LinkCoeffs(a2, b2)
        ji, jd = jcm.LinkCoeffs(a1, b1), jcm.LinkCoeffs(a2, b2)
        for pods, pod in grid:
            for n in (4, 4096, 1 << 20, 1 << 30):
                for la in cost_model.TWO_LEVEL_LEADER_ALGOS:
                    assert cost_model.two_level_leader_time(pods, n, pd, la) == jcm.two_level_leader_time(pods, n, jd, la)
                    for pa in cost_model.TWO_LEVEL_POD_ALGOS:
                        assert cost_model.two_level_allreduce_time(pods, pod, n, pi, pd, pa, la) == \
                            jcm.two_level_allreduce_time(pods, pod, n, ji, jd, pa, la)
                assert cost_model.choose_two_level(pods, pod, n, pi, pd) == jcm.choose_two_level(pods, pod, n, ji, jd)
            assert cost_model.two_level_crossover_pods(pod, 1 << 20, pi, pd) == \
                jcm.two_level_crossover_pods(pod, 1 << 20, ji, jd)
    assert (cost_model.TWO_LEVEL_POD_ALGOS, cost_model.TWO_LEVEL_LEADER_ALGOS) == (
        hierarchy.POD_ALGOS, hierarchy.LEADER_ALGOS)


def _row(plan):
    """A plan's row without its walltimes."""
    row = plan.to_row()
    row.pop("solve_ms")
    for level in row["levels"]:
        level.pop("solve_ms")
    return row


def test_hier_synthesis_and_artifact_byte_for_byte(tmp_path, monkeypatch):
    """``synthesize_two_level``, the ``hier`` policy and the strategy XML
    with ``<trees hier=...>``: the JAX package's bytes; the XML reattaches
    the plan in both directions."""
    from adapcc_tpu.strategy import hierarchy as jh
    from adapcc_tpu.strategy import xml_io as jxml
    from adapcc_tpu.strategy.synthesizer import Synthesizer as JSynth

    from adapcc_tpu_torch.primitives import ALLREDUCE
    from adapcc_tpu_torch.strategy.synthesizer import Synthesizer

    monkeypatch.delenv(hierarchy.HIER_SKETCH_ENV, raising=False)
    for slices, ici in LAYOUTS + ((4, 4),):
        for num_trans in (1, 2):
            pp, jp = _plans(slices, ici, num_trans)
            assert _row(pp) == _row(jp)
            assert emit_strategy_xml(pp.strategy) == jxml.emit_strategy_xml(jp.strategy)
        ips = [f"slice-{r // ici}" for r in range(slices * ici)]
        bw, lat = _profile(slices, ici)
        port_xml, jax_xml = tmp_path / "p.xml", tmp_path / "j.xml"
        for n in (4096, 64 << 20):
            assert Synthesizer(str(port_xml), ips, "hier").generate_strategy(ALLREDUCE, 2, n, bw, lat) == \
                JSynth(str(jax_xml), ips, "hier").generate_strategy(ALLREDUCE, 2, n, bw, lat)
            assert port_xml.read_bytes() == jax_xml.read_bytes()
            assert b'hier="' in port_xml.read_bytes()
        for parsed, other in ((parse_strategy_xml(str(jax_xml)), jxml.parse_strategy_xml(str(port_xml))),):
            plan, jplan = hierarchy.plan_of(parsed), jh.plan_of(other)
            assert (plan.sketch.num_pods, plan.sketch.pod_size, plan.pod_algo, plan.leader_algo) == (
                jplan.sketch.num_pods, jplan.sketch.pod_size, jplan.pod_algo, jplan.leader_algo)
            assert [t.children for t in plan.leader_strategy.trees] == [t.children for t in jplan.leader_strategy.trees]
            assert emit_strategy_xml(parsed) == jxml.emit_strategy_xml(other)
    rp, rj = _plans(2, 4)
    dcn = cost_model.LinkCoeffs(1e-2, 1e-12)
    from adapcc_tpu.sim import cost_model as jcm
    from adapcc_tpu_torch.sim.cost_model import LinkCostModel

    pm = LinkCostModel(8, classes={cost_model.DCN: dcn, cost_model.ICI: cost_model.LinkCoeffs(1e-6, 1e-12)})
    jm = jcm.LinkCostModel(8, classes={jcm.DCN: jcm.LinkCoeffs(1e-2, 1e-12), jcm.ICI: jcm.LinkCoeffs(1e-6, 1e-12)})
    pr, jr = hierarchy.resolve_leader_level(rp, pm), jh.resolve_leader_level(rj, jm)
    assert (pr.leader_algo, pr.resolved_level, pr.ici_solve is rp.ici_solve) == (jr.leader_algo, "dcn", True)
    assert emit_strategy_xml(pr.strategy) == jxml.emit_strategy_xml(jr.strategy)


def test_sketch_env_and_flat_world_rejections_like_jax(monkeypatch):
    from adapcc_tpu.strategy import hierarchy as jh
    from adapcc_tpu.strategy.synthesizer import Synthesizer as JSynth

    from adapcc_tpu_torch.primitives import ALLREDUCE
    from adapcc_tpu_torch.strategy.synthesizer import Synthesizer

    for raw, world in (("4by8", None), ("0x8", None), ("x", None), ("4x8", 16), ("4x1", None)):
        monkeypatch.setenv(hierarchy.HIER_SKETCH_ENV, raw)
        msgs = []
        for h in (hierarchy, jh):
            with pytest.raises(ValueError) as err:
                h.sketch_from_env(world)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] and hierarchy.HIER_SKETCH_ENV in msgs[0]
    monkeypatch.setenv(hierarchy.HIER_SKETCH_ENV, "1x8")
    assert hierarchy.resolve_sketch(8, ["a"] * 4 + ["b"] * 4) is None
    monkeypatch.setenv(hierarchy.HIER_SKETCH_ENV, "2x4")
    assert hierarchy.resolve_sketch(8) == hierarchy.HierarchySketch(2, 4)
    assert jh.resolve_sketch(8) == jh.HierarchySketch(2, 4)
    monkeypatch.delenv(hierarchy.HIER_SKETCH_ENV)
    for table in (["a", "a", "b", "b", "b", "b"], ["a", "a", "b", "b", "a", "a"], ["a", "b"]):
        msgs = []
        for h in (hierarchy, jh):
            with pytest.raises(ValueError) as err:
                h.HierarchySketch.from_ip_table(table)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    bw = (np.ones((4, 4)) - np.eye(4)).tolist()
    msgs = []
    for synth in (Synthesizer, JSynth):
        with pytest.raises(ValueError) as err:
            synth(None, ["h"] * 4, "hier").synthesize(ALLREDUCE, 1, 0, bw, bw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "multi-pod" in msgs[0]


def test_communicator_two_level_world(tmp_path):
    """``AdapCC.init`` on a 2 × 4 world with ``policy="hier"``: the ip table
    is the slice rows (an existing table is not read, and not overwritten),
    the synthesized strategy carries its plan, and the façade's allreduce
    runs the composed plan against the same call on the JAX package's
    communicator."""
    import jax.numpy as jnp

    from adapcc_tpu.api import AdapCC as JAdapCC
    from adapcc_tpu.config import CommArgs as JArgs
    from adapcc_tpu.primitives import ReduceOp as JOp

    from adapcc_tpu_torch.api import AdapCC
    from adapcc_tpu_torch.config import CommArgs
    from adapcc_tpu_torch.primitives import ALLREDUCE, DETECT

    (tmp_path / "p").mkdir()
    (tmp_path / "p" / "ip_table.txt").write_text("\n".join(f"10.0.0.{r}" for r in range(8)) + "\n")
    args = CommArgs(strategy_file=str(tmp_path / "p" / "s.xml"), logical_graph=str(tmp_path / "p" / "g.xml"),
                    topology_dir=str(tmp_path / "p"), entry_point=DETECT, policy="hier", parallel_degree=2)
    AdapCC.init(args, world_size=8, device="cpu", num_slices=2)
    comm = AdapCC.communicator
    assert comm.ip_table == [f"slice-{r // 4}" for r in range(8)]
    assert (tmp_path / "p" / "ip_table.txt").read_text().split()[0] == "10.0.0.0"
    AdapCC.setup(ALLREDUCE)
    strategy = comm._engine(ALLREDUCE).strategy
    assert strategy.synthesis == "two-level" and hierarchy.plan_of(strategy).sketch.num_pods == 2
    # the same strategy file through the JAX package's communicator
    jargs = JArgs(strategy_file=args.strategy_file, logical_graph=str(tmp_path / "j.xml"),
                  topology_dir=str(tmp_path / "j"), entry_point=-1, parallel_degree=2)
    JAdapCC.init(jargs, mesh=_jax_mesh(2, 4))
    JAdapCC.setup(ALLREDUCE)
    x = _payload((3, 11), 60)
    got = AdapCC.allreduce(torch.from_numpy(x), active_gpus=RELAY, op=ReduceOp.AVG)
    want = JAdapCC.allreduce(jnp.asarray(x), active_gpus=RELAY, op=JOp.AVG)
    _check(got, want)
    AdapCC.clear(ALLREDUCE)
    JAdapCC.clear(ALLREDUCE)
