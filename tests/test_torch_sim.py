"""The port's collective simulator held against the JAX package's.

Every float is compared with ``==``: the port copies the order of every sum
and every ``max``, so the event replay, its vectorized twin, the program
replay, the lower bounds, the failover terms, the rankings and the fault-plan
rows are JAX's to the bit.  Both packages get the same explicit cost model
(the port's defaults are the H100's and differ on purpose); where a default
is read inside a function (the codec rate of the ``sim-rank`` codec choice)
the port's constant is set to JAX's with ``monkeypatch``.  The grid of
strategies × collectives × masks is covered, not multiplied: each strategy
runs every collective, unmasked and with a relay.
"""

import numpy as np
import pytest

from adapcc_tpu_torch import sim
from adapcc_tpu_torch.compiler import builders
from adapcc_tpu_torch.compiler.synthesize import pipelined_allreduce_program
from adapcc_tpu_torch.elastic import FaultEvent, FaultPlan
from adapcc_tpu_torch.primitives import ALLREDUCE, BROADCAST, REDUCE
from adapcc_tpu_torch.sim import cost_model as cm
from adapcc_tpu_torch.strategy import hierarchy
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.strategy.synthesizer import Synthesizer
from adapcc_tpu_torch.strategy.xml_io import parse_strategy_xml

XML = "tests/fixtures/strategy/4-4_1.xml"
IPS8 = {r: f"h{r // 4}" for r in range(8)}
#: a heterogeneous explicit model: NVLink-like and NIC-like classes, one
#: per-link fit, then rank 5 degraded 3x
ICI_AB = (2e-6, 1.0 / 200e9)
DCN_AB = (9e-6, 1.0 / 25e9)
LINK_AB = ((1, 2), (3e-6, 1.0 / 150e9))
NBYTES = 3 * (1 << 20) + 12345
RELAY = [0, 1, 2, 4, 6, 7]


def _models():
    """The same explicit model in both packages: (port, jax)."""
    from adapcc_tpu.sim import cost_model as jcm

    out = []
    for mod in (cm, jcm):
        m = mod.LinkCostModel(
            8, links={LINK_AB[0]: mod.LinkCoeffs(*LINK_AB[1])},
            classes={mod.ICI: mod.LinkCoeffs(*ICI_AB), mod.DCN: mod.LinkCoeffs(*DCN_AB)}, ips=IPS8,
            source="test")
        out.append(m.degraded([5], 3.0))
    return out


def _strategies(name):
    """(port, jax) strategies of one grid entry."""
    from adapcc_tpu.strategy import hierarchy as jh
    from adapcc_tpu.strategy.ir import Strategy as JStrategy
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jparse

    if name == "ring":
        return Strategy.ring(8, 2, IPS8), JStrategy.ring(8, 2, IPS8)
    if name == "binary":
        return Strategy.binary(8, 2, IPS8), JStrategy.binary(8, 2, IPS8)
    if name == "xml":
        return parse_strategy_xml(XML), jparse(XML)
    return (hierarchy.synthesize_two_level(hierarchy.HierarchySketch(2, 4), nbytes=1 << 20, num_trans=2).strategy,
            jh.synthesize_two_level(jh.HierarchySketch(2, 4), nbytes=1 << 20, num_trans=2).strategy)


@pytest.mark.parametrize("name", ["ring", "binary", "xml", "two-level"])
def test_replay_event_and_vector_match_jax(name):
    """Makespans, per-link and per-class busy time, and the transfer log of
    the event replay; the vector replay's makespan equal to the event
    replay's, in both packages."""
    from adapcc_tpu.sim import replay as jreplay

    port_s, jax_s = _strategies(name)
    assert port_s.fingerprint() == jax_s.fingerprint()
    pm, jm = _models()
    for collective in ("allreduce", "reduce", "broadcast"):
        for active in (None, RELAY):
            p = sim.simulate_strategy(port_s, pm, NBYTES, collective, active=active, engine="event")
            j = jreplay.simulate_strategy(jax_s, jm, NBYTES, collective, active=active, engine="event")
            case = f"{name} {collective} active={active}"
            assert p.seconds == j.seconds > 0, case
            assert p.report.link_busy == j.report.link_busy, case
            assert p.report.class_busy == j.report.class_busy, case
            assert [tuple(vars(t).values()) for t in p.report.transfers] == \
                [tuple(vars(t).values()) for t in j.report.transfers], case
            assert p.to_row() == j.to_row(), case
            pv = sim.simulate_strategy(port_s, pm, NBYTES, collective, active=active, engine="vector",
                                       keep_links=True)
            jv = jreplay.simulate_strategy(jax_s, jm, NBYTES, collective, active=active, engine="vector",
                                           keep_links=True)
            assert pv.seconds == jv.seconds == p.seconds, case
            assert pv.report.link_busy == jv.report.link_busy and pv.report.class_busy == jv.report.class_busy, case


def test_simulate_program_matches_jax():
    """``simulate_program`` on the IR builders: event and vector, a
    heterogeneous model and a uniform one, where it equals
    ``schedule_program_time``."""
    from adapcc_tpu.compiler import builders as jb
    from adapcc_tpu.compiler.synthesize import pipelined_allreduce_program as jpipe
    from adapcc_tpu.sim import replay as jreplay
    from adapcc_tpu.sim.cost_model import LinkCostModel as JModel

    pm, jm = _models()
    pairs = [(builders.ring_allreduce_program(8), jb.ring_allreduce_program(8)),
             (builders.rd_allreduce_program(8), jb.rd_allreduce_program(8)),
             (builders.tree_allreduce_program(8, wire_dtype="int8"), jb.tree_allreduce_program(8, wire_dtype="int8")),
             (builders.two_level_allreduce_program(2, 4), jb.two_level_allreduce_program(2, 4)),
             (pipelined_allreduce_program(8), jpipe(8))]
    for port_p, jax_p in pairs:
        assert port_p.fingerprint() == jax_p.fingerprint()
        for engine in ("event", "vector"):
            p = sim.simulate_program(port_p, pm, NBYTES, engine=engine)
            j = jreplay.simulate_program(jax_p, jm, NBYTES, engine=engine)
            assert (p.seconds, p.strategy_label, p.collective) == (j.seconds, j.strategy_label, j.collective) != 0
            assert p.report.link_busy == j.report.link_busy, (port_p.name, engine)
        flat = cm.LinkCostModel.uniform(8, *ICI_AB)
        assert sim.simulate_program(port_p, flat, NBYTES).seconds == jreplay.simulate_program(
            jax_p, JModel.uniform(8, *ICI_AB), NBYTES).seconds == cm.schedule_program_time(
            port_p, NBYTES, cm.LinkCoeffs(*ICI_AB))


def test_lower_bounds_and_failover_terms_match_jax(monkeypatch):
    from adapcc_tpu.sim import cost_model as jcm

    # a codec's failover terms read the codec rate: JAX's for the comparison
    monkeypatch.setattr(cm, "DEFAULT_CODEC_BYTES_PER_S", jcm.DEFAULT_CODEC_BYTES_PER_S)
    pm, jm = _models()
    for collective in ("allreduce", "reduce", "broadcast"):
        for world in (None, 1, 5):
            for fn in ("latency_lower_bound",):
                assert getattr(cm, fn)(pm, collective, world) == getattr(jcm, fn)(jm, collective, world)
            for fn in ("bandwidth_lower_bound", "collective_lower_bound"):
                assert getattr(cm, fn)(pm, NBYTES, collective, world) == getattr(jcm, fn)(jm, NBYTES, collective,
                                                                                         world)
    assert cm.fastest_coeffs(pm) == cm.LinkCoeffs(*vars(jcm.fastest_coeffs(jm)).values())
    assert cm.optimality_gap(3.0, 2.0) == jcm.optimality_gap(3.0, 2.0) and cm.optimality_gap(1.0, 0.0) == 0.0
    coeffs, jcoeffs = cm.LinkCoeffs(*DCN_AB), jcm.LinkCoeffs(*DCN_AB)
    assert cm.detection_latency_s(0.7, 0.3) == jcm.detection_latency_s(0.7, 0.3)
    assert cm.supervised_detection_latency_s(0.5, 1.0, 3, 0.25) == jcm.supervised_detection_latency_s(0.5, 1.0, 3, 0.25)
    for cached in (True, False):
        assert cm.plan_swap_stall_s(cached) == jcm.plan_swap_stall_s(cached)
        for kw in ({}, {"slowdown": 4.0, "n_down": 2, "wire_dtype": "bf16"}):
            assert cm.failover_cost(8, NBYTES, coeffs, standby_cached=cached, step_time_s=0.1, **kw) == \
                jcm.failover_cost(8, NBYTES, jcoeffs, standby_cached=cached, step_time_s=0.1, **kw)
    assert cm.full_rebuild_stall_s(8, coeffs) == jcm.full_rebuild_stall_s(8, jcoeffs)
    for bad in (lambda m: m.latency_lower_bound(pm if m is cm else jm, "gather"),
                lambda m: m.failover_cost(8, 1, coeffs if m is cm else jcoeffs, n_down=8),
                lambda m: m.supervised_detection_latency_s(0.5, 1.0, 0)):
        with pytest.raises(ValueError) as pe:
            bad(cm)
        with pytest.raises(ValueError) as je:
            bad(jcm)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="slowdown"):
        pm.degraded([1], 0.5)


def test_choose_wire_dtype_matches_jax(monkeypatch):
    """The codec choice on JAX's codec rate (the port's default is the
    card's, read at call time): every codec's time and the winner."""
    from adapcc_tpu.sim import cost_model as jcm

    monkeypatch.setattr(cm, "DEFAULT_CODEC_BYTES_PER_S", jcm.DEFAULT_CODEC_BYTES_PER_S)
    for ab in (ICI_AB, DCN_AB, (5e-6, 1.0 / 2e9)):
        for nbytes in (4096, NBYTES, 1 << 28):
            assert cm.choose_wire_dtype(8, nbytes, cm.LinkCoeffs(*ab)) == jcm.choose_wire_dtype(
                8, nbytes, jcm.LinkCoeffs(*ab))
    assert cm.choose_wire_dtype(8, 1 << 28, cm.LinkCoeffs(5e-6, 1.0 / 2e9))[0] == "int8"


def test_rank_relay_and_degradation_match_jax():
    from adapcc_tpu.sim import rank as jrank

    pm, jm = _models()
    pairs = [_strategies(n) for n in ("ring", "binary", "xml")]
    for active in (None, RELAY):
        p = sim.rank_candidates([(f"c{i}", s) for i, (s, _) in enumerate(pairs)], pm, NBYTES, active=active)
        j = jrank.rank_candidates([(f"c{i}", s) for i, (_, s) in enumerate(pairs)], jm, NBYTES, active=active)
        assert [(c.label, c.seconds, c.lower_bound_s, c.optimality_gap, c.to_row()) for c in p] == \
            [(c.label, c.seconds, c.lower_bound_s, c.optimality_gap, c.to_row()) for c in j]
    # a bare Strategy is labeled by its synthesis; ties keep input order
    tie = sim.rank_candidates([pairs[0][0], pairs[0][0]], pm, NBYTES)
    assert [c.label for c in tie] == [c.label for c in jrank.rank_candidates([pairs[0][1]] * 2, jm, NBYTES)]
    port_s, jax_s = pairs[2]
    assert sim.relay_latency(port_s, pm, NBYTES, RELAY, "reduce") == jrank.relay_latency(jax_s, jm, NBYTES, RELAY,
                                                                                        "reduce")
    p, j = (sim.predict_degradation(port_s, pm, NBYTES, [3, 6], 2.5),
            jrank.predict_degradation(jax_s, jm, NBYTES, [3, 6], 2.5))
    assert vars(p) == vars(j) and (p.ratio, p.relay_gain) == (j.ratio, j.relay_gain)
    with pytest.raises(ValueError, match="at least one candidate"):
        sim.rank_candidates([], pm, NBYTES)


def test_simulate_fault_plan_rows_match_jax():
    from adapcc_tpu.elastic import FaultEvent as JEvent
    from adapcc_tpu.elastic import FaultPlan as JPlan
    from adapcc_tpu.sim import replay as jreplay

    events = [(0, "slow", 3, 4.0), (2, "down", 6, 4.0), (5, "recover", 6, 4.0), (6, "down", 1, 4.0),
              (7, "slow", 2, 1.5)]
    plan = FaultPlan([FaultEvent(*e) for e in events], world=8)
    jplan = JPlan([JEvent(*e) for e in events], world=8)
    pm, jm = _models()
    (port_s, jax_s) = _strategies("xml")
    for kw in ({}, {"steps": 10, "collective": "reduce", "standby_cached": False, "heartbeat_timeout_s": 0.25}):
        p = sim.simulate_fault_plan(port_s, pm, NBYTES, plan, **kw)
        j = jreplay.simulate_fault_plan(jax_s, jm, NBYTES, jplan, **kw)
        assert [vars(r) for r in p] == [vars(r) for r in j]
        assert [r.to_row() for r in p] == [r.to_row() for r in j]
    assert [r.step for r in p if r.swapped] == [0, 2, 5, 6, 7]
    with pytest.raises(ValueError, match="fault plan world 8 != strategy world 4"):
        sim.simulate_fault_plan(Strategy.ring(4), pm, NBYTES, plan)


def test_sim_rank_xml_matches_jax_byte_for_byte(tmp_path, monkeypatch):
    """The ``sim-rank`` policy on one two-host profile: the emitted strategy
    XML (shape, ``synthesis`` label, ``wire_dtype``) is JAX's byte for
    byte, for an allreduce on a fast fabric, one on a slow inter-host
    link (int8 wins) and a broadcast."""
    from adapcc_tpu.sim import cost_model as jcm
    from adapcc_tpu.strategy.synthesizer import Synthesizer as JSynth

    monkeypatch.setattr(cm, "DEFAULT_CODEC_BYTES_PER_S", jcm.DEFAULT_CODEC_BYTES_PER_S)
    ips = [IPS8[r] for r in range(8)]
    rng = np.random.default_rng(5)
    same = np.equal.outer(np.arange(8) // 4, np.arange(8) // 4)
    lat = np.where(same, 3e-6, 2e-5) * rng.uniform(0.9, 1.1, (8, 8))
    codecs = []
    for prim, dcn_gbps, size in ((ALLREDUCE, 40.0, 1 << 22), (ALLREDUCE, 0.5, 1 << 26), (BROADCAST, 40.0, 1 << 20),
                                 (REDUCE, 0.5, 0)):
        bw = np.where(same, 180.0, dcn_gbps) * rng.uniform(0.9, 1.1, (8, 8))
        np.fill_diagonal(bw, 0.0)
        np.fill_diagonal(lat, 0.0)
        outs = []
        for synth_cls, name in ((Synthesizer, "port.xml"), (JSynth, "jax.xml")):
            path = str(tmp_path / name)
            chunk = synth_cls(path, ips, "sim-rank").generate_strategy(prim, 2, size, bw.tolist(), lat.tolist())
            outs.append((chunk, open(path, "rb").read()))
        assert outs[0] == outs[1], (prim, dcn_gbps)
        assert b'+sim-rank" chunk_bytes=' in outs[0][1]
        codecs.append(b'wire_dtype="int8"' in outs[0][1])
    # the slow inter-host link flips the payloads to int8
    assert codecs == [False, True, False, True]


def test_sim_engine_env_and_rejection(monkeypatch):
    from adapcc_tpu.sim import vector as jvector

    for env, world in (("", 8), ("", 4096), ("event", 4096), (" Vector ", 8), ("auto", 256)):
        monkeypatch.setenv("ADAPCC_SIM_ENGINE", env)
        assert sim.resolve_sim_engine(None, world) == jvector.resolve_sim_engine(None, world)
    assert sim.resolve_sim_engine("event", 1 << 17) == "event"
    monkeypatch.setenv("ADAPCC_SIM_ENGINE", "vectorised")
    with pytest.raises(ValueError) as pe:
        sim.resolve_sim_engine(None, 8)
    with pytest.raises(ValueError) as je:
        jvector.resolve_sim_engine(None, 8)
    assert str(pe.value) == str(je.value) and "ADAPCC_SIM_ENGINE" in str(pe.value)
    monkeypatch.delenv("ADAPCC_SIM_ENGINE")
    # the lowering caches: a re-price hits, a clear empties
    sim.clear_lowering_cache()
    s = Strategy.ring(8)
    sim.lowered_columns(s)
    sim.lowered_columns(s)
    assert sim.lowering_cache_info()["hits"] == 1 and sim.lowering_cache_info()["misses"] == 1
    sim.clear_lowering_cache()
    assert sim.lowering_cache_info()["entries"] == 0


def test_congestion_and_flow_replays_match_jax():
    """The congestion-profile replay (a seeded profile and a hand-made one
    with overlapping windows of both classes, event and vector replays) and
    the flow-LP broadcast replay, rows and timelines equal to JAX's."""
    from adapcc_tpu.sim import replay as jreplay
    from adapcc_tpu.sim.congestion import CongestionProfile as JProfile
    from adapcc_tpu.sim.congestion import CongestionWindow as JWindow
    from adapcc_tpu.strategy.flow_lp import solve_broadcast_lp as jsolve

    from adapcc_tpu_torch.sim.congestion import CongestionProfile, CongestionWindow
    from adapcc_tpu_torch.strategy.flow_lp import solve_broadcast_lp

    pm, jm = _models()
    windows = [(1, 4, cm.DCN, 4.0), (2, 6, cm.ICI, 3.0), (3, 5, cm.DCN, 2.0)]
    profiles = [(CongestionProfile.seeded(8, 12, seed=4, n_windows=3, classes=(cm.DCN, cm.ICI)),
                 JProfile.seeded(8, 12, seed=4, n_windows=3, classes=(cm.DCN, cm.ICI))),
                (CongestionProfile([CongestionWindow(*w) for w in windows], 8),
                 JProfile([JWindow(*w) for w in windows], 8))]
    for name in ("ring", "xml"):
        port_s, jax_s = _strategies(name)
        for (pp, jp), engine, steps in zip(profiles, ("event", "vector"), (None, 9)):
            assert pp.to_dict() == jp.to_dict()
            p = sim.simulate_congestion_profile(port_s, pm, NBYTES, pp, steps=steps, engine=engine)
            j = jreplay.simulate_congestion_profile(jax_s, jm, NBYTES, jp, steps=steps, engine=engine)
            assert [r.to_row() for r in p] == [r.to_row() for r in j], (name, engine)
            assert [(r.seconds, r.healthy_s, r.factors) for r in p] == [(r.seconds, r.healthy_s, r.factors) for r in j]
            assert any(r.congested and r.contention_ratio > 1 for r in p)
    with pytest.raises(ValueError, match="world"):
        sim.simulate_congestion_profile(Strategy.ring(4), pm, NBYTES, profiles[0][0])
    edges = [(0, 1), (0, 2), (1, 3), (2, 4), (3, 4), (4, 3), (4, 5), (5, 6), (6, 7), (3, 7)]
    bw = [1.0, 2.0, 1.0, 0.5, 3.0, 3.0, 2.0, 1.5, 1.0, 0.25]
    p = sim.simulate_flow_broadcast(solve_broadcast_lp(8, edges, bw, num_rounds=5), pm, NBYTES)
    j = jreplay.simulate_flow_broadcast(jsolve(8, edges, bw, num_rounds=5), jm, NBYTES)
    assert p.seconds == j.seconds > 0 and p.to_row() == j.to_row()
    assert [tuple(vars(t).values()) for t in p.report.transfers] == [tuple(vars(t).values()) for t in j.report.transfers]
    assert p.report.link_busy == j.report.link_busy
