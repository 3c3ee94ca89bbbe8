"""The port's supervisor (liveness, journal, daemon, chaos) held against the
JAX package's.

Every test injects its clock; nothing sleeps for a decision.  The daemon
runs the same scripted heartbeats and fault plan in both packages, each over
its own engine and standby cache (built on one explicit cost model, not
warmed: JAX's warm would compile), and the journals come out byte for byte
alike, with the same epochs, masks and swap labels.  The port's warm swap
and its prepared-plan cache hits are checked on the port alone, as the JAX
package's own tests check its compiled-program hits.  The one chaos test
that signals a process spawns a fresh interpreter, kills it and reaps it
under its own deadline.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.communicator import Communicator
from adapcc_tpu_torch.config import CommArgs
from adapcc_tpu_torch.coordinator import CoordinatorLogic
from adapcc_tpu_torch.elastic import FaultEvent, FaultPlan, StandbyPlanCache
from adapcc_tpu_torch.primitives import ALLREDUCE, SKIP_BOOTSTRAP
from adapcc_tpu_torch.sim.cost_model import LinkCostModel
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.supervisor import (
    DEAD,
    HEALTHY,
    SUSPECTED,
    BeatChaos,
    ChaosInjector,
    DecisionJournal,
    LivenessConfig,
    LivenessTable,
    Supervisor,
    supervisor_enabled,
    wall_schedule,
)
from adapcc_tpu_torch.utils.observability import CollectiveTrace, MetricsRegistry

CFG = dict(timeout_s=1.0, period_s=0.5, grace=2)
#: the explicit cost model both packages' standby caches rank on
ALPHA, BETA = 5e-6, 1.0 / 100e9
#: a chaos test's own deadline: a hung child fails this test, not the suite
CHAOS_DEADLINE_S = 10.0


# --------------------------------------------------------------------------- #
# liveness
# --------------------------------------------------------------------------- #


def test_liveness_state_machine_matches_jax():
    """healthy → suspected → dead, the false-positive guard inside the
    grace window, a recovery beat, medians and rows: every transition and
    row equal to JAX's over one script."""
    from adapcc_tpu.supervisor import liveness as jl

    port = LivenessTable(4, LivenessConfig(**CFG), now=0.0)
    ref = jl.LivenessTable(4, jl.LivenessConfig(**CFG), now=0.0)
    script = [("beat", r, 0.4, 0.05 * (r + 1)) for r in range(4)] + [
        ("sweep", 0.9), ("beat", 0, 1.3, 0.05), ("sweep", 1.5), ("beat", 1, 2.2, None), ("sweep", 2.3),
        ("sweep", 2.5), ("beat", 3, 2.6, 0.3), ("sweep", 3.0), ("beat", 2, 3.1, 0.1), ("sweep", 9.0),
    ]
    for step in script:
        if step[0] == "beat":
            _, rank, now, median = step
            assert port.beat(rank, now, median) == ref.beat(rank, now, median), step
        else:
            assert port.sweep(step[1]) == ref.sweep(step[1]), step
        now = step[2] if step[0] == "beat" else step[1]
        assert port.rows(now) == ref.rows(now), step
    assert port.dead() == ref.dead() and port.medians() == ref.medians()
    assert (HEALTHY, SUSPECTED, DEAD) == (jl.HEALTHY, jl.SUSPECTED, jl.DEAD)
    metrics = MetricsRegistry()
    port.export_gauges(metrics, 9.0)
    assert metrics.snapshot()["gauges"]["liveness/rank2/state"] == 2.0
    with pytest.raises(ValueError, match="outside world"):
        port.beat(4, 0.0)


def test_liveness_and_supervisor_env_knobs_match_jax(monkeypatch):
    from adapcc_tpu.supervisor import daemon as jd
    from adapcc_tpu.supervisor import liveness as jl

    cases = [({"ADAPCC_HEARTBEAT_PERIOD_S": "fast"}, True), ({"ADAPCC_HEARTBEAT_GRACE": "0"}, True),
             ({"ADAPCC_HEARTBEAT_GRACE": "two"}, True),
             ({"ADAPCC_HEARTBEAT_GRACE": "3", "ADAPCC_HEARTBEAT_PERIOD_S": "0.5",
               "ADAPCC_HEARTBEAT_TIMEOUT_S": "2.5"}, False)]
    for env, bad in cases:
        for k in ("ADAPCC_HEARTBEAT_PERIOD_S", "ADAPCC_HEARTBEAT_GRACE", "ADAPCC_HEARTBEAT_TIMEOUT_S"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if bad:
            with pytest.raises(ValueError) as pe:
                LivenessConfig.from_env()
            with pytest.raises(ValueError) as je:
                jl.LivenessConfig.from_env()
            assert str(pe.value) == str(je.value) and "ADAPCC_HEARTBEAT" in str(pe.value)
        else:
            assert vars(LivenessConfig.from_env()) == vars(jl.LivenessConfig.from_env()) == {
                "timeout_s": 2.5, "period_s": 0.5, "grace": 3}
    for value, explicit in (("", True), ("on", False), ("OFF", True), ("1", False)):
        monkeypatch.setenv("ADAPCC_SUPERVISOR", value)
        assert supervisor_enabled(explicit) == jd.supervisor_enabled(explicit)
    monkeypatch.setenv("ADAPCC_SUPERVISOR", "maybe")
    with pytest.raises(ValueError, match="ADAPCC_SUPERVISOR"):
        supervisor_enabled()
    with pytest.raises(ValueError, match="grace"):
        LivenessConfig(grace=0)


# --------------------------------------------------------------------------- #
# the journal
# --------------------------------------------------------------------------- #


def _journal_script(journal_cls, path):
    j = journal_cls(path)
    j.append("suspect", rank=2, age_s=1.2)
    d = j.append("epoch", alive=[0, 1, 3], relays=[1], wv_epoch=1)
    j.append("swap", label="rank2-down", fingerprint="abc", warmed=True, engine_epoch=1)
    j.mark_applied(d.seq)
    j.append("demote", ranks=[3], medians={"3": 0.25})
    j.append("epoch", alive=[0, 1, 3], relays=[1, 3], wv_epoch=2)
    j.close()


def _state(st):
    return ([(d.seq, d.kind, d.payload) for d in st.decisions], st.applied, st.next_seq, st.last_view,
            [d.seq for d in st.unapplied])


def test_journals_cross_between_the_packages(tmp_path):
    """The same appends give the same bytes; a journal written by either
    package replays in the other to the same state; appends continue the
    other package's sequence."""
    from adapcc_tpu.supervisor.journal import DecisionJournal as JJournal

    _journal_script(DecisionJournal, str(tmp_path / "port"))
    _journal_script(JJournal, str(tmp_path / "jax"))
    raw = (tmp_path / "port").read_bytes()
    assert raw == (tmp_path / "jax").read_bytes() and raw.endswith(b"\n")
    for path in ("port", "jax"):
        p, j = DecisionJournal(str(tmp_path / path)), JJournal(str(tmp_path / path))
        assert _state(p.replay()) == _state(j.replay())
        assert _state(p.replay())[4] == [5]  # the last epoch never confirmed
    p = DecisionJournal(str(tmp_path / "jax"))
    assert p.append("clear", rank=2).seq == 6
    p.mark_applied(5)
    p.close()
    assert _state(JJournal(str(tmp_path / "jax")).replay())[2:] == (8, {"alive": [0, 1, 3], "relays": [1, 3],
                                                                         "wv_epoch": 2}, [])


def test_journal_torn_tail_repair_and_broken_chain_match_jax(tmp_path):
    from adapcc_tpu.supervisor.journal import DecisionJournal as JJournal

    for cls, name in ((DecisionJournal, "port"), (JJournal, "jax")):
        path = str(tmp_path / name)
        j = cls(path)
        j.append("suspect", rank=1)
        d = j.append("epoch", alive=[0], relays=[], wv_epoch=1)
        j.mark_applied(d.seq)
        j.close()
        with open(path, "a") as f:  # the crash-mid-write window
            f.write('{"v": 1, "seq": 3, "kind": "ep')
        j2 = cls(path)  # repairs the torn tail before its first append
        j2.append("epoch", alive=[], relays=[], wv_epoch=2)
        j2.mark_applied(3)
        j2.close()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    st = DecisionJournal(str(tmp_path / "port")).replay()
    assert [x.seq for x in st.decisions] == [0, 1, 3] and st.applied == {1, 3} and st.next_seq == 5
    broken = tmp_path / "broken"
    broken.write_text(json.dumps({"v": 1, "seq": 0, "kind": "suspect"}) + "\n"
                      + json.dumps({"v": 1, "seq": 5, "kind": "suspect"}) + "\n")
    corrupt = tmp_path / "corrupt"
    corrupt.write_text("garbage\n" + json.dumps({"v": 1, "seq": 0, "kind": "suspect"}) + "\n")
    for path, match in ((broken, "monotone"), (corrupt, "corrupt journal record")):
        with pytest.raises(ValueError, match=match) as pe:
            DecisionJournal(str(path))
        with pytest.raises(ValueError) as je:
            JJournal(str(path))
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="mark_applied"):
        DecisionJournal(str(tmp_path / "x")).append("applied")


# --------------------------------------------------------------------------- #
# the daemon
# --------------------------------------------------------------------------- #


def _port_world(tmp_path, name="sup.journal", warm=False, plan=None, step=None, config=CFG):
    trace = CollectiveTrace()
    engine = CollectiveEngine(4, Strategy.ring(4), trace=trace)
    x = torch.ones(4, 8)
    engine.all_reduce(x)
    cache = StandbyPlanCache(engine, nbytes=x.numel() * 4, top_k=4, cost_model=LinkCostModel.uniform(4, ALPHA, BETA),
                             device="cpu")
    cache.build()
    if warm:
        cache.warm((8,), torch.float32)
    logic = CoordinatorLogic(4, fault_plan=plan)
    sup = Supervisor(logic, engine, cache=cache, journal_path=str(tmp_path / name), config=LivenessConfig(**config),
                     fault_plan=plan, step_source=step, clock=lambda: 0.0)
    return sup, logic, engine, trace, cache, x


def _jax_world(mesh4, tmp_path, name="jax.journal", plan=None, step=None, config=CFG):
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.coordinator import CoordinatorLogic as JLogic
    from adapcc_tpu.elastic import StandbyPlanCache as JCache
    from adapcc_tpu.sim.cost_model import LinkCostModel as JModel
    from adapcc_tpu.strategy.ir import Strategy as JStrategy
    from adapcc_tpu.supervisor import LivenessConfig as JConfig
    from adapcc_tpu.supervisor import Supervisor as JSupervisor
    from adapcc_tpu.utils.observability import CollectiveTrace as JTrace

    trace = JTrace()
    engine = JEngine(mesh4, JStrategy.ring(4), trace=trace)
    cache = JCache(engine, nbytes=32, top_k=4, cost_model=JModel.uniform(4, ALPHA, BETA))
    cache.build()
    logic = JLogic(4, fault_plan=plan)
    sup = JSupervisor(logic, engine, cache=cache, journal_path=str(tmp_path / name), config=JConfig(**config),
                      fault_plan=plan, step_source=step, clock=lambda: 0.0)
    return sup, logic, engine, trace


def _heartbeat_script(sup, logic):
    """Every rank leases; rank 2 goes silent and dies; rank 1 pauses inside
    the grace window (suspected, then cleared); rank 2 comes back (admit).
    Returns the decisions of each poll, the engine epochs and the masks."""
    out = []
    for r in range(4):
        logic.heartbeat_arrive(r, now=0.0, median_s=0.1)
    beats = {0.5: (0, 1, 3), 1.0: (0, 1, 3), 1.6: (0, 3), 2.2: (0, 3), 2.3: (1,), 2.8: (0, 1, 3), 3.4: (0, 1, 2, 3)}
    for t, ranks in beats.items():
        for r in ranks:
            logic.heartbeat_arrive(r, now=t, median_s=0.1)
        out.append((sup.poll(t), sup.engine_epoch, sup.current_mask().tolist(), sup.worldview().epoch))
    return out


def _supervisor_events(trace):
    return [{k: v for k, v in e.extra.items()} for e in trace.events() if e.primitive == "supervisor"]


def test_daemon_decisions_epochs_and_journal_match_jax(mesh4, tmp_path):
    """Feed A (heartbeat silence, the false-positive guard, an admit) and
    feed B (a fault plan: a straggler demoted, a rank down, recovered) on
    both packages: the decisions of every poll, the engine and WorldView
    epochs, the masks, the journal bytes and the supervisor's trace records
    (liveness rows included) are the same."""
    port = _port_world(tmp_path)
    ref = _jax_world(mesh4, tmp_path)
    got, want = _heartbeat_script(port[0], port[1]), _heartbeat_script(ref[0], ref[1])
    assert got == want
    kinds = [d["kind"] for poll in got for d in poll[0]]
    assert kinds == ["suspect", "suspect", "dead", "epoch", "clear", "admit", "epoch"]
    assert (tmp_path / "sup.journal").read_bytes() == (tmp_path / "jax.journal").read_bytes()
    assert _supervisor_events(port[3]) == _supervisor_events(ref[3])
    assert [e["label"] for e in map(json.loads, (tmp_path / "sup.journal").read_text().splitlines())
            if e["kind"] == "swap"] == ["rank2-down", "base"]

    events = [(0, "slow", 3, 4.0), (2, "down", 1, 4.0), (4, "recover", 1, 4.0), (5, "recover", 3, 4.0)]
    from adapcc_tpu.elastic import FaultEvent as JEvent
    from adapcc_tpu.elastic import FaultPlan as JPlan

    step = [0]
    plan_cfg = dict(timeout_s=100.0, period_s=1.0, grace=1)
    port = _port_world(tmp_path, "plan.journal", plan=FaultPlan([FaultEvent(*e) for e in events], 4),
                       step=lambda: step[0], config=plan_cfg)
    ref = _jax_world(mesh4, tmp_path, "jplan.journal", plan=JPlan([JEvent(*e) for e in events], 4),
                     step=lambda: step[0], config=plan_cfg)
    rows = []
    for s in range(7):
        step[0] = s
        rows.append([(sup.poll(), sup.engine_epoch, sup.current_mask().tolist()) for sup in (port[0], ref[0])])
    assert all(p == j for p, j in rows)
    assert (tmp_path / "plan.journal").read_bytes() == (tmp_path / "jplan.journal").read_bytes()
    assert [r[0][2] for r in rows] == [[True, True, True, False]] * 2 + [[True, False, True, False]] * 2 + [
        [True, True, True, False]] + [[True] * 4] * 2


def test_daemon_warm_swap_is_a_cache_hit_and_recovery_restores_base(tmp_path):
    """Silence detected, the warmed one-rank-down plan swapped in: the
    failover dispatch is a prepared-plan cache hit under the new epoch, the
    dead rank's row is a relay's (it receives the result), the stale epoch
    raises, and the recovery swaps back to the base plan with a hit."""
    from adapcc_tpu_torch.comm.engine import EpochMismatch

    metrics = MetricsRegistry()
    sup, logic, engine, trace, cache, x = _port_world(tmp_path)
    # equal predictions: the ranking breaks ties by label, rank0/rank1-down
    assert [p.label for p in cache.warm((8,), torch.float32, top_k=2)] == ["rank0-down", "rank1-down"]
    sup.metrics = metrics
    for r in range(4):
        logic.heartbeat_arrive(r, now=0.0)
    for t in (1.0, 1.6, 2.2, 2.8):
        for r in (0, 2, 3):
            logic.heartbeat_arrive(r, now=t)
        sup.poll(t)
    wv = sup.worldview()
    assert sorted(wv.alive) == [0, 2, 3] and sup.engine_epoch == engine.epoch == 1
    assert engine.strategy is cache.plans[frozenset({0, 2, 3})].strategy
    out = engine.all_reduce(x * torch.arange(1.0, 5.0)[:, None], active_gpus=wv.active_list(), epoch=sup.engine_epoch)
    ev = trace.events()[-1]
    assert ev.extra["cache_hit"] is True and ev.extra["epoch"] == 1
    assert torch.equal(out, torch.full((4, 8), 8.0))  # 1 + 3 + 4 on every row, the dead rank's too
    with pytest.raises(EpochMismatch):
        engine.all_reduce(x, epoch=0)
    assert metrics.snapshot()["gauges"]["supervisor/engine_epoch"] == 1.0
    logic.heartbeat_arrive(1, now=3.0)
    for r in (0, 2, 3):
        logic.heartbeat_arrive(r, now=3.0)
    sup.poll(3.0)
    assert engine.strategy is cache.base_strategy and sup.engine_epoch == 2
    engine.all_reduce(x, epoch=2)  # the setup's dispatch prepared it
    assert trace.events()[-1].extra["cache_hit"] is True
    # a plan built but never warmed is a miss at its first dispatch
    plan, epoch = cache.activate([0, 1, 2])
    assert not plan.warmed
    engine.all_reduce(x, active_gpus=[0, 1, 2], epoch=epoch)
    assert trace.events()[-1].extra["cache_hit"] is False


def test_daemon_restart_and_crash_window(tmp_path):
    """A restart on the same journal resumes to an identical WorldView and
    bumps no epoch; a decision journaled but never actuated (the crash
    window) completes exactly once on the next restart."""
    sup, logic, engine, trace, cache, x = _port_world(tmp_path, warm=True)
    logic.mark_down([2])
    sup.poll(0.0)
    epoch, view = engine.epoch, sup.applied_view
    sup.stop()
    sup2 = Supervisor(logic, engine, cache=cache, journal_path=str(tmp_path / "sup.journal"),
                      config=LivenessConfig(**CFG), clock=lambda: 0.0)
    assert (sup2.applied_view, sup2.engine_epoch, engine.epoch) == (view, epoch, epoch)
    assert sup2.journal.replay().next_seq == sup.journal.replay().next_seq
    logic.mark_down([3])
    wv = logic.worldview()
    sup2.journal.append("epoch", alive=sorted(wv.alive), relays=[], wv_epoch=wv.epoch)
    sup2.stop()
    sup3 = Supervisor(logic, engine, cache=cache, journal_path=str(tmp_path / "sup.journal"),
                      config=LivenessConfig(**CFG), clock=lambda: 0.0)
    assert engine.epoch == epoch + 1 and sorted(sup3.applied_view.alive) == [0, 1]
    assert sup3.journal.replay().unapplied == []
    sup3.stop()
    sup4 = Supervisor(logic, engine, cache=cache, journal_path=str(tmp_path / "sup.journal"),
                      config=LivenessConfig(**CFG), clock=lambda: 0.0)
    assert engine.epoch == epoch + 1 and sup4.applied_view == sup3.applied_view
    sup4.stop()


def test_daemon_thread_starts_and_stops(tmp_path):
    sup, logic, engine, trace, cache, x = _port_world(tmp_path)
    try:
        sup.start(period_s=0.01)
        with pytest.raises(RuntimeError, match="already running"):
            sup.start(period_s=0.01)
    finally:
        sup.stop()
    assert sup._thread is None
    with pytest.raises(ValueError, match="step_source"):
        Supervisor(CoordinatorLogic(4), fault_plan=FaultPlan([FaultEvent(0, "down", 0)], 4))


def test_communicator_supervisor(tmp_path):
    """``Communicator.supervisor()``: the ALLREDUCE engine, a standalone
    logic of its world, a built standby cache, the journal in the topology
    directory; a world change it actuates reaches the Communicator's
    collectives under the new epoch."""
    args = CommArgs(strategy_file=str(tmp_path / "strategy.xml"), logical_graph=str(tmp_path / "lg.xml"),
                    topology_dir=str(tmp_path), entry_point=SKIP_BOOTSTRAP)
    comm = Communicator(args, world_size=4, device="cpu")
    comm.init_threads(ALLREDUCE)
    sup = comm.supervisor()
    try:
        assert sup.engine is comm._engine(ALLREDUCE) and sup.logic.world_size == 4
        assert len(sup.cache.plans) == 4 and sup.journal.path == os.path.join(str(tmp_path), "supervisor.journal")
        sup.logic.mark_down([1])
        assert [d["kind"] for d in sup.poll(0.0)] == ["epoch"]
        x = torch.arange(4.0)[:, None].expand(4, 3).contiguous()
        out = comm.all_reduce(x, active_gpus=sup.applied_view.active_list(), epoch=sup.engine_epoch)
        assert torch.equal(out, torch.full((4, 3), 5.0))
    finally:
        sup.stop()
        comm.clear()


# --------------------------------------------------------------------------- #
# chaos
# --------------------------------------------------------------------------- #


def test_wall_schedule_and_beat_chaos_match_jax():
    from adapcc_tpu.elastic import FaultPlan as JPlan
    from adapcc_tpu.supervisor import BeatChaos as JBeat
    from adapcc_tpu.supervisor import wall_schedule as jwall

    for seed in (0, 7):
        plan, jplan = FaultPlan.seeded(8, 12, seed=seed, n_faults=3), JPlan.seeded(8, 12, seed=seed, n_faults=3)
        for period, window in ((0.1, 0.2), (0.05, 0.03)):
            got = [vars(a) for a in wall_schedule(plan, period, window)]
            assert got == [vars(a) for a in jwall(jplan, period, window)]
            assert got == [vars(a) for a in plan.chaos_schedule(period, duty_window_s=window)]
    port, ref = BeatChaos(0.3, 0.05, 0.4, seed=3), JBeat(0.3, 0.05, 0.4, seed=3)
    decisions = [port.gate(r, s) for r in range(4) for s in range(40)]
    assert decisions == [ref.gate(r, s) for r in range(4) for s in range(40)]
    assert 0 < sum(not send for send, _ in decisions) < len(decisions)
    with pytest.raises(ValueError, match="unknown chaos action"):
        from adapcc_tpu_torch.supervisor import ChaosAction

        ChaosAction(0.0, "pause", 0)


def test_chaos_injector_kills_and_reaps_a_spawned_process():
    """A fresh interpreter (spawned, never forked) killed on schedule and
    reaped within the test's own deadline."""
    plan = FaultPlan([FaultEvent(step=1, kind="down", rank=0)], world=2)
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        inj = ChaosInjector(plan, step_period_s=0.05)
        inj.start({0: proc.pid, 1: os.getpid()})
        inj.join(timeout=CHAOS_DEADLINE_S)
        assert [a.kind for a in inj.delivered] == ["kill"]
        assert proc.wait(timeout=CHAOS_DEADLINE_S) == -9
    finally:
        inj.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=CHAOS_DEADLINE_S)
    with pytest.raises(ValueError, match="no pid"):
        ChaosInjector(plan, step_period_s=0.05).run({1: os.getpid()})
