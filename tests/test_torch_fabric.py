"""The port's flow-LP broadcast and shared-fabric QoS held against the JAX
package's.

Both packages call the same ``scipy.optimize.linprog`` (HiGHS) on the same
matrices, so the solutions are compared exactly: every round's flows, the
round durations, the makespan and the lowered comm rounds.  The fabric's
plans and frontier rows are compared as JSON, and their replays with ``==``.
"""

import json

import numpy as np
import pytest

from adapcc_tpu_torch.adapt.fabric import (
    JOB_PRIORITY_ENV,
    SharedFabric,
    contend_links,
    hot_links,
    strategy_links,
)
from adapcc_tpu_torch.sim.cost_model import DCN, ICI, LinkCoeffs, LinkCostModel
from adapcc_tpu_torch.strategy.flow_lp import solve_broadcast_lp
from adapcc_tpu_torch.strategy.ir import Strategy

WORLD = 8
POD_IPS = {r: f"10.0.0.{r // 4}" for r in range(WORLD)}  # 2 pods × 4
POD_TABLE = [POD_IPS[r] for r in range(WORLD)]


def _ring_edges(n):
    edges = []
    for i in range(n):
        edges.append((i, (i + 1) % n))
        edges.append(((i + 1) % n, i))
    return edges


#: tests/test_flow_lp.py's graphs: (nodes, edges, bandwidths, rounds)
LP_CASES = {
    "line-2-rounds": (3, [(0, 1), (1, 2)], [1.0, 1.0], 2),
    "line-3-rounds": (3, [(0, 1), (1, 2)], [1.0, 1.0], 3),
    "line-6-rounds": (3, [(0, 1), (1, 2)], [1.0, 1.0], 6),
    "line-default": (3, [(0, 1), (1, 2)], [1.0, 1.0], 0),
    "star": (5, [(0, v) for v in range(1, 5)], [1.0] * 4, 0),
    "slow-link": (2, [(0, 1)], [0.5], 0),
    "ring4": (4, _ring_edges(4), [1.0] * 8, 0),
    "fanout-1-round": (3, [(0, 1), (0, 2)], [1.0, 1.0], 1),
    "cycle": (3, [(0, 1), (1, 2), (2, 1)], [0.1, 10.0, 10.0], 6),
    "mixed": (5, [(0, 1), (0, 2), (1, 3), (2, 4), (3, 4), (4, 3)], [1.0, 2.0, 1.0, 0.5, 3.0, 3.0], 0),
    "line9": (9, [(i, i + 1) for i in range(8)], [1.0] * 8, 0),
}


def _solution_row(sol):
    return {"rounds": [sorted((list(e), f) for e, f in r.items()) for r in sol.rounds],
            "durations": sol.durations, "makespan": sol.makespan,
            "comm_rounds": [list(map(list, r.edges)) for r in sol.comm_rounds()]}


@pytest.mark.parametrize("case", list(LP_CASES))
def test_flow_lp_matches_jax(case):
    from adapcc_tpu.strategy.flow_lp import solve_broadcast_lp as jsolve

    n, edges, bw, rounds = LP_CASES[case]
    port = solve_broadcast_lp(n, edges, bw, source=0, num_rounds=rounds)
    jax_ = jsolve(n, edges, bw, source=0, num_rounds=rounds)
    assert _solution_row(port) == _solution_row(jax_)
    assert port.makespan == jax_.makespan
    # the lowered rounds replay soundly: no node sends before it holds data
    have = {0}
    for r in port.comm_rounds():
        assert all(u in have for u, _ in r.edges), case
        have |= {v for _, v in r.edges}
    assert have == set(range(n))


def test_flow_lp_refusals_match_jax():
    from adapcc_tpu.strategy.flow_lp import solve_broadcast_lp as jsolve

    for args in ((3, [(0, 1)], [1.0], 7), (3, [(0, 1)], [1.0, 2.0], 0), (3, [(0, 1), (-1, 2)], [1.0, 1.0], 0),
                 (3, [(0, 1), (1, 1)], [1.0, 1.0], 0), (3, [(0, 1)], [1.0], 0), (3, [(0, 1), (0, 1)], [1.0, 1.0], 0)):
        msgs = []
        for solve in (solve_broadcast_lp, jsolve):
            with pytest.raises(ValueError) as e:
                solve(*args[:3], source=args[3])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_flow_broadcast_replay_on_the_8_rank_graph_matches_jax():
    """The flow LP on the world-8 two-pod graph (bandwidths read off the
    cost model) and its replay, exactly JAX's."""
    from adapcc_tpu.sim import cost_model as jcm
    from adapcc_tpu.sim.replay import simulate_flow_broadcast as jreplay
    from adapcc_tpu.strategy.flow_lp import solve_broadcast_lp as jsolve

    from adapcc_tpu_torch.sim import simulate_flow_broadcast

    rows = []
    for cm, solve, replay in ((None, solve_broadcast_lp, simulate_flow_broadcast), (jcm, jsolve, jreplay)):
        mod = cm or __import__("adapcc_tpu_torch.sim.cost_model", fromlist=["x"])
        model = mod.LinkCostModel(WORLD, classes={mod.ICI: mod.LinkCoeffs(2e-6, 1 / 200e9),
                                                  mod.DCN: mod.LinkCoeffs(9e-6, 1 / 25e9)}, ips=POD_IPS, source="t")
        bw, _ = model.to_graphs()
        edges = [(s, d) for s in range(WORLD) for d in range(WORLD) if s != d and (s // 4 == d // 4 or s % 4 == d % 4)]
        sol = solve(WORLD, edges, [bw[s][d] for s, d in edges], source=0)
        tl = replay(sol, model, 16 << 20)
        rows.append([_solution_row(sol), tl.to_row(), tl.seconds,
                     [list(vars(t).values()) for t in tl.report.transfers], sorted(tl.report.link_busy.items())])
    assert json.dumps(rows[0]) == json.dumps(rows[1])
    assert rows[0][2] > 0 and rows[0][1]["mode"] == "simulated"


# --------------------------------------------------------------------------- #
# the shared fabric
# --------------------------------------------------------------------------- #


def _model(mod, ips=POD_IPS):
    return mod.LinkCostModel(WORLD, classes={mod.ICI: mod.LinkCoeffs(1e-6, 1.0 / 45e9),
                                             mod.DCN: mod.LinkCoeffs(25e-6, 1.0 / 12.5e9)},
                             ips=ips, source="test-fabric")


def _fabric_rows(fabric_mod, cm_mod, penalty):
    fab = fabric_mod.SharedFabric(_model(cm_mod), POD_TABLE, share_penalty=penalty)
    fab.add_job("training", priority="high", nbytes=16 << 20)
    fab.add_job("batch", priority="low", nbytes=16 << 20, degree=2)
    fab.add_job("eval", priority="low", nbytes=1 << 20)
    coord, unco = fab.plan(coordinated=True), fab.plan(coordinated=False)
    return [coord.to_row(), unco.to_row(), fab.frontier(), sorted(coord.shared_links),
            [a.ranked_s for a in coord.assignments], [a.strategy.fingerprint() for a in coord.assignments]]


@pytest.mark.parametrize("penalty", [2.0, 4.0])
def test_shared_fabric_plans_and_frontier_match_jax(penalty):
    from adapcc_tpu.adapt import fabric as jfabric
    from adapcc_tpu.sim import cost_model as jcm

    from adapcc_tpu_torch.adapt import fabric as pfabric
    from adapcc_tpu_torch.sim import cost_model as pcm

    port = _fabric_rows(pfabric, pcm, penalty)
    assert json.dumps(port, sort_keys=True) == json.dumps(_fabric_rows(jfabric, jcm, penalty), sort_keys=True)
    assert port[2]["high_priority_wins"] and port[2]["mode"] == "simulated"


def test_qos_two_job_drill_low_yields_and_high_wins():
    """tests/test_fabric.py's acceptance drill on the port: the low job
    avoids the high job's bottleneck links, the high job's shared steady
    state beats the uncoordinated one, and the frontier row repeats."""
    model = _model(__import__("adapcc_tpu_torch.sim.cost_model", fromlist=["x"]))
    fab = SharedFabric(model, POD_TABLE)
    fab.add_job("training", priority="high", nbytes=16 << 20)
    fab.add_job("batch", priority="low", nbytes=16 << 20)
    plan = fab.plan(coordinated=True)
    hi, lo = plan.job("training"), plan.job("batch")
    assert lo.yielded_links > 0 and hi.yielded_links == 0
    assert not (hot_links(hi.strategy, model) & hot_links(lo.strategy, model))
    assert 0.0 < plan.fairness() <= 1.0 and plan.throughput_gbps() > 0
    assert hi.shared_s < fab.plan(coordinated=False).job("training").shared_s
    assert json.dumps(fab.frontier(), sort_keys=True) == json.dumps(fab.frontier(), sort_keys=True)
    for a in plan.assignments:
        assert a.alone_s <= a.shared_s < a.alone_s * 3.0


def test_links_priority_and_validation_match_jax(monkeypatch):
    from adapcc_tpu.adapt import fabric as jfabric
    from adapcc_tpu.sim import cost_model as jcm
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    from adapcc_tpu_torch.adapt import job_priority

    s, js = Strategy.ring(WORLD, 2, POD_IPS), JStrategy.ring(WORLD, 2, POD_IPS)
    assert strategy_links(s) == jfabric.strategy_links(js)
    pm, jm = _model(__import__("adapcc_tpu_torch.sim.cost_model", fromlist=["x"])), _model(jcm)
    assert hot_links(s, pm) == jfabric.hot_links(js, jm) and hot_links(s, pm, band=0.1) == jfabric.hot_links(js, jm, 0.1)
    target = sorted(strategy_links(s))[:3]
    c, jc = contend_links(pm, target, 2.0), jfabric.contend_links(jm, target, 2.0)
    assert c.source == jc.source and {k: (v.alpha, v.beta) for k, v in c.links.items()} == {
        k: (v.alpha, v.beta) for k, v in jc.links.items()}
    monkeypatch.delenv(JOB_PRIORITY_ENV, raising=False)
    assert job_priority() == "high" and job_priority("low") == "low"
    monkeypatch.setenv(JOB_PRIORITY_ENV, "low")
    assert job_priority("high") == "low"
    fab = SharedFabric(pm, POD_TABLE)
    assert fab.add_job("env").priority == "low" and fab.add_job("pinned", priority="high").priority == "high"
    monkeypatch.setenv(JOB_PRIORITY_ENV, "medium")
    with pytest.raises(ValueError, match=JOB_PRIORITY_ENV):
        job_priority()
    for bad, match in (((pm, POD_TABLE[:-1]), "ip table"), ((pm, POD_TABLE, 0.5), "share_penalty")):
        with pytest.raises(ValueError, match=match):
            SharedFabric(*bad)
    with pytest.raises(ValueError, match="share factor"):
        contend_links(pm, target, 0.5)
    fab = SharedFabric(LinkCostModel(WORLD, classes={ICI: LinkCoeffs(1e-6, 1e-11), DCN: LinkCoeffs(2e-5, 8e-11)}),
                       POD_TABLE)
    assert fab.model.ips == dict(enumerate(POD_TABLE))
    with pytest.raises(ValueError, match="no jobs"):
        fab.plan()
    fab.add_job("a", priority="high")
    with pytest.raises(ValueError, match="already registered"):
        fab.add_job("a")
    with pytest.raises(ValueError, match="high|low"):
        fab.add_job("b", priority="medium")
    with pytest.raises(KeyError, match="no job"):
        fab.plan().job("ghost")
    assert np.isfinite(fab.plan().fairness())
