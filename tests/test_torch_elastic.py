"""The port's elastic failover held against the JAX package's: fault plans,
the coordinator under a plan, degraded scenarios and their standby ranking,
the engine's prepared-plan cache across a swap, the async relay sync and
trainer, and the trainer's prewarm.

Floats are compared with ``==`` unless a test says otherwise.  The async
relay trainer runs at gloo world 4 (rank 0 in this process, ranks 1–3
spawned) from a seeded tiny GPT-2, 6 AdamW(3e-4) steps under a mask
sequence that banks rank 2 for two steps and rank 0 for one, against the JAX
trainer's ``bsp=False`` on the 4-device CPU mesh under the same masks; each
rank's losses agree within ``LOSS_ATOL`` and its parameters within
``PARAM_ATOL`` (the key bias, whose true gradient is zero, within ``2·lr`` a
step), the DDP parity tolerances of ``tests/test_torch_ddp.py``.  The model
is the smallest GPT-2 that file's helpers would build (vocab 16, 8 tokens,
width 16): the frameworks' summation orders drift a loss by a few ulps over
6 steps (the same in a full-world run), and a loss near 2.8 keeps that
inside ``LOSS_ATOL``, while a bank that dropped the deferred gradients moves
the losses by about 1e-2.  The
``sync_deferred`` check runs in the same workers on integer-valued
gradients, where every sum is exact and the average one rounding: bit for
bit JAX's.  The workers import only torch: JAX is imported inside the
functions that build the references.
"""

import copy
import json
import multiprocessing
import threading

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.coordinator import CoordinatorLogic
from adapcc_tpu_torch.ddp.hook import GradSyncHook
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.elastic import (
    FaultEvent,
    FaultPlan,
    StandbyPlanCache,
    degraded_scenarios,
    load_fault_plan,
    reemit_for_active,
)
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.sim.cost_model import DCN, ICI, LinkCoeffs, LinkCostModel
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.strategy.xml_io import parse_strategy_xml
from adapcc_tpu_torch.utils.observability import CollectiveTrace
from test_torch_ddp import LOSS_ATOL, LR, PARAM_ATOL, PER_RANK_BATCH, _free_port

WORLD = 4
#: the async relay trainer's GPT-2 (module docstring)
TINY = dict(vocab_size=16, max_seq=8, n_layer=1, n_head=2, d_model=16)
#: the async relay's mask sequence: rank 2 banked two steps, rank 0 one
MASKS = [[True] * 4, [True, True, False, True], [True, True, False, True], [True] * 4,
         [False, True, True, True], [True] * 4]
STEPS = len(MASKS)
#: the key bias's true gradient is zero: Adam turns rounding noise into
#: steps of ±lr, held to 2·lr a step (tests/test_torch_ddp.py)
KEY_BIAS_ATOL = 2 * LR * STEPS
#: sync_deferred's masks (the first three of the trainer's) and gradients
DEFERRED_STEPS = 3
EVENTS = [(2, "down", 5, 4.0), (3, "slow", 1, 3.0), (6, "recover", 5, 4.0), (7, "recover", 1, 4.0),
          (8, "slow", 2, 2.0), (9, "down", 2, 4.0)]


def _tokens(world, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY["vocab_size"], size=(world * PER_RANK_BATCH, TINY["max_seq"]))


def _flax_params(seed=0):
    """The flax tree of a seeded port model (as ``tests/test_torch_ddp.py``
    builds it, at this file's ``TINY``)."""
    tree = {}
    for key, t in GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=seed).state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        arr = t.numpy()
        if leaf == "bias":
            node["bias"] = arr
        elif path[-1] in ("wte", "wpe"):
            node["embedding"] = arr
        elif path[-1].startswith("ln"):
            node["scale"] = arr
        else:
            node["kernel"] = arr.T
    return {"params": tree}


def _plans():
    from adapcc_tpu.elastic import FaultEvent as JEvent
    from adapcc_tpu.elastic import FaultPlan as JPlan

    return FaultPlan([FaultEvent(*e) for e in EVENTS], 8), JPlan([JEvent(*e) for e in EVENTS], 8)


# --------------------------------------------------------------------------- #
# fault plans
# --------------------------------------------------------------------------- #


def test_fault_plan_replay_masks_seeded_and_rejections_match_jax():
    from adapcc_tpu.elastic import FaultEvent as JEvent
    from adapcc_tpu.elastic import FaultPlan as JPlan

    plan, jplan = _plans()
    for step in range(12):
        p, j = plan.state_at(step), jplan.state_at(step)
        assert (p.down, p.slow, p.healthy, p.faulty) == (j.down, j.slow, j.healthy, j.faulty)
        assert plan.mask_at(step).tolist() == jplan.mask_at(step).tolist()
        assert plan.contributing_at(step) == jplan.contributing_at(step)
    assert plan.mask_at(4).tolist() == [True, False, True, True, True, False, True, True]
    for seed in (0, 3, 11):
        for kw in ({}, {"n_faults": 4, "recover": False, "slowdown": 2.5}):
            a = FaultPlan.seeded(8, 10, seed=seed, **kw)
            assert a.to_dict() == FaultPlan.seeded(8, 10, seed=seed, **kw).to_dict() == JPlan.seeded(
                8, 10, seed=seed, **kw).to_dict()
    bad = [lambda m, e: e(step=0, kind="explode", rank=0), lambda m, e: e(step=-1, kind="down", rank=0),
           lambda m, e: e(step=0, kind="slow", rank=0, slowdown=0.5),
           lambda m, e: m([e(step=0, kind="down", rank=9)], world=8),
           lambda m, e: m([e(step=0, kind="down", rank=r) for r in range(2)], world=2),
           lambda m, e: m.seeded(1, 4)]
    for make in bad:
        with pytest.raises(ValueError) as pe:
            make(FaultPlan, FaultEvent)
        with pytest.raises(ValueError) as je:
            make(JPlan, JEvent)
        assert str(pe.value) == str(je.value)


def test_fault_plan_files_cross_and_the_env_funnel_matches_jax(tmp_path):
    from adapcc_tpu.elastic import FaultPlan as JPlan
    from adapcc_tpu.elastic import load_fault_plan as jload

    plan, jplan = _plans()
    plan.save(str(tmp_path / "port.json"))
    jplan.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert JPlan.load(str(tmp_path / "port.json")).to_dict() == plan.to_dict()
    assert FaultPlan.load(str(tmp_path / "jax.json")).to_dict() == jplan.to_dict()
    (tmp_path / "bad.json").write_text("{not json")
    (tmp_path / "nokey.json").write_text(json.dumps({"events": []}))
    (tmp_path / "typed.json").write_text(json.dumps({"world": 8, "events": [{"step": 0, "kind": "down"}]}))
    assert load_fault_plan(env={}) is None and jload(env={}) is None
    env = {"ADAPCC_FAULT_PLAN": str(tmp_path / "port.json")}
    assert load_fault_plan(8, env).to_dict() == jload(8, env).to_dict()
    for name, world in (("missing.json", None), ("bad.json", 8), ("nokey.json", None), ("typed.json", None),
                        ("port.json", 4)):
        env = {"ADAPCC_FAULT_PLAN": str(tmp_path / name)}
        with pytest.raises((ValueError, FileNotFoundError)) as pe:
            load_fault_plan(world, env)
        with pytest.raises((ValueError, FileNotFoundError)) as je:
            jload(world, env)
        assert (type(pe.value), str(pe.value)) == (type(je.value), str(je.value)), name


def test_coordinator_under_a_fault_plan_decides_as_jax():
    """A down rank's arrivals are dropped at the funnel: the freeze and
    heartbeat barriers shrink and status 0 surfaces with the alive subset
    (no wall-clock wait); a recovery restores the full barrier.  The same
    answers and WorldViews from both packages' logic.  Each logic reads the
    stepped clock of ``tests/test_torch_coordinator.py`` (``_SteppedClock``),
    on time the alive ranks of each step, so how a loaded machine schedules
    the four threads cannot move a decision: 2 ms an arrival keeps the
    rent-or-buy leader's rent below its buy point until every on-time rank
    is in (``(m - 1)·arrival + initial rent < buy(m)`` for m = 2, 3 at the
    default costs needs under 6.5 ms)."""
    from adapcc_tpu.coordinator import CoordinatorLogic as JLogic
    from adapcc_tpu.elastic import FaultEvent as JEvent
    from adapcc_tpu.elastic import FaultPlan as JPlan

    from test_torch_coordinator import _SteppedClock

    events = [(1, "down", 3, 4.0), (4, "recover", 3, 4.0)]
    kw = dict(relay_threshold=30.0, time_slot=0.01, fault_timeout=30.0)
    outs = []
    for logic in (CoordinatorLogic(4, fault_plan=FaultPlan([FaultEvent(*e) for e in events], 4), **kw),
                  JLogic(4, fault_plan=JPlan([JEvent(*e) for e in events], 4), **kw)):
        seen = []
        clock = _SteppedClock(logic, 3, arrival_s=0.002, read_s=kw["time_slot"])
        with clock.installed():
            for step, on_time in ((1, 3), (5, 4)):
                clock.on_time = on_time
                results = {}

                def worker(r, step=step, results=results, logic=logic):
                    active = logic.hook_arrive(step=step, rank=r)
                    alive, status = logic.controller_arrive(step=step, rank=r)
                    results[r] = (sorted(active), sorted(alive), status)

                threads = [threading.Thread(target=worker, args=(r,)) for r in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=10)
                assert not any(t.is_alive() for t in threads), "the injection path hung"
                wv = logic.worldview()
                seen.append((results, sorted(wv.alive), sorted(wv.dead), wv.epoch))
        outs.append(seen)
    assert outs[0] == outs[1]
    assert outs[0][0][0][0] == ([0, 1, 2], [0, 1, 2], 0) and outs[0][1][1] == [0, 1, 2, 3]


# --------------------------------------------------------------------------- #
# degraded plans and the standby cache
# --------------------------------------------------------------------------- #


def test_degraded_scenarios_and_reemit_match_jax():
    from adapcc_tpu.elastic import degraded_scenarios as jscen
    from adapcc_tpu.elastic import reemit_for_active as jreemit
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    for world, ips in ((4, {r: f"10.0.0.{r // 2}" for r in range(4)}), (8, {r: f"h{r // 4}" for r in range(8)}),
                       (6, None), (1, None)):
        assert degraded_scenarios(world, ips) == jscen(world, ips)
        assert degraded_scenarios(world, ips, include_hosts=False) == jscen(world, ips, include_hosts=False)
    like, jlike = Strategy.ring(8), JStrategy.ring(8)
    like.chunk_bytes = jlike.chunk_bytes = 1 << 16
    like.wire_dtype = jlike.wire_dtype = "int8"
    for active in ([0, 1, 3, 4, 6, 7], [2, 3], list(range(1, 8))):
        for shape in ("ring", "binary"):
            for num_trans in (1, 3):
                p = reemit_for_active(8, active, IPS := {r: f"h{r // 4}" for r in range(8)}, num_trans, shape, like)
                j = jreemit(8, active, IPS, num_trans, shape, jlike)
                assert p.fingerprint() == j.fingerprint() and p.synthesis == j.synthesis
                assert (p.chunk_bytes, p.wire_dtype) == (j.chunk_bytes, j.wire_dtype) == (1 << 16, "int8")
                assert [t.root for t in p.trees] == [t.root for t in j.trees] and set(
                    t.root for t in p.trees) <= set(active)
    for bad in (lambda f: f(8, []), lambda f: f(8, [9]), lambda f: f(4, [0], shape="star")):
        with pytest.raises(ValueError) as pe:
            bad(reemit_for_active)
        with pytest.raises(ValueError) as je:
            bad(jreemit)
        assert str(pe.value) == str(je.value)


def test_standby_ranking_matches_jax(mesh8):
    """The cache's sim-ranked plans at world 8 over the two-host
    ``4-4_1.xml``: 8 one-rank-down and 2 one-host-down scenarios, each
    plan's label, shape, fingerprint and predicted seconds JAX's, in the
    same order; an unanticipated shrink re-emits on the spot, cold."""
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.elastic import StandbyPlanCache as JCache
    from adapcc_tpu.sim import cost_model as jcm
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jparse

    xml = "tests/fixtures/strategy/4-4_1.xml"
    classes = {ICI: LinkCoeffs(3e-6, 1.0 / 300e9), DCN: LinkCoeffs(12e-6, 1.0 / 20e9)}
    jclasses = {jcm.ICI: jcm.LinkCoeffs(3e-6, 1.0 / 300e9), jcm.DCN: jcm.LinkCoeffs(12e-6, 1.0 / 20e9)}
    port = StandbyPlanCache(CollectiveEngine(8, parse_strategy_xml(xml)), nbytes=40 << 20,
                            cost_model=LinkCostModel(8, classes=classes), device="cpu")
    ref = JCache(JEngine(mesh8, jparse(xml)), nbytes=40 << 20, cost_model=jcm.LinkCostModel(8, classes=jclasses))
    got, want = port.build(), ref.build()
    assert len(got) == 10 and sum(p.label.startswith("host") for p in got) == 2

    def rows(plans):
        return [(p.label, p.strategy.synthesis, p.strategy.fingerprint(), p.predicted_s, p.to_row()) for p in plans]

    assert rows(got) == rows(want)
    assert rows([port.plan_for([0, 1, 2, 3, 6])]) == rows([ref.plan_for([0, 1, 2, 3, 6])])
    assert port.plans[frozenset({0, 1, 2, 3, 6})].label.startswith("adhoc-")


def test_engine_cache_hit_across_warm_activate_and_restore():
    """World 4, stacked: the setup's dispatch, a warm of every plan, the
    failover dispatch a hit under the new epoch (3 contributors), the
    recovery back to the base plan a hit; ``clear`` drops the cache; a
    broadcast rooted at a dead rank is refused in JAX's words."""
    trace = CollectiveTrace()
    eng = CollectiveEngine(4, Strategy.ring(4), trace=trace)
    x = torch.ones(4, 8)
    eng.all_reduce(x)
    assert trace.events()[-1].extra["cache_hit"] is False
    cache = StandbyPlanCache(eng, nbytes=32, top_k=4, device="cpu")
    cache.build()
    warmed = cache.warm((8,), torch.float32)
    assert len(warmed) == 4 and all(p.warmed for p in warmed) and eng.strategy is cache.base_strategy
    plan, epoch = cache.activate([0, 1, 3])
    assert epoch == 1 and eng.strategy is plan.strategy
    out = eng.all_reduce(x, active_gpus=[0, 1, 3], epoch=epoch)
    assert trace.events()[-1].extra["cache_hit"] is True and trace.events()[-1].extra["epoch"] == 1
    assert torch.equal(out, torch.full((4, 8), 3.0))
    epoch = cache.restore_full()
    eng.all_reduce(x, epoch=epoch)
    assert trace.events()[-1].extra["cache_hit"] is True
    assert cache.adopt(plan.strategy) == 3 and eng.strategy is plan.strategy
    eng.clear()
    eng.all_reduce(x, active_gpus=[0, 1, 3])
    assert trace.events()[-1].extra["cache_hit"] is False


def test_dead_root_broadcast_refused_in_jax_words(mesh4):
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    with pytest.raises(ValueError, match="dead root cannot source") as pe:
        CollectiveEngine(4, Strategy.ring(4)).broadcast(torch.from_numpy(x), active_gpus=[1, 2, 3])
    with pytest.raises(ValueError) as je:
        JEngine(mesh4, JStrategy.ring(4)).broadcast(x, active_gpus=[1, 2, 3])
    assert str(pe.value) == str(je.value).replace("adapcc_tpu.elastic", "adapcc_tpu_torch.elastic")
    out = CollectiveEngine(4, Strategy.ring(4)).broadcast(torch.from_numpy(x), active_gpus=[0, 1, 3])
    assert torch.equal(out, torch.from_numpy(x[0]).expand(4, 8))


# --------------------------------------------------------------------------- #
# the async relay: sync_deferred and the bsp=False trainer at world 4
# --------------------------------------------------------------------------- #


def _integer_grads(world, step):
    """Per rank, two integer-valued float32 gradients (a matrix and a
    vector), different every step."""
    rng = np.random.default_rng(100 + step)
    return (rng.integers(-20, 21, size=(world, 3, 4)).astype(np.float32),
            rng.integers(-20, 21, size=(world, 5)).astype(np.float32))


def _port_rank(rank, init_method, state_dict, tokens):
    """One gloo rank: its sync_deferred outputs per step, then its async
    relay trainer's losses and final parameters."""
    world = build_world_mesh(WORLD, rank=rank, device="cpu", init_method=init_method)
    try:
        hook = GradSyncHook(Strategy.ring(WORLD), mode="schedule")
        bank = [torch.zeros(3, 4), torch.zeros(5)]
        deferred_rows = []
        for step in range(DEFERRED_STEPS):
            grads = [torch.from_numpy(g[rank].copy()) for g in _integer_grads(WORLD, step)]
            synced, bank = hook.sync_deferred(grads, bank, torch.tensor(MASKS[step]))
            deferred_rows.append(([s.numpy().copy() for s in synced], [b.numpy().copy() for b in bank]))
        model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=None)
        model.load_state_dict(state_dict)
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world, Strategy.ring(WORLD),
                             sync_mode="schedule", bsp=False)
        state = TrainState.create(model, trainer.tx)
        shard = torch.from_numpy(tokens[rank * PER_RANK_BATCH:(rank + 1) * PER_RANK_BATCH])
        losses = [trainer.step(state, shard, active_mask=torch.tensor(m))[1].item() for m in MASKS]
        return deferred_rows, np.array(losses), {k: v.detach().numpy() for k, v in model.state_dict().items()}
    finally:
        destroy_world()


def _port_child(*args):
    torch.set_num_threads(1)
    return _port_rank(*args)


def _jax_deferred(mesh4):
    """JAX's ``sync_deferred`` per step on the same gradients and masks:
    ``[(synced leaves [world, ...], bank leaves [world, ...])]``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.ddp.hook import GradSyncHook as JHook
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    hook = JHook(JStrategy.ring(WORLD), axis_name="ranks", mode="schedule")

    def per_shard(g, d, m):
        synced, bank = hook.sync_deferred({"a": g["a"][0], "b": g["b"][0]}, {"a": d["a"][0], "b": d["b"][0]}, m)
        return jax.tree_util.tree_map(lambda t: t[None], synced), jax.tree_util.tree_map(lambda t: t[None], bank)

    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh4, in_specs=(P("ranks"), P("ranks"), P()),
                               out_specs=(P("ranks"), P("ranks")), check_vma=False))
    bank = {"a": jnp.zeros((WORLD, 3, 4)), "b": jnp.zeros((WORLD, 5))}
    rows = []
    for step in range(DEFERRED_STEPS):
        a, b = _integer_grads(WORLD, step)
        synced, bank = fn({"a": jnp.asarray(a), "b": jnp.asarray(b)}, bank, jnp.asarray(MASKS[step]))
        rows.append(([np.asarray(synced["a"]), np.asarray(synced["b"])], [np.asarray(bank["a"]),
                                                                          np.asarray(bank["b"])]))
    return rows


def _jax_async_trainer(params, tokens):
    """The JAX trainer's ``bsp=False`` on the 4-device CPU mesh: per-step
    ``[world]`` losses and the final parameters as a state dict."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.ddp import DDPTrainer as JTrainer
    from adapcc_tpu.ddp import TrainState as JState
    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.models.gpt2 import lm_loss as jloss
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    model = JGPT2(JConfig(**TINY, dtype=jnp.float32, attention="xla"))
    mesh = Mesh(jax.devices()[:WORLD], ("ranks",))
    trainer = JTrainer(lambda p, b: jloss(model.apply(p, b), b), optax.adamw(LR), mesh, JStrategy.ring(WORLD),
                       sync_mode="schedule", bsp=False)
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    state = jax.device_put(JState.create(params, trainer.tx), NamedSharding(mesh, P()))
    losses = []
    for mask in MASKS:
        state, loss = trainer.step(state, batch, active_mask=jnp.asarray(mask))
        losses.append(np.asarray(loss))
    return np.stack(losses, axis=1), flax_to_state_dict(jax.device_get(state.params))


def test_async_relay_sync_and_trainer_at_world4_match_jax(mesh4):
    params = _flax_params()
    sd = flax_to_state_dict(params)
    tokens = _tokens(WORLD, seed=13)
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(WORLD - 1) as pool:
        pending = [pool.apply_async(_port_child, (r, init_method, sd, tokens)) for r in range(1, WORLD)]
        jax_rows = _jax_deferred(mesh4)
        jax_losses, jax_params = _jax_async_trainer(params, tokens)
        per_rank = [_port_rank(0, init_method, sd, tokens)] + [p.get(timeout=180) for p in pending]
    d = TINY["d_model"]
    for rank, (rows, losses, final) in enumerate(per_rank):
        for step, ((synced, bank), (jsynced, jbank)) in enumerate(zip(rows, jax_rows)):
            for got, want in zip(synced + bank, [s[rank] for s in jsynced + jbank]):
                assert got.tobytes() == want.tobytes(), f"rank {rank} step {step}"
        # the bank: rank 2 carries two steps' gradients, then contributes them
        assert (np.abs(rows[1][1][0]).sum() > 0) == (rank == 2) and not np.abs(rows[0][1][0]).any()
        np.testing.assert_allclose(losses, jax_losses[rank], atol=LOSS_ATOL, err_msg=f"rank {rank}")
        assert final.keys() == jax_params.keys()
        for name, want in jax_params.items():
            got, want = final[name], want.numpy()
            if name.endswith("attn.qkv.bias"):  # [q | k | v]: the key bias apart
                np.testing.assert_allclose(got[d:2 * d], want[d:2 * d], atol=KEY_BIAS_ATOL, err_msg=name)
                got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
            np.testing.assert_allclose(got, want, atol=PARAM_ATOL, err_msg=f"rank {rank} {name}")


# --------------------------------------------------------------------------- #
# prewarm, adopt_strategy and the supervised step
# --------------------------------------------------------------------------- #


def _snapshot(state, trainer):
    return (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
            [t.clone() for t in trainer._deferred or []], [t.clone() for t in trainer._residual or []])


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(-1).view(torch.uint8),
                                                                       b.view(-1).view(torch.uint8))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("kw", [dict(bsp=False), dict(grad_compress="int8", error_feedback=True, dynamic_mask=True)])
def test_prewarm_leaves_the_state_bit_for_bit_and_adopt_is_warm(kw):
    """World 1 in this process: after a step that fills the bank (the
    deferred bank under a masked-out step, or the error-feedback residual),
    ``prewarm`` of a second world-1 strategy leaves the parameters, the
    optimizer's moments, the deferred bank and the residual bit for bit as
    they were and starts one build generation; ``adopt_strategy`` then
    returns True and the next steps start none.  A supervised step takes
    the supervisor's mask."""
    world = build_world_mesh(1, device="cpu")
    try:
        model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=3)
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world, Strategy.ring(1),
                             sync_mode="schedule", **kw)
        state = TrainState.create(model, trainer.tx)
        batch = torch.from_numpy(_tokens(1, seed=2))
        trainer.step(state, batch, active_mask=torch.tensor([kw.get("bsp", True)]))
        banked = trainer._deferred if not kw.get("bsp", True) else trainer._residual
        assert any(bool(t.abs().sum() > 0) for t in banked)
        base = trainer.recompiles
        standby = Strategy.ring(1, num_trans=2)
        before = _snapshot(state, trainer)
        assert trainer.prewarm(standby, state, batch)
        assert _same(_snapshot(state, trainer), before)
        assert trainer.recompiles == base + 1 and not trainer.prewarm(standby, state, batch)
        assert trainer.hook.strategy is not standby
        assert trainer.adopt_strategy(standby) is True
        trainer.step(state, batch, active_mask=torch.tensor([True]))
        assert trainer.recompiles == base + 1 and trainer.hook.strategy is standby
        assert trainer.adopt_strategy(Strategy.ring(1)) is True  # the base was stepped
        assert trainer.adopt_strategy(Strategy.ring(1, num_trans=3)) is False

        class _Supervisor:
            def current_mask(self):
                return np.array([False])

        trainer.adopt_strategy(Strategy.ring(1))
        trainer.attach_supervisor(_Supervisor())
        trainer.step(state, batch)
        if not kw.get("bsp", True):  # the supervisor's mask banked this step
            assert any(bool(t.abs().sum() > 0) for t in trainer._deferred)
        with pytest.raises(ValueError, match="dynamic_mask=True"):
            DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world, Strategy.ring(1)).attach_supervisor(
                _Supervisor())
    finally:
        destroy_world()
