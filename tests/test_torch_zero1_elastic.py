"""ZeRO-1's elastic state in the port held against the JAX package's.

- Replica placement equals JAX's over worlds 1–8, with and without ip
  tables, refusals in JAX's words; the replica store's capture, freshness
  guard and reconstruct give JAX's rows bit for bit on the same stacked
  pair (a bfloat16 first moment included).
- ``rebalance_zero1_pair`` and ``reshard_zero1_snapshot`` give JAX's rows
  bit for bit for 8 → 4 and 4 → 8, ring on and off, and refuse an
  un-resharded or untagged snapshot with JAX's messages; the converters of
  ``models/convert.py`` carry JAX's re-balanced pair across and back, tag
  kept, stacked and by row, bit for bit.
- ``DDPTrainer(zero1=True, shard_replicas=1)`` per rank at gloo world 2
  (rank 0 here, rank 1 spawned) in the memory-lean configuration (remat
  ``"dots"``, ``lm_loss_chunked``, ``adamw(mu_dtype=bfloat16)``) against
  JAX's ``DDPTrainer(zero1=True)`` on the 2-device mesh.  Each step starts
  both from the JAX trainer's state before it (carried across by
  ``models/convert.py``), so a difference cannot cascade.  The frameworks'
  gradients differ in the last float32 bits, and Adam's first step divides
  a gradient by its own magnitude, so no row is bit for bit JAX's: losses
  agree to ``LOSS_ATOL``, each rank's master to ``PARAM_ATOL`` (0.1·lr;
  ``KEY_BIAS_ATOL``, 2·lr, for the key bias, whose true gradient is zero),
  the bfloat16 first moment to one bfloat16 ulp of the element plus half
  of one of the parameter's largest (``MU_SCALE``: where ``0.9·mu +
  0.1·g`` cancels), the second to ``NU_RTOL`` of its largest element
  (tests/test_torch_ddp.py states the parameter bounds and why).
  What is bit for bit: the per-rank rows against the port's stacked
  ``Zero1Optimizer`` on the same torch gradients (two free-running steps),
  JAX's optimizer tail on the same synced gradient
  (``test_zero1_tail_is_jax_bit_for_bit``), a lost rank's rows brought back
  by ``recover_zero1_trainer_state``, and a 2 → 1 → 2 re-balance.
- A mid-run shrink to world 1 continues as the uninterrupted world-2 run
  within JAX's ``test_zero1_midrun_shrink_is_convergence_equivalent``
  tolerance (rtol 2e-5, atol 1e-6; the key bias, as above, to
  ``KEY_BIAS_ATOL``).
- The supervisor's ``on_world_change`` seam drives a re-balance, as in
  JAX's ``tests/test_supervisor.py``; the cost model's recovery terms equal
  JAX's.

The worker imports only torch: JAX is imported inside the functions that
build the references.
"""

import multiprocessing

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.checkpoint import TrainCheckpointState
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, adamw
from adapcc_tpu_torch.elastic import (
    ShardReplicaStore,
    gather_zero1_pair,
    grow_zero1_trainer_state,
    rebalance_zero1_pair,
    recover_zero1_trainer_state,
    replica_placement,
    reshard_zero1_snapshot,
    shrink_zero1_trainer_state,
)
from adapcc_tpu_torch.models.convert import (
    adam_state_to_jax,
    flax_to_state_dict,
    zero1_snapshot_from_jax,
    zero1_snapshot_to_jax,
    zero1_state_from_jax,
)
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss_chunked
from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer, _flatten_meta, _unflatten, zero1_train_step
from adapcc_tpu_torch.strategy.ir import Strategy
from test_torch_ddp import LOSS_ATOL, PARAM_ATOL, _free_port

TINY = dict(vocab_size=256, max_seq=32, n_layer=2, n_head=2, d_model=64)
LR = 3e-4
STEPS = 2
PER_RANK_BATCH = 2
#: the chunked loss's vocabulary block: 256 is not a multiple of it
BLOCK = 96
KEY_BIAS_ATOL = 2 * LR
#: where ``0.9·mu + 0.1·g`` cancels, a small first moment keeps the terms'
#: absolute rounding error: half a bfloat16 ulp of the parameter's largest
#: first moment (the largest gap seen is well inside it)
MU_SCALE = 0.5
NU_RTOL = 1e-4
#: JAX's convergence-equivalence tolerance for a mid-run shrink
SHRINK_RTOL, SHRINK_ATOL = 2e-5, 1e-6
BF16 = torch.bfloat16


def _model(state_dict=None, **cfg):
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, **cfg), device="cpu", seed=None if state_dict else 0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _flax_params(seed=0):
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


def _lean_loss(m, b):
    return lm_loss_chunked(m, b, block=BLOCK)


def _bits(t):
    return t.view(torch.int16) if t.dtype == BF16 else t.view(torch.int32)


def _same(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a.contiguous()), _bits(b.contiguous()))


def _jax_bf16(a):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _raises_alike(port_call, jax_call):
    with pytest.raises(Exception) as pe:
        port_call()
    with pytest.raises(Exception) as je:
        jax_call()
    assert (type(pe.value).__name__, str(pe.value)) == (type(je.value).__name__, str(je.value))


# --------------------------------------------------------------------------- #
# replica placement and the store
# --------------------------------------------------------------------------- #


def _ip_tables(world):
    return {"none": None, "one host": {r: "a" for r in range(world)},
            "two hosts": {r: f"h{r // 2 % 2}" for r in range(world)},
            "ragged": {r: "h0" if r < 3 else f"h{1 + r % 2}" for r in range(world)}}


@pytest.mark.parametrize("world", range(1, 9))
def test_replica_placement_matches_jax(world):
    from adapcc_tpu.elastic import replica_placement as jplace

    for name, ips in _ip_tables(world).items():
        for k in range(world):
            assert replica_placement(world, ips, k) == jplace(world, ips, k), (name, k)
    for args in ((world, None, world), (0, None, 1), (world, None, -1)):
        _raises_alike(lambda: replica_placement(*args), lambda: jplace(*args))


def _stacked_pair(world, shard, seed=0, count=3):
    """A stacked pair with seeded master and moments, as the port holds it
    (master, state_dict) and as JAX's optax adamw(mu_dtype=bfloat16) state."""
    import optax

    rng = np.random.default_rng(seed)
    master = torch.from_numpy(rng.normal(size=(world, shard)).astype(np.float32))
    state = {"step": torch.tensor(float(count)),
             "exp_avg": torch.from_numpy(rng.normal(size=(world, shard)).astype(np.float32) * 1e-3).to(BF16),
             "exp_avg_sq": torch.from_numpy(rng.random(size=(world, shard)).astype(np.float32) * 1e-6)}
    opt = Zero1Optimizer(adamw(LR, mu_dtype=BF16), world)
    optimizer = opt.tx([master])
    optimizer.state[master] = state
    j = adam_state_to_jax(state, world)
    jstate = (optax.ScaleByAdamState(count=j["count"], mu=_jax_bf16(j["mu"]), nu=j["nu"]),
              optax.EmptyState(), optax.EmptyState())
    return (master, optimizer.state_dict()), (master.numpy().copy(), jstate)


def _port_rows(sd):
    st = sd["state"][0]
    return st["exp_avg"], st["exp_avg_sq"]


def _jax_rows(jstate):
    import jax.numpy as jnp

    adam = jstate[0]
    return (torch.from_numpy(np.array(jnp.asarray(adam.mu, jnp.float32))).to(BF16),
            torch.from_numpy(np.array(adam.nu)))


def test_store_capture_freshness_and_reconstruct_match_jax():
    from adapcc_tpu.elastic import ShardReplicaStore as JStore

    world, ips = 4, {0: "a", 1: "a", 2: "b", 3: "b"}
    port_pair, jax_pair = _stacked_pair(world, 40)
    ps, js = ShardReplicaStore(world, ips, replicas=2), JStore(world, ips, replicas=2)
    assert ps.placement == js.placement
    _raises_alike(lambda: ps.payload_for(1), lambda: js.payload_for(1))
    ps.capture(port_pair, 3)
    js.capture(jax_pair, 3)
    for r in range(world):
        pm, prows, pstep = ps.payload_for(r, expect_step=3)
        jm, jrows, jstep = js.payload_for(r, expect_step=3)
        assert pstep == jstep == 3 and ps.holders_of(r) == js.holders_of(r)
        assert _same(pm, torch.from_numpy(jm))
        pmu, pnu = prows["state"][0]["exp_avg"], prows["state"][0]["exp_avg_sq"]
        jmu, jnu = _jax_rows(jrows)
        assert _same(pmu, jmu) and _same(pnu, jnu)
    _raises_alike(lambda: ps.payload_for(2, expect_step=4), lambda: js.payload_for(2, expect_step=4))
    _raises_alike(lambda: ps.reconstruct(port_pair, [5]), lambda: js.reconstruct(jax_pair, [5]))
    # the dead rows zeroed, then repaired from the replicas
    lost_master = port_pair[0].clone()
    lost_master[[1, 3]] = 0
    lost_sd = {"state": {0: {k: (v.clone().index_fill_(0, torch.tensor([1, 3]), 0) if v.dim() else v)
                             for k, v in port_pair[1]["state"][0].items()}},
               "param_groups": port_pair[1]["param_groups"]}
    pm, psd = ps.reconstruct((lost_master, lost_sd), [1, 3], step=3)
    jm, jstate = js.reconstruct((np.where(np.isin(np.arange(world), [1, 3])[:, None], 0, jax_pair[0]),
                                 jax_pair[1]), [1, 3], step=3)
    assert _same(pm, port_pair[0]) and _same(pm, torch.from_numpy(jm))
    for got, want, ref in zip(_port_rows(psd), _jax_rows(jstate), _port_rows(port_pair[1])):
        assert _same(got, ref) and _same(got, want)


# --------------------------------------------------------------------------- #
# re-balance of the stacked pair
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("old,new", [(8, 4), (4, 8)])
@pytest.mark.parametrize("ring", [False, True], ids=["plain", "ring"])
def test_rebalance_pair_and_snapshot_match_jax(old, new, ring):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.checkpoint import TrainCheckpointState as JState
    from adapcc_tpu.elastic import rebalance_zero1_pair as jrebalance
    from adapcc_tpu.elastic import reshard_zero1_snapshot as jreshard
    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JZero1

    params = _flax_params()
    model = _model(flax_to_state_dict(params))
    tx, jtx = adamw(LR, mu_dtype=BF16), optax.adamw(LR, mu_dtype=jnp.bfloat16)
    mesh = {w: Mesh(jax.devices()[:w], ("ranks",)) for w in (old, new)}
    popt, jopt = Zero1Optimizer(tx, old, ring=ring), JZero1(jtx, mesh[old], ring=ring, ring_interpret=True)
    master, _ = popt.init(model)
    jmaster, _ = jopt.init(params)
    assert _same(master, torch.from_numpy(np.asarray(jmaster)))
    # seeded moments in the old layout: real rows only where the master
    # has parameters (padding stays zero on both sides)
    (_, sd), (_, jstate) = _stacked_pair(old, master.shape[1], seed=old)
    pad = master == 0
    for k in ("exp_avg", "exp_avg_sq"):
        sd["state"][0][k][pad] = 0
    j = adam_state_to_jax(sd["state"][0], old)
    jstate = (optax.ScaleByAdamState(count=j["count"], mu=_jax_bf16(j["mu"]), nu=j["nu"]),) + jstate[1:]
    layout = popt.layout_metadata()
    assert layout == jopt.layout_metadata()
    new_p, new_j = Zero1Optimizer(tx, new, ring=ring), JZero1(jtx, mesh[new], ring=ring, ring_interpret=True)
    pm, psd = rebalance_zero1_pair((master, sd), model, layout, new_p)
    jm, jst = jrebalance((np.asarray(jmaster), jstate), params, layout, new_j)
    assert _same(pm, torch.from_numpy(np.asarray(jm)))
    for got, want in zip(_port_rows(psd), _jax_rows(jst)):
        assert _same(got, want)
    assert float(psd["state"][0]["step"]) == 3 and np.asarray(jst[0].count).tolist() == [3] * new
    # the converters carry JAX's re-balanced pair across with its tag, and
    # back: stacked, and one rank's row
    conv = zero1_snapshot_from_jax(np.asarray(jm), jst, new_j.layout_metadata(), tx)
    assert conv.extra == new_p.checkpoint_extra() and _same(conv.opt_state[0], pm)
    assert all(_same(a, b) for a, b in zip(_port_rows(conv.opt_state[1]), _port_rows(psd)))
    back_m, back_adam, back_layout = zero1_snapshot_to_jax(conv)
    assert back_layout == new_j.layout_metadata() and np.array_equal(back_m, np.asarray(jm))
    assert np.array_equal(back_adam["count"], np.asarray(jst[0].count))
    assert np.array_equal(back_adam["mu"], np.asarray(jnp.asarray(jst[0].mu, jnp.float32)))
    assert np.array_equal(back_adam["nu"], np.asarray(jst[0].nu))
    row, row_state = zero1_state_from_jax(np.asarray(jm), jst, rank=1)
    assert _same(row, pm[1]) and _same(row_state["exp_avg"], psd["state"][0]["exp_avg"][1])
    # the snapshot funnel: re-tagged, validated, and back again exactly
    snap = TrainCheckpointState(None, (master, sd), step=3, extra=popt.checkpoint_extra())
    back = reshard_zero1_snapshot(reshard_zero1_snapshot(snap, model, new_p), model,
                                  Zero1Optimizer(tx, old, ring=ring))
    assert back.extra == popt.checkpoint_extra() and _same(back.opt_state[0], master)
    assert all(_same(a, b) for a, b in zip(_port_rows(back.opt_state[1]), _port_rows(sd)))
    # an un-resharded snapshot into a receiver of the new layout, and an
    # untagged one: JAX's refusals
    jsnap = JState(params=params, opt_state=(np.asarray(jmaster), jstate), extra=jopt.checkpoint_extra())
    _raises_alike(
        lambda: TrainCheckpointState(None, (master, sd), extra=new_p.checkpoint_extra()).apply_snapshot(
            snap.capture_snapshot()),
        lambda: JState(params=params, opt_state=(jmaster, jstate), extra=new_j.checkpoint_extra()).apply_snapshot(
            jsnap.capture_snapshot()))
    _raises_alike(lambda: reshard_zero1_snapshot(TrainCheckpointState(None, (master, sd)), model, new_p),
                  lambda: jreshard(JState(params=params, opt_state=(np.asarray(jmaster), jstate)), params, new_j))


def test_zero1_tail_is_jax_bit_for_bit():
    """The per-rank optimizer tail on one synced gradient: optax's adamw
    with a bfloat16 first moment on JAX's ``[L]`` row and the port's
    ``AdamW`` on the same row, three steps: master, mu and nu bit for bit."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(5)
    row = rng.normal(size=(1024,)).astype(np.float32)
    grads = [(rng.normal(size=row.shape) * 10.0 ** rng.integers(-6, 0)).astype(np.float32) for _ in range(3)]
    jtx = optax.adamw(LR, mu_dtype=jnp.bfloat16)
    jrow, jst = jnp.asarray(row), jtx.init(jnp.asarray(row))
    prow = torch.from_numpy(row.copy())
    opt = adamw(LR, mu_dtype=BF16)([prow])
    for g in grads:
        u, jst = jtx.update(jnp.asarray(g), jst, jrow)
        jrow = optax.apply_updates(jrow, u)
        prow.grad = torch.from_numpy(g)
        opt.step()
    st = opt.state[prow]
    assert _same(prow, torch.from_numpy(np.array(jrow)))
    assert _same(st["exp_avg"], _jax_rows((jst[0],))[0]) and _same(st["exp_avg_sq"], torch.from_numpy(
        np.asarray(jst[0].nu)))


# --------------------------------------------------------------------------- #
# the per-rank trainer at world 2
# --------------------------------------------------------------------------- #


def _lean_trainer(world, replicas=1):
    return DDPTrainer(_lean_loss, adamw(LR, mu_dtype=BF16), world, Strategy.ring(world.world_size), zero1=True,
                      shard_replicas=replicas)


def _lean_model(state_dict):
    return _model(state_dict, remat=True, remat_policy="dots")


def _rows_of(state):
    st = state.optimizer.state[state.master]
    return state.master.clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone()


def _anchored_steps(trainer, rank, befores, shard):
    """One port step from each JAX state before it: ``befores[s]`` is the
    JAX trainer's state (state_dict, master [2, L], adam count/mu/nu as
    float32) before step ``s``.  Returns (losses, rows after each step)."""
    losses, rows = [], []
    for s, (sd, master, adam) in enumerate(befores):
        model = _lean_model(sd)
        state = trainer.init_state(model)
        if s:
            state.master.copy_(torch.from_numpy(master[rank]))
            st = state.optimizer.state[state.master]
            st.update(step=torch.tensor(float(adam["count"])), exp_avg=torch.from_numpy(adam["mu"][rank]).to(BF16),
                      exp_avg_sq=torch.from_numpy(adam["nu"][rank]).clone())
            state.step = int(adam["count"])
        _, loss = trainer.step(state, shard)
        losses.append(loss.item())
        rows.append(_rows_of(state))
    return losses, rows


def _lean_rank(rank, init_method, befores, tokens):
    """One gloo rank of the world-2 drill (module docstring)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    world = build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    out = {}
    try:
        shard = torch.from_numpy(tokens[rank * PER_RANK_BATCH:(rank + 1) * PER_RANK_BATCH])
        trainer = _lean_trainer(world)
        out["losses"], out["anchored"] = _anchored_steps(trainer, rank, befores, shard)
        # free-running from the initial weights: the stacked comparison,
        # the replica repair and the re-balances
        model = _lean_model(befores[0][0])
        state = trainer.init_state(model)
        for _ in range(STEPS):
            trainer.step(state, shard)
        out["free"] = _rows_of(state)
        out["replica_step"] = trainer.replica_store.replica_step(1 - rank)
        lost = _rows_of(state)
        if rank == 1:  # rank 1's rows are lost, its replacement holds zeros
            st = state.optimizer.state[state.master]
            for t in (state.master, st["exp_avg"], st["exp_avg_sq"]):
                t.zero_()
        repaired = recover_zero1_trainer_state(trainer, state, dead=[1])
        out["recovered"] = all(_same(a, b) for a, b in zip(_rows_of(repaired), lost))
        snap = gather_zero1_pair(trainer, repaired)
        out["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        # branch A: two more steps at world 2
        for _ in range(STEPS):
            trainer.step(repaired, shard)
        out["branch_a"] = {k: v.clone() for k, v in model.state_dict().items()}
    finally:
        destroy_world()
        torch.set_num_threads(threads)
    if rank == 0:
        # branch B: the world shrinks to this rank alone, which takes the
        # whole global batch; then 2 → 1 → 2 on the stacked snapshot
        world1 = build_world_mesh(1, device="cpu")
        try:
            model = _lean_model(out["params"])
            t1 = _lean_trainer(world1, replicas=0)
            state = shrink_zero1_trainer_state(t1, t1.init_state(model), snap)
            for _ in range(STEPS):
                t1.step(state, torch.from_numpy(tokens))
            out["branch_b"] = {k: v.clone() for k, v in model.state_dict().items()}
            one = gather_zero1_pair(t1, shrink_zero1_trainer_state(t1, t1.init_state(_lean_model(out["params"])),
                                                                   snap))
        finally:
            destroy_world()
        out["shrunk"] = one
        out["snapshot"] = snap
    return out


def _lean_child(conn, init_method, tokens):
    """Rank 1 in a spawned process: it starts while the JAX reference is
    computed, then takes the JAX states from ``conn`` and sends its
    results back; it stays until they are received (its tensors travel as
    shared memory this process serves)."""
    conn.send(_lean_rank(1, init_method, conn.recv(), tokens))
    conn.recv()


def _jax_lean_befores(params, tokens):
    """JAX's ``DDPTrainer(zero1=True)`` in the memory-lean configuration on
    the 2-device mesh: per step its losses, and the state before and after
    each step as (state_dict, master [2, L], adam count/mu/nu float32)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.ddp import DDPTrainer as JTrainer
    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.models.gpt2 import lm_loss_chunked as jloss
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    model = JGPT2(JConfig(**TINY, dtype=jnp.float32, attention="xla", remat=True, remat_policy="dots"))
    mesh = Mesh(jax.devices()[:2], ("ranks",))
    trainer = JTrainer(lambda p, b: jloss(model, p, b, block=BLOCK), optax.adamw(LR, mu_dtype=jnp.bfloat16), mesh,
                       JStrategy.ring(2), zero1=True)
    state = trainer.init_state(params)
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))

    def snapshot(state):
        master, opt = jax.device_get(state.opt_state)
        adam = opt[0]
        return (flax_to_state_dict(jax.device_get(state.params)), np.asarray(master),
                {"count": int(np.asarray(adam.count)[0]), "mu": np.asarray(adam.mu).astype(np.float32),
                 "nu": np.asarray(adam.nu)})

    states, losses = [snapshot(state)], []
    for _ in range(STEPS):
        state, loss = trainer.step(state, batch)
        losses.append(np.asarray(loss))
        states.append(snapshot(state))
    return np.stack(losses, axis=1), states


def _by_param(row_pair, meta, model):
    """The two ranks' rows of one tensor as ``{parameter: array}``."""
    scratch = _model()
    _unflatten(torch.cat(row_pair).float(), meta, scratch)
    return {k: v.detach().numpy() for k, v in scratch.named_parameters()}


def _assert_rows_close(port_rows, jax_state, meta, model):
    """Master, mu and nu of both ranks against JAX's after one step."""
    _, jmaster, adam = jax_state
    d = TINY["d_model"]
    want = [torch.from_numpy(jmaster.reshape(-1)), torch.from_numpy(adam["mu"].reshape(-1)),
            torch.from_numpy(adam["nu"].reshape(-1))]
    for i, name in enumerate(("master", "mu", "nu")):
        got = _by_param([port_rows[r][i] for r in range(2)], meta, model)
        ref = _by_param([want[i]], meta, model)
        for pname, g in got.items():
            w = ref[pname]
            if name == "master":
                atol = np.full(w.shape, PARAM_ATOL, np.float32)
                if pname.endswith("attn.qkv.bias"):
                    atol[d:2 * d] = KEY_BIAS_ATOL
                bound = atol
            elif name == "mu":
                # one bfloat16 ulp of the element, and one at the scale of
                # the parameter's largest first moment
                bound = (np.abs(w) + MU_SCALE * np.abs(w).max()) * 2.0 ** -7
            else:
                bound = np.full(w.shape, NU_RTOL * np.abs(w).max() + 1e-30, np.float32)
            gap = np.abs(g - w)
            assert (gap <= bound).all(), f"{name} {pname}: max gap {gap.max()}"


@pytest.fixture(scope="module")
def lean_world2():
    params = _flax_params()
    tokens = np.random.default_rng(7).integers(0, TINY["vocab_size"], size=(2 * PER_RANK_BATCH, TINY["max_seq"]))
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    here, there = ctx.Pipe()
    child = ctx.Process(target=_lean_child, args=(there, init_method, tokens))
    child.start()
    try:
        j_losses, j_states = _jax_lean_befores(params, tokens)
        befores = j_states[:-1]
        here.send(befores)
        rank0 = _lean_rank(0, init_method, befores, tokens)
        assert here.poll(180), "rank 1 sent no result"
        per_rank = [rank0, here.recv()]
        here.send("received")
        child.join(60)
    finally:
        if child.is_alive():
            child.terminate()
    return tokens, j_losses, j_states, per_rank


def test_zero1_trainer_per_rank_matches_jax_rows(lean_world2):
    tokens, j_losses, j_states, per_rank = lean_world2
    for rank in range(2):
        np.testing.assert_allclose(per_rank[rank]["losses"], j_losses[rank], atol=LOSS_ATOL)
    model = _model()
    meta = _flatten_meta(model, 2)
    for s in range(STEPS):
        _assert_rows_close([per_rank[r]["anchored"][s] for r in range(2)], j_states[s + 1], meta, model)
    for r in range(2):
        _, mu, nu = per_rank[r]["anchored"][-1]
        assert mu.dtype == BF16 and nu.dtype == torch.float32


def test_zero1_trainer_per_rank_is_the_stacked_form_bit_for_bit(lean_world2):
    """The per-rank rows after two free-running steps against the port's
    single-controller ``Zero1Optimizer`` on the same weights and batch:
    bit for bit (at world 2 the average of two float32 gradients is exact
    either way: a sum and a halving)."""
    tokens, _, j_states, per_rank = lean_world2
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = _lean_model(j_states[0][0])
        opt = Zero1Optimizer(adamw(LR, mu_dtype=BF16), 2)
        master, optimizer = opt.init(model)
        step = zero1_train_step(_lean_loss, opt)
        for _ in range(STEPS):
            step(model, master, optimizer, torch.from_numpy(tokens))
    finally:
        torch.set_num_threads(threads)
    st = optimizer.state[master]
    for r in range(2):
        got = per_rank[r]["free"]
        assert _same(got[0], master[r]) and _same(got[1], st["exp_avg"][r]) and _same(got[2], st["exp_avg_sq"][r])
        assert per_rank[r]["replica_step"] == STEPS


def test_zero1_lost_rank_recovers_and_shrink_continues(lean_world2):
    tokens, _, _, per_rank = lean_world2
    assert per_rank[0]["recovered"] and per_rank[1]["recovered"]
    a, b = per_rank[0]["branch_a"], per_rank[0]["branch_b"]
    d = TINY["d_model"]
    for name in a:
        x, y = a[name].numpy(), b[name].numpy()
        if name.endswith("attn.qkv.bias"):
            np.testing.assert_allclose(x[d:2 * d], y[d:2 * d], atol=KEY_BIAS_ATOL * STEPS, rtol=0, err_msg=name)
            x, y = np.delete(x, np.s_[d:2 * d]), np.delete(y, np.s_[d:2 * d])
        np.testing.assert_allclose(x, y, rtol=SHRINK_RTOL, atol=SHRINK_ATOL, err_msg=name)
    # world 1's single row is the canonical flat state of world 2's rows
    (m2, sd2), (m1, sd1) = per_rank[0]["snapshot"], per_rank[0]["shrunk"]
    total = _flatten_meta(_model(), 1).total
    assert _same(m1.reshape(-1)[:total], m2.reshape(-1)[:total])
    for x1, x2 in zip(_port_rows(sd1), _port_rows(sd2)):
        assert _same(x1.reshape(-1)[:total], x2.reshape(-1)[:total])


def test_shrink_and_grow_guard_their_direction():
    world = build_world_mesh(1, device="cpu")
    try:
        trainer = _lean_trainer(world, replicas=0)
        state = trainer.init_state(_model())
        pair = (torch.zeros(2, 4), {"state": {}})
        with pytest.raises(ValueError, match="grow_zero1_trainer_state"):
            shrink_zero1_trainer_state(trainer, state, (torch.zeros(1, 4), {}), old_world=0)
        with pytest.raises(ValueError, match="shrink_zero1_trainer_state"):
            grow_zero1_trainer_state(trainer, state, pair)
        with pytest.raises(ValueError, match="init_state"):
            shrink_zero1_trainer_state(_lean_trainer(world, replicas=0), state, pair)
        with pytest.raises(ValueError, match="replica store"):
            recover_zero1_trainer_state(trainer, state, dead=[0])
        with pytest.raises(ValueError, match="requires zero1=True"):
            DDPTrainer(_lean_loss, adamw(LR), world, Strategy.ring(1), shard_replicas=1)
    finally:
        destroy_world()


def test_zero1_rank_chunked_all_gather_is_the_single_one():
    """``overlap="bucket"`` splits the per-rank all-gather into
    ``even_chunk_bounds`` slices (JAX's chunked ``lax.all_gather``): the
    parameters it rebuilds are the single gather's bit for bit."""
    from adapcc_tpu_torch.parallel.zero1_rank import zero1_apply_shard_rank

    world = build_world_mesh(1, device="cpu")
    try:
        got = []
        for chunks in (1, 3):
            model = _model()
            opt = Zero1Optimizer(adamw(LR, mu_dtype=BF16), 1)
            row, optimizer = opt.init_row(model, 0)
            g = torch.from_numpy(np.random.default_rng(2).normal(size=row.shape).astype(np.float32))
            zero1_apply_shard_rank(optimizer, row, g, opt._meta, model, overlap_chunks=chunks)
            got.append(model.state_dict())
        assert all(_same(got[0][k], got[1][k]) for k in got[0])
        assert not _same(got[0]["wte.weight"], _model().state_dict()["wte.weight"])
    finally:
        destroy_world()


# --------------------------------------------------------------------------- #
# the supervisor's world-change seam, the recovery cost terms
# --------------------------------------------------------------------------- #


def test_supervisor_world_change_seam_drives_rebalance(tmp_path):
    """``on_world_change`` fires once a membership change, after the
    journal append and before the applied marker: a re-balance of the
    stacked ZeRO-1 pair onto the alive world runs there, exact."""
    from adapcc_tpu_torch.coordinator import CoordinatorLogic
    from adapcc_tpu_torch.supervisor import Supervisor

    model = _model()
    opt = Zero1Optimizer(adamw(LR, mu_dtype=BF16), 4)
    master, optimizer = opt.init(model)
    pair = {"world": 4, "pair": (master, optimizer.state_dict()), "layout": opt.layout_metadata()}
    calls = []

    def rebalance(old, new):
        target = Zero1Optimizer(adamw(LR, mu_dtype=BF16), len(new.alive))
        moved = rebalance_zero1_pair(pair["pair"], model, pair["layout"], target)
        pair.update(pair=moved, layout=target.layout_metadata())
        calls.append((sorted(old.alive), sorted(new.alive), moved[0].shape[0]))

    logic = CoordinatorLogic(4)
    sup = Supervisor(logic, journal_path=str(tmp_path / "sup.journal"), clock=lambda: 0.0)
    sup.on_world_change = rebalance
    logic.mark_down([2])
    sup.poll(0.0)
    logic.mark_recovered([2])
    sup.poll(0.0)
    assert calls == [([0, 1, 2, 3], [0, 1, 3], 3), ([0, 1, 3], [0, 1, 2, 3], 4)]
    assert _same(pair["pair"][0], master)
    st = sup.journal.replay()
    assert len(st.epoch_bumps()) == 2 and st.unapplied == []


def test_recovery_cost_terms_match_jax(monkeypatch):
    from adapcc_tpu.sim import cost_model as jcm

    from adapcc_tpu_torch.sim import cost_model as cm

    for name in ("DEFAULT_PLAN_SWAP_DISPATCH_S", "DEFAULT_COLD_COMPILE_S", "DEFAULT_CODEC_BYTES_PER_S",
                 "DEFAULT_CKPT_BYTES_PER_S"):
        monkeypatch.setattr(cm, name, getattr(jcm, name))
    coeffs, jcoeffs = cm.LinkCoeffs(3e-6, 1 / 50e9), jcm.LinkCoeffs(3e-6, 1 / 50e9)
    for world in (2, 4, 8):
        for nbytes in (1e6, 6.4e8):
            for replicas in range(world):
                assert cm.replication_overhead_time(world, 3 * nbytes, coeffs, replicas) == \
                    jcm.replication_overhead_time(world, 3 * nbytes, jcoeffs, replicas)
            for cached in (True, False):
                assert cm.replica_repair_time(world, nbytes, coeffs, cached) == jcm.replica_repair_time(
                    world, nbytes, jcoeffs, cached)
            assert cm.checkpoint_reload_time(nbytes, 50, 0.1) == jcm.checkpoint_reload_time(nbytes, 50, 0.1)
            for kw in ({}, {"wire_dtype": "int8", "replicas": world - 1, "save_interval_steps": 7},
                       {"step_time_s": 0.2, "state_bytes": 2e9, "standby_cached": False}):
                assert cm.recovery_cost(world, nbytes, coeffs, **kw) == jcm.recovery_cost(world, nbytes, jcoeffs,
                                                                                          **kw)
    for bad in (lambda m, c: m.replication_overhead_time(2, 1.0, c, 2),
                lambda m, c: m.replica_repair_time(1, 1.0, c),
                lambda m, c: m.checkpoint_reload_time(1.0, 1, 1.0, 0.0),
                lambda m, c: m.recovery_cost(4, 1.0, c, save_interval_steps=0)):
        _raises_alike(lambda: bad(cm, coeffs), lambda: bad(jcm, jcoeffs))
