"""The port's expert parallelism held against the JAX package's.

The same numpy-seeded flax ``MoEMLP`` tree and tokens go through
``adapcc_tpu`` (jitted, on the conftest's CPU mesh) and, converted
(``models/convert.py::moe_state_dict_from_flax``), through
``adapcc_tpu_torch`` on CPU tensors.  Held:

- the dense ``MoEMLP``, float32, with and without the router z-loss: the
  dispatch mask equal to JAX's exactly (read out of JAX's traced program:
  its ``combine > 0``), at a capacity that drops tokens; ``y`` within
  ``Y_ATOL``, ``aux`` within ``AUX_ATOL`` and every gradient within
  ``GRAD_ATOL`` (float32 on both sides: only the order of additions
  differs); one bfloat16 case within ``BF16_RTOL`` of each tensor's
  largest element (one bf16 rounding of a float32 sum on each side, in
  different orders: one ulp, ``2**-7`` of the value);
- ``expert_parallel_moe`` stacked at world 4 and per rank over gloo at
  world 2 (rank 0 here, rank 1 spawned) against JAX's on a CPU mesh:
  ``y``, ``aux`` and the gradients within the same bounds.  JAX's
  gradients are taken outside its ``shard_map``: there they equal JAX's
  dense module's (asserted below), because the router's gradient flows
  through ``pmean``s and a replicated input, so ``check_vma=False``'s
  ``1/world`` cotangent on the replicated ``aux`` cancels; per rank, the
  router's gradients are summed over the axis, as every replicated
  parameter's are in the port.  The raw exchange and the engine-routed one
  are equal bit for bit, the two-level 2 × 2 stacked exchange equals the
  flat one bit for bit, the engine records JAX's two ``all_to_all`` events
  a forward, and the world, hierarchy and axis refusals are JAX's words;
- the engine's all_to_all in record mode, flat and two-level: the same
  dispatches leave the same tuning cells (every key field) in both
  packages, and replaying each package's trace keys the same cells;
- ``train_moe``: it trains (the loss collapses on separable clusters, as in
  tests/test_parallel.py), infers (``computation time:``), refuses an
  indivisible batch in JAX's words, and under ``ADAPCC_TUNER=record``
  leaves ``all_to_all`` samples in the tuning file at the bucket JAX's
  test computes from ``moe_capacity``.

Workers import only torch: this module imports JAX inside functions.
"""

import dataclasses
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.models.convert import moe_state_dict_from_flax
from adapcc_tpu_torch.models.moe import MoEConfig, MoEMLP, route, router_logits
from adapcc_tpu_torch.parallel import Mesh, expert_parallel_moe, moe_capacity
from adapcc_tpu_torch.parallel.axis import sum_grads
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace

Y_ATOL, AUX_ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5
BF16_RTOL = 2.0 ** -7
WIDTHS = dict(num_experts=8, d_model=16, d_hidden=32, top_k=2)
#: every expert can take every token: nothing drops (tests/test_parallel.py)
NO_DROP = 8.0
#: a capacity that drops tokens, for the dispatch mask
TIGHT = 1.0
N_TOKENS = 32
RANK_WORLD = 2


def _cfg(capacity_factor=NO_DROP, z=0.0, dtype=torch.float32):
    return MoEConfig(**WIDTHS, capacity_factor=capacity_factor, dtype=dtype, router_z_coef=z)


def _jax_cfg(capacity_factor=NO_DROP, z=0.0, dtype="float32"):
    import jax.numpy as jnp

    from adapcc_tpu.models.moe import MoEConfig as JaxConfig

    return JaxConfig(**WIDTHS, capacity_factor=capacity_factor, dtype=getattr(jnp, dtype), router_z_coef=z)


def _data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N_TOKENS, WIDTHS["d_model"])).astype(np.float32)
    g = rng.normal(size=(N_TOKENS, WIDTHS["d_model"])).astype(np.float32)
    return x, g


@pytest.fixture(scope="module")
def flax_params():
    """flax's MoEMLP tree (``eval_shape``) with seeded numpy values: a
    router wide enough to spread the tokens unevenly, non-zero biases."""
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.moe import MoEMLP as JaxMoE

    tree = jax.eval_shape(JaxMoE(_jax_cfg()).init, jax.random.PRNGKey(0), jnp.zeros((1, 4, WIDTHS["d_model"])))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(lambda leaf: (rng.normal(size=leaf.shape) * 0.3).astype(np.float32), tree)


def _port_model(flax_params, cfg):
    model = MoEMLP(cfg, device="cpu", seed=None)
    model.load_state_dict(moe_state_dict_from_flax(flax_params))
    return model


def _port_grads(model, run):
    """``(y, aux, {name: grad})`` of ``sum(y·g) + aux`` for ``run(model)``."""
    model.zero_grad(set_to_none=True)
    y, aux = run(model)
    _, g = _data()
    ((y.float().reshape(N_TOKENS, -1) * torch.from_numpy(g)).sum() + aux).backward()
    return y.detach(), aux.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _jax_grads(fn, params):
    """JAX's ``(y, aux, grads)`` of ``sum(y·g) + aux`` for ``fn(params)``,
    jitted, the grads converted to the port's names."""
    import jax
    import jax.numpy as jnp

    _, g = _data()

    def loss(p):
        y, aux = fn(p)
        return jnp.sum(y.reshape(N_TOKENS, -1).astype(jnp.float32) * g) + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y, np.float32), float(aux), moe_state_dict_from_flax(jax.device_get(grads))


def _close(got, want, what, rtol_of_max=None):
    y, aux, grads = got
    jy, jaux, jgrads = want
    if rtol_of_max is None:
        np.testing.assert_allclose(y.float().reshape(jy.shape).numpy(), jy, atol=Y_ATOL, err_msg=what)
        np.testing.assert_allclose(aux.item(), jaux, atol=AUX_ATOL, err_msg=what)
    else:
        np.testing.assert_allclose(y.float().reshape(jy.shape).numpy(), jy, atol=rtol_of_max * np.abs(jy).max(),
                                   err_msg=what)
        np.testing.assert_allclose(aux.item(), jaux, atol=rtol_of_max * abs(jaux), err_msg=what)
    assert sorted(grads) == sorted(jgrads)
    for name, t in grads.items():
        w = jgrads[name].float().numpy()
        atol = GRAD_ATOL if rtol_of_max is None else rtol_of_max * np.abs(w).max()
        np.testing.assert_allclose(t.float().numpy(), w, atol=atol, err_msg=f"{what} d{name}")


# --------------------------------------------------------------------------- #
# the dense module
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("router", ["seeded", "ties"])
def test_dispatch_mask_equals_jax(flax_params, router):
    """JAX's ``combine > 0`` read out of its traced program, at a capacity
    that drops tokens, against the port's from the same routing code the
    module runs.  ``ties``: a zero router makes every probability equal, so
    each choice is a tie that ``jnp.argmax`` and ``torch.argmax`` both give
    to the first expert."""
    import jax
    import jax.numpy as jnp
    from jax import core

    from adapcc_tpu.models.moe import MoEMLP as JaxMoE

    if router == "ties":
        flax_params = jax.tree_util.tree_map(lambda a: a, flax_params)
        flax_params["params"]["router"] = {k: np.zeros_like(v) for k, v in flax_params["params"]["router"].items()}
    x, _ = _data()
    model = JaxMoE(_jax_cfg(TIGHT))
    closed = jax.make_jaxpr(lambda p, x: model.apply(p, x))(flax_params, jnp.asarray(x)[None])
    (gt,) = [e for e in closed.jaxpr.eqns if e.primitive.name == "gt"]
    (want,) = core.eval_jaxpr(closed.jaxpr.replace(outvars=[gt.outvars[0]]), closed.consts,
                              *jax.tree_util.tree_leaves((flax_params, jnp.asarray(x)[None])))
    port = _port_model(flax_params, _cfg(TIGHT))
    with torch.no_grad():
        probs = torch.softmax(router_logits(torch.from_numpy(x), port.router.weight, port.router.bias), -1)
        mask = route(probs, WIDTHS["top_k"], port.capacity(N_TOKENS)) > 0
    want = np.asarray(want)
    assert mask.numpy().shape == want.shape and (mask.numpy() == want).all()
    assert want.sum() < N_TOKENS * WIDTHS["top_k"], "the tight capacity should drop tokens"


@pytest.mark.parametrize("z", [0.0, 0.1])
def test_moe_mlp_matches_flax(flax_params, z):
    import jax.numpy as jnp

    from adapcc_tpu.models.moe import MoEMLP as JaxMoE

    x, _ = _data()
    for cf in (NO_DROP, TIGHT):
        want = _jax_grads(lambda p: JaxMoE(_jax_cfg(cf, z)).apply(p, jnp.asarray(x)[None]), flax_params)
        got = _port_grads(_port_model(flax_params, _cfg(cf, z)), lambda m: m(torch.from_numpy(x)[None]))
        _close(got, want, f"dense cf={cf} z={z}")


def test_moe_mlp_bf16_matches_flax(flax_params):
    import jax.numpy as jnp

    from adapcc_tpu.models.moe import MoEMLP as JaxMoE

    x, _ = _data()
    want = _jax_grads(lambda p: JaxMoE(_jax_cfg(NO_DROP, 0.1, "bfloat16")).apply(p, jnp.asarray(x)[None]),
                      flax_params)
    got = _port_grads(_port_model(flax_params, _cfg(NO_DROP, 0.1, torch.bfloat16)),
                      lambda m: m(torch.from_numpy(x)[None]))
    assert got[0].dtype == torch.float32  # y comes back in x's dtype
    _close(got, want, "dense bf16", rtol_of_max=BF16_RTOL)


def test_moe_capacity_matches_jax():
    from adapcc_tpu.parallel.expert import moe_capacity as jax_capacity

    for cf in (0.5, 1.0, 1.25, 2.0, 8.0):
        for k in (1, 2):
            for n in (1, 7, 16, 100, 2048):
                assert moe_capacity(dataclasses.replace(_cfg(cf), top_k=k), n) == \
                    jax_capacity(dataclasses.replace(_jax_cfg(cf), top_k=k), n)


# --------------------------------------------------------------------------- #
# expert parallelism, stacked
# --------------------------------------------------------------------------- #


def _jax_mesh(world, name="experts"):
    import jax
    from jax.sharding import Mesh as JaxMesh

    return JaxMesh(np.array(jax.devices()[:world]), (name,))


@pytest.fixture(scope="module")
def jax_ep(flax_params):
    """JAX's dense module and its EP at worlds 4 and 2 (no drops): each
    ``(y, aux, grads)``."""
    import jax.numpy as jnp

    from adapcc_tpu.models.moe import MoEMLP as JaxMoE
    from adapcc_tpu.parallel import expert_parallel_moe as jax_ep_fn

    x, _ = _data()
    cfg = _jax_cfg(NO_DROP, 0.1)
    out = {"dense": _jax_grads(lambda p: JaxMoE(cfg).apply(p, jnp.asarray(x)[None]), flax_params)}
    for world in (4, RANK_WORLD):
        out[world] = _jax_grads(lambda p: jax_ep_fn(p, jnp.asarray(x), cfg, _jax_mesh(world)), flax_params)
    return out


def test_jax_ep_gradient_outside_the_body_is_the_dense_one(jax_ep):
    for world in (4, RANK_WORLD):
        for name, g in jax_ep[world][2].items():
            np.testing.assert_allclose(g.numpy(), jax_ep["dense"][2][name].numpy(), atol=GRAD_ATOL, err_msg=name)


def test_expert_parallel_stacked_matches_jax_and_exchanges_agree(flax_params, jax_ep):
    x, _ = _data()
    cfg = _cfg(NO_DROP, 0.1)
    tx = torch.from_numpy(x)
    raw = _port_grads(_port_model(flax_params, cfg),
                      lambda m: expert_parallel_moe(m, tx, cfg, Mesh.stacked_mesh({"experts": 4})))
    _close(raw, jax_ep[4], "stacked world 4")
    _close(raw, jax_ep["dense"], "stacked world 4 against JAX's dense")

    trace = CollectiveTrace()
    engine = CollectiveEngine(4, Strategy.ring(4), trace=trace)
    routed = _port_grads(_port_model(flax_params, cfg),
                         lambda m: expert_parallel_moe(m, tx, cfg, Mesh.stacked_mesh({"experts": 4}), engine=engine))
    two_level = _port_grads(_port_model(flax_params, cfg),
                            lambda m: expert_parallel_moe(m, tx, cfg, Mesh.stacked_mesh({"dcn": 2, "ici": 2})))
    trace2 = CollectiveTrace()
    engine2 = CollectiveEngine(4, Strategy.ring(4), trace=trace2, num_slices=2)
    two_level_routed = _port_grads(
        _port_model(flax_params, cfg),
        lambda m: expert_parallel_moe(m, tx, cfg, Mesh.stacked_mesh({"dcn": 2, "ici": 2}), engine=engine2))
    for other in (routed, two_level, two_level_routed):
        assert torch.equal(other[0], raw[0]) and torch.equal(other[1], raw[1])
        assert all(torch.equal(other[2][n], raw[2][n]) for n in raw[2])
    # JAX records its two exchanges once per traced program (xla[moe] /
    # two_level[moe]); the port once per (leg, shape, dtype, axis): the same
    # two events, and none on a second forward of the same shapes
    assert [(e.impl, e.extra["moe"]) for e in trace.events()] == [("torch_flat[moe]", True)] * 2
    assert [e.impl for e in trace2.events()] == ["two_level[moe]"] * 2
    expert_parallel_moe(_port_model(flax_params, cfg), tx, cfg, Mesh.stacked_mesh({"experts": 4}), engine=engine)
    assert len(trace.events()) == 2


def test_expert_parallel_refusals_match_jax(mesh8, flax_params):
    import jax.numpy as jnp

    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.comm.two_level import build_two_level_mesh
    from adapcc_tpu.parallel import expert_parallel_moe as jax_ep_fn
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    x, _ = _data()
    cfg, jcfg = _cfg(), _jax_cfg()
    model = _port_model(flax_params, cfg)

    def both(port_kw, jax_kw, mesh, jmesh):
        with pytest.raises(ValueError) as mine:
            expert_parallel_moe(model, torch.from_numpy(x), cfg, mesh, **port_kw)
        with pytest.raises(ValueError) as theirs:
            jax_ep_fn(flax_params, jnp.asarray(x), jcfg, jmesh, **jax_kw)
        assert str(mine.value) == str(theirs.value)

    engine4 = JaxEngine(_jax_mesh(4), JaxStrategy.ring(4), axis_name="experts")
    both(dict(engine=CollectiveEngine(4, Strategy.ring(4))), dict(engine=engine4),
         Mesh.stacked_mesh({"experts": 8}), _jax_mesh(8))
    flat_engine = JaxEngine(_jax_mesh(4), JaxStrategy.ring(4), axis_name="experts")
    both(dict(engine=CollectiveEngine(4, Strategy.ring(4))), dict(engine=flat_engine),
         Mesh.stacked_mesh({"dcn": 2, "ici": 2}), build_two_level_mesh(2, 2))
    both(dict(axis_name="experts2"), dict(axis_name="experts2"),
         Mesh.stacked_mesh({"dcn": 2, "ici": 2}), build_two_level_mesh(2, 2))
    odd = dataclasses.replace(cfg, num_experts=6)
    with pytest.raises(ValueError) as mine:
        expert_parallel_moe(MoEMLP(odd, device="cpu"), torch.from_numpy(x), odd, Mesh.stacked_mesh({"experts": 4}))
    with pytest.raises(ValueError) as theirs:
        jax_ep_fn(flax_params, jnp.asarray(x), dataclasses.replace(jcfg, num_experts=6), _jax_mesh(4))
    assert str(mine.value) == str(theirs.value)


# --------------------------------------------------------------------------- #
# expert parallelism, per rank over gloo
# --------------------------------------------------------------------------- #


def _rank_results(rank, init_method, flax_params):
    """This rank's EP at world 2: its tokens' ``y``, ``aux`` and gradients
    (the router's summed over the axis, the experts' its own slice), raw
    and engine-routed, and the engine's trace."""
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    build_world_mesh(RANK_WORLD, rank=rank, device="cpu", init_method=init_method)
    try:
        mesh = Mesh.per_rank({"experts": RANK_WORLD})
        x, g = _data()
        n_loc = N_TOKENS // RANK_WORLD
        mine = slice(rank * n_loc, (rank + 1) * n_loc)
        cfg = _cfg(NO_DROP, 0.1)
        trace = CollectiveTrace()
        engine = CollectiveEngine(RANK_WORLD, Strategy.ring(RANK_WORLD), trace=trace)
        out = {}
        for name, eng in (("raw", None), ("engine", engine)):
            model = _port_model(flax_params, cfg)
            y, aux = expert_parallel_moe(model, torch.from_numpy(x[mine]), cfg, mesh, engine=eng)
            ((y * torch.from_numpy(g[mine])).sum() + aux).backward()
            sum_grads([model.router.weight, model.router.bias], [mesh["experts"]])
            out[name] = (y.detach().numpy(), aux.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()})
        out["trace"] = [e.impl for e in trace.events()]
        return out
    finally:
        destroy_world()


def _rank_child(rank, init_method, flax_params):
    torch.set_num_threads(1)
    return _rank_results(rank, init_method, flax_params)


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_expert_parallel_per_rank_over_gloo_matches_jax(flax_params, jax_ep):
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    # plain dicts of numpy: the worker must unpickle them without flax
    params = _plain(flax_params)
    with multiprocessing.get_context("spawn").Pool(RANK_WORLD - 1) as pool:
        pending = pool.apply_async(_rank_child, (1, init_method, params))
        per_rank = [_rank_results(0, init_method, params), pending.get(timeout=120)]
    e_loc = WIDTHS["num_experts"] // RANK_WORLD
    for name in ("raw", "engine"):
        y = torch.from_numpy(np.concatenate([r[name][0] for r in per_rank]))
        for r in per_rank:
            assert r[name][1] == per_rank[0][name][1]  # aux is replicated
            for n in ("router.weight", "router.bias"):  # summed over the axis
                assert np.array_equal(r[name][2][n], per_rank[0][name][2][n])
        grads = {n: torch.from_numpy(per_rank[0][name][2][n]) for n in ("router.weight", "router.bias")}
        for n in ("w1", "w2"):
            grads[n] = torch.from_numpy(np.concatenate(
                [r[name][2][n][k * e_loc:(k + 1) * e_loc] for k, r in enumerate(per_rank)]))
        _close((y, torch.tensor(per_rank[0][name][1]), grads), jax_ep[RANK_WORLD], f"per rank {name}")
    for r in per_rank:
        assert all(np.array_equal(r["engine"][2][n], r["raw"][2][n]) for n in r["raw"][2])
        assert np.array_equal(r["engine"][0], r["raw"][0])
        assert r["trace"] == ["process_group[moe]"] * 2


# --------------------------------------------------------------------------- #
# the engine's all_to_all in the tuner
# --------------------------------------------------------------------------- #


def _cells(db):
    return sorted((k.primitive, k.size_bucket, k.world, k.topology, k.path, k.chunk_bytes, k.wire_dtype, db.count(k))
                  for k in db.keys())


@pytest.mark.parametrize("num_slices", [1, 2])
def test_all_to_all_feeds_the_tuner_like_jax(mesh4, num_slices):
    import jax.numpy as jnp

    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.comm.two_level import build_two_level_mesh
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy
    from adapcc_tpu.tuner import CollectiveTuner as JaxTuner
    from adapcc_tpu.tuner import TuningDatabase as JaxDatabase
    from adapcc_tpu.tuner.db import mesh_fingerprint as jax_fingerprint
    from adapcc_tpu.tuner.measure import replay_trace as jax_replay
    from adapcc_tpu.utils.observability import CollectiveTrace as JaxTrace

    from adapcc_tpu_torch.tuner import CollectiveTuner, TuningDatabase
    from adapcc_tpu_torch.tuner.db import mesh_fingerprint
    from adapcc_tpu_torch.tuner.measure import replay_trace

    jmesh = mesh4 if num_slices == 1 else build_two_level_mesh(2, 2)
    topo = mesh_fingerprint("cpu", world=4)
    assert topo == jax_fingerprint(jmesh)
    jtuner = JaxTuner(4, topo, db=JaxDatabase(persist=False), mode="record")
    tuner = CollectiveTuner(4, topo, db=TuningDatabase(persist=False), mode="record")
    jtrace, trace = JaxTrace(), CollectiveTrace()
    jstrategy = JaxStrategy.ring(4)
    jeng = JaxEngine(jmesh, jstrategy, tuner=jtuner, trace=jtrace)
    eng = CollectiveEngine(4, Strategy.ring(4), tuner=tuner, trace=trace, num_slices=num_slices)
    rng = np.random.default_rng(3)
    for payload in ((5,), (300,), (4, 64)):
        x = rng.normal(size=(4, 4, *payload)).astype(np.float32)
        for _ in range(3):  # the first dispatch of each shape is its warmup
            got = eng.all_to_all(torch.from_numpy(x))
            want = np.asarray(jeng.all_to_all(jnp.asarray(x)))
        assert np.array_equal(got.numpy(), want)
    assert _cells(tuner.db) == _cells(jtuner.db) and len(_cells(tuner.db)) == 3
    assert {c[4] for c in _cells(tuner.db)} == {"xla" if num_slices == 1 else "two_level"}
    replayed, jreplayed = TuningDatabase(persist=False), JaxDatabase(persist=False)
    assert replay_trace(trace, replayed, 4, topo) == jax_replay(jtrace, jreplayed, 4, topo) == (9, 0)
    assert [c[:-1] for c in _cells(replayed)] == [c[:-1] for c in _cells(jreplayed)]
    assert all(e.extra["duration_s"] > 0 for e in trace.events())


# --------------------------------------------------------------------------- #
# train_moe
# --------------------------------------------------------------------------- #


SMALL = ["--world", "4", "--experts", "4", "--dmodel", "32", "--dhidden", "64", "--batch", "128",
         "--device", "cpu"]


def test_train_moe_trains_and_infers(capsys, monkeypatch):
    from adapcc_tpu_torch.workloads.train_moe import build_parser, run

    monkeypatch.setenv("ADAPCC_TUNER", "off")
    first, last = run(build_parser().parse_args(SMALL + ["--steps", "25", "--classes", "4"]))
    assert last < first * 0.2, (first, last)
    run(build_parser().parse_args(SMALL + ["--mode", "inference", "--steps", "3"]))
    assert "computation time:" in capsys.readouterr().out


def test_train_moe_rejects_indivisible_batch():
    from adapcc_tpu.workloads.train_moe import build_parser as jax_parser
    from adapcc_tpu.workloads.train_moe import run as jax_run

    from adapcc_tpu_torch.workloads.train_moe import build_parser, run

    with pytest.raises(ValueError) as mine:
        run(build_parser().parse_args(["--world", "4", "--batch", "130", "--device", "cpu"]))
    with pytest.raises(ValueError) as theirs:
        jax_run(jax_parser().parse_args(["--world", "4", "--batch", "130"]))
    assert str(mine.value) == str(theirs.value)


def test_train_moe_feeds_the_tuner_under_all_to_all(tmp_path, monkeypatch, capsys):
    from adapcc_tpu.parallel.expert import moe_capacity as jax_capacity
    from adapcc_tpu.tuner.db import size_bucket as jax_bucket

    from adapcc_tpu_torch.tuner import TuningDatabase
    from adapcc_tpu_torch.workloads.train_moe import build_parser, run

    db_path = str(tmp_path / "tuning.jsonl")
    monkeypatch.setenv("ADAPCC_TUNER", "record")
    monkeypatch.setenv("ADAPCC_TUNER_DB", db_path)
    first, last = run(build_parser().parse_args(
        ["--world", "4", "--steps", "9", "--experts", "4", "--dmodel", "16", "--dhidden", "32", "--batch", "64",
         "--tune-every", "3", "--device", "cpu"]))
    assert np.isfinite(first) and np.isfinite(last)
    assert "[tuner] all_to_all" in capsys.readouterr().out
    a2a = [k for k in TuningDatabase(db_path).keys() if k.primitive == "all_to_all"]
    # JAX's test's geometry: world · e_loc · capacity · d_model float32
    jcfg = dataclasses.replace(_jax_cfg(2.0), num_experts=4, d_model=16, d_hidden=32)
    per_rank = 4 * 1 * jax_capacity(jcfg, 64 // 4) * 16 * 4
    assert [k.size_bucket for k in a2a] == [jax_bucket(per_rank)] and a2a[0].path == "xla"
    assert TuningDatabase(db_path).count(a2a[0]) == 2  # 3 probes, the first discarded
