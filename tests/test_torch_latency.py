"""The port's latency plane held against the JAX package's.

- The stacked executors (``rd_allreduce_stacked``, ``tree_allreduce_stacked``,
  the rd halves, the binomial reduce and broadcast) against JAX's
  ``comm/latency.py`` shard functions under ``shard_map`` on the CPU mesh,
  bit for bit, at worlds 2, 4 and 8 (6 for the binomial trees: recursive
  doubling refuses it): a cover of SUM, MAX and AVG, with and without a
  relay, float32 (a column of ``-0.0`` on every rank), int32 and bfloat16,
  payloads the world does not divide, roots 0 and 5.
- The per-rank ``*_shard`` functions at world 4 over gloo (rank 0 here,
  ranks 1-3 in one spawn) against the same JAX rows, bit for bit, on a
  cover of the stacked cases (each kind's inputs, ops and masks once).
- The engine: ``auto``'s pick per size on JAX's own cases and cost model,
  the env over the argument, the loud refusals (rd at world 6 with JAX's
  message, a pinned codec beside a pinned algorithm), the trace.

Workers import only torch: this module imports JAX inside functions.
"""

import functools
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import latency as lat
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace

#: the cover: (kind, input, op, relay masked, root)
BASE_CASES = [
    ("rd", "f32", "SUM", False), ("rd", "f32", "AVG", True), ("rd", "f32", "MAX", True),
    ("rd", "i32", "AVG", False), ("rd", "i32", "SUM", True), ("rd", "bf16", "SUM", False),
    ("rd", "bf16", "AVG", True),
    ("tree", "f32", "SUM", True), ("tree", "f32", "AVG", True), ("tree", "f32", "MAX", False),
    ("tree", "i32", "AVG", True), ("tree", "bf16", "AVG", True),
    ("rs", "rs", "SUM", False), ("rs", "rs", "AVG", True), ("rs", "rs", "MAX", True),
    ("ag", "f32", None, False), ("ag", "i32", None, False),
]
#: rooted binomial cases, once per root
ROOTED_CASES = [("breduce", "f32", "SUM", True), ("breduce", "f32", "MAX", False),
                ("breduce", "i32", "AVG", True), ("breduce", "f32", "AVG", False), ("breduce", "f32", "SUM", False),
                ("bbcast", "f32", None, False)]
WORLDS = (2, 4, 6, 8)
RANK_WORLD = 4


def _cases(world):
    roots = (0, 5) if world > 5 else (0, world - 1)
    cases = [c + (0,) for c in BASE_CASES if world & (world - 1) == 0 or c[0] == "tree"]
    return cases + [c + (root,) for root in roots for c in ROOTED_CASES]


def _relay(world):
    return min(3, world - 1)


def _inputs(world):
    """Seeded numpy inputs by name (float32 data; the int32 and bfloat16
    inputs are cast from it)."""
    rng = np.random.default_rng(world)
    f32 = (rng.normal(size=(world, 1001)) * 5).astype(np.float32)
    f32[:, 0] = -0.0
    return {"f32": f32, "i32": np.round(f32 * 100).astype(np.int32),
            "bf16": (rng.normal(size=(world, 257)) * 3).astype(np.float32),
            "rs": (rng.normal(size=(world, world * 24)) * 5).astype(np.float32)}


def _torch_in(inputs, name):
    x = torch.from_numpy(inputs[name].copy())
    return x.to(torch.bfloat16) if name == "bf16" else x


def _raw(t):
    """A result's raw bits as numpy (bfloat16 as int16)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _jax_rows(world):
    """JAX's stacked results of ``_cases(world)``, one compiled program
    (computed once a process: the per-rank test reads world 4's again)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.comm import latency as jl
    from adapcc_tpu.primitives import ReduceOp as JOp

    inputs = _inputs(world)
    names = ("f32", "i32", "bf16", "rs")
    arrays = [jnp.asarray(inputs["f32"]), jnp.asarray(inputs["i32"]),
              jnp.asarray(inputs["bf16"]).astype(jnp.bfloat16), jnp.asarray(inputs["rs"])]
    mask = jnp.asarray([r != _relay(world) for r in range(world)])
    cases = _cases(world)

    def per_shard(*args):
        xs = dict(zip(names, (a[0] for a in args[:-1])))
        m = args[-1]
        outs = []
        for kind, name, op, masked, root in cases:
            x, jop, mk = xs[name], getattr(JOp, op) if op else None, m if masked else None
            if kind == "rd":
                o = jl.rd_allreduce_shard(x, mk, world, "ranks", op=jop)
            elif kind == "tree":
                o = jl.tree_allreduce_shard(x, mk, world, "ranks", op=jop)
            elif kind == "rs":
                o = jl.rd_reduce_scatter_shard(x, mk, world, "ranks", op=jop)
            elif kind == "ag":
                o = jl.rd_all_gather_shard(x, world, "ranks")
            elif kind == "breduce":
                o = jl.binomial_reduce_shard(x, mk, root, world, "ranks", op=jop)
            else:
                o = jl.binomial_broadcast_shard(x, root, world, "ranks")
            outs.append(o[None])
        return tuple(outs)

    mesh = Mesh(np.array(jax.devices()[:world]), ("ranks",))
    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=(P("ranks"),) * 4 + (P(),),
                               out_specs=tuple(P("ranks") for _ in cases), check_vma=False))
    return [_raw(o) for o in fn(*arrays, mask)]


def _port_stacked(world):
    inputs = _inputs(world)
    mask = torch.tensor([r != _relay(world) for r in range(world)])
    outs = []
    for kind, name, op, masked, root in _cases(world):
        x, rop, mk = _torch_in(inputs, name), getattr(ReduceOp, op) if op else None, mask if masked else None
        if kind == "rd":
            o = lat.rd_allreduce_stacked(x, mk, rop)
        elif kind == "tree":
            o = lat.tree_allreduce_stacked(x, mk, rop)
        elif kind == "rs":
            o = lat.rd_reduce_scatter_stacked(x, mk, rop)
        elif kind == "ag":
            o = lat.rd_all_gather_stacked(x)
        elif kind == "breduce":
            o = lat.binomial_reduce_stacked(x, mk, root, rop)
        else:
            o = lat.binomial_broadcast_stacked(x, root)
        outs.append(_raw(o))
    return outs


def _assert_bits(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


def _assert_rows(world, cases, got, want):
    """Every case bit for bit, but an unmasked AVG at a world that is not a
    power of two: JAX divides by the Python int ``world``, which XLA
    compiles into a multiply by its float32 reciprocal (an ulp off the
    quotient in a third of the elements); the port divides, as JAX op by op
    does and as every engine path does (by the active count, a traced
    value).  There the port is held bit for bit to JAX's own SUM rows
    divided in IEEE float32, and within one ulp of JAX's compiled rows."""
    index = {c: i for i, c in enumerate(cases)}
    for i, case in enumerate(cases):
        kind, name, op, masked, root = case
        if op == "AVG" and not masked and world & (world - 1):
            total = want[index[(kind, name, "SUM", False, root)]]
            _assert_bits(got[i], total / np.float32(world), (world, case, "IEEE quotient"))
            np.testing.assert_array_max_ulp(got[i], want[i], maxulp=1)
        else:
            _assert_bits(got[i], want[i], (world, case))


@pytest.mark.parametrize("world", WORLDS)
def test_stacked_latency_plane_matches_jax_bit_for_bit(world):
    _assert_rows(world, _cases(world), _port_stacked(world), _jax_rows(world))


# --------------------------------------------------------------------------- #
# the per-rank form over gloo
# --------------------------------------------------------------------------- #


def _rank_cases():
    """The per-rank cover: each kind, op, input and mask of ``_cases(4)``
    once (both roots of the rooted kinds), in ``_cases`` order."""
    seen, cases = set(), []
    for case in _cases(RANK_WORLD):
        kind, name, op, masked, root = case
        keys = {(kind, "name", name, root), (kind, "op", op, root), (kind, "masked", masked, root)}
        if not keys <= seen:
            cases.append(case)
            seen |= keys
    return cases


def _rank_results(rank, init_method):
    """This rank's result of every per-rank case, in ``_rank_cases`` order."""
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    world = RANK_WORLD
    build_world_mesh(world, rank=rank, device="cpu", init_method=init_method)
    try:
        inputs = _inputs(world)
        mask = [r != _relay(world) for r in range(world)]
        outs = []
        for kind, name, op, masked, root in _rank_cases():
            x = _torch_in(inputs, name)[rank]
            rop, mk = getattr(ReduceOp, op) if op else None, mask if masked else None
            if kind == "rd":
                o = lat.rd_allreduce_shard(x, mk, world, rop)
            elif kind == "tree":
                o = lat.tree_allreduce_shard(x, mk, world, rop)
            elif kind == "rs":
                o = lat.rd_reduce_scatter_shard(x, mk, world, rop)
            elif kind == "ag":
                o = lat.rd_all_gather_shard(x, world)
            elif kind == "breduce":
                o = lat.binomial_reduce_shard(x, mk, root, world, rop)
            else:
                o = lat.binomial_broadcast_shard(x, root, world)
            outs.append(_raw(o))
        return outs
    finally:
        destroy_world()


def _rank_child(rank, init_method):
    torch.set_num_threads(1)
    return _rank_results(rank, init_method)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_per_rank_latency_plane_over_gloo_matches_jax_bit_for_bit():
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(RANK_WORLD - 1) as pool:
        pending = [pool.apply_async(_rank_child, (r, init_method)) for r in range(1, RANK_WORLD)]
        rows = dict(zip(_cases(RANK_WORLD), _jax_rows(RANK_WORLD)))  # while the workers start
        per_rank = [_rank_results(0, init_method)] + [p.get(timeout=120) for p in pending]
    cases = _rank_cases()
    got = [np.stack([per_rank[r][i] for r in range(RANK_WORLD)]) for i in range(len(cases))]
    _assert_rows(RANK_WORLD, cases, got, [rows[c] for c in cases])


# --------------------------------------------------------------------------- #
# the engine: selection, pins, refusals
# --------------------------------------------------------------------------- #


def _engines(world, mesh, monkeypatch):
    """The port's and JAX's engines over ring(world), each with a tuner in
    off mode on the JAX package's default cost model (the crossover
    ``auto`` reads is then the same number)."""
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.sim.calibrate import load_or_default as jax_defaults
    from adapcc_tpu.strategy.ir import Strategy as JStrategy
    from adapcc_tpu.tuner import CollectiveTuner as JTuner
    from adapcc_tpu.tuner import TuningDatabase as JDb
    from adapcc_tpu.utils.observability import CollectiveTrace as JTrace

    from adapcc_tpu_torch.sim.cost_model import LinkCoeffs, LinkCostModel
    from adapcc_tpu_torch.tuner import CollectiveTuner, TuningDatabase

    monkeypatch.delenv("ADAPCC_TUNER", raising=False)
    jm = jax_defaults(world=world)
    pm = LinkCostModel(world, classes={k: LinkCoeffs(c.alpha, c.beta) for k, c in jm.classes.items()})
    pt = CollectiveTuner(world, "t", db=TuningDatabase(persist=False), mode="off", cost_model=pm)
    jt = JTuner(world, "t", db=JDb(persist=False), mode="off", cost_model=jm)
    port = CollectiveEngine(world, Strategy.ring(world), trace=CollectiveTrace(), tuner=pt)
    ref = JEngine(mesh, JStrategy.ring(world), trace=JTrace(), tuner=jt)
    return port, ref


def test_engine_auto_selects_per_size_like_jax(mesh8, monkeypatch):
    """JAX's ``test_engine_auto_selects_per_size`` cases (1 KB a rank: rd;
    240 KB: the flat plane) on the same cost model pick alike; the rows
    agree (rd bit for bit, the flat sum within its add order)."""
    import jax.numpy as jnp

    port, ref = _engines(8, mesh8, monkeypatch)
    assert port._allreduce_crossover_bytes() == ref._allreduce_crossover_bytes()
    monkeypatch.setenv("ADAPCC_COLL_ALGO", "auto")
    rng = np.random.default_rng(7)
    picks = []
    for n in (256, 60_000):
        x = rng.normal(size=(8, n)).astype(np.float32)
        got, want = port.all_reduce(torch.from_numpy(x)), np.asarray(ref.all_reduce(jnp.asarray(x)))
        pe, je = port.trace.events()[-1], ref.trace.events()[-1]
        picks.append((pe.impl, pe.extra["algo"], je.impl, je.extra["algo"]))
        if pe.impl == "rd":
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert picks == [("rd", "rd", "rd", "rd"), ("torch_fused", "ring", "xla", "ring")]


def test_engine_pins_env_and_refusals_like_jax(mesh8, monkeypatch):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    port, ref = _engines(8, mesh8, monkeypatch)
    x = np.random.default_rng(4).normal(size=(8, 40)).astype(np.float32)
    # the env beats the argument
    monkeypatch.setenv("ADAPCC_COLL_ALGO", "tree")
    got = port.all_reduce(torch.from_numpy(x), algo="ring")
    want = ref.all_reduce(jnp.asarray(x), algo="ring")
    assert port.trace.events()[-1].impl == ref.trace.events()[-1].impl == "tree"
    assert np.array_equal(got.numpy(), np.asarray(want))
    monkeypatch.delenv("ADAPCC_COLL_ALGO")
    # the relay contract through the engine, rd pinned
    got = port.all_reduce(torch.from_numpy(x), algo="rd", active_gpus=[0, 2, 3, 5, 6, 7], op=ReduceOp.AVG)
    from adapcc_tpu.primitives import ReduceOp as JOp

    want = ref.all_reduce(jnp.asarray(x), algo="rd", active_gpus=[0, 2, 3, 5, 6, 7], op=JOp.AVG)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the extras, prepared-plan cache_hit included, are the JAX engine's
    assert port.trace.events()[-1].extra == ref.trace.events()[-1].extra
    # the rd halves through the engine
    xr = torch.from_numpy(x)
    assert np.array_equal(port.reduce_scatter(xr, algo="rd", active_gpus=[1, 2]).numpy(),
                          np.asarray(ref.reduce_scatter(jnp.asarray(x), algo="rd", active_gpus=[1, 2])))
    assert np.array_equal(port.all_gather(xr, [0, 5], algo="rd").numpy(),
                          np.asarray(ref.all_gather(jnp.asarray(x), [0, 5], algo="rd")))
    assert [e.impl for e in port.trace.events()[-2:]] == ["rd", "rd"]
    # two pins in conflict, loud on both sides
    monkeypatch.setenv("ADAPCC_WIRE_DTYPE", "int8")
    for eng, t in ((port, xr), (ref, jnp.asarray(x))):
        with pytest.raises(ValueError, match="no wire-codec plane"):
            eng.ring_allreduce(t, algo="rd")
    monkeypatch.delenv("ADAPCC_WIRE_DTYPE")
    # recursive doubling at world 6: JAX's message; auto stays on the flat plane
    mesh6 = Mesh(np.array(jax.devices()[:6]), ("ranks",))
    port6, ref6 = CollectiveEngine(6, Strategy.ring(6)), JEngine(mesh6, JStrategy.ring(6))
    msgs = []
    for eng, t in ((port6, torch.ones(6, 8)), (ref6, jnp.ones((6, 8)))):
        with pytest.raises(ValueError, match="power-of-two") as err:
            eng.all_reduce(t, algo="rd")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError) as err:
        lat.rd_allreduce_stacked(torch.ones(6, 8), None)
    assert str(err.value) == msgs[0].replace("allreduce algo='rd' cannot run here", "rd_allreduce_shard")
    monkeypatch.setenv("ADAPCC_COLL_ALGO", "auto")
    port6.all_reduce(torch.ones(6, 8))
    assert torch.equal(port6.ring_allreduce(torch.ones(6, 8)), torch.full((6, 8), 6.0))
    monkeypatch.delenv("ADAPCC_COLL_ALGO")
    # the trees run at world 6, where rd cannot
    got = port6.all_reduce(torch.arange(48.0).view(6, 8), algo="tree", op=ReduceOp.MAX)
    assert torch.equal(got, torch.arange(40.0, 48.0).expand(6, 8))


def test_world_one_and_rejections():
    x = torch.arange(6.0).view(1, 6)
    for fn in (lambda: lat.rd_allreduce_stacked(x, None, ReduceOp.AVG), lambda: lat.tree_allreduce_stacked(x, None),
               lambda: lat.binomial_broadcast_stacked(x, 0), lambda: lat.rd_reduce_scatter_stacked(x, None)):
        assert torch.equal(fn(), x)
    assert lat.rd_all_gather_stacked(x).shape == (1, 1, 6)
    with pytest.raises(ValueError, match="must divide the world"):
        lat.rd_reduce_scatter_stacked(torch.ones(4, 6), None)
    with pytest.raises(ValueError, match="root 4 outside world"):
        lat.binomial_reduce_stacked(torch.ones(4, 6), None, 4)
    with pytest.raises(ValueError, match="has no 'tree' variant"):
        CollectiveEngine(4, Strategy.ring(4)).all_gather(torch.ones(4, 2), algo="tree")


def test_latency_pricing_equals_jax_to_the_float():
    """The latency plane's pricing (the rd halves, the allreduce selector,
    the crossover) on a grid of worlds, sizes and coefficients: JAX's
    Python floats, to the float."""
    from adapcc_tpu.sim import cost_model as jcm

    from adapcc_tpu_torch.sim import cost_model as pcm

    for alpha, beta in ((38.861e-6, 1 / 450e9), (1e-6, 1 / 50e9), (5e-6, 0.0), (0.0, 1e-9)):
        pc, jc = pcm.LinkCoeffs(alpha, beta), jcm.LinkCoeffs(alpha, beta)
        for world in (2, 4, 6, 8, 64):
            assert pcm.allreduce_crossover_bytes(world, pc) == jcm.allreduce_crossover_bytes(world, jc)
            for n in (4, 4096, 65536, 1 << 20, 4 << 20, 1 << 30):
                for fn in ("recursive_halving_reduce_scatter_time", "recursive_doubling_all_gather_time",
                           "recursive_doubling_allreduce_time", "binomial_tree_time"):
                    assert getattr(pcm, fn)(world, n, pc) == getattr(jcm, fn)(world, n, jc), (fn, world, n)
                assert pcm.choose_allreduce_algo(world, n, pc) == jcm.choose_allreduce_algo(world, n, jc)
                assert pcm.choose_allreduce_algo(world, n, pc, ("tree", "rd")) == \
                    jcm.choose_allreduce_algo(world, n, jc, ("tree", "rd"))
    assert pcm.COLL_ALGO_CANDIDATES == jcm.COLL_ALGO_CANDIDATES
    with pytest.raises(ValueError, match="unknown algorithm"):
        pcm.choose_allreduce_algo(4, 8, pcm.LinkCoeffs(1, 1), ("ring", "ir"))
