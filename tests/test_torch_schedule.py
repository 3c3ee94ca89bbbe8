"""The port's strategy-tree ("schedule") plane held against the JAX engine's.

- The stacked :class:`CollectiveEngine` against the JAX ``CollectiveEngine``
  on the CPU mesh, bit for bit, for all six primitives: a cover of
  strategies (a merged segmented ring, merged binary trees, one tree, the
  two-host world-8 strategy, skewed MILP shares, ``ADAPCC_MERGE_ROUNDS=0``)
  × ops (SUM, AVG, MAX) × masks (none, one relay, a relay root) × dtypes
  (float32, bfloat16, int32) on payloads the trees do not divide, with a
  column of ``-0.0`` on every rank (the unmerged SUM path turns it to
  ``+0.0`` where a rank is no destination of a round).
- The fused fast paths against JAX's XLA collectives: a float sum may add
  in another order, so float32 sums are held within 1e-5 absolute (a few
  float32 ulps of partial sums below 32 in magnitude); integers, MAX and
  the data movements bit for bit.
- The per-rank ``*_shard`` functions at world 4 over gloo (rank 0 here,
  ranks 1-3 in spawned workers) bit for bit against the stacked results,
  and the hook's bucketed schedule plane against the stacked engine.

Workers import only torch: this module imports JAX inside functions.
"""

import multiprocessing
import pathlib
import socket
import warnings

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import engine
from adapcc_tpu_torch.comm.engine import CollectiveEngine, EpochMismatch
from adapcc_tpu_torch.ddp.hook import GradSyncHook
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace
from adapcc_tpu_torch.strategy.xml_io import parse_strategy_xml
from test_torch_ring import trace_rows

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "strategy"
#: float32 fast-path sums against XLA's psum: the order of the adds differs
FAST_ATOL = 1e-5

#: strategy cases by id: (world, builder and its arguments or a fixture,
#: MILP shares, ADAPCC_MERGE_ROUNDS)
STRATEGIES = {
    "ring4x4-merged": (4, ("ring", 4, 4), None, None),
    "binary4x2-merged": (4, ("binary", 4, 2), None, None),
    "4xml-one-tree": (4, "4.xml", None, None),
    "4-4_1xml-two-hosts": (8, "4-4_1.xml", None, None),
    "milp-skewed-shares": (4, ("ring", 4, 2), [0.7, 0.3], None),
    "ring4x4-merge-off": (4, ("ring", 4, 4), None, "0"),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _strategy(spec, shares, pkg):
    """The port's (``pkg="torch"``) or the JAX package's strategy."""
    if pkg == "torch":
        from adapcc_tpu_torch.strategy import ir, xml_io
    else:
        from adapcc_tpu.strategy import ir, xml_io
    if isinstance(spec, str):
        s = xml_io.parse_strategy_xml(str(FIXTURES / spec))
    else:
        s = getattr(ir.Strategy, spec[0])(spec[1], spec[2])
    if shares is not None:
        s = ir.Strategy(s.trees, s.world_size, shares=list(shares))
    return s


def _payload(world, shape, dtype, seed):
    """Seeded numpy float32 data, a column of -0.0 on every rank."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(world, *shape)) * 5).astype(np.float32)
    x.reshape(world, -1)[:, 0] = -0.0
    if dtype == "int32":
        x = np.round(x * 1000)
    return x


def _to_jax(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(_DTYPES[dtype])


def _bits(a):
    """A result as (dtype name, shape, raw bits)."""
    if isinstance(a, torch.Tensor):
        name = str(a.dtype).removeprefix("torch.")
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        arr = a.numpy()
    else:
        arr = np.asarray(a)
        name = str(arr.dtype)
        if name == "bfloat16":
            arr = arr.view(np.int16)
    return name, arr.shape, arr.view(np.uint8 if arr.dtype.itemsize == 1 else f"u{arr.dtype.itemsize}").tobytes()


def _masks(world, roots):
    """Active sets: everyone implicitly, one relay (a rank that roots no
    tree, where there is one), a relay root, everyone explicitly."""
    relay = next((r for r in range(world - 1, -1, -1) if r not in roots), world - 1)
    root = sorted(roots)[0]
    return {"none": None, "relay": [r for r in range(world) if r != relay],
            "root-relay": [r for r in range(world) if r != root], "all": list(range(world))}


#: the cover per strategy: (primitive, dtype, op, mask kind, payload shape)
COVER = [
    ("all_reduce", "float32", "SUM", "none", (7, 143)),
    ("all_reduce", "bfloat16", "AVG", "relay", (1001,)),
    ("all_reduce", "int32", "AVG", "root-relay", (3, 7, 11)),
    ("all_reduce", "float32", "MAX", "relay", (1001,)),
    ("all_reduce", "float32", "SUM", "all", (3,)),
    ("reduce", "float32", "AVG", "relay", (7, 143)),
    ("reduce", "int32", "MAX", "none", (1001,)),
    ("reduce", "bfloat16", "SUM", "root-relay", (1001,)),
    ("broadcast", "float32", "-", "none", (7, 143)),
    ("broadcast", "int32", "-", "all", (1001,)),
]


@pytest.mark.parametrize("case", list(STRATEGIES))
def test_stacked_schedule_plane_matches_jax_bit_for_bit(case, mesh4, mesh8, monkeypatch):
    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.primitives import ReduceOp as JaxOp

    world, spec, shares, merge = STRATEGIES[case]
    if merge is not None:
        monkeypatch.setenv("ADAPCC_MERGE_ROUNDS", merge)
    port_s, ref_s = _strategy(spec, shares, "torch"), _strategy(spec, shares, "jax")
    trace = CollectiveTrace()
    port = CollectiveEngine(world, port_s, trace=trace, use_xla_fastpath=False)
    ref = JaxEngine(mesh4 if world == 4 else mesh8, ref_s, use_xla_fastpath=False)
    merged = engine._merged_plan(port_s) is not None
    masks = _masks(world, {t.root for t in port_s.trees})
    for i, (prim, dtype, op, mask_kind, shape) in enumerate(COVER):
        x = _payload(world, shape, dtype, seed=i)
        active = masks[mask_kind]
        if prim == "broadcast":
            got, want = port.broadcast(_to_torch(x, dtype), active), ref.broadcast(_to_jax(x, dtype), active)
        else:
            kw = {"active_gpus": active}
            got = getattr(port, prim)(_to_torch(x, dtype), op=getattr(ReduceOp, op), **kw)
            want = getattr(ref, prim)(_to_jax(x, dtype), op=getattr(JaxOp, op), **kw)
        assert _bits(got) == _bits(want), (case, prim, dtype, op, mask_kind)
        rec = trace_rows(trace)[-1]
        assert rec["impl"] == "schedule" and rec["merged"] is merged
    # a root left out of a broadcast's active set raises in both
    with pytest.raises(ValueError, match="broadcast roots"):
        port.broadcast(_to_torch(_payload(world, (5,), "float32", 0), "float32"), masks["root-relay"])
    with pytest.raises(ValueError, match="broadcast roots"):
        ref.broadcast(_to_jax(_payload(world, (5,), "float32", 0), "float32"), masks["root-relay"])


def test_fused_fast_paths_and_flat_primitives_match_jax(mesh4):
    """Unmasked ``all_reduce``/``reduce``/``broadcast`` with the fast path
    allowed, and ``all_gather``, ``all_to_all``, ``reduce_scatter``."""
    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.primitives import ReduceOp as JaxOp

    trace = CollectiveTrace()
    port = CollectiveEngine(4, _strategy(("binary", 4, 2), None, "torch"), trace=trace)
    ref = JaxEngine(mesh4, _strategy(("binary", 4, 2), None, "jax"))

    def check(got, want, exact):
        if exact:
            assert _bits(got) == _bits(want)
        else:
            assert str(got.dtype).removeprefix("torch.") == str(np.asarray(want).dtype)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FAST_ATOL)

    for i, (dtype, op) in enumerate([("float32", "SUM"), ("float32", "AVG"), ("float32", "MAX"),
                                     ("int32", "SUM"), ("int32", "AVG")]):
        x = _payload(4, (7, 143), dtype, seed=10 + i)
        exact = dtype == "int32" or op == "MAX"
        for prim in ("all_reduce", "reduce"):
            check(getattr(port, prim)(_to_torch(x, dtype), op=getattr(ReduceOp, op)),
                  getattr(ref, prim)(_to_jax(x, dtype), op=getattr(JaxOp, op)), exact)
            assert trace_rows(trace)[-1]["impl"] == "torch_fused"
    for dtype in ("float32", "bfloat16", "int32"):
        x = _payload(4, (1001,), dtype, seed=20)
        check(port.broadcast(_to_torch(x, dtype)), ref.broadcast(_to_jax(x, dtype)), True)
        a2a = _payload(4, (4, 3, 5), dtype, seed=21)
        for active in (None, [0, 1, 3]):
            check(port.all_gather(_to_torch(x, dtype), active), ref.all_gather(_to_jax(x, dtype), active), True)
            check(port.all_to_all(_to_torch(a2a, dtype), active), ref.all_to_all(_to_jax(a2a, dtype), active), True)
    assert trace_rows(trace)[-1]["impl"] == "torch_flat"
    assert torch.equal(port.all_to_all(_to_torch(a2a, "int32")), _to_torch(a2a, "int32").transpose(0, 1))
    for i, (dtype, op, active) in enumerate([("float32", "SUM", None), ("float32", "AVG", [0, 2, 3]),
                                             ("float32", "AVG", None), ("int32", "SUM", [1, 2]),
                                             ("int32", "AVG", None)]):
        x = _payload(4, (6, 34), dtype, seed=30 + i)
        check(port.reduce_scatter(_to_torch(x, dtype), active_gpus=active, op=getattr(ReduceOp, op)),
              ref.reduce_scatter(_to_jax(x, dtype), active_gpus=active, op=getattr(JaxOp, op)),
              dtype == "int32")
    x = _payload(4, (10,), "float32", 40)
    for eng, tensor, op in ((port, _to_torch(x, "float32"), ReduceOp), (ref, _to_jax(x, "float32"), JaxOp)):
        with pytest.raises(ValueError, match="SUM/AVG"):
            eng.reduce_scatter(tensor, op=op.MAX)
        with pytest.raises(ValueError, match="must divide the world"):
            eng.reduce_scatter(tensor[:, :9])
        with pytest.raises(ValueError, match=r"\[world, world"):
            eng.all_to_all(tensor)


def test_engine_contract_epochs_pins_and_trace(monkeypatch):
    """Keyword-only options, epochs, algorithm pins that wait for their
    slices, the merge knob, the deprecated spelling and the trace."""
    trace = CollectiveTrace()
    eng = CollectiveEngine(4, Strategy.ring(4, 4), trace=trace)
    x = torch.arange(8.0).view(4, 2)
    with pytest.raises(TypeError):
        eng.all_reduce(x, ReduceOp.AVG)
    with pytest.raises(ValueError, match="outside world"):
        eng.all_reduce(x, active_gpus=[4])
    with pytest.raises(ValueError, match="leading dim"):
        eng.reduce(x[:3])
    assert eng.advance_epoch() == 1
    with pytest.raises(EpochMismatch, match="dead epoch 0"):
        eng.all_reduce(x, epoch=0)
    eng.all_reduce(x, epoch=1, active_gpus=[0, 1])
    # the first dispatch at its key prepares the plan: no cache hit
    assert trace_rows(trace)[-1] == {"primitive": "allreduce", "impl": "schedule", "epoch": 1, "nbytes": 32,
                                     "algo": "ring", "merged": True, "cache_hit": False}
    assert eng.advance_epoch(Strategy.binary(4)) == 2 and eng.strategy.synthesis == "binary"
    eng.all_reduce(x, active_gpus=[0, 1])
    assert trace_rows(trace)[-1]["merged"] is False
    with pytest.raises(ValueError, match="standby strategy world"):
        eng.advance_epoch(Strategy.ring(2))
    eng.clear()
    x4 = torch.arange(16.0).view(4, 4)
    # the IR plane runs the strategy's program (tests/test_torch_compiler.py
    # holds its bits); the latency plane runs by pin, and a pin it cannot run
    # raises (tests/test_torch_latency.py holds its bits)
    assert torch.equal(eng.all_reduce(x4, algo="ir"), x4.sum(0).expand(4, 4))
    assert trace_rows(trace)[-1]["impl"] == "ir"
    with pytest.raises(ValueError, match="has no 'tree' variant"):
        eng.reduce_scatter(x4, algo="tree")
    eng.all_gather(x4, algo="rd")
    assert trace_rows(trace)[-1]["impl"] == "rd"
    monkeypatch.setenv("ADAPCC_COLL_ALGO", "rdx")
    with pytest.raises(ValueError, match="expected one of"):
        eng.all_gather(x)
    monkeypatch.delenv("ADAPCC_COLL_ALGO")
    monkeypatch.setenv("ADAPCC_MERGE_ROUNDS", "maybe")
    with pytest.raises(ValueError, match="ADAPCC_MERGE_ROUNDS"):
        CollectiveEngine(4, Strategy.ring(4))
    monkeypatch.delenv("ADAPCC_MERGE_ROUNDS")
    monkeypatch.setattr(engine, "_BOARDCAST_WARNED", False)
    with pytest.warns(DeprecationWarning, match="boardcast"):
        a = eng.boardcast(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(eng.boardcast(x), a)
    # the engine is functional: inputs are left as they were
    y = x.clone()
    eng.all_reduce(y, active_gpus=[1, 2], op=ReduceOp.MAX)
    eng.reduce(y, active_gpus=[1, 2])
    assert torch.equal(y, x)
    # the ring plane still takes the old positional form
    assert CollectiveEngine(4, Strategy.ring(4)).ring_allreduce(x).shape == x.shape


# --------------------------------------------------------------------------- #
# the per-rank form over gloo
# --------------------------------------------------------------------------- #

WORLD = 4
#: per-rank cases: (strategy spec, shares)
RANK_STRATEGIES = [(("ring", 4, 4), None), (("binary", 4, 2), None), ("4.xml", None), (("ring", 4, 2), [0.7, 0.3])]
#: (dtype, op, active ranks) per strategy, a cover
RANK_COVER = [("float32", "SUM", [0, 1, 2, 3]), ("float32", "AVG", [0, 1, 3]), ("bfloat16", "AVG", [1, 2, 3]),
              ("int32", "MAX", [0, 2]), ("int32", "AVG", [0, 1, 2, 3])]
#: a two-host strategy at world 4: the hook resolves it to the schedule plane
HOOK_IPS = {0: "h0", 1: "h0", 2: "h1", 3: "h1"}


def _hook_grads(rank):
    g = torch.Generator().manual_seed(100 + rank)
    return [torch.randn(3, 5, generator=g), torch.randn(7, generator=g), torch.randn(2, 2, generator=g)]


def _rank_results(rank, init_method):
    """Every per-rank call of this rank, in a fixed order."""
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    build_world_mesh(WORLD, rank=rank, device="cpu", init_method=init_method)
    try:
        out = []
        for si, (spec, shares) in enumerate(RANK_STRATEGIES):
            s = _strategy(spec, shares, "torch")
            for ci, (dtype, op, active) in enumerate(RANK_COVER):
                x = _to_torch(_payload(WORLD, (1001,), dtype, seed=50 + ci)[rank], dtype)
                mask = [r in active for r in range(WORLD)]
                out.append(engine.allreduce_shard(x.clone(), mask, s, getattr(ReduceOp, op)))
                out.append(engine.reduce_shard(x.clone(), mask, s, getattr(ReduceOp, op)))
            x = _to_torch(_payload(WORLD, (1001,), "float32", seed=60 + si)[rank], "float32")
            out.append(engine.broadcast_shard(x, s))
            out.append(engine.broadcast_fastpath_shard(x, s))
            out.append(engine.reduce_fastpath_shard(x, s, ReduceOp.SUM))
            out.append(engine.reduce_fastpath_shard(x.to(torch.int32), s, ReduceOp.AVG))
        hook = GradSyncHook(Strategy.ring(WORLD, 2, HOOK_IPS), bucket_cap_mb=60 / 2**20)
        grads = _hook_grads(rank)
        out.extend(hook.sync(grads, torch.tensor([True, False, True, True])))
        out.append(torch.tensor(hook.recorded_buckets))
        return [t.numpy() if t.dtype != torch.bfloat16 else t.view(torch.int16).numpy() for t in out]
    finally:
        destroy_world()


def _rank_child(rank, init_method):
    torch.set_num_threads(1)
    return _rank_results(rank, init_method)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stacked_wants():
    """The stacked engine's results in ``_rank_results``'s order, and
    whether each is held bit for bit."""
    wants = []
    for si, (spec, shares) in enumerate(RANK_STRATEGIES):
        s = _strategy(spec, shares, "torch")
        sched, fast = CollectiveEngine(WORLD, s, use_xla_fastpath=False), CollectiveEngine(WORLD, s)
        for ci, (dtype, op, active) in enumerate(RANK_COVER):
            x = _to_torch(_payload(WORLD, (1001,), dtype, seed=50 + ci), dtype)
            wants.append((sched.all_reduce(x, active_gpus=active, op=getattr(ReduceOp, op)), True))
            wants.append((sched.reduce(x, active_gpus=active, op=getattr(ReduceOp, op)), True))
        x = _to_torch(_payload(WORLD, (1001,), "float32", seed=60 + si), "float32")
        wants += [(sched.broadcast(x), True), (fast.broadcast(x), True), (fast.reduce(x), False),
                  (fast.reduce(x.to(torch.int32), op=ReduceOp.AVG), True)]
    return wants


def test_per_rank_schedule_plane_over_gloo_matches_the_stacked_engine():
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(WORLD - 1) as pool:
        pending = [pool.apply_async(_rank_child, (r, init_method)) for r in range(1, WORLD)]
        per_rank = [_rank_results(0, init_method)] + [p.get(timeout=120) for p in pending]
    wants = _stacked_wants()
    for i, (want, exact) in enumerate(wants):
        got = np.stack([per_rank[r][i] for r in range(WORLD)])
        if want.dtype == torch.bfloat16:
            want = want.view(torch.int16)
        if exact:
            assert got.dtype == want.numpy().dtype and np.array_equal(got.view(np.uint8), want.numpy().view(np.uint8)), i
        else:  # gloo's sum may add in another order than torch.sum over the rows
            np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=FAST_ATOL)
    # the hook: its buckets through the stacked engine, leaf by leaf
    plan = per_rank[0][-1]
    # filled in reverse leaf order: the 2x2 and 7 leaves (44 bytes), then 3x5
    assert plan.tolist() == [[11, 11], [15, 15]]
    eng = CollectiveEngine(WORLD, Strategy.ring(WORLD, 2, HOOK_IPS), use_xla_fastpath=False)
    grads = [_hook_grads(r) for r in range(WORLD)]
    buckets = [torch.stack([torch.cat([g[1], g[2].reshape(-1)]) for g in grads]),
               torch.stack([g[0].reshape(-1) for g in grads])]
    synced = [eng.all_reduce(b, active_gpus=[0, 2, 3], op=ReduceOp.AVG) for b in buckets]
    for r in range(WORLD):
        got = per_rank[r][len(wants):len(wants) + 3]
        assert np.array_equal(got[0].reshape(-1), synced[1][r].numpy())
        assert np.array_equal(np.concatenate([got[1], got[2].reshape(-1)]), synced[0][r].numpy())


def test_hook_resolves_the_two_host_fixture_to_the_schedule_plane():
    """``4-4_1.xml`` spans hosts h0 and h1: ``mode="auto"`` resolves to the
    bucketed schedule plane (a world-1 group runs the plane in full with the
    one-rank strategy), and what still waits raises."""
    from adapcc_tpu.ddp.hook import GradSyncHook as JaxHook
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jax_parse

    path = str(FIXTURES / "4-4_1.xml")
    assert GradSyncHook(parse_strategy_xml(path))._resolved_mode() == "schedule" == JaxHook(
        jax_parse(path))._resolved_mode()
    # the observability sinks run now (tests/test_torch_tuner.py)
    trace = CollectiveTrace()
    assert GradSyncHook(parse_strategy_xml(path), trace=trace)._trace is trace
    hook = GradSyncHook(Strategy.ring(1, ips={0: "a"}), mode="schedule", bucket_cap_mb=1e-5)
    with pytest.raises(ValueError, match="no recorded bucket plan"):
        hook.resolved_chunk_bytes()
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    build_world_mesh(1, device="cpu")
    try:
        grads = [torch.full((4,), -0.0), torch.arange(6.0).view(2, 3)]
        want = [g.clone() for g in grads]
        out = hook.sync(grads, None, transposed=[False, True], order=[1, 0])
        assert out is grads and all(torch.equal(a, b) for a, b in zip(grads, want))
        assert hook.recorded_buckets == [(4, 4), (6, 6)]
        assert hook.resolved_chunk_bytes() == [4, 6]
        hook.reset_plan()
        assert hook.recorded_buckets == []
    finally:
        destroy_world()
