"""The port's overlapped sync, gradient accumulation and ZeRO-1's non-ring
path held against the JAX package's.

- ``resolve_overlap_mode``, ``even_chunk_bounds`` and ``overlap_chunk_count``
  against JAX's, case by case;
- the per-rank chunked entry points (``chunked_allreduce_shard``,
  ``chunked_psum_shard``) at world 4 over gloo (rank 0 here, ranks 1-3 in
  spawned workers) against JAX's under ``shard_map`` on the 4-device CPU
  mesh, bit for bit, with the number of chunk dispatches;
- ``DDPTrainer`` at world 1 with ``accum_steps=2`` under each overlap mode
  against the JAX trainer (losses and parameters at ``test_torch_ddp.py``'s
  tolerances); in the port, "off", "bucket" and (one rank: the sync is the
  identity) "microbatch" give the same bits;
- the trainer's and ``Zero1Optimizer``'s refusals with JAX's messages;
- ZeRO-1 without the ring at world 4 against JAX's
  ``Zero1Optimizer(ring=False)``, unchunked and in ragged chunks.

The workers import only torch: JAX is imported inside the functions that
build the reference.
"""

import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import engine
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.ddp import overlap
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer, zero1_train_step
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy
from test_torch_ddp import LOSS_ATOL, LR, STEPS, TINY, _assert_params_close, _flax_params, _tokens

WORLD = 4
ACCUM = 2
#: the JAX package's microbatch-overlap parity bound (tests/test_overlap.py)
MICROBATCH_RTOL = 2e-5
MICROBATCH_ATOL = 1e-6


# --------------------------------------------------------------------------- #
# the host-side tables, case by case against JAX's
# --------------------------------------------------------------------------- #


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("env, arg", [
    (None, None), (None, "off"), (None, "bucket"), (None, "microbatch"), ("microbatch", "bucket"),
    (" Bucket ", "off"), ("", "bucket"), ("bucketed", "off"), (None, "rolling"),
])
def test_resolve_overlap_mode_matches_jax(monkeypatch, env, arg):
    from adapcc_tpu.ddp.overlap import resolve_overlap_mode as jax_resolve

    if env is None:
        monkeypatch.delenv(overlap.OVERLAP_ENV, raising=False)
    else:
        monkeypatch.setenv(overlap.OVERLAP_ENV, env)
    assert _outcome(lambda: overlap.resolve_overlap_mode(arg)) == _outcome(lambda: jax_resolve(arg))


@pytest.mark.parametrize("total, n", [(10, 3), (8, 8), (7, 20), (0, 4), (5, 1), (42_103_045, 41), (-1, 2)])
def test_even_chunk_bounds_matches_jax(total, n):
    from adapcc_tpu.ddp.overlap import even_chunk_bounds as jax_bounds

    assert _outcome(lambda: overlap.even_chunk_bounds(total, n)) == _outcome(lambda: jax_bounds(total, n))


@pytest.mark.parametrize("nbytes, chunk_bytes, env", [
    (0, None, None), (1, None, None), (4 << 20, None, None), ((4 << 20) + 1, None, None),
    (168_412_180, None, None), (1000, 256, None), (1000, 256, "300"), (1000, None, "0"), (1000, -4, None),
])
def test_overlap_chunk_count_matches_jax(monkeypatch, nbytes, chunk_bytes, env):
    from adapcc_tpu.ddp.overlap import overlap_chunk_count as jax_count

    if env is None:
        monkeypatch.delenv("ADAPCC_RING_CHUNK_BYTES", raising=False)
    else:
        monkeypatch.setenv("ADAPCC_RING_CHUNK_BYTES", env)
    got = _outcome(lambda: overlap.overlap_chunk_count(nbytes, chunk_bytes))
    assert got == _outcome(lambda: jax_count(nbytes, chunk_bytes))
    assert got[0] == "ok" or (env, chunk_bytes) != (None, None)


# --------------------------------------------------------------------------- #
# the chunked entry points per rank over gloo, against JAX under shard_map
# --------------------------------------------------------------------------- #

#: (plane, strategy, op, dtype, active mask or None, elements a rank,
#: chunk_bytes, ADAPCC_RING_CHUNK_BYTES or None).  The schedule plane adds
#: in its own rounds, so it holds its bits at world 4.  A flat float sum over
#: gloo (or NCCL) at world >= 3 adds an element in an order that depends on
#: its offset in the buffer, so chunking moves bits there; at world 2 an add
#: of two commutes, so the psum plane's float cases run on ranks 0 and 1
#: (mask and world of 2), its integer cases at world 4.
CHUNK_CASES = [
    ("schedule", "binary", "SUM", "float32", [1, 1, 0, 1], 999, 512, None),     # relay, two trees, ragged
    ("schedule", "binary", "AVG", "float32", [1, 1, 1, 1], 1000, 1024, None),
    ("schedule", "ring2", "AVG", "int32", [1, 0, 1, 1], 777, 256, None),         # integer AVG -> float32
    ("schedule", "ring", "MAX", "float32", [1, 1, 1, 0], 515, 256, None),
    ("schedule", "ring", "SUM", "float32", [1, 1, 1, 1], 1024, 256, "2048"),    # the env wins
    ("schedule", "binary", "SUM", "float32", [1, 0, 1, 1], 100, 1 << 20, None),  # one chunk: allreduce_shard
    ("psum", None, "SUM", "float32", None, 1001, 256, None),                    # the static full world
    ("psum", None, "AVG", "float32", [1, 0], 1001, 512, None),
    ("psum", None, "AVG", "float32", None, 1000, 256, "1024"),
    ("psum", None, "AVG", "int32", [1, 0, 1, 1], 999, 400, None),
    ("psum", None, "SUM", "int32", None, 1001, 256, None),
]


def _case_world(case):
    plane, _, _, dtype, *_ = case
    return 2 if plane == "psum" and dtype != "int32" else WORLD


def _chunk_strategy(spec, flavour):
    if flavour == "torch":
        from adapcc_tpu_torch.strategy.ir import Strategy as S
    else:
        from adapcc_tpu.strategy.ir import Strategy as S
    return {"binary": lambda: S.binary(WORLD, 2), "ring2": lambda: S.ring(WORLD, 2),
            "ring": lambda: S.ring(WORLD)}[spec]()


def _chunk_payload(i, dtype, n, world):
    rng = np.random.default_rng(100 + i)
    if dtype == "int32":
        return rng.integers(-50, 50, size=(world, n)).astype(np.int32)
    x = rng.normal(size=(world, n)).astype(np.float32)
    x[:, ::97] = -0.0  # signed zeros ride the +0.0 pass of an unmerged tree
    return x


def _chunk_rank(rank, init_method):
    """This rank's results over ``CHUNK_CASES``: per case the chunked result,
    the result through ``async_op=True``, the unchunked entry point's, and
    the chunk dispatches (tree chunks or flat all_reduces)."""
    build_world_mesh(WORLD, rank=rank, device="cpu", init_method=init_method)
    pair = torch.distributed.new_group([0, 1])
    calls = []
    inner = engine._tree_allreduce_chunk
    engine._tree_allreduce_chunk = lambda seg, *a: (calls.append(seg.numel()), inner(seg, *a))[1]
    try:
        out = []
        for i, (plane, spec, op, dtype, mask, n, cb, env) in enumerate(CHUNK_CASES):
            world = _case_world(CHUNK_CASES[i])
            if rank >= world:
                out.append(None)
                continue
            group = pair if world == 2 else None
            x = torch.from_numpy(_chunk_payload(i, dtype, n, world)[rank].copy())
            op = getattr(ReduceOp, op)
            mask_t = None if mask is None else torch.tensor(mask, dtype=torch.bool)
            if env is not None:
                os.environ["ADAPCC_RING_CHUNK_BYTES"] = env
            try:
                calls.clear()
                if plane == "schedule":
                    s = _chunk_strategy(spec, "torch")
                    got = engine.chunked_allreduce_shard(x, mask_t, s, op, chunk_bytes=cb)
                    dispatches = list(calls)
                    pending = engine.chunked_allreduce_shard(x, mask_t, s, op, chunk_bytes=cb, async_op=True)
                    whole = engine.allreduce_shard(x, mask_t, s, op)
                else:
                    got = engine.chunked_psum_shard(x.clone(), mask_t, op, chunk_bytes=cb, world=world, group=group)
                    pending = engine.chunked_psum_shard(x.clone(), mask_t, op, chunk_bytes=cb, world=world,
                                                        group=group, async_op=True)
                    dispatches = len(pending._works)
                    whole = (engine.allreduce(x.clone(), op, group) if mask_t is None
                             else engine.masked_psum_shard(x.clone(), mask_t, op, group))
            finally:
                os.environ.pop("ADAPCC_RING_CHUNK_BYTES", None)
            out.append((got.numpy(), pending.wait().numpy(), whole.numpy(), dispatches))
        return out
    finally:
        engine._tree_allreduce_chunk = inner
        destroy_world()


def _chunk_child(rank, init_method):
    torch.set_num_threads(1)
    return _chunk_rank(rank, init_method)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_chunked(monkeypatch):
    """JAX's results over ``CHUNK_CASES``, stacked ``[world, n]``, and the
    schedule plane's chunk dispatches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    import adapcc_tpu.comm.engine as jeng
    from adapcc_tpu.primitives import ReduceOp as JaxReduceOp

    calls = []
    inner = jeng._tree_allreduce_chunk
    monkeypatch.setattr(jeng, "_tree_allreduce_chunk",
                        lambda seg, *a, **kw: (calls.append(int(seg.size)), inner(seg, *a, **kw))[1])
    refs = []
    for i, (plane, spec, op, dtype, mask, n, cb, env) in enumerate(CHUNK_CASES):
        world = _case_world(CHUNK_CASES[i])
        mesh = Mesh(jax.devices()[:world], ("ranks",))
        op = getattr(JaxReduceOp, op)
        if env is None:
            monkeypatch.delenv("ADAPCC_RING_CHUNK_BYTES", raising=False)
        else:
            monkeypatch.setenv("ADAPCC_RING_CHUNK_BYTES", env)
        if plane == "schedule":
            s = _chunk_strategy(spec, "jax")

            def body(t, m, s=s, op=op, cb=cb):
                return jeng.chunked_allreduce_shard(t[0], m, s, op=op, chunk_bytes=cb)[None]
        else:
            def body(t, m, op=op, cb=cb, masked=mask is not None, world=world):
                return jeng.chunked_psum_shard(t[0], m if masked else None, op=op, chunk_bytes=cb,
                                               world=world)[None]
        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("ranks"), P()), out_specs=P("ranks"),
                                   check_vma=False))
        calls.clear()
        m = jnp.asarray([True] * world if mask is None else [bool(v) for v in mask])
        refs.append((np.asarray(fn(jnp.asarray(_chunk_payload(i, dtype, n, world)), m)), list(calls)))
    monkeypatch.delenv("ADAPCC_RING_CHUNK_BYTES", raising=False)
    return refs


def test_chunked_entry_points_over_gloo_match_jax_bit_for_bit(monkeypatch):
    monkeypatch.delenv("ADAPCC_RING_CHUNK_BYTES", raising=False)
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(WORLD - 1) as pool:
        pending = [pool.apply_async(_chunk_child, (r, init_method)) for r in range(1, WORLD)]
        refs = _jax_chunked(monkeypatch)
        per_rank = [_chunk_rank(0, init_method)] + [p.get(timeout=120) for p in pending]
    for i, (case, (want, jax_calls)) in enumerate(zip(CHUNK_CASES, refs)):
        plane, _, _, _, mask, n, cb, env = case
        world = _case_world(case)
        x = _chunk_payload(i, case[3], n, world)
        for rank in range(world):
            got, waited, whole, dispatches = per_rank[rank][i]
            for name, arr in (("chunked", got), ("async", waited), ("unchunked", whole)):
                assert arr.dtype == want.dtype and np.array_equal(arr, want[rank]), f"case {i} {case} rank {rank}: {name}"
                differ = np.flatnonzero(arr.view(np.uint32) != want[rank].view(np.uint32))
                if plane == "psum" and mask is None:
                    # the one difference of the flat plane: a sum of nothing but
                    # -0.0 is -0.0 over gloo and +0.0 in JAX's psum
                    assert (x[:, differ] == 0).all() and np.signbit(x[:, differ]).all(), (i, name, differ)
                    assert np.signbit(arr[differ]).all() and not np.signbit(want[rank][differ]).any()
                else:
                    assert differ.size == 0, f"case {i} {case} rank {rank}: {name} bits at {differ[:5]}"
            # the chunked result is the unchunked one bit for bit
            assert np.array_equal(got.view(np.uint8), whole.view(np.uint8)), (i, rank)
            if plane == "schedule":
                assert dispatches == jax_calls, (i, dispatches, jax_calls)  # tree chunks, in order
            else:  # one all_reduce a chunk of 4-byte elements
                assert dispatches == len(engine._chunk_bounds(n, int(env or cb) // 4)), (i, dispatches)
    # chunking happened where it should: ragged tails, and the env's size
    assert refs[0][1][-1] != refs[0][1][0] and refs[4][1] == [512, 512]
    assert refs[5][1] == []  # one chunk falls through to allreduce_shard


# --------------------------------------------------------------------------- #
# DDPTrainer: accumulation under each overlap mode, at world 1
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def flax_params():
    return _flax_params()


@pytest.fixture
def world1():
    world = build_world_mesh(1, device="cpu")
    yield world
    destroy_world()


def _jax_accum(params, tokens, **trainer_kw):
    """The JAX world-1 trainer: per-step losses and the final params."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.ddp import DDPTrainer as JaxDDPTrainer
    from adapcc_tpu.ddp import TrainState as JaxTrainState
    from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from adapcc_tpu.models.gpt2 import lm_loss as jax_lm_loss
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32, attention="xla"))
    mesh = Mesh(jax.devices()[:1], ("ranks",))
    trainer = JaxDDPTrainer(lambda p, b: jax_lm_loss(model.apply(p, b), b), optax.adamw(LR), mesh,
                            JaxStrategy.ring(1), **trainer_kw)
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    state = jax.device_put(JaxTrainState.create(params, trainer.tx), NamedSharding(mesh, P()))
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.step(state, batch)
        losses.append(float(np.asarray(loss)[0]))
    return np.array(losses), flax_to_state_dict(jax.device_get(state.params))


def _port_accum(params, tokens, world, **trainer_kw):
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world, Strategy.ring(1), **trainer_kw)
    state = TrainState.create(model, trainer.tx)
    losses = [trainer.step(state, torch.from_numpy(tokens))[1] for _ in range(STEPS)]
    return torch.stack(losses), {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def accum_runs(flax_params):
    """JAX's and the port's world-1 runs with ``accum_steps=2`` under each
    overlap mode (the port's in one world of its own)."""
    tokens = _tokens(1, seed=5)
    refs = {mode: _jax_accum(flax_params, tokens, accum_steps=ACCUM, overlap=mode)
            for mode in overlap.OVERLAP_MODES}
    world = build_world_mesh(1, device="cpu")
    try:
        port = {mode: _port_accum(flax_params, tokens, world, accum_steps=ACCUM, overlap=mode)
                for mode in overlap.OVERLAP_MODES}
    finally:
        destroy_world()
    return refs, port


@pytest.mark.parametrize("mode", overlap.OVERLAP_MODES)
def test_accumulated_steps_match_jax(accum_runs, mode):
    refs, port = accum_runs
    losses_j, params_j = refs[mode]
    losses_t, params_t = port[mode]
    if mode == "microbatch":  # the JAX package's bound for the reordered float32 adds
        np.testing.assert_allclose(losses_t.numpy(), losses_j, rtol=MICROBATCH_RTOL, atol=MICROBATCH_ATOL)
    else:
        np.testing.assert_allclose(losses_t.numpy(), losses_j, atol=LOSS_ATOL)
    assert losses_t[-1] < losses_t[0]
    _assert_params_close({k: v.numpy() for k, v in params_t.items()}, params_j)
    # one rank: the sync is the identity, so every schedule gives the same
    # bits as the sequential accumulation without overlap
    losses_off, params_off = port["off"]
    assert torch.equal(losses_t, losses_off)
    assert all(torch.equal(params_t[k], params_off[k]) for k in params_off)


def test_accumulation_refuses_an_uneven_batch(world1):
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world1, Strategy.ring(1), accum_steps=3)
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=0)
    with pytest.raises(ValueError, match="per-rank batch 2 not divisible by accum_steps 3"):
        trainer.step(TrainState.create(model, trainer.tx), torch.from_numpy(_tokens(1)))


def test_bucket_overlap_composes_with_error_feedback(flax_params, world1):
    """int8 gradients with error feedback, accumulated: ``"bucket"`` only
    changes the dispatch granularity, so params, losses and the residual
    bank are the unbucketed run's bit for bit."""
    tokens = _tokens(1, seed=9)
    runs = []
    for mode in ("off", "bucket"):
        model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=None)
        model.load_state_dict(flax_to_state_dict(flax_params))
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world1, Strategy.ring(1),
                             grad_compress="int8", error_feedback=True, accum_steps=ACCUM, overlap=mode)
        state = TrainState.create(model, trainer.tx)
        losses = torch.stack([trainer.step(state, torch.from_numpy(tokens))[1] for _ in range(STEPS)])
        runs.append((losses, model.state_dict(), trainer._residual))
    (la, pa, ra), (lb, pb, rb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(a, b) for a, b in zip(ra, rb)) and any(bool(r.abs().sum()) for r in ra)


def test_bucket_overlap_syncs_in_the_flax_layout_on_the_psum_plane(world1, monkeypatch):
    """Under ``"bucket"`` the trainer hands the psum plane the flax leaf
    order and layout, as JAX buckets its leaves; ``ADAPCC_OVERLAP`` steers
    the hook as it steers JAX's."""
    monkeypatch.setenv(overlap.OVERLAP_ENV, "bucket")
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world1, Strategy.ring(1), overlap="off")
    assert trainer.overlap == trainer.hook.overlap == "bucket"
    assert trainer.hook._resolved_mode() == "psum"
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=0)
    order, transposed = trainer._sync_layout(model)
    assert (order, transposed) == tuple(map(list, DDPTrainer._flax_layout(model)))
    trainer.hook.bucket_cap_mb = 0.05
    trainer.step(TrainState.create(model, trainer.tx), torch.from_numpy(_tokens(1)))
    assert len(trainer.hook.recorded_buckets) > 1


# --------------------------------------------------------------------------- #
# refusals, with JAX's wording
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kw", [
    dict(overlap="microbatch"),
    dict(overlap="microbatch", accum_steps=2, bsp=False, dynamic_mask=True),
    dict(overlap="microbatch", accum_steps=2, grad_compress="int8", error_feedback=True),
    dict(overlap="microbatch", accum_steps=2, measure_gns=True),
    dict(overlap="rolling"),
    dict(accum_steps=0),
])
def test_trainer_guard_rails_raise_as_jax(world1, monkeypatch, kw):
    import jax
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.ddp import DDPTrainer as JaxDDPTrainer
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    monkeypatch.delenv(overlap.OVERLAP_ENV, raising=False)
    with pytest.raises(ValueError) as port_err:
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, Strategy.ring(1), **kw)
    with pytest.raises(ValueError) as jax_err:
        JaxDDPTrainer(lambda p, b: b, optax.sgd(0.1), Mesh(jax.devices()[:1], ("ranks",)), JaxStrategy.ring(1),
                      **kw)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kw", [dict(), dict(accum_steps=2), dict(accum_steps=2, overlap="bucket"),
                                dict(accum_steps=4, overlap="microbatch"),
                                dict(accum_steps=2, grad_compress="int8", error_feedback=True)])
def test_overlap_modes_match_jax(world1, monkeypatch, kw):
    import jax
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.ddp import DDPTrainer as JaxDDPTrainer
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    monkeypatch.delenv(overlap.OVERLAP_ENV, raising=False)
    port = DDPTrainer(lambda m, b: m(b), adamw(LR), world1, Strategy.ring(1), **kw)
    ref = JaxDDPTrainer(lambda p, b: b, optax.sgd(0.1), Mesh(jax.devices()[:1], ("ranks",)), JaxStrategy.ring(1),
                        **kw)
    assert port._overlap_modes == ref._overlap_modes
    assert port.overlap == port.hook.overlap == ref.overlap


@pytest.mark.parametrize("kw", [dict(overlap="microbatch"), dict(ring=True, overlap="bucket"),
                                dict(overlap="rolling")])
def test_zero1_refusals_match_jax(kw):
    import jax
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JaxZero1Optimizer

    with pytest.raises(ValueError) as port_err:
        Zero1Optimizer(adamw(LR), WORLD, **kw)
    with pytest.raises(ValueError) as jax_err:
        JaxZero1Optimizer(optax.sgd(0.1), Mesh(jax.devices()[:WORLD], ("ranks",)), **kw)
    # JAX's wording, but the port's ring is no Pallas kernel
    assert str(port_err.value) == str(jax_err.value).replace("the Pallas ring's", "the ring's")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("ring", [None, False, True])
def test_zero1_layout_metadata_matches_jax(world, ring):
    """``Zero1Optimizer(tx, world)`` gives JAX's default layout (no ring);
    named either way, the same tag as JAX's for the same world."""
    import jax
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JaxZero1Optimizer

    kw = {} if ring is None else {"ring": ring}
    port = Zero1Optimizer(adamw(LR), world, **kw)
    ref = JaxZero1Optimizer(optax.sgd(0.1), Mesh(jax.devices()[:world], ("ranks",)), **kw)
    assert port.layout_metadata() == ref.layout_metadata()
    assert port.checkpoint_extra({"a": 1}) == ref.checkpoint_extra({"a": 1})


# --------------------------------------------------------------------------- #
# ZeRO-1 without the ring, unchunked and chunked, against JAX
# --------------------------------------------------------------------------- #


def _zero1_chunk_bytes(total):
    """An ``overlap_chunk_bytes`` that splits the non-ring shard into at
    least 3 chunks of two lengths (ragged)."""
    shard = -(-total // WORLD)
    for n in range(3, 50):
        if shard % n:
            return 4 * -(-shard // n)
    raise AssertionError("no ragged split")


def _jax_zero1_plain(params, tokens, overlap_mode, chunk_bytes):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from adapcc_tpu.models.gpt2 import lm_loss as jax_lm_loss
    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JaxZero1Optimizer
    from adapcc_tpu.parallel.fsdp import zero1_train_step as jax_zero1_train_step

    model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32, attention="xla"))
    mesh = Mesh(jax.devices()[:WORLD], ("ranks",))
    opt = JaxZero1Optimizer(optax.adamw(LR), mesh, overlap=overlap_mode, overlap_chunk_bytes=chunk_bytes)
    master, opt_state = opt.init(params)
    init_master = np.asarray(master)
    step = jax_zero1_train_step(lambda p, b: jax_lm_loss(model.apply(p, b), b), opt, mesh)
    params = jax.device_put(params, NamedSharding(mesh, P()))
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    losses = []
    for _ in range(STEPS):
        params, master, opt_state, loss = step(params, master, opt_state, batch)
        losses.append(np.asarray(loss))
    return init_master, opt.overlap_chunks(), np.stack(losses, axis=1), flax_to_state_dict(jax.device_get(params))


def test_zero1_without_the_ring_matches_jax_unchunked_and_in_ragged_chunks(flax_params, monkeypatch):
    monkeypatch.delenv("ADAPCC_RING_CHUNK_BYTES", raising=False)
    tokens = _tokens(WORLD, seed=13)
    sd = flax_to_state_dict(flax_params)
    total = sum(v.numel() for v in sd.values())
    chunk_bytes = _zero1_chunk_bytes(total)
    runs = {}
    for mode in ("off", "bucket"):
        model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=None)
        model.load_state_dict(sd)
        opt = Zero1Optimizer(adamw(LR), WORLD, overlap=mode, overlap_chunk_bytes=chunk_bytes)
        master, opt_state = opt.init(model)
        init_master = master.clone()
        step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
        losses = [step(model, master, opt_state, torch.from_numpy(tokens))[3] for _ in range(STEPS)]
        runs[mode] = (init_master, opt.overlap_chunks(), torch.stack(losses, dim=1), master,
                      {k: v.detach().clone() for k, v in model.state_dict().items()})
    (m0, c0, l0, f0, p0), (m1, c1, l1, f1, p1) = runs["off"], runs["bucket"]
    shard = m0.shape[1]
    lengths = {n for _, n in overlap.even_chunk_bounds(shard, c1)}
    assert c0 == 1 and c1 >= 3 and len(lengths) == 2 and m0.shape == (WORLD, -(-total // WORLD))
    # chunking is bit for bit the single collective: master and params
    assert torch.equal(l0, l1) and torch.equal(f0, f1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    for mode, (init_master, chunks, losses, _, params) in runs.items():
        j_master, j_chunks, j_losses, j_params = _jax_zero1_plain(flax_params, tokens, mode, chunk_bytes)
        assert chunks == j_chunks
        assert np.array_equal(init_master.numpy(), j_master)  # the identity layout, unaligned
        np.testing.assert_allclose(losses.numpy(), j_losses, atol=LOSS_ATOL)
        _assert_params_close({k: v.numpy() for k, v in params.items()}, j_params)
