"""The port's ring plane held against the JAX package's Pallas ring.

The JAX kernels run as ``tests/test_pallas_ring.py`` runs them: under the
Pallas TPU interpreter on the virtual 4-device CPU mesh.  The port's ring
on a CPU tensor is its plain version, ``_ring_plain``, which replays the
kernels' walk hop by hop; every comparison is bit for bit (``np.array_equal``
on float32 views; bfloat16 widens to float32 exactly), because both sides
add each element's terms in the ring's order and round to the payload
dtype after every hop.  JAX is imported inside the functions that build the
references.
"""

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import ring
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace

F32_TILE = 8 * 128
BF16_TILE = 16 * 128
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def trace_rows(trace):
    """The events of an engine's ``CollectiveTrace`` as flat dicts: the
    event's primitive, impl and bytes beside its extras."""
    return [{"primitive": e.primitive, "impl": e.impl, "nbytes": e.nbytes, **e.extra} for e in trace.events()]


def _jax_dtype(name):
    import jax.numpy as jnp

    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _payload(world, n, dtype_name, seed=0):
    """Seeded ``[world, n]`` normals in ``dtype_name``, as float32 numpy
    (exact for bfloat16 values) and as the torch tensor."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(world, n)).astype(np.float32))
    x = x.to(DTYPES[dtype_name])
    return x.float().numpy(), x


def _np(t):
    return t.float().numpy()


def _jax_ring(x32, dtype_name, chunk_bytes):
    """The JAX Pallas ring on every row of ``x32``: per-rank reduce-scatter
    results, the all-gather of those, and the allreduce, from one program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.comm.pallas_ring import (
        ring_all_gather_shard,
        ring_allreduce_shard,
        ring_reduce_scatter_shard,
    )

    world = x32.shape[0]
    mesh = Mesh(jax.devices()[:world], ("ranks",))

    def per_shard(x):
        x = x[0]
        rs = ring_reduce_scatter_shard(x, world, interpret=True, chunk_bytes=chunk_bytes)
        ag = ring_all_gather_shard(rs, world, interpret=True, chunk_bytes=chunk_bytes)
        ar = ring_allreduce_shard(x, world, interpret=True, chunk_bytes=chunk_bytes)
        return rs[None], ag[None], ar[None]

    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"),
                               check_vma=False))
    rs, ag, ar = fn(jnp.asarray(x32, _jax_dtype(dtype_name)))
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (rs, ag, ar))


# --------------------------------------------------------------------------- #
# the planner
# --------------------------------------------------------------------------- #

PLAN_NELEMS = (1, 1000, F32_TILE, 3 * F32_TILE, 52 * F32_TILE, 10**6 + 7)


@pytest.mark.parametrize("chunk_bytes", [None, 4096, 8192, 5 * 4096, 1 << 20])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plan_matches_jax(dtype_name, world, chunk_bytes):
    from adapcc_tpu.comm.pallas_ring import plan_ring_schedule as jax_plan

    for nelems in PLAN_NELEMS:
        for rs, ag in ((True, True), (True, False), (False, True)):
            got = ring.plan_ring_schedule(nelems, DTYPES[dtype_name], world, chunk_bytes, rs=rs, ag=ag)
            want = jax_plan(nelems, _jax_dtype(dtype_name), world, chunk_bytes, rs=rs, ag=ag)
            assert got.to_row() == want.to_row(), (nelems, rs, ag)
            assert got.dtype == want.dtype


def test_chunk_bytes_env_override_and_rejection(monkeypatch):
    from adapcc_tpu.comm.pallas_ring import resolve_chunk_bytes as jax_resolve

    monkeypatch.setenv(ring.RING_CHUNK_ENV, "8192")
    assert ring.resolve_chunk_bytes(4096) == jax_resolve(4096) == 8192
    for bad in ("8k", "0", "-1"):
        monkeypatch.setenv(ring.RING_CHUNK_ENV, bad)
        with pytest.raises(ValueError, match=ring.RING_CHUNK_ENV):
            ring.resolve_chunk_bytes()
        with pytest.raises(ValueError, match=ring.RING_CHUNK_ENV):
            jax_resolve()
    monkeypatch.delenv(ring.RING_CHUNK_ENV)
    assert ring.resolve_chunk_bytes() == jax_resolve() == 4 * 1024 * 1024
    with pytest.raises(ValueError, match="positive"):
        ring.resolve_chunk_bytes(0)
    # a codec plans the fused kernels, and what they cannot run raises
    assert ring.plan_ring_schedule(1024, torch.float32, 4, wire_dtype="int8").wire_dtype == "int8"
    with pytest.raises(ValueError, match="float32"):
        ring.plan_ring_schedule(1024, torch.bfloat16, 4, wire_dtype="int8")


# --------------------------------------------------------------------------- #
# the ring, bit for bit
# --------------------------------------------------------------------------- #

# (world, n, dtype, chunk_bytes, expected path): n of one tile and a ragged
# 1000 in both dtypes on the vmem path; three tiles in both dtypes on the
# stream path at 4096-byte staging, and a ragged payload at 8192 bytes whose
# 3-tile chunk streams as 2 tiles of 2 (a zero-padded last tile); the
# world-2 ring, where left and right are one rank.  Each JAX case costs
# seconds in the interpreter, so the grid is a cover, not a product.
RING_CASES = [
    (4, F32_TILE, "float32", None, "vmem"),
    (4, 1000, "float32", None, "vmem"),
    (4, BF16_TILE, "bfloat16", None, "vmem"),
    (4, 1000, "bfloat16", None, "vmem"),
    (4, 3 * F32_TILE, "float32", 4096, "hbm-stream"),
    (4, 3 * BF16_TILE, "bfloat16", 4096, "hbm-stream"),
    (4, 12 * F32_TILE - 100, "float32", 8192, "hbm-stream"),
    (2, 3 * F32_TILE, "float32", None, "vmem"),
]


@pytest.mark.parametrize("world,n,dtype_name,chunk_bytes,path", RING_CASES)
def test_ring_matches_jax_kernels_bit_for_bit(world, n, dtype_name, chunk_bytes, path):
    x32, x = _payload(world, n, dtype_name)
    rs_j, ag_j, ar_j = _jax_ring(x32, dtype_name, chunk_bytes)

    trace = CollectiveTrace()
    strategy = Strategy.ring(world)
    if chunk_bytes is not None:
        strategy.chunk_bytes = chunk_bytes  # the engine's default granularity
    eng = CollectiveEngine(world, strategy, trace=trace)
    ar = eng.ring_allreduce(x)
    rs = eng.ring_reduce_scatter(x)
    ag = eng.ring_all_gather(torch.from_numpy(rs_j).to(DTYPES[dtype_name]))
    assert [r["impl"] for r in trace_rows(trace)] == [f"plain_ring[{path}]"] * 3
    assert np.array_equal(_np(ar), ar_j)
    # the engine rolls rank r's chunk (r + 1) % world into row (r + 1)
    assert np.array_equal(_np(rs), np.roll(rs_j, 1, axis=0))
    assert np.array_equal(_np(ring.ring_reduce_scatter_stacked(x, chunk_bytes)), rs_j)
    assert np.array_equal(_np(ag), ag_j)

    # the plain walk itself, on the chunk-major buffer the kernels take
    chunks, _ = ring._pad_chunks(x, world)
    plain = ring._ring_plain(chunks, rs=True, ag=True).reshape(world, -1)[:, :n]
    assert np.array_equal(_np(plain), ar_j)


def _recording(monkeypatch, name, plain):
    """Replace the kernel wrapper ``name`` by one that records the shape and
    stage rows it is handed and runs ``plain`` on them."""
    seen = []

    def wrapper(chunks, rs, ag, stage_rows, *args, **kw):
        seen.append((tuple(chunks.shape), stage_rows))
        return plain(chunks, rs, ag, *args)

    monkeypatch.setattr(ring, name, wrapper)
    return seen


@pytest.mark.parametrize("own", [False, True])
def test_k1b_dispatch_hands_the_kernel_unpadded_chunks(monkeypatch, own):
    """K1b bounds each block's stripe by the chunk's real length, so the
    stream path hands it the caller's chunks as they are: a 37-tile chunk at
    8-tile staging streams as 4 tiles of 8 and a ragged last tile of 5, with
    no stage padding to slice back out."""
    seen = _recording(monkeypatch, "ring_k1b", ring._ring_plain)
    world = 4
    _, x = _payload(world, world * 37 * F32_TILE - 123, "float32")
    chunks, _ = ring._pad_chunks(x, world)
    ranks = torch.arange(world)
    buf = chunks[ranks, ranks] if own else chunks
    rs, ag = (False, True) if own else (True, True)
    plan = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, world, 8 * F32_TILE * 4)
    got = ring._run_ring_chunks(buf, rs=rs, ag=ag, chunk_bytes=8 * F32_TILE * 4)
    assert (plan.path, plan.n_tiles, plan.stage_bytes) == ("hbm-stream", 5, 8 * F32_TILE * 4)
    assert seen == [(tuple(buf.shape), 64)] and buf.shape[-2] == 37 * 8 != plan.n_tiles * 64
    assert torch.equal(got, ring._ring_plain(chunks, rs, ag))


@pytest.mark.parametrize("own", [False, True])
def test_k5b_dispatch_hands_the_kernel_unpadded_chunks(monkeypatch, own):
    """K5b bounds each block's stripe by the chunk's real length too, so the
    stream path hands it the caller's chunks as they are: a 37-tile chunk at
    8-tile int8 staging (the scales take their share of the budget: 7-tile
    tiles of 56 rows) streams as 5 whole tiles and a ragged last one of 16
    rows, with no stage padding to slice back out; the bits are the fused
    walk's on the unpadded chunks."""
    seen = _recording(monkeypatch, "ring_k5b", ring._fused_ring_plain)
    world = 4
    _, x = _payload(world, world * 37 * F32_TILE - 123, "float32")
    chunks, _ = ring._pad_chunks(x, world)
    ranks = torch.arange(world)
    buf = chunks[ranks, ranks] if own else chunks
    rs, ag = (False, True) if own else (True, True)
    plan = ring.plan_ring_schedule(chunks[0].numel(), torch.float32, world, 8 * F32_TILE * 4,
                                   rs=rs, ag=ag, wire_dtype="int8")
    stage_rows = plan.stage_bytes // 512
    got = ring._run_ring_chunks(buf, rs=rs, ag=ag, chunk_bytes=8 * F32_TILE * 4, wire_dtype="int8")
    assert (plan.path, plan.n_tiles, stage_rows) == ("hbm-stream", 6, 56)
    assert seen == [(tuple(buf.shape), stage_rows)] and buf.shape[-2] == 37 * 8 != plan.n_tiles * stage_rows
    assert torch.equal(got, ring._fused_ring_plain(chunks, rs, ag, "int8", 256))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_stacked_collectives_at_a_ragged_multi_tile_payload_match_jax(monkeypatch, dtype_name):
    """The stacked reduce-scatter, all-gather and allreduce at a payload
    whose 5-tile chunks stream in tiles of 2 (a ragged last tile of 1), bit
    for bit the JAX ring's, with K1b (its plain version here) handed the
    unpadded chunks."""
    world, tile = 4, {"float32": F32_TILE, "bfloat16": BF16_TILE}[dtype_name]
    dtype = DTYPES[dtype_name]
    chunk_bytes = 2 * tile * dtype.itemsize
    x32, x = _payload(world, world * 5 * tile - 300, dtype_name)
    rs_j, ag_j, ar_j = _jax_ring(x32, dtype_name, chunk_bytes)
    seen = _recording(monkeypatch, "ring_k1b", ring._ring_plain)
    rs = ring.ring_reduce_scatter_stacked(x, chunk_bytes)
    ag = ring.ring_all_gather_stacked(torch.from_numpy(rs_j).to(dtype), chunk_bytes)
    ar = ring.ring_allreduce_stacked(x, chunk_bytes)
    rows = 5 * tile // 128
    stage = 2 * tile // 128
    assert seen == [((world, world, rows, 128), stage), ((world, rows, 128), stage),
                    ((world, world, rows, 128), stage)]
    assert np.array_equal(_np(rs), rs_j)
    assert np.array_equal(_np(ag), ag_j)
    assert np.array_equal(_np(ar), ar_j)


@pytest.mark.parametrize("chunk_bytes", [None, 4096])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_all_gather_from_own_chunks_equals_the_full_walk(dtype_name, chunk_bytes):
    """The stacked all-gather hands the walk only each rank's own chunk, the
    one chunk of the input an all-gather reads: the result is the walk's
    over the full chunk-major buffer, on the vmem and the stream path."""
    world = 4
    _, x = _payload(world, world * 3 * BF16_TILE, dtype_name)
    chunks, _ = ring._pad_chunks(x, world)
    ranks = torch.arange(world)
    own = chunks[ranks, ranks]
    got = ring._run_ring_chunks(own, rs=False, ag=True, chunk_bytes=chunk_bytes)
    assert torch.equal(got, ring._ring_plain(chunks, False, True))
    with pytest.raises(ValueError, match="all-gather alone"):
        ring._ring_plain(own, True, True)
    ring.check_errors()  # nothing was launched on a CPU tensor: nothing to raise


def test_all_gather_rejects_unaligned_payloads():
    import jax.numpy as jnp

    from adapcc_tpu.comm.pallas_ring import ring_all_gather_shard

    eng = CollectiveEngine(4, Strategy.ring(4))
    with pytest.raises(ValueError, match="tile-aligned"):
        eng.ring_all_gather(torch.ones(4, 100))
    # 8·128 is a float32 tile but not a bfloat16 one (16·128)
    with pytest.raises(ValueError, match="2048"):
        eng.ring_all_gather(torch.ones(4, F32_TILE, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="2048"):
        ring_all_gather_shard(jnp.ones((F32_TILE,), jnp.bfloat16), 4)


# --------------------------------------------------------------------------- #
# the engine's contract
# --------------------------------------------------------------------------- #


def test_engine_chunk_precedence_env_over_argument_over_strategy(monkeypatch):
    x = torch.ones(4, 16 * F32_TILE)
    strategy = Strategy.ring(4)
    strategy.chunk_bytes = 8192
    trace = CollectiveTrace()
    eng = CollectiveEngine(4, strategy, trace=trace)
    eng.ring_allreduce(x)
    eng.ring_allreduce(x, chunk_bytes=1 << 20)
    monkeypatch.setenv(ring.RING_CHUNK_ENV, "4096")
    eng.ring_allreduce(x, chunk_bytes=1 << 20)
    assert [(r["chunk_bytes"], r["ring_path"]) for r in trace_rows(trace)] == [
        (8192, "hbm-stream"), (1 << 20, "vmem"), (4096, "hbm-stream")]
    rec = trace_rows(trace)[0]
    assert rec["nbytes"] == x.numel() * 4 and rec["stage_bytes"] == 8192


def test_engine_world_one_and_stacked_shapes():
    x = torch.arange(12.0).reshape(1, 12)
    eng = CollectiveEngine(1, Strategy.ring(1))
    assert torch.equal(eng.ring_allreduce(x), x)
    assert torch.equal(eng.ring_reduce_scatter(x), x)
    assert eng.ring_all_gather(torch.ones(1, F32_TILE)).shape == (1, 1, F32_TILE)
    eng4 = CollectiveEngine(4, Strategy.ring(4))
    assert eng4.ring_allreduce(torch.ones(4, 3, 5)).shape == (4, 3, 5)
    assert torch.equal(eng4.ring_allreduce(torch.ones(4, 3, 5)), torch.full((4, 3, 5), 4.0))
    with pytest.raises(ValueError, match="leading dim 4"):
        eng4.ring_allreduce(torch.ones(2, 8))


def test_engine_rejects_what_waits(monkeypatch):
    x = torch.ones(4, F32_TILE)
    trace = CollectiveTrace()
    eng = CollectiveEngine(4, Strategy.ring(4), trace=trace)
    # the IR plane runs, its program carrying its own codec and chunking
    # (its parity is tests/test_torch_compiler.py); the latency plane runs
    # (its parity is tests/test_torch_latency.py)
    assert torch.equal(eng.ring_allreduce(x, algo="ir"), torch.full_like(x, 4.0))
    with pytest.raises(ValueError, match="program properties"):
        eng.ring_allreduce(x, algo="ir", wire_dtype="int8")
    assert torch.equal(eng.ring_allreduce(x, algo="rd"), torch.full_like(x, 4.0))
    # the wire codecs run now, through the fused walk (its plain version on
    # a CPU tensor): the argument, and the env over the strategy's "off"
    assert torch.equal(eng.ring_allreduce(x, wire_dtype="int8"),
                       ring.ring_allreduce_stacked(x, wire_dtype="int8"))
    assert torch.equal(eng.ring_reduce_scatter(x, wire_dtype="bf16"), eng.ring_reduce_scatter(x))
    monkeypatch.setenv("ADAPCC_WIRE_DTYPE", "int8")
    assert torch.equal(eng.ring_all_gather(x), ring.ring_all_gather_stacked(x, wire_dtype="int8"))
    assert [r["impl"] for r in trace_rows(trace)] == ["ir", "rd", "plain_ring[vmem+int8]", "plain_ring[vmem+bf16]",
                                                      "plain_ring[vmem]", "plain_ring[vmem+int8]"]
    monkeypatch.delenv("ADAPCC_WIRE_DTYPE")
    monkeypatch.setenv("ADAPCC_COLL_ALGO", "auto")
    eng.ring_allreduce(x)  # below the card's crossover: recursive doubling
    assert trace_rows(trace)[-1]["impl"] == "rd"
    with pytest.raises(ValueError, match="do not split into 3 slices"):
        CollectiveEngine(4, Strategy.ring(4), num_slices=3)
    with pytest.raises(ValueError, match="ring_allreduce needs a flat ranks mesh"):
        CollectiveEngine(4, Strategy.ring(4), num_slices=2).ring_allreduce(x)
    # a tuner attaches now (tests/test_torch_tuner.py); a malformed mode raises
    monkeypatch.delenv("ADAPCC_COLL_ALGO")
    monkeypatch.setenv("ADAPCC_TUNER", "chose")
    with pytest.raises(ValueError, match="ADAPCC_TUNER"):
        CollectiveEngine(4, Strategy.ring(4))


def test_kernel_wrappers_refuse_what_they_cannot_launch():
    """On a tensor that is neither on the CPU nor on a card, the wrappers
    raise instead of running the plain version; nothing was launched."""
    meta = torch.empty((4, 4, 8, 128), device="meta")
    launches = [w.launches for w in ring.KERNELS]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ring.ring_k1a(meta, True, True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ring.ring_k1b(meta, True, True, 8)
    assert [w.launches for w in ring.KERNELS] == launches
