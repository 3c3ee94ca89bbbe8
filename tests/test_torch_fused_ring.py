"""The port's fused-codec ring held against the JAX package's.

On a CPU tensor the fused kernels' wrappers run their plain version,
``_fused_ring_plain``, which replays the fused walk hop by hop with the
port's codec.  It is held

- against the JAX fused Pallas kernels (``ring_allreduce_shard`` and
  friends with ``wire_dtype``) under the TPU interpreter on the 4-device CPU
  mesh, as ``tests/test_fused_ring.py`` runs them: three cases, each costing
  seconds (one streamed int8 allreduce, one one-stage int8 reduce-scatter
  and all-gather, one bf16 allreduce);
- against the reference's host replay of the schedule
  (``_simulate_fused_allreduce``) and the JAX ppermute quant ring for the
  rest.

Tolerances: int8 results within 4 float32 ulps (the reference's bound
between its data planes: XLA on the CPU may contract a hop's decode-multiply
and add into one FMA, the port rounds twice; and XLA compiles the
interpreted kernel's codec as one program, a couple of ulps off the codec's
op-by-op definition, which the port matches bit for bit); bf16 sums bit for
bit; every rank identical.  JAX is imported inside the functions that build
references.
"""

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import ring
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.quant import get_codec, ring_error_bound, wire_ring_allreduce_stacked
from adapcc_tpu_torch.quant.codec import dequantize_int8, quantize_int8
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace
from test_torch_ring import trace_rows

TILE = 8 * 128
ULPS = 4


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _assert_ulp_close(a: np.ndarray, b: np.ndarray, ulps: int = ULPS) -> None:
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    assert (np.abs(a - b) <= tol).all(), f"beyond {ulps} ulps: max diff {np.abs(a - b).max()}"


def _rank_identical(out: np.ndarray) -> None:
    for r in range(1, out.shape[0]):
        assert np.array_equal(out[r], out[0]), f"rank {r} differs from rank 0"


def _payload(world: int, n: int, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(world, n)) * scale).astype(np.float32)


def _jax_run(per_shard, *arrays):
    """``per_shard`` over the 4-device mesh under jit; numpy outputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(jax.devices()[:4], ("ranks",))
    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"),
                               check_vma=False))
    out = fn(*(jnp.asarray(a) for a in arrays))
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


# --------------------------------------------------------------------------- #
# the planner and the support funnel
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("wire,block", [("int8", 128), ("int8", 256), ("int8", 1024), ("bf16", None)])
def test_plan_wire_fields_match_jax(wire, block):
    import jax.numpy as jnp

    from adapcc_tpu.comm.pallas_ring import plan_ring_schedule as jax_plan

    for world in (1, 2, 4, 8):
        for nelems in (1000, TILE, 13 * TILE * world, 10**6 + 7):
            for chunk_bytes in (None, 4096, 5 * 4096, 1 << 20):
                for rs, ag in ((True, True), (True, False), (False, True)):
                    got = ring.plan_ring_schedule(nelems, torch.float32, world, chunk_bytes, rs=rs, ag=ag,
                                                  wire_dtype=wire, block_size=block)
                    want = jax_plan(nelems, jnp.float32, world, chunk_bytes, rs=rs, ag=ag,
                                    wire_dtype=wire, block_size=block)
                    assert got.to_row() == want.to_row(), (world, nelems, chunk_bytes, rs, ag)
                    assert got.block_size == want.block_size


def test_unsupported_reason_and_env_gate_match_jax(monkeypatch):
    import jax.numpy as jnp

    from adapcc_tpu.comm import pallas_ring as jpr

    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for wire in ("off", "bf16", "int8", "fp8"):
            for block in (None, 64, 128, 192, 256, 384, 512, 1024, 2048):
                got = ring.fused_wire_unsupported_reason(dtype, wire, block)
                want = jpr.fused_wire_unsupported_reason(jdtype, wire, block)
                assert (got is None) == (want is None), (dtype, wire, block)
    assert "block_size" in ring.fused_wire_unsupported_reason(torch.float32, "int8", 192)
    assert "float32" in ring.fused_wire_unsupported_reason(torch.bfloat16, "int8")
    monkeypatch.delenv(ring.FUSED_WIRE_ENV, raising=False)
    assert ring.resolve_fused_wire() == jpr.resolve_fused_wire() == "auto"
    # the device is no reason: a CPU tensor takes the plain version, a CUDA
    # one its kernel or a raise
    assert ring.fused_ring_dispatch_reason(torch.float32, "int8", 256) is None
    monkeypatch.setenv(ring.FUSED_WIRE_ENV, "OFF")
    assert ring.resolve_fused_wire() == jpr.resolve_fused_wire() == "off"
    assert "pins the unfused path" in ring.fused_ring_dispatch_reason(torch.float32, "int8")
    monkeypatch.setenv(ring.FUSED_WIRE_ENV, "o n")
    with pytest.raises(ValueError, match="ADAPCC_FUSED_WIRE"):
        ring.resolve_fused_wire()
    monkeypatch.setenv(ring.FUSED_WIRE_ENV, "on")  # any reason raises
    with pytest.raises(ValueError, match="ADAPCC_FUSED_WIRE=on"):
        ring.fused_ring_dispatch_reason(torch.bfloat16, "int8")
    assert ring.fused_ring_dispatch_reason(torch.float32, "bf16") is None


# --------------------------------------------------------------------------- #
# the plain fused walk against the JAX fused kernels (interpreter)
# --------------------------------------------------------------------------- #

def test_streamed_int8_allreduce_matches_jax_kernel():
    """A ragged payload whose 3-tile chunks stream as 2 tiles of 2 (a zero
    padded last tile): K5b's path."""
    from adapcc_tpu.comm.pallas_ring import ring_allreduce_shard

    world, n, chunk_bytes = 4, 4 * 3 * TILE - 300, 8400
    xs = _payload(world, n, seed=7, scale=13)
    plan = ring.plan_ring_schedule(n, torch.float32, world, chunk_bytes, wire_dtype="int8")
    assert (plan.path, plan.n_tiles, plan.stage_bytes) == ("hbm-stream", 2, 8192)
    want = _jax_run(lambda x: ring_allreduce_shard(x[0], world, interpret=True, chunk_bytes=chunk_bytes,
                                                   wire_dtype="int8")[None], xs)
    got = ring.ring_allreduce_stacked(torch.from_numpy(xs), chunk_bytes, wire_dtype="int8").numpy()
    _assert_ulp_close(got, want)
    _rank_identical(got)
    _rank_identical(want)
    assert (np.abs(got[0] - xs.sum(0)) <= ring_error_bound(xs)).all()


def test_one_stage_int8_reduce_scatter_and_all_gather_match_jax_kernels():
    """K5a's path: a reduce-scatter alone leaves the float32 sum of decoded
    hops; an all-gather alone gives every rank the codec's value of every
    rank's chunk, bit for bit."""
    import jax.numpy as jnp

    from adapcc_tpu.comm.pallas_ring import ring_all_gather_shard, ring_reduce_scatter_shard
    from adapcc_tpu.quant import get_codec as jax_get_codec

    world, chunk = 4, 2 * TILE
    xs = _payload(world, world * chunk, seed=10)
    own = _payload(world, chunk, seed=11, scale=7)

    def per_shard(x, o):
        rs = ring_reduce_scatter_shard(x[0], world, interpret=True, wire_dtype="int8", block_size=128)
        ag = ring_all_gather_shard(o[0], world, interpret=True, wire_dtype="int8", block_size=128)
        return rs[None], ag[None]

    rs_j, ag_j = _jax_run(per_shard, xs, own)
    rs = ring.ring_reduce_scatter_stacked(torch.from_numpy(xs), wire_dtype="int8", block_size=128).numpy()
    ag = ring.ring_all_gather_stacked(torch.from_numpy(own), wire_dtype="int8", block_size=128).numpy()
    # no final encode rounds this sum, so where terms cancel, one contracted
    # FMA is hundreds of ulps of the result (448 seen): the 4 ulps are
    # counted at the terms' magnitude, the sum over ranks of |x| that bounds
    # every partial (3 seen); rank r holds chunk r + 1
    mass = np.roll(np.abs(xs).sum(0).reshape(world, chunk), -1, axis=0)
    assert (np.abs(rs - rs_j) <= ULPS * np.spacing(mass)).all()
    bound = ring_error_bound(xs, block_size=128).reshape(world, chunk)
    full = xs.sum(0).reshape(world, chunk)
    for r in range(world):
        assert (np.abs(rs[r] - full[(r + 1) % world]) <= bound[(r + 1) % world]).all()
    # the all-gather is the codec's value of each chunk, bit for bit, as
    # JAX's codec defines it op by op; the interpreted kernel, compiled by
    # XLA as one program, lands within 4 ulps of it (2 seen)
    _assert_ulp_close(ag, ag_j)
    _rank_identical(ag)
    for src in range(world):
        want = jax_get_codec("int8").apply(jnp.asarray(own[src]), 128)
        assert np.array_equal(_bits(ag[0, src]), _bits(want))
        assert np.array_equal(_bits(ag[0, src]), _bits(get_codec("int8").apply(torch.from_numpy(own[src]), 128)))


def test_bf16_allreduce_matches_jax_kernel_bit_for_bit():
    from adapcc_tpu.comm.pallas_ring import ring_allreduce_shard

    world, n = 4, 4000
    xs = _payload(world, n, seed=8)
    want = _jax_run(lambda x: ring_allreduce_shard(x[0], world, interpret=True, wire_dtype="bf16")[None], xs)
    got = ring.ring_allreduce_stacked(torch.from_numpy(xs), wire_dtype="bf16").numpy()
    assert np.array_equal(_bits(got), _bits(want))
    _rank_identical(got)


# --------------------------------------------------------------------------- #
# against the reference's replay and the quant rings
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("world,block", [(2, 256), (4, 128), (4, 256), (8, 1024)])
def test_fused_walk_matches_reference_replay_and_quant_rings(world, block):
    """On coinciding chunk layouts (whole tiles a chunk) the fused walk is the
    reference's replay of the fused schedule and the JAX quant ring within 4
    ulps, and the port's own quant ring bit for bit (both round twice)."""
    from test_fused_ring import _simulate_fused_allreduce

    n = world * 2 * TILE
    xs = _payload(world, n, seed=4, scale=50)
    got = ring.ring_allreduce_stacked(torch.from_numpy(xs), wire_dtype="int8", block_size=block).numpy()
    _assert_ulp_close(got, _simulate_fused_allreduce(xs, block))
    _rank_identical(got)
    unfused = wire_ring_allreduce_stacked(torch.from_numpy(xs), "int8", block).numpy()
    assert np.array_equal(_bits(got), _bits(unfused))
    if world == 4:
        from adapcc_tpu.quant import wire_ring_allreduce_shard

        want = _jax_run(lambda x: wire_ring_allreduce_shard(x[0], world, "ranks", "int8", block)[None], xs)
        _assert_ulp_close(got, want)


def test_fused_walk_paths_give_the_same_bits():
    """One stage (K5a) and every staging size (K5b), padded last tiles
    included, give the same bits (blocks nest in tiles of every size); the
    owner's adoption makes a world-of-zeros sum the codec's value."""
    world, n = 4, 4 * 13 * TILE
    x = torch.from_numpy(_payload(world, n, seed=9))
    one_stage = ring.ring_allreduce_stacked(x, 1 << 30, wire_dtype="int8")
    for tiles in (1, 5, 13):
        assert torch.equal(ring.ring_allreduce_stacked(x, tiles * 4 * TILE, wire_dtype="int8"), one_stage)
    alone = torch.zeros(2, n)
    alone[0] = x[0]
    out = ring.ring_allreduce_stacked(alone, wire_dtype="int8")
    assert torch.equal(out[0], get_codec("int8").apply(x[0])) and torch.equal(out[1], out[0])


def test_fused_plain_takes_own_chunks_and_refuses_what_the_kernels_do():
    world = 4
    chunks, _ = ring._pad_chunks(torch.from_numpy(_payload(world, world * 3 * TILE, seed=12)), world)
    ranks = torch.arange(world)
    own = chunks[ranks, ranks]
    for wire in ("int8", "bf16"):
        assert torch.equal(ring._fused_ring_plain(own, False, True, wire),
                           ring._fused_ring_plain(chunks, False, True, wire))
    with pytest.raises(ValueError, match="all-gather alone"):
        ring._fused_ring_plain(own, True, True, "int8")
    launches = [w.launches for w in ring.KERNELS]
    with pytest.raises(ValueError, match="float32"):
        ring.ring_k5a(chunks.bfloat16(), True, True, "int8")
    with pytest.raises(ValueError, match="block_size=384"):
        ring.ring_k5b(chunks, True, True, 8, "int8", 384)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ring.ring_k5a(torch.empty(chunks.shape, device="meta"), True, True, "int8")
    with pytest.raises(ValueError, match="cannot run on the fused ring"):
        ring.ring_allreduce_stacked(chunks.reshape(world, -1).bfloat16(), wire_dtype="int8")
    assert [w.launches for w in ring.KERNELS] == launches


def test_fused_reduce_scatter_alone_returns_the_owned_chunks():
    """A fused reduce-scatter alone returns each rank's owned chunk only, row
    ``r`` the chunk ``(r + 1) % world``, on both wrappers (their plain
    version here) and through the stacked collective: the plain walk's
    owned chunks, bit for bit."""
    world = 4
    chunks, chunk = ring._pad_chunks(torch.from_numpy(_payload(world, world * 3 * TILE - 50, seed=14)), world)
    ranks = torch.arange(world)
    for wire, block in (("int8", 128), ("bf16", None)):
        want = ring._fused_ring_plain(chunks, True, False, wire, block or 0)[ranks, (ranks + 1) % world]
        for got in (ring.ring_k5a(chunks, True, False, wire, block),
                    ring.ring_k5b(chunks, True, False, 8, wire, block)):
            assert got.shape == (world, chunks.shape[2], 128)
            assert torch.equal(got, want)
        stacked = ring.ring_reduce_scatter_stacked(chunks.reshape(world, -1), 4096, wire_dtype=wire,
                                                   block_size=block)
        assert torch.equal(stacked, want.reshape(world, chunk))


# --------------------------------------------------------------------------- #
# the schedule twin of the fused direct walk (csrc/ring.cu fused_walk)
# --------------------------------------------------------------------------- #

BATCH = 1024  # a warp's batch in csrc/ring.cu (kBatchElems): a stripe is whole batches


def _twin_encode(v, wire, block):
    if wire == "bf16":
        return (v.to(torch.bfloat16),)
    q, scales = quantize_int8(v, block)
    return q.reshape(-1), scales


def _twin_decode(codes, wire, block):
    if wire == "bf16":
        return codes[0].float()
    return dequantize_int8(codes[0].reshape(-1, block), codes[1])


def _twin_walk(chunks, rs, ag, wire, block, stage_rows, blocks, tile_major, seed):
    """The fused walk as ``csrc/ring.cu::fused_walk`` runs it, with its index
    math: per-rank wire buffers of ``world`` chunks, a prologue phase, the
    chunk of each step, stripes of whole batches recomputed from each tile's
    real length, and one ready counter per (rank, block) with the kernel's
    wait target.  A seeded scheduler runs, one iteration at a time, any
    (rank, block) whose wait would pass.  Every wire write is tagged with
    the phase that wrote it, and every read asserts that it sees the left
    neighbour's write of the phase before on the same tile: never an older
    value, never a later overwrite.  Returns what the launch returns."""
    world, rows = chunks.shape[0], chunks.shape[-2]
    n = rows * 128
    x = chunks.reshape(world, -1, n)  # [world, world or 1, n]
    stage = stage_rows * 128
    n_tiles = -(-n // stage)
    n_rs, n_ag = (world - 1) * rs, (world - 1) * ag
    phases = 1 + n_rs + n_ag
    own = int(rs)
    unit = block if wire == "int8" else 1024
    codes = [torch.zeros(world, n, dtype=torch.int8 if wire == "int8" else torch.bfloat16) for _ in range(world)]
    scales = [torch.zeros(world, n // unit) for _ in range(world)]
    tags = [torch.full((world, n // BATCH), -1) for _ in range(world)]
    out = torch.full((world, n) if rs and not ag else (world, world, n), float("nan"))
    ready = np.zeros((world, blocks), dtype=np.int64)  # completed iterations (the counter less its epoch)
    total = phases * n_tiles
    stride = 1 if tile_major else n_tiles

    def run(r, b, it):
        phase, tile = (it % phases, it // phases) if tile_major else (it // n_tiles, it % n_tiles)
        t0 = tile * stage
        n_batches = min(stage, n - t0) // BATCH
        per = -(-n_batches // blocks)
        b0 = min(b * per, n_batches)
        b1 = min(b0 + per, n_batches)
        if b0 == b1:
            return
        el = slice(t0 + b0 * BATCH, t0 + b1 * BATCH)
        bt = slice((t0 + b0 * BATCH) // BATCH, (t0 + b1 * BATCH) // BATCH)
        un = slice((t0 + b0 * BATCH) // unit, (t0 + b1 * BATCH) // unit)
        left = (r - 1) % world

        def pull(c):
            assert (tags[left][c, bt] == phase - 1).all(), (r, b, phase, tile, c, tags[left][c, bt])
            return codes[left][c, el], scales[left][c, un]

        def push(c, wire_tile):
            codes[r][c, el] = wire_tile[0]
            if wire == "int8":
                scales[r][c, un] = wire_tile[1]
            tags[r][c, bt] = phase

        if phase == 0:
            c = r
            enc = _twin_encode(x[r, 0 if x.shape[1] == 1 else c, el], wire, block)
            push(c, enc)
            if not rs:
                out[r, c, el] = _twin_decode(enc, wire, block)
        elif phase <= n_rs:
            step = phase - 1
            c = (r - step - 1) % world
            total_ = x[r, c, el] + _twin_decode(pull(c), wire, block)
            if step < n_rs - 1:
                push(c, _twin_encode(total_, wire, block))
            elif not ag:
                out[r, el] = total_
            else:
                enc = _twin_encode(total_, wire, block)
                push(c, enc)
                out[r, c, el] = _twin_decode(enc, wire, block)
        else:
            step = phase - 1 - n_rs
            c = (r + own - step - 1) % world
            landed = pull(c)
            out[r, c, el] = _twin_decode(landed, wire, block)
            if step < n_ag - 1:
                push(c, landed)

    rng = np.random.default_rng(seed)
    while (ready < total).any():
        runnable = [(r, b) for r in range(world) for b in range(blocks)
                    if ready[r, b] < total and ((ready[r, b] % phases if tile_major else ready[r, b] // n_tiles) == 0
                                                or ready[(r - 1) % world, b] >= ready[r, b] - stride + 1)]
        assert runnable, "the walk deadlocked"
        r, b = runnable[rng.integers(len(runnable))]
        run(r, b, int(ready[r, b]))
        ready[r, b] += 1
    return out.reshape(*out.shape[:-1], rows, 128)


@pytest.mark.parametrize("wire,block", [("int8", 256), ("bf16", None)])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_fused_walk_twin_reads_every_wire_tile_before_its_overwrite(world, wire, block):
    """The twin of the fused direct walk, on a ragged 3-tile chunk (tiles of
    16, 16 and 8 rows, two blocks a rank, so one block's stripe of the last
    tile is empty) with whole zero blocks, tile-major and step-major, under
    seeded schedules: every read sees the write it needs, and the result
    equals ``_fused_ring_plain`` bit for bit for a reduce-scatter alone
    (its owned chunks), an all-gather (from each rank's own chunk and from
    the full payload) and both."""
    xs = _payload(world, world * 40 * 128 - 123, seed=15, scale=3)
    xs[:, :TILE] = 0.0
    chunks, _ = ring._pad_chunks(torch.from_numpy(xs), world)
    assert chunks.shape[2] == 40
    ranks = torch.arange(world)
    own = chunks[ranks, ranks]
    for seed, tile_major in ((0, True), (1, True), (2, False)):
        for buf, rs, ag in ((chunks, True, False), (own, False, True), (chunks, False, True), (chunks, True, True)):
            got = _twin_walk(buf, rs, ag, wire, block or 0, 16, 2, tile_major, seed)
            want = ring._fused_ring_plain(chunks, rs, ag, wire, block or 0)
            if not ag:
                want = want[ranks, (ranks + 1) % world]
            assert torch.equal(got, want), (seed, tile_major, rs, ag)


# --------------------------------------------------------------------------- #
# the engine's codec branches
# --------------------------------------------------------------------------- #

def test_engine_fused_dispatch_trace_rows_match_jax_plan(monkeypatch):
    import jax.numpy as jnp

    from adapcc_tpu.comm.pallas_ring import plan_ring_schedule as jax_plan
    from adapcc_tpu.sim.cost_model import wire_bytes_per_element

    monkeypatch.delenv(ring.FUSED_WIRE_ENV, raising=False)
    strategy = Strategy.ring(4)
    strategy.wire_dtype = "int8"
    trace = CollectiveTrace()
    eng = CollectiveEngine(4, strategy, trace=trace)
    x = torch.from_numpy(_payload(4, 4 * 2 * TILE, seed=11))
    out = eng.ring_allreduce(x)
    eng.ring_allreduce(x, wire_dtype="bf16", chunk_bytes=4096)
    eng.ring_reduce_scatter(x, quant_block_size=1024)
    assert [r["impl"] for r in trace_rows(trace)] == ["plain_ring[vmem+int8]", "plain_ring[hbm-stream+bf16]",
                                          "plain_ring[vmem+int8]"]
    for rec, (wire, block, chunk_bytes, rs, ag) in zip(trace_rows(trace), [("int8", 256, None, True, True),
                                                               ("bf16", None, 4096, True, True),
                                                               ("int8", 1024, None, True, False)]):
        plan = jax_plan(x[0].numel(), jnp.float32, 4, chunk_bytes, rs=rs, ag=ag, wire_dtype=wire,
                        block_size=block)
        assert {k: rec[k] for k in plan.to_row()} == plan.to_row()
        assert rec["fused"] is True and rec["nbytes"] == x.numel() * 4
        assert rec["wire_bytes"] == int(plan.payload_bytes / 4.0 * wire_bytes_per_element(wire, block or 1))
    rows = trace_rows(trace)
    assert rows[0]["wire_bytes"] < rows[0]["nbytes"] // 3 // 4 + 1  # ~1/4 of a rank's bytes
    # the CUDA kernels' slot beside the TPU planner's record: a 2048-element
    # chunk's codes, then 8 scales of 4 bytes (JAX pads the scales to a tile)
    assert rows[0]["slot_bytes"] == 2048 + 8 * 4 and rows[0]["scale_slot_bytes"] == 8 * 128 * 4
    assert rows[1]["slot_bytes"] == rows[1]["wire_stage_bytes"] == rows[1]["stage_bytes"] // 2
    assert (np.abs(out[0].numpy() - x.numpy().sum(0)) <= ring_error_bound(x.numpy())).all()


def test_engine_reroute_records_reason_and_notes_once(monkeypatch, capfd):
    monkeypatch.setenv(ring.FUSED_WIRE_ENV, "off")
    monkeypatch.setattr(ring, "_REROUTE_NOTED", set())
    strategy = Strategy.ring(8)
    strategy.wire_dtype = "int8"
    trace = CollectiveTrace()
    eng = CollectiveEngine(8, strategy, trace=trace)
    x = torch.from_numpy(_payload(8, 512, seed=13))
    first, second = eng.ring_allreduce(x), eng.ring_allreduce(x)
    assert torch.equal(first, wire_ring_allreduce_stacked(x, "int8")) and torch.equal(first, second)
    rec = trace_rows(trace)[-1]
    assert rec["impl"] == "quant_ring[int8]" and "ADAPCC_FUSED_WIRE=off" in rec["reroute_reason"]
    assert rec["wire_bytes"] == int(512 * (1 + 4 / 256)) and rec["block_size"] == 256
    err = capfd.readouterr().err
    assert err.count("rerouted off the fused ring kernels") == 1
    # a bf16 payload cannot take the fused kernels either: the quant ring runs
    monkeypatch.delenv(ring.FUSED_WIRE_ENV)
    eng.ring_allreduce(x.bfloat16())
    rec = trace_rows(trace)[-1]
    assert rec["impl"] == "quant_ring[int8]" and "float32" in rec["reroute_reason"]


def test_a_card_the_kernels_were_not_built_for_raises_instead_of_rerouting(monkeypatch, capfd):
    """Only a CPU tensor takes a plain version: the card is no reroute
    reason, and a tensor that is not on the CPU reaches its kernel's launch,
    which raises on a device the kernels were not built for."""
    monkeypatch.delenv(ring.FUSED_WIRE_ENV, raising=False)
    monkeypatch.setattr(ring, "_REROUTE_NOTED", set())
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))
    assert ring.fused_ring_dispatch_reason(torch.float32, "int8", 256) is None
    with pytest.raises(RuntimeError, match="built for sm_90a; cuda:0 is sm_80"):
        ring._check_card(torch.device("cuda", 0))
    strategy = Strategy.ring(4)
    strategy.wire_dtype = "int8"
    trace = CollectiveTrace()
    eng = CollectiveEngine(4, strategy, trace=trace)
    x = torch.empty(4, 4 * TILE, device="meta")
    for call in (eng.ring_allreduce, eng.ring_reduce_scatter, lambda t: eng.ring_allreduce(t, wire_dtype="off")):
        with pytest.raises(ValueError, match="ring kernels run on CUDA or CPU tensors, got meta"):
            call(x)
    assert trace.events() == [] and "rerouted" not in capfd.readouterr().err


def test_engine_rs_ag_refuse_codecs_they_cannot_run(monkeypatch):
    eng = CollectiveEngine(4, Strategy.ring(4))
    x = torch.ones(4, 4 * TILE)
    monkeypatch.setenv(ring.FUSED_WIRE_ENV, "off")
    with pytest.raises(ValueError, match="no unfused wire data plane"):
        eng.ring_reduce_scatter(x, wire_dtype="int8")
    with pytest.raises(ValueError, match="no unfused wire data plane"):
        eng.ring_all_gather(torch.ones(4, TILE), wire_dtype="bf16")
    # an explicit "off" still runs the float32 kernels
    assert torch.equal(eng.ring_reduce_scatter(x, wire_dtype="off"), torch.full((4, TILE), 4.0))
    monkeypatch.setenv(ring.FUSED_WIRE_ENV, "on")
    with pytest.raises(ValueError, match="ADAPCC_FUSED_WIRE=on"):
        eng.ring_allreduce(x.bfloat16(), wire_dtype="int8")
    monkeypatch.delenv(ring.FUSED_WIRE_ENV)
    with pytest.raises(ValueError, match="ring_reduce_scatter"):
        eng.ring_reduce_scatter(x.bfloat16(), wire_dtype="int8")
