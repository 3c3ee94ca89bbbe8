"""The port's optimizer passes, fused codec wire, two-level classification
and per-rank executor held against the JAX package's.

- each pass (``dce``, ``fuse_codec``, ``coalesce``) and the whole pipeline
  on every builder family, plain, relayed and with a codec: the output
  program step for step JAX's, the same fingerprint, verified;
- ``ADAPCC_IR_OPT``: values, precedence and rejections in JAX's words; an
  already-optimal program comes back as the same object; rd at world 8
  coalesces from 14 transfers to 6; a broken pass is rejected naming the
  (rank, round, chunk), as in JAX;
- the fused int8 wire: bit for bit the port's unfused form (rows whose
  blocks are ragged inside each chunk row included); each chunk row's
  codes, scales, decoded and round-tripped values bit for bit JAX's codec
  run op by op on that row; and within ``2·(w−1)`` ulps of the inputs'
  ``Σ|x|`` of JAX's compiled program, where XLA contracts each dequantize
  multiply into its add (one rounding fewer a hop);
  float32 programs bit for bit between naive and optimized;
- two-level worlds: the color classification equal to JAX's, a program
  that does not decompose refused in JAX's words before anything runs, the
  engine's two-level IR run bit for bit the composed plan on integer data,
  and the per-rank two-level form refused until the per-process slice;
- the per-rank executor at world 4 over gloo (rank 0 here, ranks 1-3
  spawned): a ring, an rd and a relayed fused-int8 program against JAX's
  rows, and the transfers each rank posts equal to the color plan's.

Workers import only torch; this module imports JAX inside functions.
"""

import dataclasses
import functools
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch import compiler as pc
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace
from test_torch_compiler import _to_jax

WORLD = 8
RANK_WORLD = 4


def _relay_ring(m, world=WORLD, wire="off"):
    return dataclasses.replace(m.ring_allreduce_program(world, wire_dtype=wire), relays=(world - 1,))


#: the optimizer's domain: every builder family, plain, relayed, with a codec
PROGRAMS = {
    "ring-seg8": lambda m: m.ring_allreduce_program(WORLD),
    "rd8": lambda m: m.rd_allreduce_program(WORLD),
    "tree8": lambda m: m.tree_allreduce_program(WORLD),
    "twolevel-2x4": lambda m: m.two_level_allreduce_program(2, 4),
    "pipelined8": lambda m: m.pipelined_allreduce_program(WORLD),
    "ring-relay": lambda m: _relay_ring(m),
    "rd8-relay": lambda m: dataclasses.replace(m.rd_allreduce_program(WORLD), relays=(WORLD - 1,)),
    "ring4-int8": lambda m: m.ring_allreduce_program(4, wire_dtype="int8"),
    "rd4-int8-relay": lambda m: dataclasses.replace(m.rd_allreduce_program(4, wire_dtype="int8"), relays=(3,)),
    "pipelined4-bf16": lambda m: m.pipelined_allreduce_program(4, wire_dtype="bf16"),
}


@pytest.mark.parametrize("pass_name", ["dce", "fuse_codec", "coalesce", "pipeline"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pass_output_is_jax_program(name, pass_name):
    from adapcc_tpu import compiler as jc

    from test_torch_compiler import _same_steps

    port, ref = PROGRAMS[name](pc), PROGRAMS[name](jc)
    if pass_name == "pipeline":
        got, want = pc.optimize_program(port, passes=pc.PASS_NAMES), jc.optimize_program(ref, passes=jc.PASS_NAMES)
        assert got.applied_passes == want.applied_passes and got.block_size == want.block_size
    else:
        got, want = pc.PASSES[pass_name](port), jc.PASSES[pass_name](ref)
        assert (got is port) == (want is ref)
    _same_steps(got, want)
    pc.verify_program(got)
    assert pc.dispatch_count(got) == jc.dispatch_count(want)
    if pass_name in ("dce", "coalesce"):  # a fused int8 color ships two arrays
        assert pc.dispatch_count(got) <= pc.dispatch_count(port)
    assert pc.round_dispatch_counts(got) == jc.round_dispatch_counts(want)
    assert _to_jax(pc.normalize_program(got)).fingerprint() == jc.normalize_program(want).fingerprint()


def test_resolve_ir_opt_values_and_rejections(monkeypatch):
    from adapcc_tpu.compiler import optimize as jo

    monkeypatch.delenv(pc.IR_OPT_ENV, raising=False)
    for value in (None, "off", "on", "coalesce,dce", "fuse_codec", " On ", "dce, coalesce"):
        assert pc.resolve_ir_opt(value) == jo.resolve_ir_opt(value)
    assert pc.resolve_ir_opt() == pc.PASS_NAMES and pc.resolve_ir_opt("coalesce,dce") == ("dce", "coalesce")
    for bad in ("coalesse", "on,dce", ",", "none"):
        msgs = []
        for mod in (pc.optimize, jo):
            with pytest.raises(ValueError, match="expected off|on or a comma list") as err:
                mod.resolve_ir_opt(bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        monkeypatch.setenv(pc.IR_OPT_ENV, bad)
        with pytest.raises(ValueError, match=pc.IR_OPT_ENV):
            pc.resolve_ir_opt()
        monkeypatch.delenv(pc.IR_OPT_ENV)
    monkeypatch.setenv(pc.IR_OPT_ENV, "off")  # the env beats the argument
    assert pc.resolve_ir_opt("on") == () == jo.resolve_ir_opt("on")
    with pytest.raises(ValueError, match="unknown optimizer pass 'coalesse'"):
        pc.optimize_program(pc.rd_allreduce_program(4), passes=["coalesse"])


def test_identity_coalescing_dce_and_broken_pass_like_jax():
    from adapcc_tpu import compiler as jc

    for prog in (Strategy.ring(WORLD, WORLD).schedule_program(), pc.tree_allreduce_program(WORLD),
                 pc.pipelined_allreduce_program(WORLD)):
        assert pc.optimize_program(prog, passes=pc.PASS_NAMES) is prog
    rd = pc.rd_allreduce_program(WORLD)
    opt = pc.optimize_program(rd, passes=pc.PASS_NAMES)
    assert (pc.dispatch_count(rd), pc.dispatch_count(opt), opt.applied_passes) == (14, 6, ("coalesce",))
    assert opt.fingerprint() != rd.fingerprint() and "|b" not in rd.fingerprint()
    assert pc.optimize_program(rd, passes=["dce"]) is rd
    relay = _relay_ring(pc)
    pruned = pc.optimize_program(relay, passes=["dce"])
    assert pruned.applied_passes == ("dce",) and pruned.total_sends() < relay.total_sends()

    def clobber_first_reduce(m):
        def rewrite(program):
            rounds, broken = [], False
            for rnd in program.rounds:
                steps = []
                for s in rnd:
                    if not broken and s.kind == "reduce":
                        s, broken = m.Step("copy", s.rank, s.chunk, span=s.span), True
                    steps.append(s)
                rounds.append(tuple(steps))
            return dataclasses.replace(program, rounds=tuple(rounds))
        return rewrite

    msgs = []
    for m in (pc, jc):
        with pytest.raises(m.ScheduleVerificationError, match=r"rank=\d+, round=\d+, chunk=\d+") as err:
            m.optimize_program(m.rd_allreduce_program(WORLD), passes=[("clobber", clobber_first_reduce(m))])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------- #
# the fused codec wire and float32 bit identity
# --------------------------------------------------------------------------- #

#: the fused programs at world 4: (name, builder, payload elements) — 1001
#: elements make 251-element chunk rows (one ragged block each), 2803 make
#: 701 (two whole blocks and a ragged one), at the default block of 256
FUSED = {
    "ring-int8": (lambda m: m.ring_allreduce_program(RANK_WORLD, wire_dtype="int8"), 1001),
    "pipelined-int8": (lambda m: m.pipelined_allreduce_program(RANK_WORLD, wire_dtype="int8"), 2803),
    "relay-ring-int8": (lambda m: _relay_ring(m, RANK_WORLD, "int8"), 1001),
    "rd-int8": (lambda m: m.rd_allreduce_program(RANK_WORLD, wire_dtype="int8"), 2803),
    "twolevel-int8": (lambda m: m.two_level_allreduce_program(2, 2, wire_dtype="int8"), 1001),
}


def _fused_input(n, seed=5):
    return np.random.default_rng(seed).normal(size=(RANK_WORLD, n)).astype(np.float32)


def _jax_run(program, xn, op_name="SUM"):
    """JAX's executor (``allreduce_per_shard``) on world-4 rows, compiled."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu import compiler as jc
    from adapcc_tpu.primitives import ReduceOp as JOp

    mesh = Mesh(np.array(jax.devices()[:RANK_WORLD]), ("ranks",))
    fn = jax.shard_map(jc.allreduce_per_shard(program, "ranks", getattr(JOp, op_name)), mesh=mesh,
                       in_specs=P("ranks"), out_specs=P("ranks"), check_vma=False)
    return np.asarray(jax.jit(fn)(xn[:, None]))[:, 0]


def _contraction_bound(xn, world):
    """JAX's compiled fused program rounds each hop's dequantize-and-add
    once where the port rounds twice: at most an ulp of the partial sum a
    hop (bounded by ``Σ|x|``), re-encoded downstream, so ``2·(w−1)`` ulps of
    ``Σ|x|``."""
    return 2 * (world - 1) * np.spacing(np.abs(xn).sum(0).astype(np.float32))


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_int8_equals_unfused_and_jax(name):
    from adapcc_tpu import compiler as jc

    build, n = FUSED[name]
    naive = build(pc)
    fused = pc.optimize_program(naive, passes=pc.PASS_NAMES)
    assert "fuse_codec" in fused.applied_passes and fused.block_size == 256
    assert any(s.kind == "send" and s.codec == "int8" for _, s in fused.steps())
    xn = _fused_input(n)
    live = list(naive.contributors())
    got = pc.execute_program_stacked(torch.from_numpy(xn), fused).numpy()
    unfused = pc.execute_program_stacked(torch.from_numpy(xn), naive).numpy()
    assert np.array_equal(got[live].view(np.int32), unfused[live].view(np.int32))
    assert not np.array_equal(got[live], np.broadcast_to(xn[live].sum(0), got[live].shape))  # the codec ran
    ref_fused = jc.optimize_program(build(jc), passes=jc.PASS_NAMES)
    assert ref_fused.fingerprint() == fused.fingerprint()
    want = _jax_run(ref_fused, xn)
    assert (np.abs(got[live] - want[live]) <= _contraction_bound(xn, RANK_WORLD)).all()
    # the block size is the program's: a fused program at 128 is its own program
    small = dataclasses.replace(fused, block_size=128)
    assert small.fingerprint() != fused.fingerprint()
    assert np.array_equal(pc.execute_program_stacked(torch.from_numpy(xn), small).numpy()[live].view(np.int32),
                          pc.execute_program_stacked(torch.from_numpy(xn), dataclasses.replace(
                              naive, block_size=128)).numpy()[live].view(np.int32))


@pytest.mark.parametrize("seg,block", [(251, 256), (701, 256), (701, 128), (1024, 256)])
def test_row_codec_is_jax_codec_op_by_op(seg, block):
    """The executor encodes each chunk row on its own: codes, scales, the
    decoded row and the unfused round trip, row by row, bit for bit JAX's
    codec (eager, op by op) on that row; float32 and bfloat16 rows."""
    import jax.numpy as jnp

    from adapcc_tpu.quant.codec import get_codec as jget

    from adapcc_tpu_torch.compiler import lower

    rows = np.random.default_rng(seg + block).normal(size=(3, seg)).astype(np.float32) * 3
    rows[1, : seg // 2] = 0.0  # an all-zero block keeps scale 1
    for dtype in (torch.float32, torch.bfloat16):
        wire = torch.from_numpy(rows).to(dtype)
        q, scales = lower._encode_rows("int8", wire, block)
        decoded = lower._decode_rows("int8", (q, scales), seg, block)
        applied = lower._apply_codec(wire, True, "int8", block)
        for r in range(rows.shape[0]):
            jrow = jnp.asarray(wire[r].float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else
                                                                 jnp.float32)
            jq, js = jget("int8").encode(jrow.astype(jnp.float32), block)
            assert np.array_equal(q[r].numpy(), np.asarray(jq)) and np.array_equal(scales[r].numpy(), np.asarray(js))
            jd = np.asarray(jget("int8").decode((jq, js), seg, block))
            assert np.array_equal(decoded[r].numpy().view(np.int32), jd.view(np.int32))
            ja = np.asarray(jget("int8").apply(jrow, block).astype(jnp.float32))
            assert np.array_equal(applied[r].float().numpy().view(np.int32), ja.view(np.int32))


def test_fused_wire_dispatches_and_float_identity():
    """A fused int8 color ships codes and scales (two transfers); bf16 one;
    on float32 the optimized program is the naive one bit for bit (the
    relay's own row aside: dce drops deliveries no one reads)."""
    ring = pc.ring_allreduce_program(RANK_WORLD, wire_dtype="int8")
    fused = pc.optimize_program(ring, passes=["fuse_codec"])
    assert pc.round_dispatch_counts(ring) == [1] * 6
    assert pc.round_dispatch_counts(fused) == [2, 2, 2, 1, 1, 1]  # the all-gather ships decoded sums
    bf16 = pc.optimize_program(pc.ring_allreduce_program(RANK_WORLD, wire_dtype="bf16"), passes=["fuse_codec"])
    assert pc.dispatch_count(bf16) == pc.dispatch_count(ring)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(WORLD, 96)).astype(np.float32))
    for name in ("ring-seg8", "rd8", "tree8", "twolevel-2x4", "pipelined8", "ring-relay", "rd8-relay"):
        prog = PROGRAMS[name](pc)
        opt = pc.optimize_program(prog, passes=pc.PASS_NAMES)
        live = list(prog.contributors())
        for op in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.AVG):
            a, b = pc.execute_program_stacked(x, prog, op), pc.execute_program_stacked(x, opt, op)
            assert torch.equal(a[live].view(torch.int32), b[live].view(torch.int32)), (name, op)
    # bf16 fused against its unfused form, and a bf16 payload through int8
    for prog, xt in ((pc.pipelined_allreduce_program(RANK_WORLD, wire_dtype="bf16"), x[:RANK_WORLD]),
                     (pc.ring_allreduce_program(RANK_WORLD, wire_dtype="int8"), x[:RANK_WORLD].bfloat16())):
        opt = pc.optimize_program(prog, passes=pc.PASS_NAMES)
        a, b = pc.execute_program_stacked(xt, prog), pc.execute_program_stacked(xt, opt)
        assert a.dtype == xt.dtype and torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                                                   b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


# --------------------------------------------------------------------------- #
# two-level worlds
# --------------------------------------------------------------------------- #


def test_two_level_classification_refusal_and_engine(monkeypatch):
    from adapcc_tpu import compiler as jc

    from adapcc_tpu_torch.strategy.hierarchy import HierarchySketch, synthesize_two_level

    for pods, size in ((2, 4), (4, 2)):
        port = pc.optimize_program(pc.two_level_allreduce_program(pods, size), passes=pc.PASS_NAMES)
        ref = jc.optimize_program(jc.two_level_allreduce_program(pods, size), passes=jc.PASS_NAMES)
        assert pc.two_level_color_axes(port, pods, size) == jc.two_level_color_axes(ref, pods, size)
    axes = pc.two_level_color_axes(pc.two_level_allreduce_program(2, 4), 2, 4)
    assert {a for rnd in axes for a, _ in rnd} == {"ici", "dcn"}
    msgs = []
    for m in (pc, jc):
        for args in ((m.ring_allreduce_program(WORLD), 2, 4), (m.ring_allreduce_program(WORLD), 3, 3)):
            with pytest.raises(ValueError, match="round|mesh is 3x3") as err:
                m.two_level_color_axes(*args)
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]
    # the engine on 2 slices x 4: the composed two-level program, bit for bit
    # the composed plan on integer data, the hierarchy in the trace
    monkeypatch.setenv("ADAPCC_IR_OPT", "on")
    plan = synthesize_two_level(HierarchySketch(2, 4), nbytes=1 << 20)
    eng = CollectiveEngine(WORLD, plan.strategy, trace=CollectiveTrace(), num_slices=2)
    x = torch.from_numpy(np.random.default_rng(11).integers(-8, 9, size=(WORLD, 23)).astype(np.float32))
    got = eng.all_reduce(x, algo="ir")
    ev = eng.trace.events()[-1]
    assert ev.impl == "ir" and ev.extra["hier"] == "2x4" and ev.extra["program"] == "two-level-2x4"
    assert ev.extra["dispatches"] == pc.dispatch_count(eng.optimized_schedule_program())
    want = eng.all_reduce(x)
    assert eng.trace.events()[-1].impl == "two_level[composed]"
    assert torch.equal(got, want) and torch.equal(got[0], x.sum(0))
    # a program that does not decompose is refused before anything runs
    eng.set_schedule_program(pc.ring_allreduce_program(WORLD))
    with pytest.raises(ValueError, match="round 0 has a transfer group"):
        eng.all_reduce(x, algo="ir")
    with pytest.raises(NotImplementedError, match="per-process slice"):
        pc.execute_program_two_level_shard(x[0], pc.two_level_allreduce_program(2, 4), 2, 4)
    with pytest.raises(ValueError, match="round"):
        pc.execute_program_two_level_shard(x[0], pc.ring_allreduce_program(WORLD), 2, 4)


# --------------------------------------------------------------------------- #
# the per-rank form over gloo
# --------------------------------------------------------------------------- #

#: (name, builder, op, input): the per-rank runs
RANK_CASES = [
    ("ring", lambda m: m.ring_allreduce_program(RANK_WORLD), "SUM", "f32"),
    ("rd", lambda m: m.rd_allreduce_program(RANK_WORLD), "AVG", "f32"),
    ("rd-int", lambda m: m.rd_allreduce_program(RANK_WORLD), "MAX", "i32"),
    ("relay-int8", lambda m: _relay_ring(m, RANK_WORLD, "int8"), "SUM", "f32"),
]


def _rank_inputs():
    rng = np.random.default_rng(17)
    return {"f32": rng.normal(size=(RANK_WORLD, 2803)).astype(np.float32),
            "i32": rng.integers(-50, 50, size=(RANK_WORLD, 37)).astype(np.int32)}


def _rank_results(rank, init_method):
    """This rank's result of every case (each through ``ir_allreduce_shard``,
    which optimizes it: the int8 case runs fused), and the transfers this
    rank posted."""
    import torch.distributed as dist

    from adapcc_tpu_torch.comm.engine import ir_allreduce_shard
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    build_world_mesh(RANK_WORLD, rank=rank, device="cpu", init_method=init_method)
    posted = []
    real = dist.batch_isend_irecv
    dist.batch_isend_irecv = lambda ops: posted.append(len(ops)) or real(ops)
    try:
        inputs = _rank_inputs()
        outs, counts = [], []
        for _, build, op, dt in RANK_CASES:
            before = len(posted)
            out = ir_allreduce_shard(torch.from_numpy(inputs[dt][rank].copy()), build(pc), getattr(ReduceOp, op))
            outs.append(out.numpy())
            counts.append(len(posted) - before)
        return outs, counts
    finally:
        dist.batch_isend_irecv = real
        destroy_world()


def _rank_child(rank, init_method):
    torch.set_num_threads(1)
    return _rank_results(rank, init_method)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _jax_rank_rows():
    """JAX's rows of the per-rank cases, each program optimized as JAX's
    engine would, compiled."""
    from adapcc_tpu import compiler as jc

    inputs = _rank_inputs()
    return [_jax_run(jc.optimize_program(build(jc), passes=jc.PASS_NAMES), inputs[dt], op)
            for _, build, op, dt in RANK_CASES]


def test_per_rank_executor_over_gloo_matches_jax(monkeypatch):
    monkeypatch.setenv("ADAPCC_IR_OPT", "on")
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(RANK_WORLD - 1) as pool:
        pending = [pool.apply_async(_rank_child, (r, init_method)) for r in range(1, RANK_WORLD)]
        rows = _jax_rank_rows()  # while the workers start
        per_rank = [_rank_results(0, init_method)] + [p.get(timeout=120) for p in pending]
    inputs = _rank_inputs()
    for i, (name, build, op, dt) in enumerate(RANK_CASES):
        program = pc.optimize_program(build(pc), passes=pc.PASS_NAMES)
        got = np.stack([per_rank[r][0][i] for r in range(RANK_WORLD)])
        live = list(program.contributors())
        # each rank posted one batch a color and wire array it has an edge in
        for r in range(RANK_WORLD):
            want_posts = sum(col.dispatches() for rnd in pc.lower._color_rounds(program) for col in rnd
                             if any(r in pair for pair in col.perm))
            assert per_rank[r][1][i] == want_posts, (name, r)
        stacked = pc.execute_program_stacked(torch.from_numpy(inputs[dt]), program, getattr(ReduceOp, op)).numpy()
        assert np.array_equal(got[live].view(np.uint8), stacked[live].view(np.uint8)), name
        if name == "relay-int8":
            assert (np.abs(got[live] - rows[i][live]) <= _contraction_bound(inputs[dt], RANK_WORLD)).all()
        else:
            assert got.dtype == rows[i].dtype and np.array_equal(got.view(np.uint8), rows[i].view(np.uint8)), name
