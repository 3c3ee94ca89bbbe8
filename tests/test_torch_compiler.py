"""The port's schedule compiler held against the JAX package's.

- the IR: construction errors in JAX's words, and fingerprints equal to
  JAX's for every builder, a relay program, a pipeline program and the
  optimized programs;
- the builders and the pipelined program: step for step JAX's, verified by
  both packages; each verifier rejection with JAX's message, the same
  (rank, round, chunk) in it;
- program XML byte for byte in both directions, and the schema-major
  refusal; ``schedule_program_time`` equal to JAX's to the float;
- the stacked executor at world 8 against the JAX executor the engine's
  ``all_reduce(algo="ir")`` runs, on the 8-device CPU mesh, for the ring,
  rd, tree, relay and pipelined programs, over a cover of SUM, MAX and AVG
  on float32 and int32 (every op and dtype on some program): bit for bit, but where AVG divides by a count that is
  not a power of two (JAX's ``jit`` multiplies by the float32 reciprocal,
  the port divides), there bit for bit JAX's SUM rows divided in IEEE
  float32 and within one ulp of JAX's AVG rows;
- the engine: its routes, refusals and trace extras beside JAX's, and the
  tuner's ``ir`` / ``ir-opt`` cells, whose database lines load in the JAX
  package's ``TuningDatabase`` unchanged.

This module imports JAX inside functions.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from adapcc_tpu_torch import compiler as pc
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace

WORLD = 8
FIXTURE_XML = "tests/fixtures/strategy/4-4_1.xml"


@pytest.fixture(autouse=True)
def cold_program_memos():
    """Both packages memoize a strategy's derived program process-wide
    (``strategy/ir.py::_PROGRAM_CACHE``), and the engine traces whether its
    lookup hit (``program_cache_hit``).  A file run earlier in the same
    process (JAX's ``tests/test_compiler.py`` derives the ring program)
    leaves one memo warm and the other cold, and the two traces then
    differ.  Each test here starts with both memos empty."""
    from adapcc_tpu.strategy import ir as jax_ir
    from adapcc_tpu_torch.strategy import ir as port_ir

    for memo in (jax_ir._PROGRAM_CACHE, port_ir._PROGRAM_CACHE):
        memo.clear()
    yield


def _to_jax(program):
    """A port program as the JAX package's, field for field."""
    from adapcc_tpu import compiler as jc

    rounds = tuple(tuple(jc.Step(s.kind, s.rank, s.chunk, peer=s.peer, codec=s.codec, span=s.span) for s in rnd)
                   for rnd in program.rounds)
    return jc.ScheduleProgram(
        name=program.name, world=program.world, chunks=program.chunks, rounds=rounds,
        collective=program.collective, wire_dtype=program.wire_dtype, relays=program.relays,
        chunk_sources=program.chunk_sources, chunk_sinks=program.chunk_sinks,
        block_size=program.block_size, applied_passes=program.applied_passes,
    )


def _same_steps(port, ref):
    assert port.fingerprint() == ref.fingerprint()
    assert [[(s.kind, s.rank, s.chunk, s.peer, s.codec, s.span) for s in r] for r in port.rounds] == \
        [[(s.kind, s.rank, s.chunk, s.peer, s.codec, s.span) for s in r] for r in ref.rounds]


def _pipeline_program(m):
    """A two-hop point-to-point program (chunk 0: rank 0 → 1 → 2)."""
    return m.ScheduleProgram(
        name="hop", world=3, chunks=1, collective="pipeline", chunk_sources=(0,), chunk_sinks=(2,),
        rounds=((m.Step("send", 0, 0, peer=1), m.Step("recv", 1, 0, peer=0), m.Step("copy", 1, 0)),
                (m.Step("send", 1, 0, peer=2), m.Step("recv", 2, 0, peer=1), m.Step("copy", 2, 0))),
    )


def _builds(m, strategy_mod, xml_parse):
    """Every builder, both packages: (name, program)."""
    return [
        ("ring8", m.ring_allreduce_program(WORLD)),
        ("ring4-int8", m.ring_allreduce_program(4, wire_dtype="int8")),
        ("rd8", m.rd_allreduce_program(WORLD)),
        ("rd4-bf16", m.rd_allreduce_program(4, wire_dtype="bf16")),
        ("tree8", m.tree_allreduce_program(WORLD)),
        ("tree6", m.tree_allreduce_program(6)),
        ("twolevel-2x4", m.two_level_allreduce_program(2, 4)),
        ("twolevel-3x2-int8", m.two_level_allreduce_program(3, 2, wire_dtype="int8")),
        ("pipelined8", m.pipelined_allreduce_program(WORLD)),
        ("pipelined3-int8", m.pipelined_allreduce_program(3, wire_dtype="int8")),
        ("binary8x2", m.program_from_strategy(strategy_mod.Strategy.binary(WORLD, 2))),
        ("fixture", m.program_from_strategy(xml_parse(FIXTURE_XML))),
        ("relay", dataclasses.replace(m.ring_allreduce_program(WORLD), relays=(3,))),
        ("hop", _pipeline_program(m)),
    ]


@functools.lru_cache(maxsize=None)
def _both_builds():
    from adapcc_tpu import compiler as jc
    from adapcc_tpu.strategy import ir as jir
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jparse

    from adapcc_tpu_torch.strategy import ir as pir
    from adapcc_tpu_torch.strategy.xml_io import parse_strategy_xml as pparse

    return list(zip(_builds(pc, pir, pparse), _builds(jc, jir, jparse)))


# --------------------------------------------------------------------------- #
# the IR, the builders, the verifier
# --------------------------------------------------------------------------- #


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def test_ir_validation_and_fingerprints_equal_jax():
    from adapcc_tpu import compiler as jc

    bad = [
        lambda m: m.Step("teleport", 0, 0),
        lambda m: m.Step("send", 0, 0),
        lambda m: m.Step("encode", 1, 0),
        lambda m: m.Step("copy", 1, 0, span=0),
        lambda m: m.ScheduleProgram("p", 0, 1, ()),
        lambda m: m.ScheduleProgram("p", 2, 0, ()),
        lambda m: m.ScheduleProgram("p", 2, 1, (), collective="gather"),
        lambda m: m.ScheduleProgram("p", 2, 1, (), relays=(2,)),
        lambda m: m.ScheduleProgram("p", 2, 1, (), relays=(0, 1)),
        lambda m: m.ScheduleProgram("p", 2, 1, (), collective="pipeline"),
        lambda m: m.ScheduleProgram("p", 2, 1, (), collective="pipeline", chunk_sources=(0,), chunk_sinks=(1,),
                                    relays=(1,)),
        lambda m: m.ScheduleProgram("p", 2, 1, (), collective="pipeline", chunk_sources=(0,), chunk_sinks=(5,)),
        lambda m: m.ScheduleProgram("p", 2, 1, (), chunk_sources=(0,)),
        lambda m: m.ScheduleProgram("p", 2, 1, (), block_size=0),
        lambda m: m.ScheduleProgram("p", 2, 1, ((m.Step("copy", 4, 0),),)),
        lambda m: m.ScheduleProgram("p", 2, 1, ((m.Step("send", 0, 0, peer=3),),)),
        lambda m: m.ScheduleProgram("p", 2, 1, ((m.Step("copy", 0, 1),),)),
        lambda m: m.ScheduleProgram("p", 2, 2, ((m.Step("copy", 0, 1, span=2),),)),
    ]
    for make in bad:
        got, want = _error(lambda: make(pc)), _error(lambda: make(jc))
        assert got is not None and got == want
    for (name, port), (_, ref) in _both_builds():
        _same_steps(port, ref)
        assert repr(port) == repr(ref) and port.contributors() == ref.contributors(), name
        assert port.total_sends() == ref.total_sends() and port.num_rounds == ref.num_rounds
    # optimizer provenance and block geometry fold into the fingerprint alike
    prog = pc.rd_allreduce_program(WORLD)
    for variant in (dataclasses.replace(prog, applied_passes=("coalesce",)),
                    dataclasses.replace(prog, block_size=128, applied_passes=("fuse_codec", "coalesce"))):
        assert variant.fingerprint() == _to_jax(variant).fingerprint() != prog.fingerprint()


def test_builders_verified_by_both_packages_and_rd_refusal():
    from adapcc_tpu import compiler as jc

    for (name, port), (_, ref) in _both_builds():
        pc.verify_program(port)
        jc.verify_program(_to_jax(port))
        jc.verify_program(ref)
    for m in (pc, jc):
        with pytest.raises(ValueError, match="power-of-two world, got 6"):
            m.rd_allreduce_program(6)
        with pytest.raises(ValueError, match="world >= 2, got 1"):
            m.pipelined_allreduce_program(1)
        with pytest.raises(ValueError, match="pods >= 1"):
            m.two_level_allreduce_program(0, 4)
    # the pipelined ring ships two chunks a rank a round: no CommRound holds it
    prog = pc.pipelined_allreduce_program(WORLD)
    assert all(sum(s.kind == "send" and s.rank == 0 for s in rnd) == 2 for rnd in prog.rounds)


def _drop(program, pick):
    """``program`` without the first step ``pick`` selects."""
    victim = next(s for _, s in program.steps() if pick(s))
    rounds = [tuple(s for s in rnd if s is not victim) for rnd in program.rounds]
    return dataclasses.replace(program, rounds=tuple(rounds))


def _swap(program, pick, make):
    """``program`` with the first step ``pick`` selects replaced by ``make(step)``."""
    victim = next(s for _, s in program.steps() if pick(s))
    rounds = [tuple(make(s) if s is victim else s for s in rnd) for rnd in program.rounds]
    return dataclasses.replace(program, rounds=tuple(rounds))


def _append(program, round_idx, steps):
    rounds = list(program.rounds)
    rounds[round_idx] = rounds[round_idx] + tuple(steps)
    return dataclasses.replace(program, rounds=tuple(rounds))


#: verifier mutations, each built the same way in both packages
MUTATIONS = {
    "dropped-recv": lambda m: _drop(m.ring_allreduce_program(4), lambda s: s.kind == "recv"),
    "dropped-send": lambda m: _drop(m.ring_allreduce_program(4), lambda s: s.kind == "send"),
    "duplicate-send": lambda m: _append(m.ring_allreduce_program(4), 0, [m.Step("send", 0, 0, peer=1)]),
    "double-consume": lambda m: _append(m.rd_allreduce_program(4), 0, [m.Step("reduce", 2, 0)]),
    "no-recv-feeds": lambda m: _append(m.rd_allreduce_program(4), 0, [m.Step("copy", 3, 3)]),
    "unconsumed-recv": lambda m: _drop(m.tree_allreduce_program(4), lambda s: s.kind == "copy"),
    "double-reduce": lambda m: _swap(m.rd_allreduce_program(4), lambda s: s.kind == "copy",
                                     lambda s: m.Step("reduce", s.rank, s.chunk)),
    "orphaned-encode": lambda m: _drop(m.ring_allreduce_program(4, "int8"), lambda s: s.kind == "decode"),
    "codec-mismatch": lambda m: _swap(m.ring_allreduce_program(4, "int8"), lambda s: s.kind == "decode",
                                      lambda s: m.Step("decode", s.rank, s.chunk, codec="bf16")),
    "unencoded-decode": lambda m: _drop(m.ring_allreduce_program(4, "int8"), lambda s: s.kind == "encode"),
    "undelivered": lambda m: m.ScheduleProgram("short", 4, 4, m.ring_allreduce_program(4).rounds[:-1]),
    "pipeline-unheld": lambda m: dataclasses.replace(
        _pipeline_program(m), rounds=tuple(reversed(_pipeline_program(m).rounds))),
    "span-double-reduce": lambda m: m.ScheduleProgram("s", 2, 2, (
        (m.Step("send", 0, 0, peer=1, span=2), m.Step("recv", 1, 0, peer=0, span=2), m.Step("reduce", 1, 0, span=2)),
    ) * 2),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_verifier_rejections_match_jax(mutation):
    """Each broken program is rejected by both verifiers with the same
    message, naming the same (rank, round, chunk)."""
    from adapcc_tpu import compiler as jc

    make = MUTATIONS[mutation]
    port = make(pc)
    msgs = []
    for m, prog in ((pc, port), (jc, make(jc))):
        with pytest.raises(m.ScheduleVerificationError, match=r"\(rank=\d+, round=\d+, chunk=\d+\)") as err:
            m.verify_program(prog)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert port.fingerprint() == _to_jax(port).fingerprint()


# --------------------------------------------------------------------------- #
# artifacts and pricing
# --------------------------------------------------------------------------- #


def test_program_xml_byte_for_byte_both_ways(tmp_path):
    from adapcc_tpu.strategy import xml_io as jx

    from adapcc_tpu_torch.strategy import xml_io as px

    for (name, port), (_, ref) in _both_builds():
        text = px.emit_program_xml(port, str(tmp_path / f"{name}.xml"))
        assert text == jx.emit_program_xml(ref) == (tmp_path / f"{name}.xml").read_text()
        if port.chunk_sources:
            # the artifact keeps no pipeline routing, in JAX as here
            assert _error(lambda: px.parse_program_xml(text)) == _error(lambda: jx.parse_program_xml(text)) != None
            continue
        back = px.parse_program_xml(str(tmp_path / f"{name}.xml"))
        assert back.fingerprint() == jx.parse_program_xml(text).fingerprint() == port.fingerprint()
        assert back.relays == port.relays
        pc.verify_program(back)
        assert px.emit_program_xml(back) == text
    text = px.emit_program_xml(pc.pipelined_allreduce_program(4))
    msgs = []
    for mod in (px, jx):
        with pytest.raises(ValueError, match="schema major") as err:
            mod.parse_program_xml(text.replace('schema="1.0"', 'schema="2.0"'))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert px.parse_program_xml(text.replace('schema="1.0"', 'schema="1.4"')).fingerprint() == \
        pc.pipelined_allreduce_program(4).fingerprint()
    for bad, match in (("<trees/>", "expected <schedule>"), ('<schedule world="x" chunks="1"/>', "world/chunks")):
        with pytest.raises(ValueError, match=match):
            px.parse_program_xml(bad)


def test_schedule_program_time_equals_jax():
    from adapcc_tpu import compiler as jc
    from adapcc_tpu.sim import cost_model as jcm

    from adapcc_tpu_torch.sim import cost_model as pcm

    progs = [(p, r) for (_, p), (_, r) in _both_builds()]
    progs += [(pc.optimize_program(p, passes=pc.PASS_NAMES), jc.optimize_program(r, passes=jc.PASS_NAMES))
              for p, r in progs[:10]]
    progs.append((pc.ring_allreduce_program(1), jc.ring_allreduce_program(1)))
    for alpha, beta in ((1e-6, 1 / 25e9), (38.861e-6, 1 / 450e9), (0.0, 1e-9)):
        for nbytes in (4.0, 4096.0, float(1 << 20), float(128 << 20)):
            for per_dispatch in (0.0, alpha, 2e-6):
                for p, r in progs:
                    assert pcm.schedule_program_time(p, nbytes, pcm.LinkCoeffs(alpha, beta), per_dispatch) == \
                        jcm.schedule_program_time(r, nbytes, jcm.LinkCoeffs(alpha, beta), per_dispatch)
    # the closed forms: the segmented ring, and the pipelined ring at half its β term
    c = pcm.LinkCoeffs(1e-6, 1 / 25e9)
    n = float(128 << 20)
    assert pcm.schedule_program_time(pc.ring_allreduce_program(WORLD), n, c) == \
        pytest.approx(2 * (WORLD - 1) * c.time(n / WORLD))
    assert pcm.schedule_program_time(pc.pipelined_allreduce_program(WORLD), n, c) == \
        pytest.approx(2 * (WORLD - 1) * c.time(n / (2 * WORLD)))


# --------------------------------------------------------------------------- #
# the stacked executor against the JAX executor
# --------------------------------------------------------------------------- #

#: the executor's programs at world 8 (name -> builder over a compiler
#: module) and the cover each runs: every op and dtype on some program, AVG
#: on one with a power-of-two count of contributors and on relayed ones
EXEC_PROGRAMS = {
    "ring": lambda m: m.ring_allreduce_program(WORLD),
    "rd": lambda m: m.rd_allreduce_program(WORLD),
    "tree": lambda m: m.tree_allreduce_program(WORLD),
    "relay": lambda m: dataclasses.replace(m.rd_allreduce_program(WORLD), relays=(3,)),
    "pipelined": lambda m: m.pipelined_allreduce_program(WORLD),
    "ring-relays": lambda m: dataclasses.replace(m.ring_allreduce_program(WORLD), relays=(3, 6)),
}
EXEC_CASES = {
    "ring": [("f32", "SUM"), ("f32", "MAX"), ("i32", "AVG")],
    "rd": [("f32", "SUM"), ("i32", "MAX"), ("f32", "AVG")],
    "tree": [("f32", "AVG"), ("i32", "SUM"), ("f32", "MAX")],
    "relay": [("f32", "SUM"), ("f32", "AVG"), ("i32", "SUM"), ("i32", "AVG"), ("f32", "MAX")],
    "pipelined": [("f32", "SUM"), ("i32", "SUM"), ("i32", "AVG"), ("f32", "MAX")],
    "ring-relays": [("f32", "SUM"), ("f32", "AVG"), ("i32", "MAX"), ("i32", "SUM")],
}


def _exec_inputs():
    rng = np.random.default_rng(13)
    f32 = (rng.normal(size=(WORLD, 1001)) * 4).astype(np.float32)
    f32[:, 0] = -0.0
    return {"f32": f32, "i32": rng.integers(-1000, 1000, size=(WORLD, 203)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_exec_rows():
    """JAX's rows of every (program, case): the executor ``engine.all_reduce(
    algo="ir")`` runs (``allreduce_per_shard``), every program and case in
    one compiled shard_map."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu import compiler as jc
    from adapcc_tpu.primitives import ReduceOp as JOp

    inputs = _exec_inputs()
    programs = {name: build(jc) for name, build in EXEC_PROGRAMS.items()}
    keys = [(name, dt, op) for name in programs for dt, op in EXEC_CASES[name]]

    def body(xf, xi):
        xs = {"f32": xf, "i32": xi}
        return tuple(jc.allreduce_per_shard(programs[name], "ranks", getattr(JOp, op))(xs[dt]) for name, dt, op in keys)

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("ranks",))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("ranks"), P("ranks")),
                               out_specs=tuple(P("ranks") for _ in keys), check_vma=False))
    outs = fn(*(jnp.asarray(inputs[k])[:, None] for k in ("f32", "i32")))
    return {key: np.asarray(o)[:, 0] for key, o in zip(keys, outs)}


def _assert_ir_rows(got, rows, key, contributors):
    """``got`` against JAX's rows of ``key``: bit for bit, but an AVG over a
    count that is not a power of two, which is bit for bit JAX's SUM rows
    divided in IEEE float32 and within one ulp of JAX's AVG rows."""
    name, dt, op = key
    want = rows[key]
    assert got.dtype == want.dtype and got.shape == want.shape, (key, got.dtype, want.dtype)
    if op == "AVG" and contributors & (contributors - 1):
        total = rows[(name, dt, "SUM")]  # a SUM of the same input is in every AVG program's cover
        quotient = total.astype(np.float32) / np.float32(contributors)
        assert np.array_equal(got.view(np.uint8), quotient.view(np.uint8)), key
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), key


@pytest.mark.parametrize("name", sorted(EXEC_PROGRAMS))
def test_stacked_executor_matches_jax_engine_rows(name):
    rows = _jax_exec_rows()
    inputs = _exec_inputs()
    program = EXEC_PROGRAMS[name](pc)
    pc.verify_program(program)
    for dt, op in EXEC_CASES[name]:
        got = pc.execute_program_stacked(torch.from_numpy(inputs[dt]), program, getattr(ReduceOp, op))
        assert got.dtype == (torch.float32 if op == "AVG" else torch.from_numpy(inputs[dt]).dtype)
        live = list(program.contributors())
        want = {k: v[live] for k, v in rows.items() if k[0] == name}
        _assert_ir_rows(got.numpy()[live], want, (name, dt, op), len(live))


def test_stacked_executor_shape_and_world_refusal():
    program = pc.ring_allreduce_program(4)
    x = torch.arange(4 * 2 * 3, dtype=torch.float32).view(4, 2, 3)
    out = pc.execute_program_stacked(x, program)
    assert out.shape == x.shape and torch.equal(out, x.sum(0).expand_as(x))
    assert torch.equal(pc.execute_program_stacked(torch.ones(4, 0), program), torch.ones(4, 0))
    with pytest.raises(ValueError, match="is for world 4"):
        pc.execute_program_stacked(torch.ones(8, 3), program)
    # the input is never written
    y = x.clone()
    pc.execute_program_stacked(x, pc.rd_allreduce_program(4), ReduceOp.MAX)
    assert torch.equal(x, y)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #


def _engines(mesh, strategy_spec=("ring", WORLD)):
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.strategy.ir import Strategy as JStrategy
    from adapcc_tpu.utils.observability import CollectiveTrace as JTrace

    kind, arg = strategy_spec
    port = CollectiveEngine(WORLD, getattr(Strategy, kind)(WORLD, arg), trace=CollectiveTrace())
    ref = JEngine(mesh, getattr(JStrategy, kind)(WORLD, arg), trace=JTrace())
    return port, ref


def _ir_extras(extra):
    return {k: v for k, v in extra.items() if k not in ("cache_hit", "epoch")}


def test_engine_ir_routes_and_trace_extras_like_jax(mesh8, monkeypatch):
    """``all_reduce(algo="ir")`` and ``ring_allreduce`` under the env pin on
    both engines: the rows (bit for bit: ring(8, 8) is the segmented ring,
    the IR's own program), the impl and every IR trace extra alike."""
    import jax.numpy as jnp

    monkeypatch.delenv("ADAPCC_IR_OPT", raising=False)
    port, ref = _engines(mesh8)
    x = np.random.default_rng(2).normal(size=(WORLD, 96)).astype(np.float32)
    got = port.all_reduce(torch.from_numpy(x), algo="ir")
    want = ref.all_reduce(jnp.asarray(x), algo="ir")
    assert np.array_equal(got.numpy(), np.asarray(want))
    pe, je = port.trace.events()[-1], ref.trace.events()[-1]
    assert pe.impl == je.impl == "ir"
    assert _ir_extras(pe.extra) == _ir_extras(je.extra)
    assert pe.extra["program"].startswith("strategy-ring") and pe.extra["program_cache_hit"] is False
    # the legacy merged plane on the same strategy: bit for bit
    assert torch.equal(CollectiveEngine(WORLD, Strategy.ring(WORLD, WORLD), use_xla_fastpath=False).all_reduce(
        torch.from_numpy(x)), got)
    # rd pinned: the optimized program (coalesced) and its base in the trace
    from adapcc_tpu import compiler as jc

    port.set_schedule_program(pc.rd_allreduce_program(WORLD))
    ref.set_schedule_program(jc.rd_allreduce_program(WORLD))
    got = port.all_reduce(torch.from_numpy(x), algo="ir", op=ReduceOp.MAX)
    from adapcc_tpu.primitives import ReduceOp as JOp

    want = ref.all_reduce(jnp.asarray(x), algo="ir", op=JOp.MAX)
    assert np.array_equal(got.numpy(), np.asarray(want))
    pe, je = port.trace.events()[-1], ref.trace.events()[-1]
    assert _ir_extras(pe.extra) == _ir_extras(je.extra)
    assert pe.extra["passes"] == ["coalesce"] and pe.extra["dispatches"] == 6 and "base_fingerprint" in pe.extra
    assert "program_cache_hit" not in pe.extra
    # the latency plane's rd: bit for bit the IR's
    assert torch.equal(port.all_reduce(torch.from_numpy(x), algo="rd", op=ReduceOp.MAX), got)
    # the env pin reroutes ring_allreduce; its ring knobs conflict loudly
    monkeypatch.setenv("ADAPCC_COLL_ALGO", "ir")
    got = port.ring_allreduce(torch.from_numpy(x))
    want = ref.ring_allreduce(jnp.asarray(x))
    assert np.array_equal(got.numpy(), np.asarray(want)) and port.trace.events()[-1].impl == "ir"
    msgs = []
    for eng, t in ((port, torch.from_numpy(x)), (ref, jnp.asarray(x))):
        for kw in ({"chunk_bytes": 1 << 20}, {"wire_dtype": "bf16"}):
            with pytest.raises(ValueError, match="program properties") as err:
                eng.ring_allreduce(t, **kw)
            msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]


def test_engine_ir_refusals_like_jax(mesh8, monkeypatch):
    import jax.numpy as jnp

    from adapcc_tpu import compiler as jc

    port, ref = _engines(mesh8)
    msgs = []
    for eng, m, t in ((port, pc, torch.ones(WORLD, 16)), (ref, jc, jnp.ones((WORLD, 16), jnp.float32))):
        case = []
        with pytest.raises(ValueError, match="world") as err:
            eng.set_schedule_program(m.ring_allreduce_program(4))
        case.append(str(err.value))
        with pytest.raises(ValueError, match="relays") as err:
            eng.all_reduce(t, algo="ir", active_gpus=list(range(WORLD - 1)))
        case.append(str(err.value))
        monkeypatch.setenv("ADAPCC_WIRE_DTYPE", "int8")
        with pytest.raises(ValueError, match="program properties") as err:
            eng.all_reduce(t, algo="ir")
        case.append(str(err.value))
        monkeypatch.delenv("ADAPCC_WIRE_DTYPE")
        monkeypatch.setenv("ADAPCC_IR_OPT", "coalesse")
        with pytest.raises(ValueError, match="ADAPCC_IR_OPT") as err:
            eng.all_reduce(t, algo="ir")
        case.append(str(err.value))
        monkeypatch.delenv("ADAPCC_IR_OPT")
        # a corrupted program dies at the pin, the good one verified once
        prog = m.pipelined_allreduce_program(WORLD)
        eng.set_schedule_program(prog)
        assert prog.fingerprint() in eng._ir_verified and eng.schedule_program() is prog
        with pytest.raises(m.ScheduleVerificationError) as err:
            eng.set_schedule_program(_drop(prog, lambda s: s.kind == "recv"))
        case.append(str(err.value))
        msgs.append(case)
    assert msgs[0] == msgs[1]


def test_engine_program_derivation_memo_and_swaps(monkeypatch):
    """A derived program follows a strategy swap, a pinned one survives it;
    ``Strategy.schedule_program`` memoizes per spelling; each program is
    verified once."""
    monkeypatch.setenv("ADAPCC_IR_OPT", "on")
    first = Strategy.ring(WORLD, 3).schedule_program()
    strategy = Strategy.ring(WORLD, 3)
    eng = CollectiveEngine(WORLD, strategy, trace=CollectiveTrace())
    derived = eng.schedule_program()
    assert derived is first and strategy.__dict__["_last_program_cache_hit"] is True
    eng.all_reduce(torch.ones(WORLD, 30), algo="ir")
    assert eng.trace.events()[-1].extra["program_cache_hit"] is True
    eng.advance_epoch(Strategy.binary(WORLD))
    assert eng.schedule_program() is not derived and eng.schedule_program().name == f"strategy-binary-w{WORLD}"
    pinned = pc.pipelined_allreduce_program(WORLD)
    eng.set_schedule_program(pinned)
    eng.advance_epoch(Strategy.ring(WORLD))
    assert eng.schedule_program() is pinned
    assert eng.optimized_schedule_program() is pinned  # already optimal: the same object
    calls = []
    real = pc.verify.verify_program
    monkeypatch.setattr(pc.verify, "verify_program", lambda p: calls.append(p.fingerprint()) or real(p))
    for _ in range(3):
        eng.all_reduce(torch.ones(WORLD, 30), algo="ir")
    assert calls == []  # verified at the pin already


def test_ir_cells_record_and_load_in_jax_db(tmp_path, monkeypatch):
    """A recording tuner fills ``ir`` (a program the passes leave alone) and
    ``ir-opt`` (a rewritten one); the cells join a grid only when ``algos``
    names "ir"; the database file loads in the JAX package unchanged."""
    from adapcc_tpu.tuner.db import TuningDatabase as JDb

    from adapcc_tpu_torch.tuner import CollectiveTuner, TuningDatabase
    from adapcc_tpu_torch.tuner.policy import IR_OPT_PATH, IR_PATH

    monkeypatch.delenv("ADAPCC_TUNER", raising=False)
    monkeypatch.setenv("ADAPCC_IR_OPT", "on")
    path = str(tmp_path / "tuning.jsonl")
    tuner = CollectiveTuner(WORLD, "t", db=TuningDatabase(path), mode="record")
    eng = CollectiveEngine(WORLD, Strategy.ring(WORLD), trace=CollectiveTrace(), tuner=tuner)
    x = torch.ones(WORLD, 64)
    for _ in range(2):  # the first dispatch of a configuration is its warmup
        eng.all_reduce(x, algo="ir")
    eng.set_schedule_program(pc.rd_allreduce_program(WORLD))
    for _ in range(2):
        eng.all_reduce(x, algo="ir")
    assert "duration_s" in eng.trace.events()[-1].extra
    keys = set(tuner.db.keys())
    assert {k.path for k in keys} == {IR_PATH, IR_OPT_PATH}
    assert all(k.chunk_bytes == 0 and k.wire_dtype == "off" for k in keys)
    policy = tuner.policy
    assert keys <= set(policy.candidates("allreduce", 256, algos=("ir",)))
    assert not keys & set(policy.candidates("allreduce", 256))
    tuner.db.save()
    jdb = JDb(path)
    assert jdb.skipped_records == 0
    assert {json.dumps(k.to_dict(), sort_keys=True) for k in jdb.keys()} == \
        {json.dumps(k.to_dict(), sort_keys=True) for k in keys}
    for k in jdb.keys():
        assert len(jdb.samples(k)) == 1
