"""The port's pipeline-parallel plane held against the JAX package's.

The same numpy-seeded flax GPT-2 tree (float32: vocab 64, T = 16, 4
layers, 2 heads, d_model 16) goes through ``adapcc_tpu.pipe`` and, converted
(``models/convert.py``), through ``adapcc_tpu_torch.pipe`` on CPU tensors,
with ``attention="xla"`` and ``"flash"`` (the port's flash is its kernels'
plain version on the CPU; JAX's runs its Pallas kernels in interpret mode).
Held:

- equal by ``==``: tick tables, bubble fractions and stash windows over
  GPipe/1F1B × a grid, ``pipeline_program`` fingerprints, rounds and sends,
  the verifier's rejection messages, every refusal message, the partition's
  splits and the cost model's three pipeline prices
  (tests/test_pipe.py:66-205, :608-640);
- bit for bit, within the port: ``composed_loss`` and the model's loss, a
  split/merge round trip, the executor and its composed microbatched
  baseline (2 and 4 stages, both attentions, both schedules), GPipe's and
  1F1B's gradients;
- against JAX's executor (its stage functions under ``jax.jit``, a
  monkeypatch inside the test: JAX's eager per-op dispatch costs 15 s a
  run on one core) from the same weights at 2 stages, xla and flash: the
  loss within ``LOSS_ATOL`` (tests/test_torch_gpt2.py's 1e-6) and every
  stage's gradient within ``GRAD_ATOL`` (its logits' 1e-5), the
  ``PipelineReport`` fields equal, the traced hops' sizes, routes, kinds,
  microbatches and ticks equal (4 stages: JAX's split converted equals the
  port's own, which the executor holds bit for bit);
- ``pipe_send`` against JAX's engine: the moved rows, the event's fields,
  the refusals; ``pipeline_apply`` forward against JAX's and forward and
  backward against the sequential stages (tests/test_parallel.py:129-217);
  ``resolve_pipe_schedule`` picks the same schedule from the same
  ``tuning.jsonl`` either way round.
"""

import dataclasses
import functools
import os
import warnings

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.compiler.verify import ScheduleVerificationError, verify_program
from adapcc_tpu_torch.models.convert import flax_to_state_dict, stage_params_from_flax
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.parallel.axis import Mesh
from adapcc_tpu_torch.pipe import (
    DEFAULT_PIPE_SCHEDULE,
    PIPE_SCHEDULE_ENV,
    PIPE_SCHEDULES,
    PipelineExecutor,
    PipeTask,
    composed_loss,
    merge_params,
    partition_gpt2,
    pipeline_apply,
    pipeline_program,
    pipeline_schedule,
    resolve_pipe_schedule,
    split_params,
    sync_tied_embedding,
)
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.tuner.db import TuningDatabase, TuningKey, mesh_fingerprint, size_bucket
from adapcc_tpu_torch.utils.observability import CollectiveTrace

TINY = dict(vocab_size=64, max_seq=16, n_layer=4, n_head=2, d_model=16)
FLASH_BLOCK = 8
BATCH, M = 8, 4
LOSS_ATOL = 1e-6
GRAD_ATOL = 1e-5
#: tests/test_parallel.py's pipeline_apply tolerances (forward; backward)
APPLY_RTOL = 1e-5
APPLY_GRAD_ATOL, APPLY_GRAD_RTOL = 1e-5, 1e-4
SCHEDULE_GRID = [(2, 2), (2, 4), (3, 5), (4, 4), (4, 8)]


def _cfg(attention="xla", **kw):
    return GPT2Config(**{**TINY, **kw}, dtype=torch.float32, attention=attention, flash_block=FLASH_BLOCK)


def _jax_cfg(attention="xla", **kw):
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config

    return JaxGPT2Config(**{**TINY, **kw}, dtype=jnp.float32, attention=attention, flash_block=FLASH_BLOCK)


@pytest.fixture(scope="module")
def flax_params():
    """flax's GPT-2 tree (names, shapes from ``eval_shape``) filled with
    seeded numpy values: non-zero biases and norm parameters reach every
    converted leaf."""
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2

    tree = jax.eval_shape(JaxGPT2(_jax_cfg()).init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        noise = (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return noise + 1 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, TINY["vocab_size"], size=(BATCH, TINY["max_seq"]))


def _model(flax_params, attention="xla"):
    model = GPT2(_cfg(attention), device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(flax_params))
    return model


def _engine(world, trace=None):
    return CollectiveEngine(world, Strategy.ring(world), trace=trace)


def _table(sched):
    return tuple(tuple(None if t is None else (t.kind, t.mb) for t in row) for row in sched.ticks)


# --------------------------------------------------------------------------- #
# schedules, programs, the verifier
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", PIPE_SCHEDULES)
@pytest.mark.parametrize("stages,microbatches", SCHEDULE_GRID)
def test_schedule_tables_match_jax(kind, stages, microbatches):
    from adapcc_tpu.pipe import pipeline_schedule as jax_schedule

    mine, theirs = pipeline_schedule(stages, microbatches, kind), jax_schedule(stages, microbatches, kind)
    assert _table(mine) == _table(theirs)
    assert mine.num_ticks == theirs.num_ticks == 2 * (microbatches + stages - 1)
    assert mine.bubble_fraction == theirs.bubble_fraction
    assert mine.stash_high_water == theirs.stash_high_water
    assert [[(t, task.kind, task.mb) for t, task in mine.tasks_for_stage(s)] for s in range(stages)] == \
        [[(t, task.kind, task.mb) for t, task in theirs.tasks_for_stage(s)] for s in range(stages)]


@pytest.mark.parametrize("kind", PIPE_SCHEDULES)
@pytest.mark.parametrize("tied", [True, False])
def test_pipeline_programs_match_jax(kind, tied):
    from adapcc_tpu.pipe import pipeline_program as jax_program
    from adapcc_tpu.pipe import pipeline_schedule as jax_schedule

    for stages, microbatches in SCHEDULE_GRID:
        mine = pipeline_program(pipeline_schedule(stages, microbatches, kind), tied_embedding=tied, world=stages + 1)
        theirs = jax_program(jax_schedule(stages, microbatches, kind), tied_embedding=tied, world=stages + 1)
        verify_program(mine)
        assert mine.fingerprint() == theirs.fingerprint()
        assert (mine.name, mine.world, mine.chunks, mine.collective) == \
            (theirs.name, theirs.world, theirs.chunks, theirs.collective)
        assert mine.total_sends() == theirs.total_sends() == microbatches * (stages - 1) * 2 + tied
        assert (mine.chunk_sources, mine.chunk_sinks) == (theirs.chunk_sources, theirs.chunk_sinks)
        assert [[(s.kind, s.rank, s.chunk, s.peer) for s in r] for r in mine.rounds] == \
            [[(s.kind, s.rank, s.chunk, s.peer) for s in r] for r in theirs.rounds]


def _first_hop_round(prog):
    return next(i for i, rnd in enumerate(prog.rounds) if any(s.kind == "send" for s in rnd))


def _drop(kind):
    def edit(prog):
        return dataclasses.replace(prog, rounds=tuple(
            tuple(s for s in rnd if not (s.kind == kind and s.chunk == 0)) for rnd in prog.rounds))
    return edit


def _late_recv(prog):
    i = _first_hop_round(prog)
    rounds = [list(r) for r in prog.rounds]
    moved = [s for s in rounds[i] if s.kind in ("recv", "copy") and s.chunk == 0]
    rounds[i] = [s for s in rounds[i] if s not in moved]
    rounds[i + 1] = rounds[i + 1] + moved
    return dataclasses.replace(prog, rounds=tuple(tuple(r) for r in rounds))


def _swapped_hops(prog):
    hops = [i for i, rnd in enumerate(prog.rounds) for s in rnd if s.kind == "send" and s.chunk == 0]
    i0, i1 = hops
    rounds = [list(r) for r in prog.rounds]
    r0 = [s for s in rounds[i0] if s.chunk == 0]
    r1 = [s for s in rounds[i1] if s.chunk == 0]
    rounds[i0] = [s for s in rounds[i0] if s.chunk != 0] + r1
    rounds[i1] = [s for s in rounds[i1] if s.chunk != 0] + r0
    return dataclasses.replace(prog, rounds=tuple(tuple(r) for r in rounds))


#: tests/test_pipe.py's four broken programs: (stages, microbatches, kind,
#: tied, the edit, a word of the message)
BROKEN = {
    "dropped_recv": (2, 4, "1f1b", True, _drop("recv"), "dropped"),
    "mismatched_round": (2, 4, "gpipe", True, _late_recv, "no matching recv"),
    "deadlocked_pair": (2, 4, "1f1b", True, _drop("send"), "deadlock"),
    "use_before_receive": (3, 2, "gpipe", False, _swapped_hops, "before holding it"),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_verifier_rejections_match_jax(case):
    from adapcc_tpu.compiler.verify import ScheduleVerificationError as JaxError
    from adapcc_tpu.compiler.verify import verify_program as jax_verify
    from adapcc_tpu.pipe import pipeline_program as jax_program
    from adapcc_tpu.pipe import pipeline_schedule as jax_schedule

    stages, microbatches, kind, tied, edit, word = BROKEN[case]
    with pytest.raises(ScheduleVerificationError) as mine:
        verify_program(edit(pipeline_program(pipeline_schedule(stages, microbatches, kind), tied_embedding=tied)))
    with pytest.raises(JaxError) as theirs:
        jax_verify(edit(jax_program(jax_schedule(stages, microbatches, kind), tied_embedding=tied)))
    assert str(mine.value) == str(theirs.value)
    assert word in str(mine.value)


def _message(fn, *args, **kw):
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn(*args, **kw)
    return str(e.value)


def test_refusals_match_jax(monkeypatch):
    from adapcc_tpu import pipe as jpipe

    for args in [(2, 2, "wavefront"), (0, 2), (2, 0)]:
        assert _message(pipeline_schedule, *args) == _message(jpipe.pipeline_schedule, *args)
    assert _message(PipeTask, "fwdbwd", 0) == _message(jpipe.PipeTask, "fwdbwd", 0)
    assert _message(pipeline_program, pipeline_schedule(1, 4)) == \
        _message(jpipe.pipeline_program, jpipe.pipeline_schedule(1, 4))
    assert _message(pipeline_program, pipeline_schedule(4, 2), world=3) == \
        _message(jpipe.pipeline_program, jpipe.pipeline_schedule(4, 2), world=3)
    assert _message(resolve_pipe_schedule, "wavefront") == _message(jpipe.resolve_pipe_schedule, "wavefront")
    monkeypatch.setenv(PIPE_SCHEDULE_ENV, "Wavefront")
    assert _message(resolve_pipe_schedule) == _message(jpipe.resolve_pipe_schedule)
    monkeypatch.setenv(PIPE_SCHEDULE_ENV, "gpipe")
    assert resolve_pipe_schedule("1f1b") == jpipe.resolve_pipe_schedule("1f1b") == "gpipe"
    monkeypatch.delenv(PIPE_SCHEDULE_ENV)
    assert resolve_pipe_schedule() == jpipe.resolve_pipe_schedule() == DEFAULT_PIPE_SCHEDULE == "1f1b"


# --------------------------------------------------------------------------- #
# the partition, the stage modules, the composed loss
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_layer,stages", [(4, 1), (4, 2), (4, 4), (5, 2), (7, 3)])
def test_partition_matches_jax(n_layer, stages):
    from adapcc_tpu.pipe import partition_gpt2 as jax_partition

    mine = partition_gpt2(_cfg(n_layer=n_layer), stages)
    theirs = jax_partition(_jax_cfg(n_layer=n_layer), stages)
    assert (mine.num_stages, mine.n_layer, mine.block_ranges, mine.param_counts) == \
        (theirs.num_stages, theirs.n_layer, theirs.block_ranges, theirs.param_counts)


def test_partition_refusals_match_jax():
    from adapcc_tpu.pipe import partition_gpt2 as jax_partition

    assert _message(partition_gpt2, _cfg(), 5) == _message(jax_partition, _jax_cfg(), 5)
    assert _message(partition_gpt2, _cfg(), 0) == _message(jax_partition, _jax_cfg(), 0)
    assert _message(partition_gpt2, _cfg(dropout=0.1), 2) == _message(jax_partition, _jax_cfg(dropout=0.1), 2)
    from adapcc_tpu_torch.parallel.axis import Axis

    assert _message(partition_gpt2, _cfg(sp_axis=Axis("sp", 2)), 2) == \
        _message(jax_partition, _jax_cfg(sp_axis="sp"), 2)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_composed_loss_is_the_model_and_split_merge_round_trips(flax_params, tokens, attention):
    model = _model(flax_params, attention)
    part = partition_gpt2(model.cfg, 2)
    stages = split_params(model, part)
    assert "head_wte.weight" in stages[-1].state_dict()
    merged = merge_params(stages, part)
    want = model.state_dict()
    assert sorted(merged) == sorted(want) and all(torch.equal(merged[k], want[k]) for k in want)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        assert torch.equal(composed_loss(model.cfg, part, stages, t), lm_loss(model(t), t))


def test_stage_converter_matches_split(flax_params):
    from adapcc_tpu.pipe import partition_gpt2 as jax_partition
    from adapcc_tpu.pipe import split_params as jax_split

    model = _model(flax_params)
    part = partition_gpt2(model.cfg, 4)
    mine = split_params(model, part)
    converted = stage_params_from_flax(jax_split(flax_params, jax_partition(_jax_cfg(), 4)), model.cfg, part,
                                       device="cpu")
    for a, b in zip(mine, converted):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_sync_tied_embedding_refreshes_the_head_copy(flax_params):
    model = _model(flax_params)
    stages = split_params(model, partition_gpt2(model.cfg, 2))
    with torch.no_grad():
        stages[0].wte.weight.add_(1.0)
    sync_tied_embedding(stages)
    assert torch.equal(stages[-1].head_wte.weight, stages[0].wte.weight)


# --------------------------------------------------------------------------- #
# the executor
# --------------------------------------------------------------------------- #


def _baseline(cfg, part, stages, tokens, microbatches):
    """The composed microbatched twin of ``forward_backward``."""
    mb = tokens.reshape(microbatches, tokens.shape[0] // microbatches, *tokens.shape[1:])
    names = [[n for n, _ in st.named_parameters()] for st in stages]
    params = [p for st in stages for p in st.parameters()]
    loss, acc = None, None
    for m in range(microbatches):
        lm = composed_loss(cfg, part, stages, mb[m])
        g = torch.autograd.grad(lm, params)
        loss = lm.detach() if loss is None else loss + lm.detach()
        acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
    loss = loss / microbatches
    grads, i = [], 0
    for st_names in names:
        grads.append({n: acc[i + j] / microbatches for j, n in enumerate(st_names)})
        i += len(st_names)
    grads[0]["wte.weight"] = grads[0]["wte.weight"] + grads[-1]["head_wte.weight"]
    grads[-1]["head_wte.weight"] = torch.zeros_like(grads[-1]["head_wte.weight"])
    return loss, grads


def _equal_grads(a, b):
    return all(sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", PIPE_SCHEDULES)
@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("stages", [2, 4])
def test_executor_is_its_composed_baseline_bit_for_bit(flax_params, tokens, stages, attention, kind):
    model = _model(flax_params, attention)
    part = partition_gpt2(model.cfg, stages)
    sp = split_params(model, part)
    t = torch.from_numpy(tokens)
    trace = CollectiveTrace()
    ex = PipelineExecutor(model.cfg, part, _engine(stages, trace), num_microbatches=M, schedule=kind, device="cpu")
    loss, grads, report = ex.forward_backward(sp, t)
    base_loss, base_grads = _baseline(model.cfg, part, sp, t, M)
    assert torch.equal(loss, base_loss)
    assert _equal_grads(grads, base_grads)
    assert report.schedule == kind and report.ticks == 2 * (M + stages - 1)
    events = [e for e in trace.events() if e.primitive == "pipe_send"]
    assert len(events) == report.hops == ex.program.total_sends()


@pytest.mark.parametrize("stages", [2, 4])
def test_gpipe_and_1f1b_are_bit_identical(flax_params, tokens, stages):
    model = _model(flax_params)
    part = partition_gpt2(model.cfg, stages)
    sp = split_params(model, part)
    out = {kind: PipelineExecutor(model.cfg, part, _engine(stages), num_microbatches=M, schedule=kind,
                                  device="cpu").forward_backward(sp, torch.from_numpy(tokens))
           for kind in PIPE_SCHEDULES}
    (lg, gg, rg), (lf, gf, rf) = out["gpipe"], out["1f1b"]
    assert torch.equal(lg, lf) and _equal_grads(gg, gf)
    assert rg.stash_peak == (M,) * stages
    assert rf.stash_peak == tuple(min(M, stages - s) for s in range(stages))
    assert sum(rf.stash_peak_bytes) < sum(rg.stash_peak_bytes)


@pytest.fixture(scope="module")
def jax_fast_stages():
    """JAX's executor with its stage functions under ``jax.jit`` (the
    module-level name the executor calls, patched for this module only)."""
    import jax

    import adapcc_tpu.pipe.executor as jex

    orig, cache = jex.stage_forward, {}

    def jitted(cfg, part, stage, p, x, tokens=None):
        key = (id(cfg), id(part), stage)  # the cached partial keeps both alive
        if key not in cache:
            cache[key] = jax.jit(functools.partial(orig, cfg, part, stage))
        return cache[key](p, x, tokens)

    jex.stage_forward = jitted
    yield
    jex.stage_forward = orig


@pytest.mark.parametrize("stages,attention", [(2, "xla"), (2, "flash")])
def test_executor_matches_jax(flax_params, tokens, jax_fast_stages, stages, attention):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.pipe import PipelineExecutor as JaxExecutor
    from adapcc_tpu.pipe import partition_gpt2 as jax_partition
    from adapcc_tpu.pipe import split_params as jax_split
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy
    from adapcc_tpu.utils.observability import CollectiveTrace as JaxTrace

    jcfg = _jax_cfg(attention)
    jpart = jax_partition(jcfg, stages)
    jtrace = JaxTrace()
    jeng = JaxEngine(JaxMesh(jax.devices()[:stages], ("ranks",)), JaxStrategy.ring(stages),
                     use_xla_fastpath=False, trace=jtrace)
    jex = JaxExecutor(jcfg, jpart, jeng, num_microbatches=M, schedule="1f1b")
    jloss, jgrads, jrep = jex.forward_backward(jax_split(flax_params, jpart), jnp.asarray(tokens, jnp.int32))

    cfg = _cfg(attention)
    part = partition_gpt2(cfg, stages)
    sp = stage_params_from_flax(jax_split(flax_params, jpart), cfg, part, device="cpu")
    trace = CollectiveTrace()
    loss, grads, rep = PipelineExecutor(cfg, part, _engine(stages, trace), num_microbatches=M, schedule="1f1b",
                                        device="cpu").forward_backward(sp, torch.from_numpy(tokens))

    np.testing.assert_allclose(loss.item(), float(jloss), atol=LOSS_ATOL)
    for s in range(stages):
        want = flax_to_state_dict(jax.device_get(jgrads[s]))
        assert sorted(want) == sorted(grads[s])
        for name, g in grads[s].items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_ATOL, err_msg=f"stage {s} {name}")
    fields = [f.name for f in dataclasses.fields(rep) if f.name != "step_time_s"]
    assert [getattr(rep, f) for f in fields] == [getattr(jrep, f) for f in fields]

    def hops(tr):
        return [(e.nbytes, e.extra["src"], e.extra["dst"], e.extra["kind"], e.extra.get("mb"), e.extra.get("tick"))
                for e in tr.events() if e.primitive == "pipe_send"]

    assert hops(trace) == hops(jtrace)


def test_executor_refusals_match_jax(mesh2, flax_params, tokens):
    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.pipe import PipelineExecutor as JaxExecutor
    from adapcc_tpu.pipe import partition_gpt2 as jax_partition
    from adapcc_tpu.pipe import split_params as jax_split
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    jeng = JaxEngine(mesh2, JaxStrategy.ring(2), use_xla_fastpath=False)
    jpart, part = jax_partition(_jax_cfg(), 2), partition_gpt2(_cfg(), 2)
    eng = _engine(2)
    assert _message(PipelineExecutor, _cfg(), part, eng, num_microbatches=0, device="cpu") == \
        _message(JaxExecutor, _jax_cfg(), jpart, jeng, num_microbatches=0)
    assert _message(PipelineExecutor, _cfg(), partition_gpt2(_cfg(), 4), eng, device="cpu") == \
        _message(JaxExecutor, _jax_cfg(), jax_partition(_jax_cfg(), 4), jeng)
    ex = PipelineExecutor(_cfg(), part, eng, num_microbatches=M, device="cpu")
    jex = JaxExecutor(_jax_cfg(), jpart, jeng, num_microbatches=M)
    assert _message(ex.forward_backward, split_params(_model(flax_params), part), torch.from_numpy(tokens[:3])) == \
        _message(jex.forward_backward, jax_split(flax_params, jpart), tokens[:3])


def test_dp_pp_grad_sync_matches_the_full_batch_pipeline(flax_params, tokens):
    """Two data-parallel replicas on the batch's halves, each stage's
    gradients averaged through ``grad_sync``: the full-batch pipeline's
    gradients within tests/test_pipe.py's DP×PP tolerance."""
    model = _model(flax_params)
    part = partition_gpt2(model.cfg, 2)
    sp = split_params(model, part)
    t = torch.from_numpy(tokens)
    half = PipelineExecutor(model.cfg, part, _engine(2), num_microbatches=2, device="cpu")
    _, grads_b, _ = half.forward_backward(sp, t[BATCH // 2:])
    stage_iter = iter(range(2))

    def dp_sync(gs):
        other = grads_b[next(stage_iter)]
        return {n: (g + other[n]) / 2 for n, g in gs.items()}

    _, grads_dp, _ = half.forward_backward(sp, t[:BATCH // 2], grad_sync=dp_sync)
    _, grads_full, _ = PipelineExecutor(model.cfg, part, _engine(2), num_microbatches=M,
                                        device="cpu").forward_backward(sp, t)
    for a, b in zip(grads_dp, grads_full):
        for n in a:
            np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), atol=1e-5, rtol=1e-4, err_msg=n)


# --------------------------------------------------------------------------- #
# pipe_send
# --------------------------------------------------------------------------- #


def test_pipe_send_moves_one_row_like_jax(mesh4):
    import jax.numpy as jnp

    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy
    from adapcc_tpu.utils.observability import CollectiveTrace as JaxTrace

    buf = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    jtrace, trace = JaxTrace(), CollectiveTrace()
    jout = JaxEngine(mesh4, JaxStrategy.ring(4), use_xla_fastpath=False, trace=jtrace).pipe_send(
        jnp.asarray(buf), src=1, dst=3, kind="activation", mb=0, tick=2)
    eng = _engine(4, trace)
    src = torch.from_numpy(buf)
    out = eng.pipe_send(src, src=1, dst=3, kind="activation", mb=0, tick=2)
    assert torch.equal(out, torch.from_numpy(np.array(jout))) and torch.equal(src, torch.from_numpy(buf))
    (ev,), (jev,) = trace.events(), jtrace.events()
    assert (ev.primitive, ev.nbytes) == (jev.primitive, jev.nbytes) == ("pipe_send", buf[1].nbytes)
    assert (ev.impl, jev.impl) == ("torch_row_copy", "ici_hop")
    assert {k: v for k, v in ev.extra.items() if k != "cache_hit"} == jev.extra
    assert ev.extra["cache_hit"] is False
    eng.pipe_recv(src, src=1, dst=3)
    assert trace.events()[-1].extra["cache_hit"] is True and len(trace.events()) == 2


@pytest.mark.parametrize("kw", [dict(src=4, dst=0), dict(src=0, dst=-1), dict(src=2, dst=2),
                                dict(src=0, dst=1, kind="payload")])
def test_pipe_send_refusals_match_jax(mesh4, kw):
    import jax.numpy as jnp

    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    jeng = JaxEngine(mesh4, JaxStrategy.ring(4), use_xla_fastpath=False)
    assert _message(_engine(4).pipe_send, torch.zeros(4, 2), **kw) == _message(jeng.pipe_send, jnp.zeros((4, 2)), **kw)


# --------------------------------------------------------------------------- #
# the forward block and its alias
# --------------------------------------------------------------------------- #


def _apply_case(stages, d, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(stages, d, d)).astype(np.float32) * 0.3
    b = rng.normal(size=(stages, d)).astype(np.float32) * 0.1
    return w, b, rng.normal(size=(8, d)).astype(np.float32)


def _stage_fn(p, x):
    w, b = p
    return torch.tanh(x @ w + b)


def test_pipeline_apply_forward_matches_jax_and_sequential():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from adapcc_tpu.pipe import pipeline_apply as jax_apply

    w, b, batch = _apply_case(4, 16, 4)
    got = pipeline_apply(_stage_fn, (torch.from_numpy(w), torch.from_numpy(b)), torch.from_numpy(batch),
                         Mesh.stacked_mesh({"stages": 4}), num_microbatches=4)
    theirs = jax_apply(lambda p, x: jnp.tanh(x @ p[0] + p[1]), (jnp.asarray(w), jnp.asarray(b)), jnp.asarray(batch),
                       JaxMesh(np.array(jax.devices()[:4]), ("stages",)), num_microbatches=4)
    want = torch.from_numpy(batch)
    for s in range(4):
        want = _stage_fn((torch.from_numpy(w[s]), torch.from_numpy(b[s])), want)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=APPLY_RTOL, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=APPLY_RTOL, atol=1e-6)
    # one microbatch still fills and drains
    eye = torch.stack([torch.eye(4) * (s + 1) for s in range(2)])
    one = pipeline_apply(lambda wi, x: x @ wi, eye, torch.ones(3, 4), Mesh.stacked_mesh({"stages": 2}),
                         num_microbatches=1)
    assert torch.equal(one, torch.full((3, 4), 2.0))
    assert _message(pipeline_apply, _stage_fn, (torch.from_numpy(w), torch.from_numpy(b)), torch.zeros(6, 16),
                    Mesh.stacked_mesh({"stages": 4}), num_microbatches=4) == "batch 6 not divisible by microbatches 4"


def test_pipeline_apply_backward_matches_sequential():
    w, _, batch = _apply_case(4, 8, 7)
    target = torch.from_numpy(np.random.default_rng(8).normal(size=(8, 8)).astype(np.float32))

    def grads(run):
        wt, bt = torch.tensor(w, requires_grad=True), torch.tensor(batch, requires_grad=True)
        loss = ((run(wt, bt) - target) ** 2).mean()
        return (loss, *torch.autograd.grad(loss, (wt, bt)))

    def piped(wt, bt):
        return pipeline_apply(lambda wi, x: torch.tanh(x @ wi), wt, bt, Mesh.stacked_mesh({"stages": 4}),
                              num_microbatches=2)

    def sequential(wt, bt):
        x = bt
        for s in range(4):
            x = torch.tanh(x @ wt[s])
        return x

    for a, b in zip(grads(piped), grads(sequential)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=APPLY_GRAD_ATOL,
                                   rtol=APPLY_GRAD_RTOL)


def test_parallel_pipeline_alias_warns_once_and_delegates():
    import adapcc_tpu_torch.parallel.pipeline as alias
    from adapcc_tpu_torch.parallel import pipeline_apply as exported

    assert exported is pipeline_apply
    eye = torch.stack([torch.eye(4) * (s + 1) for s in range(2)])
    batch = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    mesh = Mesh.stacked_mesh({"stages": 2})
    alias._MOVED_WARNED = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        a = alias.pipeline_apply(lambda p, x: x @ p, eye, batch, mesh, num_microbatches=4)
        moved = [x for x in w if issubclass(x.category, DeprecationWarning)]
        assert len(moved) == 1 and "adapcc_tpu_torch.pipe.forward" in str(moved[0].message)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        alias.pipeline_apply(lambda p, x: x @ p, eye, batch, mesh, num_microbatches=4)
        assert not [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert torch.equal(a, pipeline_apply(lambda p, x: x @ p, eye, batch, mesh, num_microbatches=4))


# --------------------------------------------------------------------------- #
# the cost model and the tuner's pipe_step cells
# --------------------------------------------------------------------------- #


def test_cost_model_pipeline_prices_match_jax():
    from adapcc_tpu.sim import cost_model as jcm

    from adapcc_tpu_torch.sim import cost_model as cm

    for s in (1, 2, 4, 8):
        for m in (1, 4, 8, 16):
            assert cm.pipeline_bubble_fraction(s, m) == jcm.pipeline_bubble_fraction(s, m)
            for fwd, hop, ratio in ((1e-4, 1 << 20, 2.0), (3e-3, 4 << 20, 1.5)):
                assert cm.pipeline_step_time(s, m, fwd, hop, cm.LinkCoeffs(1e-6, 1 / 45e9), ratio) == \
                    jcm.pipeline_step_time(s, m, fwd, hop, jcm.LinkCoeffs(1e-6, 1 / 45e9), ratio)
            for kind in PIPE_SCHEDULES:
                for stage in range(s):
                    assert cm.pipeline_stash_bytes(s, m, kind, stage, 4096.0) == \
                        jcm.pipeline_stash_bytes(s, m, kind, stage, 4096.0) == \
                        float(pipeline_schedule(s, m, kind).stash_high_water[stage] * 4096)
    for args in [(0, 8), (2, 0)]:
        assert _message(cm.pipeline_bubble_fraction, *args) == _message(jcm.pipeline_bubble_fraction, *args)
    assert _message(cm.pipeline_stash_bytes, 2, 4, "wavefront", 0, 1.0) == \
        _message(jcm.pipeline_stash_bytes, 2, 4, "wavefront", 0, 1.0)
    assert _message(cm.pipeline_step_time, 2, 4, -1.0, 0, cm.LinkCoeffs(0, 0)) == \
        _message(jcm.pipeline_step_time, 2, 4, -1.0, 0, jcm.LinkCoeffs(0, 0))


def test_policy_pipe_paths_match_jax():
    from adapcc_tpu.tuner import policy as jpolicy

    from adapcc_tpu_torch.tuner import policy

    assert policy.PIPE_SCHEDULE_MODES == PIPE_SCHEDULES == jpolicy.PIPE_SCHEDULE_MODES
    for kind in PIPE_SCHEDULES:
        assert policy.pipe_path(kind) == jpolicy.pipe_path(kind) == f"pipe-{kind}"
        assert policy.pipe_schedule_of(policy.pipe_path(kind)) == kind
    assert _message(policy.pipe_path, "wavefront") == _message(jpolicy.pipe_path, "wavefront")
    assert _message(policy.pipe_schedule_of, "ring-uni") == _message(jpolicy.pipe_schedule_of, "ring-uni")


def _cell(schedule, world, microbatches, topology=""):
    from adapcc_tpu_torch.pipe.schedule import PIPE_PRIMITIVE
    from adapcc_tpu_torch.tuner.policy import pipe_path

    return TuningKey(primitive=PIPE_PRIMITIVE, size_bucket=size_bucket(0), world=world, topology=topology,
                     path=pipe_path(schedule), chunk_bytes=microbatches, wire_dtype="off")


def test_resolve_reads_the_same_tuning_file_as_jax(tmp_path, mesh2, flax_params, tokens):
    """A ``tuning.jsonl`` written by either package resolves to the same
    schedule in both; the port's executor records the cells JAX's resolver
    reads."""
    from adapcc_tpu.pipe import resolve_pipe_schedule as jax_resolve
    from adapcc_tpu.tuner.db import TuningDatabase as JaxDatabase
    from adapcc_tpu.tuner.db import TuningKey as JaxKey
    from adapcc_tpu.tuner.db import mesh_fingerprint as jax_fingerprint

    path = str(tmp_path / "tuning.jsonl")
    jdb = JaxDatabase(path)
    for _ in range(3):
        jdb.record(JaxKey(**_cell("gpipe", 2, 4).to_dict()), 0.010)
        jdb.record(JaxKey(**_cell("1f1b", 2, 4).to_dict()), 0.002)
    for world in (2, 4):
        assert resolve_pipe_schedule(None, tuner_db=TuningDatabase(path), world=world, microbatches=4) == \
            jax_resolve(None, tuner_db=JaxDatabase(path), world=world, microbatches=4)
    assert resolve_pipe_schedule(None, tuner_db=TuningDatabase(path), world=2, microbatches=4) == "1f1b"

    port_path = str(tmp_path / "port.jsonl")
    db = TuningDatabase(port_path)
    model = _model(flax_params)
    part = partition_gpt2(model.cfg, 2)
    sp = split_params(model, part)
    for kind in PIPE_SCHEDULES:
        PipelineExecutor(model.cfg, part, _engine(2), num_microbatches=2, schedule=kind, tuner_db=db,
                         device="cpu").forward_backward(sp, torch.from_numpy(tokens[:2]))
    topo = mesh_fingerprint("cpu", world=2)
    assert topo == jax_fingerprint(mesh2)
    for kind in PIPE_SCHEDULES:
        assert db.stats(_cell(kind, 2, 2, topo)) is not None
    for _ in range(8):
        db.record(_cell("gpipe", 2, 2, topo), 1e-6)
    assert PipelineExecutor(model.cfg, part, _engine(2), num_microbatches=2, tuner_db=db,
                            device="cpu").schedule_kind == "gpipe"
    assert jax_resolve(None, tuner_db=JaxDatabase(port_path), world=2, microbatches=2, topology=topo) == "gpipe"
    assert os.path.getsize(port_path) > 0
