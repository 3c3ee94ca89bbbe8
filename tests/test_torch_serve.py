"""The port's serving plane held against the JAX package's.

Tiny float32 GPT-2s (vocab 64, max_seq 16, 1–2 layers, 4 heads, d_model 32)
get flax parameter trees with seeded numpy values, converted to the port.
Within the port, a slot of the continuous batcher emits the bits of its
request run alone through ``generate`` (sampled at ``temperature=1,
top_k=8``: token streams; teacher-forced: logits bit for bit, sharded over
1, 2 and 4 ranks).  Against JAX: the decode step's pieces to
``LOGITS_ATOL``; on a trace JAX saved, greedy streams and the step-clock
ledger (admission, TTFT, sojourn, their percentiles, the KV-cache stats)
equal JAX's ``GPT2Server``'s, EOS eviction and slot reuse included, and the
decode collectives' algorithm histogram equals JAX's when both engines
price with JAX's coefficients; traces load and re-save byte for byte, with
JAX's validation messages; the serving prices equal JAX's by ``==``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
from adapcc_tpu_torch.models.gpt2_generate import generate
from adapcc_tpu_torch.serve import (
    SERVE_TRACE_ENV,
    ArrivalTrace,
    GPT2Server,
    Request,
    RequestSpec,
    SlotKVCache,
    TPDecodeModel,
    load_serve_trace,
    resolve_serve_slo_ms,
    resolve_serve_slots,
    synthesize_arrival_trace,
)
from adapcc_tpu_torch.sim import cost_model as cm
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace

LOGITS_ATOL = 1e-5
TINY2 = dict(vocab_size=64, max_seq=16, n_layer=2, n_head=4, d_model=32)
TINY1 = dict(TINY2, n_layer=1)


def flax_tree(cfg: dict, seed: int):
    """A flax GPT-2 tree (flax's names and shapes) with seeded numpy values."""
    model = JaxGPT2(JaxGPT2Config(**cfg, dtype=jnp.float32))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = (rng.normal(size=leaf.shape) * 0.2).astype(np.float32)
        return noise + 1 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, tree)["params"]


def port_model(cfg: dict, params) -> GPT2:
    model = GPT2(GPT2Config(**cfg, dtype=torch.float32), device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, flax params, port model), 2 layers."""
    params = flax_tree(TINY2, 0)
    return JaxGPT2Config(**TINY2, dtype=jnp.float32), params, port_model(TINY2, params)


@pytest.fixture(scope="module")
def tiny_1layer():
    params = flax_tree(TINY1, 1)
    return JaxGPT2Config(**TINY1, dtype=jnp.float32), params, port_model(TINY1, params)


def jax_coeff_engine(world: int, trace=None) -> CollectiveEngine:
    """The port's engine pricing ``auto`` with JAX's default coefficients
    (a tuner in off mode on JAX's default cost model)."""
    from adapcc_tpu.sim.calibrate import load_or_default as jax_defaults

    from adapcc_tpu_torch.tuner import CollectiveTuner, TuningDatabase

    jm = jax_defaults(world=world)
    pm = cm.LinkCostModel(world, classes={k: cm.LinkCoeffs(c.alpha, c.beta) for k, c in jm.classes.items()})
    tuner = CollectiveTuner(world, "t", db=TuningDatabase(persist=False), mode="off", cost_model=pm)
    return CollectiveEngine(world, Strategy.ring(world), trace=trace, tuner=tuner)


def _trace(world, reqs):
    return ArrivalTrace(world=world, seed=0, requests=reqs)


# ------------------------------------------------------------ arrival traces


def test_trace_json_loads_and_resaves_jax_bytes(tmp_path):
    from adapcc_tpu.serve.trace import synthesize_arrival_trace as jax_synth

    src = str(tmp_path / "jax.json")
    jax_synth(4, 8, 0.25, seed=3, eos_id=7).save(src)
    back = load_serve_trace(world=4, env={SERVE_TRACE_ENV: src})
    out = back.save(str(tmp_path / "port.json"))
    assert open(out, "rb").read() == open(src, "rb").read()
    assert load_serve_trace(world=4, env={}) is None


def _message(fn):
    try:
        fn()
    except (ValueError, FileNotFoundError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error raised")


def test_trace_validation_messages_match_jax(tmp_path):
    from adapcc_tpu.serve import trace as jt

    from adapcc_tpu_torch.serve import trace as pt

    cases = [
        lambda m: m.synthesize_arrival_trace(2, 4, 0.0),
        lambda m: m.synthesize_arrival_trace(2, 0, 0.5),
        lambda m: m.synthesize_arrival_trace(2, 4, 0.5, prompt_len=(3, 2)),
        lambda m: m.synthesize_arrival_trace(2, 4, 0.5, max_new_tokens=(0, 2)),
        lambda m: m.synthesize_arrival_trace(2, 4, 0.5, vocab_size=1),
        lambda m: m.ArrivalTrace(world=2, seed=0, requests=[m.RequestSpec(0, 5, (1,), 2, 0),
                                                            m.RequestSpec(1, 1, (1,), 2, 0)]),
        lambda m: m.ArrivalTrace(world=0, seed=0),
        lambda m: m.RequestSpec(0, 0, (), 2, 0),
        lambda m: m.RequestSpec(0, 0, (1,), 0, 0),
        lambda m: m.RequestSpec(0, -1, (1,), 2, 0),
    ]
    for case in cases:
        assert _message(lambda: case(pt)) == _message(lambda: case(jt))
    p = tmp_path / "trace.json"
    env = {SERVE_TRACE_ENV: str(p)}
    for body in (json.dumps({"world": 4, "seed": 0}), "{not json",
                 json.dumps(jt.ArrivalTrace(world=2, seed=0, requests=[jt.RequestSpec(0, 0, (1,), 2, 0)]).to_dict())):
        p.write_text(body)
        assert _message(lambda: pt.load_serve_trace(world=4, env=env)) == \
            _message(lambda: jt.load_serve_trace(world=4, env=env))
    env = {SERVE_TRACE_ENV: str(tmp_path / "nope.json")}
    assert _message(lambda: pt.load_serve_trace(env=env)) == _message(lambda: jt.load_serve_trace(env=env))


def test_synthesized_traces_are_seeded_and_valid():
    a = synthesize_arrival_trace(2, 8, 0.25, seed=3)
    assert a.to_dict() == synthesize_arrival_trace(2, 8, 0.25, seed=3).to_dict()
    assert a.to_dict() != synthesize_arrival_trace(2, 8, 0.25, seed=4).to_dict()
    steps = [r.arrival_step for r in a.requests]
    assert steps == sorted(steps) and len(a) == 8
    t = synthesize_arrival_trace(2, 16, 0.5, seed=1, eos_id=7, prompt_len=(2, 6), max_new_tokens=(3, 5))
    assert all(7 not in r.prompt and 2 <= len(r.prompt) <= 6 and 3 <= r.max_new_tokens <= 5 for r in t.requests)
    spec = RequestSpec(0, 0, (1, 2, 3), 5, 0)
    assert spec.total_tokens == 8 and spec.service_steps == 7


def test_resolve_serve_knobs(monkeypatch):
    monkeypatch.delenv("ADAPCC_SERVE_SLOTS", raising=False)
    monkeypatch.delenv("ADAPCC_SERVE_SLO_MS", raising=False)
    assert resolve_serve_slots(None) == 4 and resolve_serve_slots(2) == 2
    monkeypatch.setenv("ADAPCC_SERVE_SLOTS", "6")
    assert resolve_serve_slots(2) == 6
    for bad, match in (("zero", "ADAPCC_SERVE_SLOTS"), ("0", ">= 1")):
        monkeypatch.setenv("ADAPCC_SERVE_SLOTS", bad)
        with pytest.raises(ValueError, match=match):
            resolve_serve_slots()
    assert resolve_serve_slo_ms(None) is None
    monkeypatch.setenv("ADAPCC_SERVE_SLO_MS", "2.5")
    assert resolve_serve_slo_ms(9.0) == 2.5
    monkeypatch.setenv("ADAPCC_SERVE_SLO_MS", "-1")
    with pytest.raises(ValueError, match="> 0"):
        resolve_serve_slo_ms()


# ------------------------------------------------------------------- KV cache


def test_kv_cache_layout_and_lifecycle(tiny):
    from adapcc_tpu.serve import SlotKVCache as JaxCache

    jcfg, _, model = tiny
    cache = SlotKVCache(model.cfg, world=4, slots=3, device="cpu")
    k, v = cache.layers[0]
    assert k.shape == (4, 3, 16, 1, 8) == v.shape and len(cache.layers) == 2
    assert cache.layout() == JaxCache(jcfg, world=4, slots=3).layout()
    assert cache.bytes_per_token == JaxCache(jcfg, world=4, slots=3).bytes_per_token
    assert cache.nbytes_per_rank == SlotKVCache(model.cfg, world=1, slots=3, device="cpu").nbytes_per_rank // 4
    assert cache.nbytes_per_rank * 4 == sum(t.numel() * t.element_size() for pair in cache.layers for t in pair)
    for k, v in cache.layers:
        k[:, 1] = 7.0
    cache.clear_slot(1)
    assert float(cache.layers[0][0][:, 1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="slot"):
        cache.clear_slot(3)
    with pytest.raises(ValueError, match="n_head"):
        SlotKVCache(model.cfg, world=3, slots=2, device="cpu")


# ------------------------------------------------------- the decode step


def test_tp_decode_pieces_match_jax(tiny):
    from adapcc_tpu.serve.model import TPDecodeModel as JaxTP

    jcfg, params, model = tiny
    world, S, T = 4, 3, TINY2["max_seq"]
    jtp, tp = JaxTP(jcfg, world), TPDecodeModel(model, world)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 64, size=(S, 1))
    pos = np.array([0, 3, 9])
    pages = [rng.normal(size=(world, S, T, 1, 8)).astype(np.float32) for _ in range(2)]
    x_j = jtp.embed(params, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32))
    x_t = tp.embed(torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    partial_j, kj, vj = jtp.attn_partial(params["h0"], x_j, jnp.asarray(pages[0]), jnp.asarray(pages[1]),
                                         jnp.asarray(pos, jnp.int32))
    kt, vt = (torch.from_numpy(p.copy()) for p in pages)
    partial_t = tp.attn_partial(0, x_t, kt, vt, torch.from_numpy(pos))
    np.testing.assert_allclose(partial_t.numpy(), np.asarray(partial_j), atol=LOGITS_ATOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=LOGITS_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=LOGITS_ATOL)
    # zero padding: each rank's row is zero outside its heads' columns
    for w in range(world):
        cols = np.ones(32, bool)
        cols[w * 8 : (w + 1) * 8] = False
        assert (partial_t[w][..., cols] == 0).all()
    full = np.asarray(partial_j).sum(axis=0)
    post_j = jtp.post_attn(params["h0"], x_j, jnp.asarray(full))
    post_t = tp.post_attn(0, x_t, torch.from_numpy(full))
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), atol=LOGITS_ATOL)
    logits_j = jtp.logits(params, jnp.asarray(post_t.numpy()))
    logits_t = tp.logits(post_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=LOGITS_ATOL)
    assert tp.collective_bytes == jtp.collective_bytes


@torch.no_grad()
def _teacher_forced(model, world, slots, steps, algo):
    """Logits of ``slots`` staggered rows (slot s joins at step s) through
    the sharded step, and of each row alone through the model's decode."""
    cfg = model.cfg
    tp = TPDecodeModel(model, world)
    eng = CollectiveEngine(world, Strategy.ring(world))
    cache = SlotKVCache(cfg, world, slots, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(world + slots).integers(0, cfg.vocab_size, size=(slots, steps)))
    alone = [model.init_cache(1) for _ in range(slots)]
    pairs = []
    for t in range(steps + slots - 1):
        rows = [s for s in range(slots) if s <= t < s + steps]
        pos = torch.tensor([min(max(0, t - s), steps - 1) for s in range(slots)])
        tok = toks[torch.arange(slots), pos][:, None]
        x = tp.embed(tok, pos)
        for layer in range(cfg.n_layer):
            k, v = cache.layers[layer]
            x = tp.post_attn(layer, x, eng.all_reduce(tp.attn_partial(layer, x, k, v, pos, rows), algo=algo)[0],
                             rows)
        logits = tp.logits(x, rows)
        for s in rows:
            ref, _ = model(tok[s : s + 1], decode=True, pos=int(pos[s]), cache=alone[s])
            pairs.append((logits[s : s + 1], ref))
    return pairs


@pytest.mark.parametrize("world,slots,algo", [(4, 3, "auto"), (2, 2, "ring"), (1, 2, "auto")])
def test_sharded_batched_decode_equals_single_row_decode_bitwise(tiny, world, slots, algo):
    _, _, model = tiny
    for got, ref in _teacher_forced(model, world, slots, TINY2["max_seq"], algo):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


# ------------------------------------------------------------- the server


def test_server_batched_equals_alone_bitwise(tiny_1layer):
    """Three requests through the batcher (staggered arrivals, queueing on
    two slots) emit the streams of one-at-a-time ``generate`` runs seeded
    alike, and of a one-slot server."""
    _, _, model = tiny_1layer
    reqs = [RequestSpec(0, 0, (5, 17, 3), 5, seed=11), RequestSpec(1, 1, (9, 2), 4, seed=23),
            RequestSpec(2, 2, (40, 41, 42), 4, seed=37)]
    srv = GPT2Server(model, 4, slots=2, temperature=1.0, top_k=8, trace=CollectiveTrace())
    srv.submit_trace(_trace(4, reqs))
    results = srv.run()
    assert len(results) == 3 and results[2].admitted_step > results[2].arrival_step
    for r, spec in zip(results, reqs):
        ref = generate(model, [list(spec.prompt)], len(spec.prompt), spec.max_new_tokens,
                       generator=torch.Generator().manual_seed(spec.seed), temperature=1.0, top_k=8)
        assert ref[0].tolist() == r.tokens, f"request {r.req_id} diverged from generate alone"
        solo = GPT2Server(model, 4, slots=1, temperature=1.0, top_k=8)
        solo.submit(Request.from_spec(spec))
        assert solo.run()[0].tokens == r.tokens


@pytest.fixture(scope="module")
def jax_trace_runs(tiny_1layer, mesh4, tmp_path_factory):
    """One greedy trace JAX saved, served by JAX's GPT2Server and by the
    port's (its engine pricing with JAX's coefficients)."""
    from adapcc_tpu.serve import GPT2Server as JaxServer
    from adapcc_tpu.serve.trace import synthesize_arrival_trace as jax_synth
    from adapcc_tpu.utils.observability import CollectiveTrace as JaxTrace

    jcfg, params, model = tiny_1layer
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    jax_synth(4, 6, 0.5, seed=5, prompt_len=(2, 5), max_new_tokens=(3, 6), vocab_size=64).save(path)
    trace = load_serve_trace(world=4, env={SERVE_TRACE_ENV: path})
    jtrace, ptrace = JaxTrace(), CollectiveTrace()
    jsrv = JaxServer(jcfg, params, mesh4, slots=2, temperature=0.0, trace=jtrace)
    from adapcc_tpu.serve.trace import load_serve_trace as jax_load

    jsrv.submit_trace(jax_load(world=4, env={SERVE_TRACE_ENV: path}))
    jres = jsrv.run()
    psrv = GPT2Server(model, 4, slots=2, temperature=0.0, engine=jax_coeff_engine(4, ptrace))
    psrv.submit_trace(trace)
    pres = psrv.run()
    return (jsrv, jres, jtrace), (psrv, pres, ptrace)


def _ledger(r):
    return (r.req_id, r.tokens, r.prompt_len, r.arrival_step, r.admitted_step, r.first_token_step, r.completed_step,
            r.eos_evicted, r.ttft_steps, r.sojourn_steps)


_SUMMARY_KEYS = ("requests", "slots", "world", "steps", "kv_cache", "kv_cache_stats", "p50_sojourn_steps",
                 "p99_sojourn_steps", "p50_ttft_steps", "p99_ttft_steps")


def test_server_greedy_on_a_jax_trace_matches_jax(jax_trace_runs):
    (jsrv, jres, _), (psrv, pres, _) = jax_trace_runs
    assert [_ledger(r) for r in pres] == [_ledger(r) for r in jres]
    js, ps = jsrv.summary(), psrv.summary()
    assert {k: ps[k] for k in _SUMMARY_KEYS} == {k: js[k] for k in _SUMMARY_KEYS}


def test_decode_collectives_histogram_matches_jax(jax_trace_runs, tiny_1layer):
    (jsrv, _, jtrace), (psrv, _, ptrace) = jax_trace_runs
    hist = []
    for tr in (jtrace, ptrace):
        h = {}
        for e in tr.events():
            if e.primitive == "allreduce":
                h[e.impl] = h.get(e.impl, 0) + 1
        hist.append(h)
    # one allreduce a layer a step that computed (idle ticks dispatch none)
    computed = psrv.metrics.snapshot()["timings"]["serve.step_s"]["count"]
    assert hist[1] == hist[0] == {"rd": tiny_1layer[2].cfg.n_layer * computed}
    evs = [e for e in ptrace.events() if e.primitive == "allreduce"]
    # stacked payload: world x slots x d_model float32
    assert evs[0].nbytes == 4 * 2 * 32 * 4 and all(e.extra["algo"] == "rd" for e in evs)


def test_eos_eviction_and_slot_reuse_match_jax(tiny_1layer, mesh4):
    from adapcc_tpu.serve import GPT2Server as JaxServer

    jcfg, params, model = tiny_1layer
    spec0 = RequestSpec(0, 0, (5, 17, 3), 6, seed=11)
    eos = int(generate(model, [list(spec0.prompt)], 3, 6, temperature=0.0)[0, 3])
    reqs = [spec0, RequestSpec(1, 1, (9, 2), 3, seed=23)]
    runs = []
    for srv in (JaxServer(jcfg, params, mesh4, slots=1, temperature=0.0, eos_id=eos),
                GPT2Server(model, 4, slots=1, temperature=0.0, eos_id=eos, engine=jax_coeff_engine(4))):
        srv.submit_trace(_trace(4, reqs))
        runs.append(([_ledger(r) for r in srv.run()], srv.summary()["kv_cache_stats"],
                     srv.metrics.snapshot()["counters"]))
    assert runs[1][:2] == runs[0][:2]
    assert {k: v for k, v in runs[1][2].items() if k.startswith("serve.")} == \
        {k: v for k, v in runs[0][2].items() if k.startswith("serve.")}
    ledger = runs[1][0]
    assert ledger[0][7] and all(t == eos for t in ledger[0][1][3:])
    assert runs[1][1]["slot_reuse"] == 1 and runs[1][1]["evictions"] == 1


def test_server_rejects_bad_requests_and_budgets_loudly(tiny_1layer):
    _, _, model = tiny_1layer
    srv = GPT2Server(model, 2, slots=1)
    with pytest.raises(ValueError, match="max_seq"):
        srv.submit(Request(0, list(range(14)), 8, 0))
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit(Request(0, [], 4, 0))
    with pytest.raises(ValueError, match="vocab_size"):
        srv.submit(Request(0, [5, 64], 4, 0))
    with pytest.raises(ValueError, match="world=4"):
        srv.submit_trace(_trace(4, [RequestSpec(0, 0, (1,), 2, 0)]))
    srv.submit(Request(0, [1, 2], 6, 0))
    srv.submit(Request(1, [1, 2], 6, 0))
    with pytest.raises(RuntimeError, match="max_steps"):
        srv.run(max_steps=3)
    idle = GPT2Server(model, 2, slots=1)
    idle.submit(Request(0, [1, 2], 2, 0, arrival_step=3))
    assert idle.step() == 0 and idle.clock == 1
    r = idle.run()[0]
    assert (r.admitted_step, r.first_token_step, r.ttft_steps, r.sojourn_steps) == (3, 5, 2, 3)


# ------------------------------------------------------------- the prices


def test_serving_prices_equal_jax(monkeypatch):
    from adapcc_tpu.sim import cost_model as jcm
    from adapcc_tpu.sim.calibrate import load_or_default as jax_defaults

    monkeypatch.setattr(cm, "DEFAULT_DECODE_COMPUTE_S_PER_LAYER", jcm.DEFAULT_DECODE_COMPUTE_S_PER_LAYER)
    jc = jcm.bottleneck_ring_coeffs(jax_defaults(world=8), 8)
    pc = cm.LinkCoeffs(jc.alpha, jc.beta)
    for world in (1, 2, 4, 8):
        for slots in (1, 4, 8):
            for algo in (None, "ring", "rd", "tree"):
                for itemsize in (4, 2):
                    assert cm.decode_step_time(world, slots, 12, 1024, pc, itemsize, algo) == \
                        jcm.decode_step_time(world, slots, 12, 1024, jc, itemsize, algo)
    assert cm.decode_step_time(4, 8, 2, 128, pc, compute_s_per_layer=3e-4) == \
        jcm.decode_step_time(4, 8, 2, 128, jc, compute_s_per_layer=3e-4)
    rng = np.random.default_rng(9)
    arrivals = sorted(rng.integers(0, 60, size=24).tolist())
    service = rng.integers(2, 20, size=24).tolist()
    gen = [max(1, s // 2) for s in service]
    for slots in (1, 3, 8):
        assert cm.simulate_serve_queue(arrivals, service, slots) == jcm.simulate_serve_queue(arrivals, service, slots)
        assert cm.serve_queue_metrics(arrivals, service, slots, 3.7e-3, slo_ms=40.0, generated_steps=gen) == \
            jcm.serve_queue_metrics(arrivals, service, slots, 3.7e-3, slo_ms=40.0, generated_steps=gen)
        assert cm.serve_queue_metrics(arrivals, service, slots, 1e-3) == \
            jcm.serve_queue_metrics(arrivals, service, slots, 1e-3)
    prefill = rng.integers(1, 12, size=24).tolist()
    decode = rng.integers(0, 16, size=24).tolist()
    for ps, ds, xfer in ((2, 2, 0), (3, 1, 2), (4, 6, 1)):
        assert cm.simulate_disagg_queue(arrivals, prefill, decode, ps, ds, xfer) == \
            jcm.simulate_disagg_queue(arrivals, prefill, decode, ps, ds, xfer)
        assert cm.disagg_queue_metrics(arrivals, prefill, decode, ps, ds, xfer, 2e-3, 3e-3, slo_ms=50.0) == \
            jcm.disagg_queue_metrics(arrivals, prefill, decode, ps, ds, xfer, 2e-3, 3e-3, slo_ms=50.0)
    refusals = (
        lambda m, c: m.simulate_serve_queue([3, 1], [2, 2], 1),
        lambda m, c: m.simulate_serve_queue([0], [0], 1),
        lambda m, c: m.simulate_serve_queue([0, 1], [2], 1),
        lambda m, c: m.serve_queue_metrics([0], [2], 1, 0.0),
        lambda m, c: m.serve_queue_metrics([0], [2], 1, 1e-3, generated_steps=[3]),
        lambda m, c: m.simulate_disagg_queue([0], [0], [1], 1, 1),
        lambda m, c: m.simulate_disagg_queue([0], [1], [1], 0, 1),
        lambda m, c: m.disagg_queue_metrics([0], [1], [1], 1, 1, 0, 0.0, 1e-3),
        lambda m, c: m.decode_step_time(2, 0, 1, 8, c),
    )
    for fn in refusals:
        assert _message(lambda: fn(cm, pc)) == _message(lambda: fn(jcm, jc))


# --------------------------------------------------------------- the CLI


def test_serve_gpt2_runs_on_the_cpu_and_replays_its_trace(tmp_path, capsys, monkeypatch):
    from adapcc_tpu_torch.workloads.serve_gpt2 import main

    monkeypatch.delenv(SERVE_TRACE_ENV, raising=False)
    path = str(tmp_path / "trace.json")
    argv = ["--device", "cpu", "--requests", "4", "--slots", "2", "--world", "4", "--dmodel", "32", "--seq", "24",
            "--max-new-tokens", "6", "--json"]
    assert main(argv + ["--trace-out", path]) == 0
    first = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in first if line.startswith("{")]
    summary = rows[-1]["summary"]
    assert summary["requests"] == 4 and summary["decode_collectives"] and len(rows) == 5
    monkeypatch.setenv(SERVE_TRACE_ENV, path)
    assert main(argv) == 0
    again = [line for line in capsys.readouterr().out.splitlines() if line.startswith('{"req_id"')]
    assert again == [line for line in first if line.startswith('{"req_id"')]
    with pytest.raises(SystemExit, match="even"):
        main(["--device", "cpu", "--disagg", "--world", "3", "--heads", "3"])
    assert os.path.exists(path)
