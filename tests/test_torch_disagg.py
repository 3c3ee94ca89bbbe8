"""The port's disaggregated serving plane held against the JAX package's.

Within the port: the SAME arrival trace served by the two-pod
``ClusterRouter`` emits the colocated ``GPT2Server``'s streams bit for bit
on the float32 (``"off"``) KV wire, every migration one ``kv_transfer``
trace event, and finished prefills wait resident when the decode pod is
full.  Against JAX: ``kv_transfer``'s pages (identity, and int8/bf16 equal
to JAX's ``codec.apply`` bit for bit) and its trace extras (all but the
wall duration); greedy router streams and ledgers; the decode-pod death's
victims and re-earned TTFTs; the token-level KL probe to ``KL_ATOL``: at
JAX's own tiny config (where JAX measures exactly 0.0 for int8) and at one
where JAX's KL is above 0, which the test checks before it asserts the
port's is too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
from adapcc_tpu_torch.serve import (
    DISAGG_ENV,
    KV_KL_BOUND_ENV,
    KV_WIRE_DTYPE_ENV,
    ArrivalTrace,
    ClusterRouter,
    GPT2Server,
    RequestSpec,
    measure_token_kl,
    resolve_disagg,
    resolve_kv_kl_bound,
    resolve_kv_wire_dtype,
)
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import CollectiveTrace

KL_ATOL = 1e-6
TINY4 = dict(vocab_size=64, max_seq=16, n_layer=1, n_head=4, d_model=32)


def seeded_params(cfg: dict, seed: int, std: float = 0.2):
    """A flax GPT-2 tree (flax's names and shapes) with seeded numpy values."""
    model = JaxGPT2(JaxGPT2Config(**cfg, dtype=jnp.float32))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = (rng.normal(size=leaf.shape) * std).astype(np.float32)
        return noise + 1 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, tree)["params"]


def port_model(cfg: dict, params) -> GPT2:
    model = GPT2(GPT2Config(**cfg, dtype=torch.float32), device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    return model.eval()


@pytest.fixture(scope="module")
def tiny4():
    params = seeded_params(TINY4, 0)
    return JaxGPT2Config(**TINY4, dtype=jnp.float32), params, port_model(TINY4, params)


def _trace(n=5, world=4):
    """JAX's drill trace: staggered arrivals, prompts of 2-4 tokens, budgets
    of 3-5 (every request migrates)."""
    reqs = []
    for i in range(n):
        plen = 2 + (i % 3)
        reqs.append(RequestSpec(req_id=i, arrival_step=i // 2,
                                prompt=tuple(1 + (j + 7 * i) % 63 for j in range(plen)),
                                max_new_tokens=3 + (i % 3), seed=100 + i))
    return ArrivalTrace(world=world, seed=0, requests=reqs)


def _jax_trace(n=5, world=4):
    from adapcc_tpu.serve.trace import ArrivalTrace as JaxTrace

    return JaxTrace.from_dict(_trace(n, world).to_dict())


def _pods():
    devs = jax.devices()
    return Mesh(devs[:2], ("ranks",)), Mesh(devs[2:4], ("ranks",))


def _by_id(results):
    return {r.req_id: r for r in results}


def _ledger(r):
    return (r.tokens, r.arrival_step, r.admitted_step, r.first_token_step, r.completed_step, r.eos_evicted)


# ------------------------------------------------------------ the KV wire


def _no_duration(extra):
    return {k: v for k, v in extra.items() if k != "duration_s"}


def test_kv_transfer_trace_and_validation_match_jax(mesh2):
    from adapcc_tpu.comm.engine import CollectiveEngine as JaxEngine
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy
    from adapcc_tpu.utils.observability import CollectiveTrace as JaxTrace

    jtrace, ptrace = JaxTrace(), CollectiveTrace()
    jeng = JaxEngine(mesh2, JaxStrategy.ring(2), trace=jtrace)
    peng = CollectiveEngine(2, Strategy.ring(2), trace=ptrace)
    rng = np.random.default_rng(4)
    pages = [(rng.normal(size=(2, 5, 2, 8)).astype(np.float32), rng.normal(size=(2, 5, 2, 8)).astype(np.float32))
             for _ in range(2)]
    for wire, block in (("off", None), ("int8", 64), ("int8", None), ("bf16", None)):
        jout = jeng.kv_transfer([(jnp.asarray(k), jnp.asarray(v)) for k, v in pages], src_pod=0, dst_pod=1,
                                wire_dtype=wire, block_size=block, chunk_bytes=512)
        pout = peng.kv_transfer([(torch.from_numpy(k), torch.from_numpy(v)) for k, v in pages], src_pod=0,
                                dst_pod=1, wire_dtype=wire, block_size=block, chunk_bytes=512, dst_device="cpu")
        assert isinstance(pout, list) and all(isinstance(pair, tuple) for pair in pout)
        for (jk, jv), (pk, pv) in zip(jout, pout):
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        je, pe = jtrace.events()[-1], ptrace.events()[-1]
        assert (pe.primitive, pe.impl, pe.nbytes) == (je.primitive, je.impl, je.nbytes)
        assert _no_duration(pe.extra) == _no_duration(je.extra) and pe.extra["duration_s"] >= 0
    assert pe.impl == "dcn_stream+bf16"
    k = torch.ones((2, 4, 2, 8))
    with pytest.raises(ValueError, match="at least one page"):
        peng.kv_transfer([], src_pod=0, dst_pod=1)
    with pytest.raises(ValueError, match="chunk_bytes"):
        peng.kv_transfer([(k, k)], src_pod=0, dst_pod=1, chunk_bytes=0)
    with pytest.raises(ValueError, match="unknown wire codec"):
        peng.kv_transfer([(k, k)], src_pod=0, dst_pod=1, wire_dtype="zstd")
    with pytest.raises(ValueError, match="kv_transfer"):
        peng.kv_transfer([(torch.ones((3, 2)), torch.ones((3, 2)))], src_pod=0, dst_pod=1)
    off = peng.kv_transfer([(k, k)], src_pod=0, dst_pod=1)
    assert off[0][0] is k  # the off wire is the identity


# ------------------------------------------------------- the router


@pytest.fixture(scope="module")
def colocated_base(tiny4):
    _, _, model = tiny4
    srv = GPT2Server(model, 4, slots=2, temperature=1.0, top_k=8)
    srv.submit_trace(_trace())
    return _by_id(srv.run())


def test_disagg_streams_bit_identical_to_colocated(tiny4, colocated_base):
    _, _, model = tiny4
    ctrace = CollectiveTrace()
    rt = ClusterRouter(model, 2, 2, prefill_slots=2, decode_slots=2, temperature=1.0, top_k=8, trace=ctrace)
    rt.submit_trace(_trace())
    got = _by_id(rt.run())
    assert set(got) == set(colocated_base)
    for rid, r in got.items():
        assert r.generated == colocated_base[rid].generated, f"req {rid} diverged from colocated"
    events = [e for e in ctrace.events() if e.primitive == "kv_transfer"]
    assert len(events) == len(got)
    for e in events:
        assert e.impl == "dcn_stream" and e.extra["wire_dtype"] == "off" and e.extra["wire_bytes"] == e.nbytes
        assert (e.extra["src_pod"], e.extra["dst_pod"]) == (0, 1) and e.extra["chunks"] >= 1
    s = rt.summary()
    assert s["disagg"] is True and s["kv_stream"]["transfers"] == len(events)
    assert s["kv_stream"]["payload_bytes"] == s["kv_stream"]["wire_bytes"]
    assert all(s["kv_cache_stats"][pod]["admissions"] == len(got) for pod in ("prefill", "decode"))


def test_single_decode_slot_waits_resident_never_drops(tiny4, colocated_base):
    _, _, model = tiny4
    rt = ClusterRouter(model, 2, 2, prefill_slots=3, decode_slots=1, temperature=1.0, top_k=8)
    rt.submit_trace(_trace())
    got = _by_id(rt.run())
    assert {rid: r.generated for rid, r in got.items()} == {rid: r.generated for rid, r in colocated_base.items()}
    snap = rt.metrics.snapshot()["counters"]
    assert snap["serve.migrated"] == snap["serve.completed"] == 5


def _routers(tiny4, **kw):
    """JAX's and the port's 2+2-pod greedy routers over the drill trace."""
    from adapcc_tpu.serve import ClusterRouter as JaxRouter

    jcfg, params, model = tiny4
    jrt = JaxRouter(jcfg, params, *_pods(), prefill_slots=2, decode_slots=2, temperature=0.0, **kw)
    prt = ClusterRouter(model, 2, 2, prefill_slots=2, decode_slots=2, temperature=0.0, **kw)
    jrt.submit_trace(_jax_trace())
    prt.submit_trace(_trace())
    return jrt, prt


_STEP_MS = ("p50_step_ms", "p99_step_ms")


def _summary(rt):
    s = rt.summary()
    for pool in s["pools"].values():
        for k in _STEP_MS:
            pool.pop(k, None)
    return s


def test_greedy_router_matches_jax(tiny4):
    jrt, prt = _routers(tiny4)
    jres, pres = jrt.run(), prt.run()
    assert [_ledger(r) for r in pres] == [_ledger(r) for r in jres]
    assert _summary(prt) == _summary(jrt)


def test_decode_pod_death_casualties_match_jax(tiny4):
    jrt, prt = _routers(tiny4)
    for _ in range(60):
        jrt.step()
        prt.step()
        if prt.decode.lanes:
            break
    assert jrt.decode.lanes and prt.decode.lanes
    victims = prt.kill_decode_pool()
    assert victims and victims == jrt.kill_decode_pool()
    jres, pres = jrt.run(max_steps=400), prt.run(max_steps=400)
    assert [_ledger(r) for r in pres] == [_ledger(r) for r in jres]
    assert prt.metrics.snapshot()["counters"] == jrt.metrics.snapshot()["counters"]
    base = _routers(tiny4)[1]
    unkilled = _by_id(base.run())
    for r in pres:
        assert r.generated == unkilled[r.req_id].generated
        if r.req_id in victims:
            assert r.ttft_steps > unkilled[r.req_id].ttft_steps


# ------------------------------------------------------- the lossy wire


def test_token_kl_matches_jax_and_gates_the_int8_wire(tiny4):
    from adapcc_tpu.serve import measure_token_kl as jax_kl

    # JAX's own tiny config and flax-initialized weights: JAX measures 0.0
    jmodel = JaxGPT2(JaxGPT2Config(**TINY4, dtype=jnp.float32))
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    jcfg = JaxGPT2Config(**TINY4, dtype=jnp.float32)
    refs = {}
    for name, params in (("init", init), ("seeded", tiny4[1])):
        model = port_model(TINY4, params)
        assert measure_token_kl(model, 2, "off") == 0.0
        for wire in ("int8", "bf16"):
            refs[name, wire] = jax_kl(jcfg, params, 2, wire)
            assert abs(measure_token_kl(model, 2, wire) - refs[name, wire]) <= KL_ATOL
    # the seeded weights distort the int8 next-token distribution in JAX
    assert refs["seeded", "int8"] > 0.0
    model = tiny4[2]
    kl = measure_token_kl(model, 2, "int8")
    assert kl > 0.0
    with pytest.raises(ValueError) as ei:
        ClusterRouter(model, 2, 2, prefill_slots=2, decode_slots=2, kv_wire_dtype="int8", kv_kl_bound=kl / 2)
    msg = str(ei.value)
    assert "exceeds the acceptance bound" in msg and KV_KL_BOUND_ENV in msg and "int8" in msg
    rt = ClusterRouter(model, 2, 2, prefill_slots=2, decode_slots=2, temperature=1.0, top_k=8,
                       kv_wire_dtype="int8", kv_kl_bound=1.0)
    rt.submit_trace(_trace(n=3))
    assert len(rt.run()) == 3
    s = rt.summary()["kv_stream"]
    assert s["wire_dtype"] == "int8" and s["token_kl"] == kl <= s["kl_bound"]
    assert s["wire_bytes"] < s["payload_bytes"]


def test_router_rejects_unequal_pods_and_wrong_trace_world(tiny4):
    model = tiny4[2]
    with pytest.raises(ValueError, match="equal"):
        ClusterRouter(model, 4, 2, prefill_slots=1, decode_slots=1)
    rt = ClusterRouter(model, 2, 2, prefill_slots=1, decode_slots=1)
    with pytest.raises(ValueError, match=r"2 pods x 2"):
        rt.submit_trace(_trace(world=2))


def test_env_resolvers(monkeypatch):
    monkeypatch.delenv(DISAGG_ENV, raising=False)
    assert resolve_disagg() is False and resolve_disagg(True) is True
    monkeypatch.setenv(DISAGG_ENV, "1")
    assert resolve_disagg(False) is True
    monkeypatch.setenv(DISAGG_ENV, "off")
    assert resolve_disagg(True) is False
    monkeypatch.setenv(DISAGG_ENV, "maybe")
    with pytest.raises(ValueError, match=DISAGG_ENV):
        resolve_disagg()
    monkeypatch.delenv(KV_WIRE_DTYPE_ENV, raising=False)
    assert resolve_kv_wire_dtype() == "off" and resolve_kv_wire_dtype("bf16") == "bf16"
    monkeypatch.setenv(KV_WIRE_DTYPE_ENV, "int8")
    assert resolve_kv_wire_dtype("off") == "int8"
    monkeypatch.setenv(KV_WIRE_DTYPE_ENV, "zstd")
    with pytest.raises(ValueError, match="unknown wire codec"):
        resolve_kv_wire_dtype()
    monkeypatch.delenv(KV_KL_BOUND_ENV, raising=False)
    assert resolve_kv_kl_bound() == 0.02
    monkeypatch.setenv(KV_KL_BOUND_ENV, "0.5")
    assert resolve_kv_kl_bound(0.1) == 0.5
    for bad in ("-1", "0", "cheap"):
        monkeypatch.setenv(KV_KL_BOUND_ENV, bad)
        with pytest.raises(ValueError, match=KV_KL_BOUND_ENV):
            resolve_kv_kl_bound()


def test_kv_stream_registers_as_fabric_job(tiny4):
    from adapcc_tpu_torch.adapt.fabric import SharedFabric
    from adapcc_tpu_torch.sim.cost_model import DCN, ICI, LinkCoeffs, LinkCostModel

    rt = ClusterRouter(tiny4[2], 2, 2, prefill_slots=2, decode_slots=2, temperature=0.0)
    rt.submit_trace(_trace(n=2))
    rt.run()
    ips = {r: f"10.0.0.{r // 4}" for r in range(8)}
    model = LinkCostModel(8, classes={ICI: LinkCoeffs(1e-6, 1.0 / 45e9), DCN: LinkCoeffs(25e-6, 1.0 / 12.5e9)},
                          ips=ips, source="test-disagg")
    job = rt.kv_stream_fabric_job(SharedFabric(model, [ips[r] for r in range(8)]))
    assert job.nbytes == rt.summary()["kv_stream"]["wire_bytes"] > 0 and job.priority == "high"
