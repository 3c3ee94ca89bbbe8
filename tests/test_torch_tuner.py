"""The port's plan tuner held against the JAX package's.

- the tuning database: JSONL in both directions, stats, corrupt and
  mixed-version records, trimming, fingerprints on the 4-device CPU mesh;
- the cost model (to 1e-12 relative under one injected ``LinkCostModel``,
  the port's card defaults set to the JAX package's for the comparison) and
  calibration artifacts across the packages;
- the policy: candidates under every narrowing and env pin, and a 200-call
  ``choose`` trajectory on a synthetic timing surface;
- the trace and the registry through dump → ``parse_track_log`` →
  ``replay_trace``;
- the engine, the trainer, ZeRO-1, the Communicator and the hook with a
  tuner, against JAX's where the JAX side runs in seconds.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch import nn

from adapcc_tpu_torch.comm.engine import CollectiveEngine
from adapcc_tpu_torch.comm.mesh import World
from adapcc_tpu_torch.ddp.hook import GradSyncHook
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer, zero1_train_step
from adapcc_tpu_torch.primitives import ALLREDUCE
from adapcc_tpu_torch.sim import calibrate, cost_model
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.tuner import (
    TUNER_MODE_ENV,
    CollectiveTuner,
    TuningDatabase,
    TuningKey,
    TuningPolicy,
    db as tdb,
    mesh_fingerprint,
    replay_trace,
    tuner_mode,
)
from adapcc_tpu_torch.tuner.policy import DEFAULT_CHUNK_GRID, HOOK_PATH, NO_CHUNK, XLA_PATH, hook_path
from adapcc_tpu_torch.utils import observability as obs
from test_torch_ddp import LOSS_ATOL, LR, TINY, _assert_params_close, _flax_params, _tokens

REL = 1e-12
#: the synthetic fabric both packages price: α 3 µs, 80 GB/s a link
ALPHA, BETA = 3e-6, 1.0 / 80e9


def _rel_eq(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.fixture
def jax_defaults(monkeypatch):
    """The port's card defaults set to the JAX package's, so one formula
    gives one number on both sides."""
    from adapcc_tpu.sim import cost_model as jcm

    monkeypatch.setattr(cost_model, "DEFAULT_HBM_BYTES_PER_S", jcm.DEFAULT_HBM_BYTES_PER_S)
    monkeypatch.setattr(cost_model, "DEFAULT_CODEC_BYTES_PER_S", jcm.DEFAULT_CODEC_BYTES_PER_S)


@pytest.fixture(autouse=True)
def _no_tuner_env(monkeypatch):
    for env in (TUNER_MODE_ENV, "ADAPCC_TUNER_DB", "ADAPCC_WIRE_DTYPE", "ADAPCC_RING_CHUNK_BYTES",
                "ADAPCC_FUSED_WIRE", "ADAPCC_OVERLAP", "ADAPCC_TUNER_OBJECTIVE", "ADAPCC_COLL_ALGO"):
        monkeypatch.delenv(env, raising=False)


def _models(world, ips=None):
    from adapcc_tpu.sim import cost_model as jcm

    return (cost_model.LinkCostModel.uniform(world, ALPHA, BETA, ips=ips),
            jcm.LinkCostModel.uniform(world, ALPHA, BETA, ips=ips))


def _policies(world, topology="t", **kw):
    from adapcc_tpu.tuner import TuningDatabase as JDb
    from adapcc_tpu.tuner import TuningPolicy as JPolicy

    port_m, jax_m = _models(world)
    return (TuningPolicy(TuningDatabase(persist=False), world, topology, cost_model=port_m, **kw),
            JPolicy(JDb(persist=False), world, topology, cost_model=jax_m, **kw))


def _dicts(keys):
    return [k.to_dict() for k in keys]


# --------------------------------------------------------------------------- #
# the database and the fingerprints
# --------------------------------------------------------------------------- #


def _key(**kw):
    base = dict(primitive="allreduce", size_bucket=1 << 20, world=4, topology="t", path="vmem",
                chunk_bytes=0, wire_dtype="off")
    base.update(kw)
    return base


def test_db_jsonl_loads_in_both_directions(tmp_path):
    from adapcc_tpu.tuner import TuningDatabase as JDb
    from adapcc_tpu.tuner import TuningKey as JKey

    rng = np.random.default_rng(0)
    cells = [_key(), _key(path="hbm-stream", chunk_bytes=1 << 20), _key(path="hook", primitive="ddp_step",
                                                                       wire_dtype="bf16")]
    jdb = JDb(str(tmp_path / "jax.jsonl"))
    pdb = TuningDatabase(str(tmp_path / "port.jsonl"))
    for i in range(60):
        c = cells[i % 3]
        t, ts = float(rng.uniform(1e-4, 1e-2)), 1000.0 + i
        jdb.record(JKey.from_dict(c), t, ts=ts)
        pdb.record(TuningKey.from_dict(c), t, ts=ts)
    assert open(tmp_path / "jax.jsonl").read() == open(tmp_path / "port.jsonl").read()
    jdb.save(str(tmp_path / "jax_saved.jsonl"))
    pdb.save(str(tmp_path / "port_saved.jsonl"))
    assert open(tmp_path / "jax_saved.jsonl").read() == open(tmp_path / "port_saved.jsonl").read()
    port_reads_jax, jax_reads_port = TuningDatabase(str(tmp_path / "jax.jsonl")), JDb(str(tmp_path / "port.jsonl"))
    assert _dicts(port_reads_jax.keys()) == _dicts(jax_reads_port.keys()) == sorted(cells, key=lambda c: tuple(
        c[f] for f in ("primitive", "size_bucket", "world", "topology", "path", "chunk_bytes", "wire_dtype")))
    assert port_reads_jax.snapshot() == jax_reads_port.snapshot() == jdb.snapshot()
    for c in cells:
        assert port_reads_jax.timed_samples(TuningKey.from_dict(c)) == jdb.timed_samples(JKey.from_dict(c))


def test_db_skips_corrupt_and_mixed_version_records_alike(tmp_path, capsys):
    from adapcc_tpu.tuner import TuningDatabase as JDb

    good = {"v": 1, "key": _key(), "t_s": 0.002, "ts": 5.0}
    lines = [json.dumps(good), "{not json", json.dumps({**good, "v": 2}), json.dumps({"v": 1, "key": {}, "t_s": 1}),
             "", json.dumps({**good, "t_s": 0.001, "ts": 6.0})]
    path = tmp_path / "mixed.jsonl"
    path.write_text("\n".join(lines) + "\n")
    port, ref = TuningDatabase(str(path)), JDb(str(path))
    assert len(port) == len(ref) == 1
    assert port.skipped_records == ref.skipped_records == 3
    assert port.snapshot() == ref.snapshot()
    err = capsys.readouterr().err
    assert err.count("skipped 3 corrupt/version-mismatched") == 2


def test_db_trims_to_the_newest_window_alike():
    from adapcc_tpu.tuner import TuningDatabase as JDb
    from adapcc_tpu.tuner import TuningKey as JKey

    port, ref = TuningDatabase(persist=False), JDb(persist=False)
    rng = np.random.default_rng(1)
    for i in rng.permutation(400):
        port.record(TuningKey.from_dict(_key()), float(i) * 1e-5, ts=float(i))
        ref.record(JKey.from_dict(_key()), float(i) * 1e-5, ts=float(i))
    assert port.samples(TuningKey.from_dict(_key())) == ref.samples(JKey.from_dict(_key()))
    assert len(port.samples(TuningKey.from_dict(_key()))) == tdb.MAX_SAMPLES_PER_KEY
    assert port.snapshot() == ref.snapshot()
    with pytest.raises(ValueError, match="clocks do not run backwards"):
        port.record(TuningKey.from_dict(_key()), -1.0)


def test_fingerprints_size_buckets_and_paths_match(mesh4, monkeypatch):
    from adapcc_tpu.tuner import db as jdb

    for args in ((4,), (4, {0: "a", 1: "a", 2: "b", 3: "b"}), (8, None, "cpu:cpu"), (2, {1: "x", 0: "y"}, "gpu:H")):
        assert tdb.topology_fingerprint(*args) == jdb.topology_fingerprint(*args)
    want = jdb.mesh_fingerprint(mesh4)
    assert mesh_fingerprint(torch.device("cpu"), world=4) == want
    assert mesh_fingerprint(World(0, 4, torch.device("cpu"))) == want
    with pytest.raises(ValueError, match="needs world"):
        mesh_fingerprint(torch.device("cpu"))
    for n in (0, 1, 2, 3, 1000, 1 << 20, (1 << 20) + 1, 673_832_960):
        assert tdb.size_bucket(n) == jdb.size_bucket(n)
    assert tdb.resolve_db_path() == jdb.resolve_db_path()
    monkeypatch.setenv(tdb.TUNER_DB_ENV, " /x/y.jsonl ")
    assert tdb.resolve_db_path() == jdb.resolve_db_path() == "/x/y.jsonl"


# --------------------------------------------------------------------------- #
# the cost model and calibration
# --------------------------------------------------------------------------- #


def test_cost_model_functions_match_on_a_grid(jax_defaults):
    from adapcc_tpu.sim import cost_model as jcm

    pc, jc = cost_model.LinkCoeffs(ALPHA, BETA), jcm.LinkCoeffs(ALPHA, BETA)
    for world in (1, 2, 3, 4, 8):
        for n in (0.0, 4.0, 4096.0, float(1 << 20), 673_832_960.0):
            pairs = [
                (cost_model.ring_allreduce_time, jcm.ring_allreduce_time, (world, n), {"chunks": 3}),
                (cost_model.recursive_doubling_allreduce_time, jcm.recursive_doubling_allreduce_time, (world, n), {}),
                (cost_model.binomial_tree_time, jcm.binomial_tree_time, (world, n), {}),
                (cost_model.all_to_all_time, jcm.all_to_all_time, (world, n), {}),
            ]
            for wd in ("off", "bf16", "int8"):
                pairs.append((cost_model.quantized_ring_allreduce_time, jcm.quantized_ring_allreduce_time,
                              (world, n), {"wire_dtype": wd}))
            for chunk in (4096.0, float(1 << 20)):
                pairs.append((cost_model.staged_ring_allreduce_time, jcm.staged_ring_allreduce_time,
                              (world, n), {"chunk_bytes": chunk}))
                for wd in ("bf16", "int8"):
                    pairs.append((cost_model.fused_quantized_ring_allreduce_time,
                                  jcm.fused_quantized_ring_allreduce_time, (world, n),
                                  {"chunk_bytes": chunk, "wire_dtype": wd, "block_size": 128}))
            for port_fn, jax_fn, args, kw in pairs:
                assert _rel_eq(port_fn(*args[:1], args[1], pc, **kw), jax_fn(*args[:1], args[1], jc, **kw)), port_fn
        assert _rel_eq(cost_model.allreduce_crossover_bytes(world, pc), jcm.allreduce_crossover_bytes(world, jc))
        for overlap in ("off", "bucket", "microbatch"):
            for buckets in (None, (3e6, 1e6, 2.5e5)):
                for wd in ("off", "int8"):
                    kw = dict(overlap=overlap, bucket_bytes=buckets, wire_dtype=wd)
                    got = cost_model.overlapped_step_time(world, 4e6, pc, 2e-3, accum=3, **kw)
                    want = jcm.overlapped_step_time(world, 4e6, jc, 2e-3, accum=3, **kw)
                    assert got.keys() == want.keys() and all(_rel_eq(got[k], want[k]) for k in got)
                    assert _rel_eq(cost_model.exposed_comm_floor_s(world, 4e6, pc, **kw),
                                   jcm.exposed_comm_floor_s(world, 4e6, jc, **kw))
    for wd, block in (("off", 256), ("bf16", 64), ("int8", 128)):
        assert cost_model.wire_bytes_per_element(wd, block) == jcm.wire_bytes_per_element(wd, block)
    pts = [(256.0, 2e-6), (4e6, 5.1e-5), (1e5, 4e-6)]
    assert cost_model.fit_alpha_beta(pts) == cost_model.LinkCoeffs(*vars(jcm.fit_alpha_beta(pts)).values())
    port_m, jax_m = _models(4, ips={0: "a", 1: "a", 2: "b", 3: "b"})
    assert cost_model.bottleneck_ring_link(port_m) == jcm.bottleneck_ring_link(jax_m) == (1, 2)
    for refusal in (lambda m: m.fused_quantized_ring_allreduce_time(4, 1e6, pc, 1e5, "off"),
                    lambda m: m.overlapped_step_time(4, 1e6, pc, 1.0, overlap="rolling")):
        with pytest.raises(ValueError):
            refusal(cost_model)


def test_cost_model_defaults_are_the_cards():
    assert cost_model.DEFAULT_HBM_BYTES_PER_S == 3.35e12
    assert cost_model.DEFAULT_COEFFS[cost_model.ICI][1] == 1.0 / 450e9
    assert cost_model.DEFAULT_COEFFS[cost_model.DCN][1] == 1.0 / 50e9
    assert (cost_model.ICI, cost_model.DCN) == ("ici", "dcn")
    for tpu_rate in (45e9, 800e9, 12.5e9, 100e9):
        assert tpu_rate not in (cost_model.DEFAULT_HBM_BYTES_PER_S, cost_model.DEFAULT_CODEC_BYTES_PER_S,
                                *(1 / c[1] for c in cost_model.DEFAULT_COEFFS.values()))


def test_prior_time_matches_for_every_path_kind(jax_defaults):
    from adapcc_tpu.tuner import TuningKey as JKey

    kinds = set()
    for world in (1, 4, 8):
        port, ref = _policies(world)
        for n in (4096, 1 << 20, 64 << 20):
            cells = []
            for prim, kw in (("allreduce", {}), ("allreduce", {"algos": ("xla", "rd", "tree")}),
                             ("ddp_step", {}), ("zero1_ring", {}), ("all_to_all", {})):
                cells += ref.candidates(prim, n, **kw)
            bucket = cells[0].size_bucket
            cells += [JKey("allreduce", bucket, world, "t", p, 0, "off") for p in ("ir", "ir-opt")]
            kinds |= {(c.path, c.wire_dtype) for c in cells}
            for c in cells:
                assert _rel_eq(port.prior_time(TuningKey.from_dict(c.to_dict()), n), ref.prior_time(c, n)), c
        assert _rel_eq(port.algo_crossover_bytes(), ref.algo_crossover_bytes())
    assert {p for p, _ in kinds} == {"vmem", "hbm-stream", "quant-ring", "xla", "rd", "tree", "hook", "hook-bucket",
                                     "hook-microbatch", "ir", "ir-opt"}
    assert {w for _, w in kinds} == {"off", "bf16", "int8"}


def test_calibration_artifacts_load_across_packages(tmp_path, capsys):
    from adapcc_tpu.sim import calibrate as jcal

    lat = np.array([[0, 2e-6, 9e-6], [2.1e-6, 0, 3e-6], [8e-6, 3.2e-6, 0]])
    bw = np.array([[0, 300.0, 40.0], [310.0, 0, 280.0], [45.0, 290.0, 0]])
    ips = {0: "a", 1: "a", 2: "b"}
    j = jcal.calibrate_from_matrices(lat, bw, ips)
    j.fingerprint, j.samples = "fab", 7
    j.save(str(tmp_path / "jax.json"))
    p = calibrate.Calibration.load(str(tmp_path / "jax.json"))
    assert p.to_dict() == j.to_dict() == calibrate.calibrate_from_matrices(lat, bw, ips).to_dict() | {
        "fingerprint": "fab", "samples": 7}
    p.save(str(tmp_path / "port.json"))
    assert jcal.Calibration.load(str(tmp_path / "port.json")).to_dict() == j.to_dict()
    port_m = calibrate.load_calibration(str(tmp_path / "jax.json"))
    jax_m = jcal.load_calibration(str(tmp_path / "port.json"))
    for s in range(3):
        for d in range(3):
            if s != d:
                assert vars(port_m.coeffs(s, d)) == vars(jax_m.coeffs(s, d))
    # a stale fabric or world still loads, and says so, as JAX's does
    for fn in (calibrate.load_or_default, jcal.load_or_default):
        m = fn(str(tmp_path / "jax.json"), world=2, fingerprint="other")
        assert m.world == 2 and m.source.endswith("@world2")
    err = capsys.readouterr().err
    assert err.count("fitted on fabric 'fab'") == 2 and err.count("fitted at world=3") == 2
    (tmp_path / "bad.json").write_text('{"version": 9}')
    assert calibrate.load_or_default(str(tmp_path / "bad.json"), world=3).source == "defaults"
    assert "unusable" in capsys.readouterr().err


# --------------------------------------------------------------------------- #
# the policy
# --------------------------------------------------------------------------- #

PIN_CASES = [
    {},
    {"ADAPCC_WIRE_DTYPE": "int8"},
    {"ADAPCC_RING_CHUNK_BYTES": str(1 << 20)},
    {"ADAPCC_FUSED_WIRE": "on"},
    {"ADAPCC_FUSED_WIRE": "off"},
]


@pytest.mark.parametrize("env", PIN_CASES, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "no-pin")
def test_candidates_match_under_pins(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for world in (2, 4):
        port, ref = _policies(world)
        for n in (4096, 4 << 20, 673_832_960):
            for prim, kw in (("allreduce", {}), ("allreduce", {"algos": ("ring",)}), ("zero1_ring", {}),
                             ("all_to_all", {}), ("ddp_step", {}),
                             ("ddp_step", {"wire_dtypes": ("bf16", "int8"), "overlap_modes": ("off", "bucket")}),
                             ("ddp_step", {"overlap_modes": ("bucket",)})):
                assert _dicts(port.candidates(prim, n, **kw)) == _dicts(ref.candidates(prim, n, **kw)), (prim, n, kw)


def test_choose_trajectory_matches_on_a_synthetic_surface(jax_defaults):
    """200 choices of both policies (seed 0) over four requests, each
    dispatch's synthetic walltime recorded into both databases."""
    from adapcc_tpu.tuner import TuningKey as JKey

    port, ref = _policies(4, trial_budget=3, min_samples=2)
    rng = np.random.default_rng(0)
    requests = [("allreduce", 4 << 20, {"algos": ("ring",)}), ("allreduce", 673_832_960, {"algos": ("ring",)}),
                ("ddp_step", 336_916_480, {"overlap_modes": ("off", "bucket")}), ("zero1_ring", 2_695_331_840, {})]

    def surface(key):
        base = {"vmem": 1.0, "hbm-stream": 1.2, "quant-ring": 3.0}.get(key.path, 1.5)
        base *= {"off": 1.0, "bf16": 0.8, "int8": 0.7}[key.wire_dtype]
        return base * (1.0 + (key.chunk_bytes % 7) / 20.0) * 1e-3

    got, want = [], []
    for i in range(200):
        prim, n, kw = requests[i % len(requests)]
        a, b = port.choose(prim, n, **kw), ref.choose(prim, n, **kw)
        got.append((a.key.to_dict(), a.source, a.expected_s, a.exec_chunk_bytes))
        want.append((b.key.to_dict(), b.source, b.expected_s, b.exec_chunk_bytes))
        t, ts = surface(b.key) * (1.0 + 0.1 * rng.random()), float(i)
        port.db.record(TuningKey.from_dict(b.key.to_dict()), t, ts=ts)
        ref.db.record(JKey.from_dict(b.key.to_dict()), t, ts=ts)
    assert got == want
    assert {s for _, s, _, _ in got} == {"prior", "explore", "measured"}
    for prim, n, kw in requests:
        assert port.rank_only(prim, n, **kw).key.to_dict() == ref.rank_only(prim, n, **kw).key.to_dict()
        inc = port.incumbent(prim, n)
        assert inc.to_dict() == ref.incumbent(prim, n).to_dict()


def test_objective_and_mode_resolution_match(monkeypatch):
    from adapcc_tpu.tuner import resolve_tuner_objective as j_objective
    from adapcc_tpu.tuner import tuner_mode as j_mode

    from adapcc_tpu_torch.tuner import resolve_tuner_objective

    def outcome(fn, *a):
        try:
            return fn(*a)
        except ValueError as e:
            return str(e)

    for env, arg in ((None, None), (None, "p99"), (" P99 ", "median"), ("p95", None), ("", "median")):
        if env is None:
            monkeypatch.delenv("ADAPCC_TUNER_OBJECTIVE", raising=False)
        else:
            monkeypatch.setenv("ADAPCC_TUNER_OBJECTIVE", env)
        assert outcome(resolve_tuner_objective, arg) == outcome(j_objective, arg)
    for env, arg in ((None, None), (None, "record"), ("CHOOSE", "off"), ("chose", None), ("", "choose")):
        if env is None:
            monkeypatch.delenv(TUNER_MODE_ENV, raising=False)
        else:
            monkeypatch.setenv(TUNER_MODE_ENV, env)
        assert outcome(tuner_mode, arg) == outcome(j_mode, arg)
    assert hook_path("bucket") == "hook-bucket" and hook_path() == HOOK_PATH


# --------------------------------------------------------------------------- #
# the trace, the registry and the replay
# --------------------------------------------------------------------------- #


def test_metrics_registry_snapshots_match():
    from adapcc_tpu.utils.observability import MetricsRegistry as JRegistry

    port, ref = obs.MetricsRegistry(), JRegistry()
    rng = np.random.default_rng(2)
    for i, x in enumerate(rng.exponential(1e-3, size=1300)):
        for reg in (port, ref):
            reg.observe("t", float(x))
            reg.incr("n", 2)
            if i % 100 == 0:
                reg.gauge("g", float(i))
    assert port.snapshot() == ref.snapshot()
    assert port.to_json() == ref.to_json()
    for q in (0.0, 0.5, 0.99, 1.0):
        xs = sorted(rng.random(17).tolist())
        from adapcc_tpu.utils.observability import nearest_rank_percentile as j_pct

        assert obs.nearest_rank_percentile(xs, q) == j_pct(xs, q)


def test_trace_dumps_parses_and_replays_into_the_live_cells(tmp_path, monkeypatch):
    """A record-mode engine's trace through dump → ``parse_track_log`` (the
    port's and JAX's) → ``replay_trace``: the same cells the live feed
    recorded, and JAX's summaries and chrome trace of the same events."""
    from adapcc_tpu.utils.observability import CollectiveTrace as JTrace
    from adapcc_tpu.utils.observability import parse_track_log as j_parse

    monkeypatch.setenv(TUNER_MODE_ENV, "record")
    tuner = CollectiveTuner(4, "t", db=TuningDatabase(persist=False))
    trace = obs.CollectiveTrace()
    eng = CollectiveEngine(4, Strategy.ring(4), trace=trace, tuner=tuner)
    x = torch.randn(4, 4 * 1024, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        eng.ring_allreduce(x)
        eng.ring_allreduce(x, chunk_bytes=4096)
        eng.ring_allreduce(x, wire_dtype="int8")
        eng.all_reduce(x)
        eng.all_reduce(x, active_gpus=[0, 1])
    monkeypatch.setenv("ADAPCC_FUSED_WIRE", "off")
    for _ in range(2):
        eng.ring_allreduce(x, wire_dtype="bf16")
    trace.dump(str(tmp_path / "track.txt"))
    events = obs.parse_track_log(str(tmp_path / "track.txt"))
    j_events = j_parse(str(tmp_path / "track.txt"))
    assert [vars(e) for e in events] == [vars(e) for e in j_events]
    assert [e.impl for e in events[:5]] == ["plain_ring[vmem]", "plain_ring[hbm-stream]", "plain_ring[vmem+int8]",
                                            "torch_fused", "schedule"]
    replayed = TuningDatabase(persist=False)
    assert replay_trace(events, replayed, 4, "t") == (10, 2)  # the masked schedule dispatches have no cell
    assert replayed.keys() == tuner.db.keys()
    assert _dicts(replayed.keys()) == [
        _key(size_bucket=16384, topology="t", path=p, chunk_bytes=c, wire_dtype=w)
        for p, c, w in (("hbm-stream", 4096, "off"), ("quant-ring", 0, "bf16"), ("vmem", 0, "int8"),
                        ("vmem", 0, "off"), ("xla", 0, "off"))]
    # the live feed discarded each configuration's first dispatch
    assert sum(replayed.count(k) for k in replayed.keys()) == 10
    assert sum(tuner.db.count(k) for k in tuner.db.keys()) == 5 and tuner.timer.discarded == 5
    ref, parsed = JTrace(), obs.CollectiveTrace()
    ref._events.extend(j_events)
    parsed._events.extend(events)
    assert trace.impl_summary() == parsed.impl_summary() == ref.impl_summary()
    parsed.dump_chrome_trace(str(tmp_path / "port.json"))
    ref.dump_chrome_trace(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    small = obs.CollectiveTrace(capacity=3)
    for i in range(5):
        small.record("allreduce", "x", i)
    assert small.dropped == 2 and [e.nbytes for e in small.events()] == [2, 3, 4]


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

#: the engine cases' per-rank payload and grid: 32 KiB a rank streams at a
#: 4096-byte budget (K1b, K5b) and is one stage a chunk at 1 MiB (K1a, K5a)
ENGINE_N = 8 * 1024
ENGINE_GRID = (4096, 1 << 20)


def _seed(db, cells, winner, key_cls):
    """Every cell at its trial budget, ``winner`` fastest: no exploration,
    a measured choice."""
    for c in cells:
        for i in range(8):
            db.record(key_cls.from_dict(c.to_dict()), (1e-3 if c == winner else 5e-3) * (1 + i / 100), ts=float(i))


@pytest.mark.parametrize("winner_path, winner_wire", [("hbm-stream", "off"), ("vmem", "int8")])
def test_engine_seeded_choice_matches_jax(winner_path, winner_wire, mesh4):
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.strategy.ir import Strategy as JStrategy
    from adapcc_tpu.tuner import CollectiveTuner as JTuner
    from adapcc_tpu.tuner import TuningDatabase as JDb
    from adapcc_tpu.utils.observability import CollectiveTrace as JTrace
    import jax.numpy as jnp

    port_m, jax_m = _models(4)
    pt = CollectiveTuner(4, "t", db=TuningDatabase(persist=False), mode="choose", chunk_grid=ENGINE_GRID,
                         cost_model=port_m)
    jt = JTuner(4, "t", db=JDb(persist=False), mode="choose", chunk_grid=ENGINE_GRID, cost_model=jax_m)
    cells = jt.policy.candidates("allreduce", ENGINE_N * 4, algos=("ring",))
    assert _dicts(cells) == _dicts(pt.policy.candidates("allreduce", ENGINE_N * 4, algos=("ring",)))
    winner = next(c for c in cells if (c.path, c.wire_dtype) == (winner_path, winner_wire))
    # both engines' ring_allreduce ask with every algorithm: the rd/tree
    # cells are offered alike and measured too (slower), so neither explores
    cells = jt.policy.candidates("allreduce", ENGINE_N * 4)
    assert _dicts(cells) == _dicts(pt.policy.candidates("allreduce", ENGINE_N * 4))
    assert {"rd", "tree"} <= {c.path for c in cells}
    _seed(pt.db, cells, winner, TuningKey)
    from adapcc_tpu.tuner import TuningKey as JKey

    _seed(jt.db, cells, winner, JKey)
    x = np.random.default_rng(3).normal(size=(4, ENGINE_N)).astype(np.float32)
    ptrace, jtrace = obs.CollectiveTrace(), JTrace()
    got = CollectiveEngine(4, Strategy.ring(4), trace=ptrace, tuner=pt).ring_allreduce(torch.from_numpy(x))
    want = np.asarray(JEngine(mesh4, JStrategy.ring(4), trace=jtrace, tuner=jt).ring_allreduce(jnp.asarray(x)))
    pe, je = ptrace.events()[-1], jtrace.events()[-1]
    assert pe.extra["tuner"] == je.extra["tuner"]
    assert pe.extra["tuner"]["chosen"]["path"] == winner_path and pe.extra["tuner"]["applied"] is True
    assert pe.impl.replace("plain_ring", "pallas_ring") == je.impl
    for f in je.extra:
        if f not in ("duration_s", "tuner", "cache_hit"):
            assert pe.extra[f] == je.extra[f], f
    if winner_wire == "off":
        assert np.array_equal(got.numpy(), want)
    else:
        # JAX under jit multiplies by 1/127 where the codec divides: 4 ulps
        m = np.maximum(np.abs(got.numpy()), np.abs(want))
        assert (np.abs(got.numpy() - want) <= 4 * (np.nextafter(m, np.inf) - m)).all()


def test_engine_precedence_off_mode_and_record_warmup(monkeypatch):
    """env > explicit arg > tuner > strategy, in the executed dispatch and in
    the trace's ``applied``; off mode is inert; a malformed mode raises;
    record mode discards each configuration's first dispatch."""
    db = TuningDatabase(persist=False)
    tuner = CollectiveTuner(4, "t", db=db, mode="choose", chunk_grid=ENGINE_GRID)
    trace = obs.CollectiveTrace()
    eng = CollectiveEngine(4, Strategy.ring(4), trace=trace, tuner=tuner)
    cells = tuner.policy.candidates("allreduce", ENGINE_N * 4, algos=("ring",))
    int8_cell = next(c for c in cells if (c.path, c.wire_dtype) == ("hbm-stream", "int8"))
    _seed(db, cells, int8_cell, TuningKey)
    x = torch.ones(4, ENGINE_N)

    def last():
        return trace.events()[-1]

    eng.ring_allreduce(x)  # the tuner steers the codec and the chunk
    assert last().impl == "plain_ring[hbm-stream+int8]" and last().extra["chunk_bytes"] == 4096
    assert last().extra["tuner"]["applied"] is True and last().extra["duration_s"] > 0
    eng.ring_allreduce(x, wire_dtype="bf16")  # the argument beats the tuner
    assert last().impl == "plain_ring[hbm-stream+bf16]" and last().extra["tuner"]["applied"] is False
    eng.ring_allreduce(x, chunk_bytes=1 << 20)
    assert last().impl == "plain_ring[vmem+int8]" and last().extra["tuner"]["applied"] is False
    monkeypatch.setenv("ADAPCC_RING_CHUNK_BYTES", str(1 << 20))  # the env beats both
    eng.ring_allreduce(x)
    assert last().extra["chunk_bytes"] == 1 << 20 and last().extra["ring_path"] == "vmem"
    monkeypatch.delenv("ADAPCC_RING_CHUNK_BYTES")
    monkeypatch.setenv("ADAPCC_WIRE_DTYPE", "bf16")
    eng.ring_allreduce(x)
    assert last().extra["wire_dtype"] == "bf16" and last().extra["tuner"]["chosen"]["wire_dtype"] == "bf16"
    monkeypatch.delenv("ADAPCC_WIRE_DTYPE")
    strat = Strategy.ring(4)
    strat.wire_dtype = "bf16"  # the strategy is the last rung: the tuner fills it
    eng2 = CollectiveEngine(4, strat, trace=trace, tuner=tuner)
    eng2.ring_allreduce(x)
    assert last().extra["wire_dtype"] == "int8"
    # off: nothing consulted, timed or recorded
    monkeypatch.setenv(TUNER_MODE_ENV, "off")
    n = sum(db.count(k) for k in db.keys())
    eng.ring_allreduce(x)
    assert "tuner" not in last().extra and "duration_s" not in last().extra
    assert sum(db.count(k) for k in db.keys()) == n
    monkeypatch.setenv(TUNER_MODE_ENV, "chose")
    with pytest.raises(ValueError, match="ADAPCC_TUNER"):
        CollectiveEngine(4, Strategy.ring(4), tuner=tuner)
    with pytest.raises(ValueError, match="ADAPCC_TUNER"):
        tuner.choosing
    # record: every dispatch timed, the first of each configuration dropped
    monkeypatch.setenv(TUNER_MODE_ENV, "record")
    rec = CollectiveTuner(4, "t", db=TuningDatabase(persist=False))
    reng = CollectiveEngine(4, Strategy.ring(4), tuner=rec)
    for _ in range(4):
        reng.ring_allreduce(x, wire_dtype="int8")
    (key,) = rec.db.keys()
    assert key == rec.key_for("allreduce", ENGINE_N * 4, "vmem", NO_CHUNK, "int8")
    assert rec.db.count(key) == 3 and rec.timer.discarded == 1
    assert rec.policy.incumbent("allreduce", ENGINE_N * 4) is None  # record never steers
    reng.clear()  # a rebuild re-discards
    reng.ring_allreduce(x, wire_dtype="int8")
    assert rec.db.count(key) == 3 and rec.timer.discarded == 2


def test_engine_auto_tuner_and_fast_path_cell(monkeypatch, mesh4, tmp_path):
    """A non-off mode builds the tuner JAX's engine builds, fingerprinted
    alike; a choosing tuner ranks the ``xla`` cell against rd and tree (a
    4 × 16-float payload: rd by the card's prior, masked or not) and the
    trace says whether its plane ran; a ring pin runs the flat fast path,
    timed into the ``xla`` cell."""
    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    monkeypatch.setenv(TUNER_MODE_ENV, "choose")
    monkeypatch.setenv("ADAPCC_TUNER_DB", str(tmp_path / "auto.jsonl"))
    eng = CollectiveEngine(4, Strategy.ring(4), trace=obs.CollectiveTrace())
    assert eng.tuner is None  # built at the first dispatch, on its device
    x = torch.ones(4, 16)
    eng.all_reduce(x)
    eng.all_reduce(x)
    eng.all_reduce(x, active_gpus=[0, 2])
    eng.all_reduce(x, algo="ring")
    eng.all_reduce(x, algo="ring")
    eng.all_reduce(x, active_gpus=[0, 2], algo="ring")
    assert eng.tuner.topology == JEngine(mesh4, JStrategy.ring(4)).tuner.topology
    assert eng.tuner.db.path == str(tmp_path / "auto.jsonl")
    events = eng.trace.events()
    for e in events[1:3]:
        assert e.impl == "rd" and e.extra["tuner"]["chosen"]["path"] == "rd" and e.extra["tuner"]["applied"] is True
        assert "duration_s" in e.extra
    assert events[4].impl == "torch_fused" and "duration_s" in events[4].extra and "tuner" not in events[4].extra
    assert events[5].impl == "schedule" and "duration_s" not in events[5].extra
    assert {k.path: eng.tuner.db.count(k) for k in eng.tuner.db.keys()} == {"rd": 2, XLA_PATH: 1}
    monkeypatch.setenv("ADAPCC_WIRE_DTYPE", "int8")  # no cell of this plane runs a codec: no ranking
    eng.all_reduce(x)
    assert "tuner" not in eng.trace.events()[-1].extra


# --------------------------------------------------------------------------- #
# the trainer, ZeRO-1, the Communicator and the hook
# --------------------------------------------------------------------------- #

#: the trainer case: adoption at step 1 (``tune_every=1``), step 2 runs the
#: adopted codec; the losses of two steps hold LOSS_ATOL (one update each)
TUNE_STEPS = 2


def _seed_ddp(db, key_for, grad_bytes, key_cls):
    """Every ddp_step cell at its budget, ``hook/bf16`` fastest."""
    for ov in ("off", "bucket"):
        for wd in ("off", "bf16", "int8"):
            fast = (ov, wd) == ("off", "bf16")
            for i in range(8):
                db.record(key_cls.from_dict(key_for("ddp_step", grad_bytes, hook_path(ov), 0, wd).to_dict()),
                          (1e-3 if fast else 1.0) * (1 + i / 100), ts=float(i))


def _jax_tuned_losses(params, tokens, grad_bytes):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.ddp import DDPTrainer as JTrainer
    from adapcc_tpu.ddp import TrainState as JState
    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.models.gpt2 import lm_loss as j_loss
    from adapcc_tpu.strategy.ir import Strategy as JStrategy
    from adapcc_tpu.tuner import CollectiveTuner as JTuner
    from adapcc_tpu.tuner import TuningDatabase as JDb
    from adapcc_tpu.tuner import TuningKey as JKey

    model = JGPT2(JConfig(**TINY, dtype=jnp.float32, attention="flash", flash_block=32))
    mesh = Mesh(jax.devices()[:1], ("ranks",))
    tuner = JTuner(1, "t", db=JDb(persist=False), mode="choose")
    _seed_ddp(tuner.db, tuner.key_for, grad_bytes, JKey)
    trainer = JTrainer(lambda p, b: j_loss(model.apply(p, b), b), optax.adamw(LR), mesh, JStrategy.ring(1),
                       tune=True, tuner=tuner, tune_every=1)
    state = JState.create(params, trainer.tx)
    losses, codecs = [], []
    for _ in range(TUNE_STEPS):
        codecs.append(trainer.hook.effective_compress())
        state, loss = trainer.step(state, jnp.asarray(tokens, jnp.int32))
        losses.append(float(np.asarray(loss)[0]))
    return losses, codecs, flax_to_state_dict(jax.device_get(state.params))


def test_trainer_adopts_at_the_step_jax_does(world1_tuned):
    params = _flax_params()
    tokens = _tokens(1)
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="flash", flash_block=32), device="cpu",
                 seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tuner = CollectiveTuner(1, "t", db=TuningDatabase(persist=False), mode="choose")
    _seed_ddp(tuner.db, tuner.key_for, grad_bytes, TuningKey)
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world1_tuned, Strategy.ring(1), tune=True,
                         tuner=tuner, tune_every=1)
    state = TrainState.create(model, trainer.tx)
    losses, codecs = [], []
    for _ in range(TUNE_STEPS):
        codecs.append(trainer.hook.effective_compress())
        state, loss = trainer.step(state, torch.from_numpy(tokens))
        losses.append(loss.item())
    j_losses, j_codecs, j_params = _jax_tuned_losses(params, tokens, grad_bytes)
    assert codecs == j_codecs == ["off", "bf16"]
    np.testing.assert_allclose(losses, j_losses, atol=LOSS_ATOL)
    _assert_params_close({k: v.detach().numpy() for k, v in model.state_dict().items()}, j_params)
    # each configuration's first step is its warmup: nothing recorded yet
    assert (tuner.timer.discarded, tuner.timer.recorded) == (2, 0)
    assert trainer._step_cell(grad_bytes) == tuner.key_for("ddp_step", grad_bytes, HOOK_PATH, 0, "bf16")


def test_trainer_error_feedback_and_env_pin_never_adopt_off_or_another_codec(world1_tuned, monkeypatch):
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=0)
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tokens = torch.from_numpy(_tokens(1))
    for kw, env in (({"grad_compress": "int8", "error_feedback": True}, None), ({}, "int8")):
        if env:
            monkeypatch.setenv("ADAPCC_WIRE_DTYPE", env)
        tuner = CollectiveTuner(1, "t", db=TuningDatabase(persist=False), mode="choose")
        for wd in ("off", "bf16", "int8"):  # off fastest, then bf16
            for i in range(8):
                tuner.db.record(tuner.key_for("ddp_step", grad_bytes, HOOK_PATH, 0, wd),
                                {"off": 1e-4, "bf16": 1e-3, "int8": 1.0}[wd], ts=float(i))
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world1_tuned, Strategy.ring(1), tune=True,
                             tuner=tuner, tune_every=1, **kw)
        state = TrainState.create(model, trainer.tx)
        codecs = []
        for _ in range(3):
            state, _ = trainer.step(state, tokens)
            codecs.append(trainer.hook.effective_compress())
        # error feedback keeps 'off' out of the grid (bf16 wins there); the
        # env pin collapses the codec axis and never steers
        assert codecs == (["bf16"] * 3 if env is None else ["int8"] * 3)
        monkeypatch.delenv("ADAPCC_WIRE_DTYPE", raising=False)


@pytest.fixture
def world1_tuned():
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    world = build_world_mesh(1, device="cpu")
    yield world
    destroy_world()


class _Flat(nn.Module):
    """``n`` float32 parameters in one leaf (an embedding: a flax leaf)."""

    def __init__(self, n):
        super().__init__()
        self.emb = nn.Embedding(n // 1024, 1024)


def test_zero1_tuned_chunk_matches_jax_and_closes_the_loop(mesh4):
    import jax.numpy as jnp
    import optax

    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JZero1
    from adapcc_tpu.tuner import CollectiveTuner as JTuner
    from adapcc_tpu.tuner import TuningDatabase as JDb

    n = 1 << 22  # large enough that the chunk grid gives distinct cells
    for seed in (0, 3):
        pt = CollectiveTuner(4, "z1", db=TuningDatabase(persist=False), mode="choose", seed=seed, epsilon=0.5)
        jt = JTuner(4, "z1", db=JDb(persist=False), mode="choose", seed=seed, epsilon=0.5)
        for _ in range(3):
            popt = Zero1Optimizer(adamw(LR), 4, ring=True, tuner=pt)
            popt.init(_Flat(n))
            jopt = JZero1(optax.sgd(0.1), mesh4, ring=True, ring_interpret=True, tuner=jt)
            jopt.init({"w": jnp.ones((n,), jnp.float32)})
            assert popt.ring_chunk_bytes == jopt.ring_chunk_bytes in DEFAULT_CHUNK_GRID
            assert (popt.tuned_plan.key.to_dict(), popt.tuned_plan.source) == (
                jopt.tuned_plan.key.to_dict(), jopt.tuned_plan.source)
            assert popt.tuning_key().to_dict() == jopt.tuning_key().to_dict()
    # across runs: each run's steps record under tuning_key(), where the next
    # init's choose looks
    db = TuningDatabase(persist=False)
    for _ in range(16):
        tuner = CollectiveTuner(4, "z1", db=db, mode="choose", epsilon=1.0, trial_budget=2, min_samples=1)
        opt = Zero1Optimizer(adamw(LR), 4, ring=True, tuner=tuner)
        opt.init(_Flat(n))
        key = opt.tuning_key()
        assert key in tuner.policy.candidates("zero1_ring", opt._meta.padded * 4)
        db.record(key, 1e-6 if key.chunk_bytes == 4 << 20 else 1e-3)
    opt = Zero1Optimizer(adamw(LR), 4, ring=True, tuner=CollectiveTuner(4, "z1", db=db, mode="choose"))
    opt.init(_Flat(n))
    assert (opt.tuned_plan.source, opt.ring_chunk_bytes) == ("measured", 4 << 20)
    pinned = Zero1Optimizer(adamw(LR), 4, ring=True, ring_chunk_bytes=2 << 20, tuner=tuner)
    pinned.init(_Flat(n))
    assert pinned.tuned_plan is None and pinned.tuning_key().chunk_bytes == 2 << 20


def test_zero1_step_records_under_its_cell(monkeypatch):
    monkeypatch.setenv(TUNER_MODE_ENV, "record")
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=0)
    tuner = CollectiveTuner(4, "z1", db=TuningDatabase(persist=False))
    opt = Zero1Optimizer(adamw(LR), 4, ring=True, tuner=tuner)
    master, opt_state = opt.init(model)
    assert opt.tuned_plan is None  # record mode measures, never chooses
    step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
    tokens = torch.from_numpy(_tokens(4))
    for _ in range(3):
        step(model, master, opt_state, tokens)
    assert tuner.db.keys() == [opt.tuning_key()] and tuner.db.count(opt.tuning_key()) == 2


def test_communicator_owns_the_tuner_and_its_engines_share_it(tmp_path, monkeypatch):
    from adapcc_tpu.tuner.db import topology_fingerprint as j_fingerprint

    from adapcc_tpu_torch.communicator import Communicator
    from adapcc_tpu_torch.config import CommArgs
    from adapcc_tpu_torch.primitives import SKIP_BOOTSTRAP

    from adapcc_tpu_torch.strategy.xml_io import emit_strategy_xml

    args = CommArgs(strategy_file=str(tmp_path / "s.xml"), logical_graph=str(tmp_path / "lg.xml"),
                    topology_dir=str(tmp_path), entry_point=SKIP_BOOTSTRAP)
    emit_strategy_xml(Strategy.ring(4), str(tmp_path / "s.xml"))
    comm = Communicator(args, world_size=4, device="cpu")
    assert comm.tuner.db.path == str(tmp_path / "tuning.jsonl")
    assert comm.tuner.topology == j_fingerprint(4, dict(enumerate(comm.ip_table)), platform="cpu:cpu")
    comm.metrics = obs.MetricsRegistry()
    comm.init_threads(ALLREDUCE)
    assert comm._engines[ALLREDUCE].tuner is comm.tuner
    monkeypatch.setenv("ADAPCC_TUNER_DB", str(tmp_path / "elsewhere.jsonl"))
    assert Communicator(args, world_size=4, device="cpu").tuner.db.path == str(tmp_path / "elsewhere.jsonl")
    monkeypatch.setenv(TUNER_MODE_ENV, "record")
    comm.init_threads(ALLREDUCE)
    comm._engines[ALLREDUCE].all_reduce(torch.ones(4, 8))
    comm._engines[ALLREDUCE].all_reduce(torch.ones(4, 8))
    assert comm.tuner.timer.recorded == 1
    hook = GradSyncHook(Strategy.ring(4), mode="schedule", communicator=comm)
    hook._bucket_plan([torch.ones(3)], "schedule")
    assert comm.metrics.snapshot()["gauges"]["bucket_plan.num_buckets"] == 1


@pytest.mark.parametrize("overlap, compress", [("off", "off"), ("bucket", "bf16")])
def test_hook_grad_sync_event_matches_jax(overlap, compress, tmp_path, monkeypatch, jax_defaults):
    """The bucket plan's ``grad_sync`` event and registry, both packages
    priced from one calibration file in the working directory."""
    import jax.numpy as jnp

    from adapcc_tpu.ddp.hook import GradSyncHook as JHook
    from adapcc_tpu.sim import calibrate as jcal
    from adapcc_tpu.strategy.ir import Strategy as JStrategy
    from adapcc_tpu.utils.observability import CollectiveTrace as JTrace
    from adapcc_tpu.utils.observability import MetricsRegistry as JRegistry

    monkeypatch.chdir(tmp_path)
    jcal.Calibration(world=2, classes={"ici": jcal.LinkCoeffs(4e-6, 1 / 200e9)}).save("topology/calibration.json")
    shapes = [(1000, 300), (7,), (4096, 64), (33, 33)]
    port_leaves = [torch.zeros(s) for s in shapes]
    jax_leaves = [jnp.zeros(s) for s in shapes]
    ips = {0: "a", 1: "b"}
    pt, jt = obs.CollectiveTrace(), JTrace()
    pm, jm = obs.MetricsRegistry(), JRegistry()
    port = GradSyncHook(Strategy.ring(2, ips=ips), bucket_cap_mb=1.0, compress=compress, overlap=overlap,
                        trace=pt, metrics=pm)
    ref = JHook(JStrategy.ring(2, ips=ips), bucket_cap_mb=1.0, compress=compress, overlap=overlap, trace=jt,
                metrics=jm)
    port._bucket_plan(port_leaves, "schedule")
    ref._bucket_plan(jax_leaves, "schedule")
    (pe,), (je,) = pt.events(), jt.events()
    assert (pe.primitive, pe.impl, pe.nbytes) == (je.primitive, je.impl, je.nbytes) == (
        "grad_sync", f"schedule[{overlap}]", 4 * sum(math.prod(s) for s in shapes))
    assert pe.extra.keys() == je.extra.keys()
    for k, v in je.extra.items():
        assert _rel_eq(pe.extra[k], v) if k == "exposed_comm_s" else pe.extra[k] == v, k
    assert pe.extra["exposed_comm_s"] > 0
    assert pm.snapshot() == jm.snapshot()
