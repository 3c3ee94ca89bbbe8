"""The port's online adaptation loop held against the JAX package's.

Each drill runs once per package on the same seeded inputs through a small
namespace of the package's modules (:func:`_ns`), and the trajectories are
compared whole: the detector's reports, the corrections, the merged
calibration files byte for byte, the triage verdicts, the controller's
report rows (every field but the walltimes ``aot_warm_s`` and ``stall_s``,
with the rankings' labels and ``pred_us``), the engines' strategy
fingerprints and epochs, and the first dispatch after a swap (``cache_hit``
and its rows).  Floats are compared with ``==``: the port keeps JAX's order
of every sum, median, ratio and α-β fit.  Feeds carry no timestamps, or the
same ones in both packages, so no comparison spans a real sleep.

The trainer's swap runs at gloo world 4 (rank 0 here, ranks 1–3 spawned,
the pattern of ``tests/test_torch_elastic.py``): every rank's controller
makes the same decision from the same fed series, adopts the winner in its
trainer, and the losses stay within the DDP parity tolerance of the JAX
trainer's under the JAX controller.
"""

import json
import multiprocessing
import os
import types

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.strategy.ir import Strategy
from test_torch_ddp import LOSS_ATOL, LR, PER_RANK_BATCH, _free_port

WORLD = 8
IPS = {r: f"10.0.0.{r // 2}" for r in range(WORLD)}  # 4 hosts × 2 lanes
TABLE = [IPS[r] for r in range(WORLD)]
#: the report fields that are walltimes, never compared
WALLTIMES = ("aot_warm_s", "stall_s")


def _ns(pkg):
    """One package's modules and constructors under one set of names."""
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        from adapcc_tpu import adapt, sim
        from adapcc_tpu.comm.engine import CollectiveEngine
        from adapcc_tpu.sim import calibrate, congestion, cost_model, replay
        from adapcc_tpu.strategy import hierarchy
        from adapcc_tpu.strategy.ir import Strategy as S
        from adapcc_tpu.strategy.synthesizer import Synthesizer
        from adapcc_tpu.supervisor import Supervisor
        from adapcc_tpu.coordinator.logic import CoordinatorLogic
        from adapcc_tpu.tuner import db, policy
        from adapcc_tpu.utils import observability

        def engine(strategy, trace=None, slices=1):
            if slices > 1:
                from adapcc_tpu.comm.two_level import build_two_level_mesh

                return CollectiveEngine(build_two_level_mesh(slices, WORLD // slices, devices=jax.devices()[:WORLD]),
                                        strategy, trace=trace)
            return CollectiveEngine(Mesh(jax.devices()[:WORLD], ("ranks",)), strategy, trace=trace)

        return types.SimpleNamespace(adapt=adapt, sim=sim, cal=calibrate, cong=congestion, cm=cost_model,
                                     replay=replay, hier=hierarchy, S=S, Synthesizer=Synthesizer, db=db,
                                     policy=policy, obs=observability, engine=engine, Supervisor=Supervisor,
                                     CoordinatorLogic=CoordinatorLogic, kw={}, flat_impl="xla",
                                     ones=lambda shape: jnp.ones(shape, jnp.float32), np=np.asarray)
    from adapcc_tpu_torch import adapt, sim
    from adapcc_tpu_torch.comm.engine import CollectiveEngine
    from adapcc_tpu_torch.coordinator.logic import CoordinatorLogic
    from adapcc_tpu_torch.sim import calibrate, congestion, cost_model, replay
    from adapcc_tpu_torch.strategy import hierarchy
    from adapcc_tpu_torch.strategy.synthesizer import Synthesizer
    from adapcc_tpu_torch.supervisor import Supervisor
    from adapcc_tpu_torch.tuner import db, policy
    from adapcc_tpu_torch.utils import observability

    def engine(strategy, trace=None, slices=1):
        return CollectiveEngine(WORLD, strategy, trace=trace, num_slices=slices)

    return types.SimpleNamespace(adapt=adapt, sim=sim, cal=calibrate, cong=congestion, cm=cost_model, replay=replay,
                                 hier=hierarchy, S=Strategy, Synthesizer=Synthesizer, db=db, policy=policy,
                                 obs=observability, engine=engine, Supervisor=Supervisor,
                                 CoordinatorLogic=CoordinatorLogic, kw={"device": "cpu"}, flat_impl="torch_fused",
                                 ones=lambda shape: torch.ones(shape), np=lambda t: t.numpy())


def _both(fn, *args):
    """``fn(ns, *args)`` for the port and for JAX; asserts the JSON of the
    two results equal and returns the port's."""
    port, jax_ = fn(_ns("port"), *args), fn(_ns("jax"), *args)
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_, sort_keys=True)
    return port


def _model(ns, dcn_slowdown=1.0, ips=IPS, source=None):
    cm = ns.cm
    return cm.LinkCostModel(WORLD, classes={cm.ICI: cm.LinkCoeffs(1e-6, 1.0 / 45e9),
                                            cm.DCN: cm.LinkCoeffs(25e-6, 1.0 / 12.5e9).scaled(dcn_slowdown)},
                            ips=ips, source=source or f"test-dcn-x{dcn_slowdown:g}")


def _key(ns, nbytes, topology="t", world=WORLD):
    return ns.db.TuningKey("allreduce", ns.db.size_bucket(nbytes), world, topology, "xla", 0, "off")


def _det(ns, model, window=4, topology="t"):
    return ns.adapt.DriftDetector(WORLD, topology, cost_model=model, factor=2.0, window=window)


def _cal_dict(cal):
    return None if cal is None else cal.to_dict()


# --------------------------------------------------------------------------- #
# knobs, the detector, the re-calibration
# --------------------------------------------------------------------------- #


def test_mode_and_drift_knobs_match_jax(monkeypatch):
    def knobs(ns):
        a = ns.adapt
        out = [a.adapt_mode(), a.adapt_mode("detect"), a.resolve_drift_factor(), a.resolve_drift_window(),
               a.resolve_drift_factor(3.5), a.resolve_drift_window(4), a.job_priority(), a.job_priority("low")]
        for env, value, fn in (("ADAPCC_ADAPT", "swapp", a.adapt_mode), ("ADAPCC_DRIFT_FACTOR", "0.5",
                                                                         a.resolve_drift_factor),
                               ("ADAPCC_DRIFT_WINDOW", "1", a.resolve_drift_window),
                               ("ADAPCC_JOB_PRIORITY", "medium", a.job_priority)):
            monkeypatch.setenv(env, value)
            try:
                fn()
            except ValueError as e:
                out.append(str(e))
            monkeypatch.delenv(env)
        monkeypatch.setenv("ADAPCC_ADAPT", "swap")
        out.append(a.adapt_mode("off"))
        monkeypatch.delenv("ADAPCC_ADAPT")
        return out

    for env in ("ADAPCC_ADAPT", "ADAPCC_DRIFT_FACTOR", "ADAPCC_DRIFT_WINDOW", "ADAPCC_JOB_PRIORITY"):
        monkeypatch.delenv(env, raising=False)
    out = _both(knobs)
    assert out[:8] == ["off", "detect", 2.0, 8, 3.5, 4, "high", "low"] and out[-1] == "swap"


def _detector_drills(ns):
    """The JAX detector tests' series, every check's report rows."""
    model = _model(ns)
    rows = []
    det = _det(ns, model)
    key = _key(ns, 1 << 20)
    pred = det.predicted_s(key)
    for i in range(4):
        det.observe(key, pred * (1.05 if i % 2 else 0.95))
    rows.append(det.check().to_rows())
    for _ in range(4):
        det.observe(key, pred * 8.0)
        rows.append(det.check().to_rows())
    # healthy ±30% noise never fires
    det = _det(ns, model)
    jitter = (0.7, 1.3, 0.9, 1.1, 1.25, 0.75, 1.0, 1.3)
    rows.append([det.observe(key, pred * jitter[i % 8]) or det.check().drifted for i in range(64)])
    # step cells against the frozen baseline
    det = _det(ns, model)
    for i in range(8):
        det.observe_step(0.010 * (1.1 if i % 2 else 0.9), nbytes=1 << 20)
    rows.append(det.check().to_rows())
    for _ in range(4):
        det.observe_step(0.030, nbytes=1 << 20)
    rows.append(det.check().to_rows())
    # the true payload, not the bucket edge
    det = _det(ns, model)
    nbytes = (1 << 20) + (1 << 18)
    k2 = _key(ns, nbytes)
    true_price = det._price_at(k2, nbytes)
    for scale in (1.0, 2.0):
        for _ in range(4):
            det.observe(k2, true_price * scale, nbytes=nbytes)
        rows.append(det.check().to_rows())
    # the database feed: idempotent, other worlds counted, the watermark
    det = _det(ns, model)
    other = ns.db.TuningKey("allreduce", 1 << 20, 4, "t", "xla", 0, "off")
    db = ns.db.TuningDatabase(persist=False)
    for i in range(6):
        db.record(key, pred * 8.0, ts=100.0 + i)
        db.record(other, 1.0, ts=100.0 + i)
    rows.append([det.ingest_db(db), det.check().to_rows(), det.ingest_db(db), det.check().to_rows()])
    det.reset(watermark=200.0)
    rows.append([det.ingest_db(db), det.check().to_rows()])
    for i in range(4):
        db.record(key, pred * 8.0, ts=300.0 + i)
    rows.append([det.ingest_db(db), det.check().to_rows(), det.ingested, det.skipped])
    det.reset(watermark=400.0)
    det.observe(key, pred * 8.0, ts=150.0)
    rows.append([len(det._windows.get(key, ())), det.skipped, repr(det)])
    # the trace feed (the flat path's impl: JAX's "xla", the port's "torch_fused")
    det = _det(ns, model, window=2)
    events = [ns.obs.TraceEvent(ts=float(i), primitive="allreduce", impl=ns.flat_impl, nbytes=(1 << 20) * WORLD, step=i,
                                extra={"duration_s": pred * 8.0, "algo": "ring"}) for i in range(3)]
    rows.append([det.ingest_trace(events), det.check().to_rows(), det.ingested, det.skipped])
    return rows


def test_detector_reports_match_jax():
    rows = _both(_detector_drills)
    assert not any(r["fired"] for r in rows[0]) and rows[4][0]["fired"]
    assert not any(rows[5]) and rows[7][0]["fired"] and rows[7][0]["reference"] == "baseline"


def _recalibration(ns, tmp):
    """Corrections (one size, two sizes, a per-link-fitted model), the
    merges, and their saved files."""
    out = []
    model = _model(ns)
    det = _det(ns, model)
    key = _key(ns, 1 << 20)
    pred = det.predicted_s(key)
    for _ in range(4):
        det.observe(key, pred * 10.0)
    out.append(_cal_dict(ns.adapt.drift_correction(det.check(), model, fingerprint="fp-t")))
    det = _det(ns, model)
    degraded = _model(ns, 10.0)
    for nbytes in (1 << 16, 1 << 22):
        k = _key(ns, nbytes)
        obs = _det(ns, degraded).predicted_s(k)
        for _ in range(4):
            det.observe(k, obs)
    corr = ns.adapt.drift_correction(det.check(), model)
    out.append(_cal_dict(corr))
    merged, merged_model = ns.adapt.corrected_model(det.check(), ns.adapt.calibration_of(model, samples=3))
    out.append([_cal_dict(merged), repr(merged_model)])
    lat = np.full((WORLD, WORLD), 1e-5)
    bw = np.full((WORLD, WORLD), 10.0)
    np.fill_diagonal(lat, 0.0)
    np.fill_diagonal(bw, 0.0)
    base = ns.cal.calibrate_from_matrices(lat, bw, IPS, source="profiled")
    pm = base.cost_model()
    det = _det(ns, pm)
    p1 = det.predicted_s(key)
    for _ in range(4):
        det.observe(key, p1 * 10.0)
    corr = ns.adapt.drift_correction(det.check(), pm)
    merged = ns.cal.merge_calibration(base, corr, decay=0.5)
    path = os.path.join(tmp, "calibration.json")
    merged.save(path)
    det.set_cost_model(merged.cost_model())
    out.append([_cal_dict(corr), det.predicted_s(key), det.check().to_rows()])
    for _ in range(4):
        det.observe(key, p1 * 10.0)
    out.append(det.check().to_rows())
    with open(path, "rb") as f:
        out.append(f.read().decode())
    return out


def test_recalibration_and_merged_file_match_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _recalibration(_ns("port"), str(tmp_path / "port"))
    jax_ = _recalibration(_ns("jax"), str(tmp_path / "jax"))
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_, sort_keys=True)
    assert list(port[0]["classes"]) == ["dcn"] and port[0]["samples"] == 4
    assert not any(r["fired"] for r in port[4])  # the loop converged


def _merges(ns, tmp):
    Cal, LC, ICI, DCN = ns.cal.Calibration, ns.cm.LinkCoeffs, ns.cm.ICI, ns.cm.DCN
    base = Cal(WORLD, classes={ICI: LC(1e-6, 1e-11)}, samples=8, source="base", fingerprint="fp-a")
    update = Cal(WORLD, classes={ICI: LC(3e-6, 3e-11)}, samples=8, source="recal", fingerprint="fp-a")
    base2 = Cal(WORLD, classes={ICI: LC(1e-6, 1e-11), DCN: LC(9e-6, 9e-11)}, samples=4, source="b2")
    out = [ns.cal.merge_calibration(base, update).to_dict(), ns.cal.merge_calibration(base2, update).to_dict()]
    chained = base
    for i in range(10):  # the provenance chain stays bounded
        chained = ns.cal.merge_calibration(chained, Cal(WORLD, classes={DCN: LC(1e-5 * i, 1e-10)}, samples=i,
                                                        source=f"r{i}"), decay=0.25)
    out.append(chained.to_dict())
    for bad in (Cal(4, classes={}), Cal(WORLD, classes={}, fingerprint="fp-b")):
        try:
            ns.cal.merge_calibration(base, bad)
        except ValueError as e:
            out.append(str(e))
    stamped = Cal(WORLD, classes={ICI: LC(1e-6, 1e-11)}, fingerprint="fp-x", samples=17, provenance=["a", "b"])
    path = os.path.join(tmp, "stamped.json")
    stamped.save(path)
    with open(path) as f:
        out.append(f.read())
    out.append(Cal.load(path).to_dict())
    return out


def test_merge_calibration_and_stamps_match_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _merges(_ns("port"), str(tmp_path / "port"))
    assert json.dumps(port) == json.dumps(_merges(_ns("jax"), str(tmp_path / "jax")))
    assert port[0]["samples"] == 12 and port[0]["provenance"] == ["base", "recal"]
    assert len(port[2]["provenance"]) == 8


def test_calibration_sources_match_jax(tmp_path, monkeypatch):
    """The profile-directory fit and the battery fit (the inter-host guess
    scaled by the defaults' class ratio: the port's defaults set to JAX's)."""
    from adapcc_tpu.sim import cost_model as jcm

    from adapcc_tpu_torch.sim import cost_model as pcm

    monkeypatch.setattr(pcm, "DEFAULT_COEFFS", dict(jcm.DEFAULT_COEFFS))
    rng = np.random.default_rng(5)
    with open(tmp_path / "topo_profile_0", "w") as f:
        for s in range(WORLD):
            for d in range(WORLD):
                if s != d:
                    f.write(f"{s},{d},lat,{rng.uniform(1e-6, 3e-5):.9f}\n{s},{d},bw,{rng.uniform(5, 90):.6f}\n")
    with open(tmp_path / "hw.jsonl", "w") as f:
        rows = [{"collective": c, "world": w, "size_bytes": n, "time_us": float(rng.uniform(10, 900)), "impl": impl}
                for c in ("allreduce", "all_gather") for w in (4, 8) for n in (1 << 12, 1 << 22)
                for impl in ("xla", "schedule")]
        f.write(json.dumps({"rows": rows[:5]}) + "\n" + "garbage\n" + json.dumps({"parsed": rows[5]}) + "\n")
        f.write(json.dumps({"rows": rows[6:]}) + "\n")

    def sources(ns):
        return [ns.cal.calibrate_from_profile_dir(str(tmp_path), WORLD, IPS).to_dict(),
                _cal_dict(ns.cal.calibrate_from_battery(str(tmp_path / "hw.jsonl"))),
                _cal_dict(ns.cal.calibrate_from_battery(str(tmp_path / "hw.jsonl"), impls=("none",))),
                repr(ns.cm.LinkCostModel.from_topo_profile_dir(str(tmp_path), WORLD))]

    out = _both(sources)
    assert out[1] is not None and out[2] is None


# --------------------------------------------------------------------------- #
# triage and the contention pricing
# --------------------------------------------------------------------------- #


def _fed(ns, model, observed, sizes=(65536, 16 << 20)):
    det = ns.adapt.DriftDetector(WORLD, "fp", cost_model=model, factor=2.0, window=4)
    pol = ns.policy.TuningPolicy(ns.db.TuningDatabase(persist=False), WORLD, "fp", cost_model=observed)
    for nb in sizes:
        key = det.probe_key(nb)
        for _ in range(4):
            det.observe(key, pol.prior_time(key, nb), nbytes=nb)
    return det.check()


def _triage(ns, case):
    model = _model(ns, source="test-fabric")
    cm = ns.cm
    observed, sizes = {
        "congestion-dcn": (model.contended({cm.DCN: 4.0}), (65536, 16 << 20)),
        "congestion-ici": (model.contended({cm.ICI: 64.0}), (65536, 16 << 20)),
        "degradation": (cm.LinkCostModel(WORLD, classes={cm.ICI: model.classes[cm.ICI],
                                                         cm.DCN: model.classes[cm.DCN].scaled(6.0)},
                                         ips=IPS, source="deg"), (65536, 16 << 20)),
        "single-size": (model.contended({cm.DCN: 4.0}), (16 << 20,)),
        "mid-band": (cm.LinkCostModel(WORLD, classes={cm.ICI: model.classes[cm.ICI].scaled(8.0),
                                                      cm.DCN: model.classes[cm.DCN]},
                                      ips=IPS, source="ici-deg"), (65536, 16 << 20)),
    }[case]
    report = _fed(ns, model, observed, sizes)
    verdict = ns.adapt.classify_drift(report, model)
    out = [report.to_rows(), verdict.to_row() if verdict else None]
    if verdict is not None and verdict.kind == "congestion":
        view = ns.adapt.contended_view(model, verdict)
        out.append([view.source, {c: [k.alpha, k.beta] for c, k in view.classes.items()}])
    return out


@pytest.mark.parametrize("case", ["congestion-dcn", "congestion-ici", "degradation", "single-size", "mid-band"])
def test_classify_drift_matches_jax(case):
    out = _both(_triage, case)
    want = {"congestion-dcn": ("congestion", "dcn"), "congestion-ici": ("congestion", "ici"),
            "degradation": ("degradation", "dcn"), "single-size": ("degradation", "dcn")}.get(case)
    if want is not None:
        assert (out[1]["kind"], out[1]["link_class"]) == want
    elif out[1] is not None:
        assert out[1]["kind"] == "degradation"


def _pricing(ns):
    cm = ns.cm
    model = _model(ns)
    link_model = cm.LinkCostModel(WORLD, links={(0, 2): cm.LinkCoeffs(3e-5, 1e-10), (0, 1): cm.LinkCoeffs(2e-6, 3e-11)},
                                  classes=model.classes, ips=IPS, source="links")
    c = link_model.contended({cm.DCN: 4.0, cm.ICI: 1.5})
    bw, lat = model.to_graphs()
    dcn, ici = model.classes[cm.DCN], model.classes[cm.ICI]
    out = [c.source, sorted((list(k), [v.alpha, v.beta]) for k, v in c.links.items()),
           {k: [v.alpha, v.beta] for k, v in c.classes.items()}, bw, lat,
           [cm.congested_ring_allreduce_time(WORLD, 16 << 20, dcn, f, w) for f in (1.0, 4.0)
            for w in ("off", "bf16", "int8")],
           [cm.congested_two_level_allreduce_time(2, 4, 16 << 20, ici, dcn, dcn_factor=f, leader_algo=a)
            for f in (1.0, 4.0) for a in ("tree", "rs-ag")],
           [cm.contended_lower_bound(model, 16 << 20, {cm.DCN: 4.0}, coll) for coll in ("allreduce", "broadcast")],
           cm.adaptation_cost(WORLD, 1 << 20, cm.bottleneck_ring_coeffs(model, WORLD), 2e-3, 1e-3),
           cm.adaptation_cost(WORLD, 1 << 20, dcn, 1e-3, 1e-3, standby_cached=False)]
    for bad in ({"pcie": 2.0}, {cm.DCN: 0.5}):
        try:
            model.contended(bad)
        except ValueError as e:
            out.append(str(e))
    return out


def test_contention_pricing_matches_jax(monkeypatch):
    """Contended models and matrices, the congested terms (the codec's rate,
    a card default in the port, set to JAX's), the window's floor and the
    adaptation arms."""
    from adapcc_tpu.sim import cost_model as jcm

    from adapcc_tpu_torch.sim import cost_model as pcm

    monkeypatch.setattr(pcm, "DEFAULT_CODEC_BYTES_PER_S", jcm.DEFAULT_CODEC_BYTES_PER_S)
    out = _both(_pricing)
    assert out[-4]["hot_swap_stall_s"] < out[-4]["full_rebuild_stall_s"]


def _profiles(ns, tmp):
    cong = ns.cong
    seeded = [cong.CongestionProfile.seeded(WORLD, steps=16, seed=s).to_dict() for s in (0, 7, 8)]
    prof = cong.CongestionProfile([cong.CongestionWindow(2, 6, "dcn", 4.0), cong.CongestionWindow(4, 8, "dcn", 2.0),
                                   cong.CongestionWindow(5, 7, "ici", 3.0)], world=WORLD, label="drill")
    model = _model(ns)
    states = [[prof.factors_at(s), prof.healthy_at(s)] for s in range(9)]
    contended = prof.contended_model(model, 5)
    path = os.path.join(tmp, "profile.json")
    prof.save(path)
    with open(path) as f:
        text = f.read()
    errors = []
    for args in ((0, 4, "pcie"), (4, 4, "dcn"), (-1, 4, "dcn"), (0, 4, "dcn", 0.5)):
        try:
            cong.CongestionWindow(*args)
        except ValueError as e:
            errors.append(str(e))
    return [seeded, states, contended.source, prof.last_step(), list(prof.classes()), text, errors, repr(prof)]


def test_congestion_profile_files_cross_both_ways(tmp_path, monkeypatch):
    from adapcc_tpu.sim import congestion as jcong

    from adapcc_tpu_torch.sim import congestion as pcong

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _profiles(_ns("port"), str(tmp_path / "port"))
    assert json.dumps(port) == json.dumps(_profiles(_ns("jax"), str(tmp_path / "jax")))
    # a file written by one package loads in the other and saves back byte for byte
    for src, dst, name in ((jcong, pcong, "from_jax.json"), (pcong, jcong, "from_port.json")):
        prof = src.CongestionProfile.seeded(WORLD, steps=24, seed=3, n_windows=3, classes=("dcn", "ici"))
        prof.save(str(tmp_path / name))
        again = dst.CongestionProfile.load(str(tmp_path / name))
        again.save(str(tmp_path / f"re_{name}"))
        assert (tmp_path / name).read_bytes() == (tmp_path / f"re_{name}").read_bytes()
        assert [again.factors_at(s) for s in range(24)] == [prof.factors_at(s) for s in range(24)]
    # the env funnel: unset, set, another world, missing, broken
    monkeypatch.delenv(pcong.CONGESTION_PROFILE_ENV, raising=False)
    assert pcong.load_congestion_profile() is None
    monkeypatch.setenv(pcong.CONGESTION_PROFILE_ENV, str(tmp_path / "from_jax.json"))
    assert pcong.load_congestion_profile(world=WORLD).to_dict() == jcong.load_congestion_profile(world=WORLD).to_dict()
    with pytest.raises(ValueError, match="world"):
        pcong.load_congestion_profile(world=4)
    monkeypatch.setenv(pcong.CONGESTION_PROFILE_ENV, str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError):
        pcong.load_congestion_profile()
    (tmp_path / "bad.json").write_text("not json{")
    monkeypatch.setenv(pcong.CONGESTION_PROFILE_ENV, str(tmp_path / "bad.json"))
    with pytest.raises(ValueError, match="congestion-profile"):
        pcong.load_congestion_profile()


# --------------------------------------------------------------------------- #
# the controller on JAX's drills
# --------------------------------------------------------------------------- #


def _row(rep):
    row = {k: v for k, v in rep.to_row().items() if k not in WALLTIMES}
    row["ranked"] = rep.ranked
    row["drift"] = rep.drift.to_rows() if rep.drift is not None else None
    return row


def _controller(ns, eng, mode, model, cal_path=None, nbytes=1 << 20, fingerprint="fp-drill", table=TABLE, **kwargs):
    return ns.adapt.AdaptationController(
        eng, ns.Synthesizer(None, table), mode=mode, cost_model=model, calibration_path=cal_path, nbytes=nbytes,
        parallel_degree=2, warm_shape=(64,), fingerprint=fingerprint,
        detector=ns.adapt.DriftDetector(WORLD, fingerprint, cost_model=model, factor=2.0, window=4),
        **ns.kw, **kwargs)


def _feed(ns, ctl, model, scale=1.0):
    key = _key(ns, 1 << 20, "fp-drill")
    pred = _det(ns, model, topology="fp-drill").predicted_s(key)
    for i in range(ctl.detector.window):
        ctl.observe(key, pred * scale * (0.95, 1.05)[i % 2])


def _dispatch(ns, eng, trace):
    out = eng.all_reduce(ns.ones((WORLD, 64)), active_gpus=list(range(WORLD)))
    ev = trace.events()[-1]
    return [ev.impl, ev.extra["cache_hit"], ev.extra.get("epoch"), ns.np(out).tolist()[0][:2]]


def _drill(ns, name, tmp):
    """One JAX drill (tests/test_adapt.py, test_fabric.py,
    test_hierarchy.py): its report rows, the engine's strategy and epoch,
    and the dispatches after each swap."""
    cm = ns.cm
    trace = ns.obs.CollectiveTrace()
    cal_path = os.path.join(tmp, "calibration.json")
    out = []
    if name == "leader-level":
        table = [f"slice-{r // 2}" for r in range(WORLD)]
        sk = ns.hier.HierarchySketch(4, 2, tuple(table))
        ici, dcn = cm.LinkCoeffs(1e-6, 1.0 / 45e9), cm.LinkCoeffs(25e-6, 1.0 / 12.5e9)  # JAX's defaults
        healthy = cm.LinkCostModel(WORLD, classes={cm.ICI: ici, cm.DCN: dcn}, ips=sk.ips(), source="drill-healthy")
        plan = ns.hier.synthesize_two_level(sk, model=healthy, nbytes=1 << 20)
        eng = ns.engine(plan.strategy, trace, slices=4)
        ctl = _controller(ns, eng, "swap", healthy, cal_path, fingerprint="fp-hier", table=table)
        degraded = cm.LinkCostModel(WORLD, classes={cm.ICI: ici, cm.DCN: cm.LinkCoeffs(5e-3, dcn.beta)},
                                    ips=sk.ips(), source="drill-congested")
        for nbytes in (64 << 10, 16 << 20):
            key = _key(ns, nbytes, "fp-hier")
            truth = ns.adapt.DriftDetector(WORLD, "fp-hier", cost_model=degraded, window=4).predicted_s(key)
            for i in range(4):
                ctl.observe(key, truth * (0.97 + 0.02 * (i % 2)), nbytes=nbytes)
        out.append(_row(ctl.maybe_adapt()))
        new_plan = ns.hier.plan_of(eng.strategy)
        out.append([new_plan.leader_algo, new_plan.resolved_level, new_plan.pod_algo])
        assert new_plan.ici_solve is plan.ici_solve  # the pod level kept
        ev = eng.all_reduce(ns.ones((WORLD, 64)), active_gpus=list(range(WORLD)))
        e = trace.events()[-1]
        out.append([e.impl, e.extra["cache_hit"], e.extra["epoch"], e.extra["hier"], ns.np(ev).tolist()[0][:2]])
    elif name in ("swap", "detect", "off", "hysteresis", "uninvertible"):
        incumbent = ns.S.ring(WORLD, 1, IPS)
        eng = ns.engine(incumbent, trace)
        kwargs = {"hysteresis_margin": 1.0} if name == "hysteresis" else {}
        ctl = _controller(ns, eng, None if name == "off" else ("detect" if name == "detect" else "swap"),
                          _model(ns), cal_path, **kwargs)
        if name == "uninvertible":
            for scale in (0.010, 0.050):
                for _ in range(ctl.detector.window):
                    ctl.observe_step(scale, nbytes=1 << 20)
                out.append(_row(ctl.maybe_adapt()))
        else:
            _feed(ns, ctl, _model(ns))
            out.append(_row(ctl.maybe_adapt()))
            _feed(ns, ctl, _model(ns, 10.0))
            out.append(_row(ctl.maybe_adapt()))
        if name == "swap":
            with open(cal_path) as f:
                out.append(f.read())
            out.append(_dispatch(ns, eng, trace))
            out.append(_row(ctl.maybe_adapt()))
            out.append([p.label for p in ctl.cache.adaptive.values()])
    else:  # the congestion drills of tests/test_fabric.py
        model = _model(ns, source="test-fabric")
        incumbent = ns.S.ring(WORLD, 1, IPS)
        eng = ns.engine(incumbent, trace)
        if name == "degradation":
            ctl = _controller(ns, eng, "swap", model, cal_path, nbytes=16 << 20, fingerprint="fp")
            degraded = cm.LinkCostModel(WORLD, classes={cm.ICI: model.classes[cm.ICI],
                                                        cm.DCN: model.classes[cm.DCN].scaled(6.0)},
                                        ips=IPS, source="deg")
            pol = ns.policy.TuningPolicy(ns.db.TuningDatabase(persist=False), WORLD, "fp", cost_model=degraded)
            for nb in ctl._probe_sizes:
                key = ctl.detector.probe_key(nb)
                for i in range(4):
                    ctl.observe(key, pol.prior_time(key, nb), nbytes=nb)
            out.append(_row(ctl.maybe_adapt()))
            with open(cal_path) as f:
                out.append(f.read())
        elif name == "healthy-jitter":
            ctl = _controller(ns, eng, "swap", model, cal_path, nbytes=16 << 20, fingerprint="fp")
            pol = ns.policy.TuningPolicy(ns.db.TuningDatabase(persist=False), WORLD, "fp", cost_model=model)
            for nb in ctl._probe_sizes:
                key = ctl.detector.probe_key(nb)
                for i in range(4):
                    ctl.observe(key, pol.prior_time(key, nb) * (0.95 if i % 2 else 1.05), nbytes=nb)
            out.append(_row(ctl.maybe_adapt()))
        else:
            window = {"congestion": (4, 8), "congestion-detect": (0, 4), "small-probe": (0, 4)}[name]
            profile = ns.cong.CongestionProfile([ns.cong.CongestionWindow(*window, cm.DCN, 4.0)], WORLD)
            ns.adapt.calibration_of(model, fingerprint="fp", samples=3).save(cal_path)
            with open(cal_path, "rb") as f:
                before = f.read()
            eng.all_reduce(ns.ones((WORLD, 64)), active_gpus=list(range(WORLD)))
            ctl = _controller(ns, eng, "swap" if name == "congestion" else "detect", model, cal_path,
                              nbytes=2048 if name == "small-probe" else 16 << 20, fingerprint="fp",
                              congestion_profile=profile)
            out.append(list(ctl._probe_sizes))
            for first in range(0, 12 if name == "congestion" else 4, 4):
                for step in range(first, first + 4):
                    ctl.tick(step)
                out.append(_row(ctl.maybe_adapt()))
                out.append([ctl.rerouted, eng.strategy.fingerprint(), eng.epoch])
                if name == "congestion" and first:
                    out.append(_dispatch(ns, eng, trace))
                with open(cal_path, "rb") as f:
                    assert f.read() == before  # congestion never touches the calibration
            out.append(_row(ctl.maybe_adapt()))
    out.append([eng.strategy.fingerprint(), eng.epoch, ctl.swaps])
    return out


DRILLS = ["swap", "detect", "off", "hysteresis", "uninvertible", "congestion", "congestion-detect", "small-probe",
          "degradation", "healthy-jitter", "leader-level"]


@pytest.mark.parametrize("name", DRILLS)
def test_controller_trajectory_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.delenv("ADAPCC_ADAPT", raising=False)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _drill(_ns("port"), name, str(tmp_path / "port"))
    jax_ = _drill(_ns("jax"), name, str(tmp_path / "jax"))
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_, sort_keys=True)
    outcomes = [r["outcome"] for r in port if isinstance(r, dict) and "outcome" in r]
    want = {"swap": ["no-drift", "swapped", "no-drift"], "detect": ["no-drift", "would-swap"],
            "off": ["off", "off"], "hysteresis": ["no-drift", "hysteresis"],
            "uninvertible": ["no-drift", "uninvertible"],
            "congestion": ["no-drift", "congestion-reroute", "congestion-cleared", "no-drift"],
            "congestion-detect": ["congestion-would-reroute"] * 2,
            "small-probe": ["congestion-would-reroute"] * 2, "degradation": ["hysteresis"],
            "healthy-jitter": ["no-drift"], "leader-level": ["swapped"]}[name]
    assert outcomes == want
    if name == "swap":
        assert port[3][:3] == ["schedule", True, 1]  # the first dispatch after the swap: warm, epoch 1
    if name == "congestion":
        assert port[5][1] is True and port[8][1] is True  # the re-route's and the restore's dispatches
    if name == "leader-level":
        assert port[2][:3] == ["two_level[composed]", True, 1]


# --------------------------------------------------------------------------- #
# the trainer's swap at gloo world 4
# --------------------------------------------------------------------------- #

TRAINER_WORLD = 4
TRAINER_IPS = {r: f"10.0.0.{r // 2}" for r in range(TRAINER_WORLD)}
TINY = dict(vocab_size=16, max_seq=8, n_layer=1, n_head=2, d_model=16)
TRAINER_STEPS = (2, 2)  # steps before the swap, after it


def _trainer_ctl(ns, eng, trainer, prewarm):
    model = ns.cm.LinkCostModel(TRAINER_WORLD, classes={ns.cm.ICI: ns.cm.LinkCoeffs(1e-6, 1.0 / 45e9),
                                                        ns.cm.DCN: ns.cm.LinkCoeffs(25e-6, 1.0 / 12.5e9)},
                                ips=TRAINER_IPS, source="trainer-drill")
    degraded = ns.cm.LinkCostModel(TRAINER_WORLD, classes={ns.cm.ICI: model.classes[ns.cm.ICI],
                                                           ns.cm.DCN: model.classes[ns.cm.DCN].scaled(10.0)},
                                   ips=TRAINER_IPS, source="trainer-drill-x10")
    ctl = ns.adapt.AdaptationController(
        eng, ns.Synthesizer(None, [TRAINER_IPS[r] for r in range(TRAINER_WORLD)]), mode="swap", cost_model=model,
        nbytes=1 << 20, parallel_degree=2, warm_shape=(64,), fingerprint="fp-train", trainer=trainer,
        trainer_prewarm=prewarm,
        detector=ns.adapt.DriftDetector(TRAINER_WORLD, "fp-train", cost_model=model, factor=2.0, window=4), **ns.kw)
    key = ns.db.TuningKey("allreduce", ns.db.size_bucket(1 << 20), TRAINER_WORLD, "fp-train", "xla", 0, "off")
    pred = ns.adapt.DriftDetector(TRAINER_WORLD, "fp-train", cost_model=degraded, window=4).predicted_s(key)
    for i in range(4):
        ctl.observe(key, pred * (0.95, 1.05)[i % 2])
    return ctl


def _port_trainer_rank(rank, init_method, state_dict, tokens):
    """One gloo rank: steps, the controller's swap into its trainer, steps."""
    from adapcc_tpu_torch.comm.engine import CollectiveEngine

    world = build_world_mesh(TRAINER_WORLD, rank=rank, device="cpu", init_method=init_method)
    try:
        model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=None)
        model.load_state_dict(state_dict)
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world,
                             Strategy.ring(TRAINER_WORLD, 1, TRAINER_IPS), sync_mode="schedule", dynamic_mask=True)
        state = TrainState.create(model, trainer.tx)
        shard = torch.from_numpy(tokens[rank * PER_RANK_BATCH:(rank + 1) * PER_RANK_BATCH])
        losses = [trainer.step(state, shard)[1].item() for _ in range(TRAINER_STEPS[0])]
        eng = CollectiveEngine(TRAINER_WORLD, trainer.hook.strategy)
        ctl = _trainer_ctl(_ns("port"), eng, trainer, lambda s: trainer.prewarm(s, state, shard))
        rep = ctl.maybe_adapt()
        recompiles = trainer.recompiles
        losses += [trainer.step(state, shard)[1].item() for _ in range(TRAINER_STEPS[1])]
        return (_row(rep), losses, recompiles, trainer.recompiles, trainer.hook.strategy.fingerprint())
    finally:
        destroy_world()


def _port_trainer_child(*args):
    torch.set_num_threads(1)
    return _port_trainer_rank(*args)


def _jax_trainer(params, tokens):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.comm.engine import CollectiveEngine as JEngine
    from adapcc_tpu.ddp import DDPTrainer as JTrainer
    from adapcc_tpu.ddp import TrainState as JState
    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.models.gpt2 import lm_loss as jloss
    from adapcc_tpu.strategy.ir import Strategy as JStrategy

    model = JGPT2(JConfig(**TINY, dtype=jnp.float32, attention="xla"))
    mesh = Mesh(jax.devices()[:TRAINER_WORLD], ("ranks",))
    trainer = JTrainer(lambda p, b: jloss(model.apply(p, b), b), optax.adamw(LR), mesh,
                       JStrategy.ring(TRAINER_WORLD, 1, TRAINER_IPS), sync_mode="schedule", dynamic_mask=True)
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    state = jax.device_put(JState.create(params, trainer.tx), NamedSharding(mesh, P()))
    losses = []
    for _ in range(TRAINER_STEPS[0]):
        state, loss = trainer.step(state, batch)
        losses.append(np.asarray(loss))
    holder = {"state": state}
    ctl = _trainer_ctl(_ns("jax"), JEngine(mesh, trainer.hook.strategy), trainer,
                       lambda s: trainer.prewarm(s, holder["state"], batch))
    rep = ctl.maybe_adapt()
    for _ in range(TRAINER_STEPS[1]):
        state, loss = trainer.step(state, batch)
        losses.append(np.asarray(loss))
    return _row(rep), np.stack(losses, axis=1), trainer.hook.strategy.fingerprint()


def test_trainer_swap_at_gloo_world4_matches_jax():
    from test_torch_elastic import _flax_params
    from adapcc_tpu_torch.models.convert import flax_to_state_dict

    params = _flax_params()
    sd = flax_to_state_dict(params)
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, TINY["vocab_size"], size=(TRAINER_WORLD * PER_RANK_BATCH, TINY["max_seq"]))
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(TRAINER_WORLD - 1) as pool:
        pending = [pool.apply_async(_port_trainer_child, (r, init_method, sd, tokens))
                   for r in range(1, TRAINER_WORLD)]
        jax_row, jax_losses, jax_fp = _jax_trainer(params, tokens)
        per_rank = [_port_trainer_rank(0, init_method, sd, tokens)] + [p.get(timeout=180) for p in pending]
    assert jax_row["outcome"] == "swapped" and jax_row["trainer_adopt_hit"] is True
    for rank, (row, losses, r_swap, r_after, fp) in enumerate(per_rank):
        assert json.dumps(row, sort_keys=True) == json.dumps(jax_row, sort_keys=True), f"rank {rank}"
        assert fp == jax_fp == row["winner"]
        assert r_after == r_swap  # the prewarmed configuration: no build after the swap
        np.testing.assert_allclose(losses, jax_losses[rank], atol=LOSS_ATOL, err_msg=f"rank {rank}")


# --------------------------------------------------------------------------- #
# the communicator, the supervisor, the variability probes
# --------------------------------------------------------------------------- #


def test_communicator_builds_wired_controller(tmp_path, monkeypatch):
    from adapcc_tpu_torch.communicator import Communicator
    from adapcc_tpu_torch.config import CommArgs
    from adapcc_tpu_torch.primitives import ALLREDUCE

    monkeypatch.delenv("ADAPCC_ADAPT", raising=False)
    args = CommArgs(topology_dir=str(tmp_path), strategy_file=str(tmp_path / "strategy.xml"),
                    logical_graph=str(tmp_path / "lg.xml"), parallel_degree=2)
    comm = Communicator(args, world_size=4, device="cpu")
    comm.init_threads(ALLREDUCE)
    ctl = comm.adaptation_controller(mode="detect")
    assert ctl.db is comm.tuner.db and ctl.fingerprint == comm.tuner.topology
    assert ctl.calibration_path == str(tmp_path / "calibration.json")
    assert ctl.engine is comm._engine(ALLREDUCE) and ctl.synthesizer is comm.synthesizer
    assert ctl.parallel_degree == 2 and ctl.cache.device == comm.device
    assert ctl.maybe_adapt().outcome == "no-drift"  # nothing measured yet
    assert comm.adaptation_controller(mode="swap", parallel_degree=1).parallel_degree == 1
    assert not os.path.exists(tmp_path / "calibration.json")


def _supervised(ns, tmp):
    """The congestion drill under ``Supervisor(adapt=ctl, adapt_every=1)``:
    each step a tick, then a poll; the journal's ``adapt`` notes."""
    model = _model(ns, source="test-fabric")
    eng = ns.engine(ns.S.ring(WORLD, 1, IPS))
    profile = ns.cong.CongestionProfile.seeded(WORLD, steps=16, seed=9, n_windows=1)
    ctl = _controller(ns, eng, "swap", model, os.path.join(tmp, "calibration.json"), nbytes=16 << 20,
                      fingerprint="fp", congestion_profile=profile)
    journal = os.path.join(tmp, "supervisor.journal")
    sup = ns.Supervisor(ns.CoordinatorLogic(WORLD), engine=eng, adapt=ctl, adapt_every=1, journal_path=journal,
                        clock=lambda: 0.0)
    steps = []
    for step in range(16):
        ctl.tick(step)
        taken = sup.poll()
        steps.append([ctl.reports[-1].outcome, [d["kind"] for d in taken], sup.engine_epoch])
    sup.stop()
    with open(journal) as f:
        notes = [json.loads(line) for line in f]
    notes = [{k: v for k, v in n.items() if k not in ("ts", "crc", "prev")} for n in notes if n.get("kind") == "adapt"]
    return [profile.to_dict(), steps, notes, os.path.exists(os.path.join(tmp, "calibration.json"))]


def test_supervisor_journals_adapt_transitions_like_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _supervised(_ns("port"), str(tmp_path / "port"))
    jax_ = _supervised(_ns("jax"), str(tmp_path / "jax"))
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_, sort_keys=True)
    outcomes = [s[0] for s in port[1]]
    assert "congestion-reroute" in outcomes and "congestion-cleared" in outcomes
    assert [n["outcome"] for n in port[2]] == ["congestion-reroute", "congestion-cleared"]
    assert port[3] is False  # congestion never writes a calibration


def test_variability_probe_drift_and_traces(tmp_path):
    from adapcc_tpu.topology import variability as jvar

    from adapcc_tpu_torch.topology.variability import VariabilityMonitor, detect_drift, load_trace

    rng = np.random.default_rng(9)
    for _ in range(40):
        hist = list(rng.uniform(5, 15, size=int(rng.integers(1, 20))))
        for kw in ({}, {"consecutive": 3}, {"direction": "down", "threshold": 0.2}, {"direction": "up", "window": 4}):
            assert detect_drift(hist, **kw) == jvar.detect_drift(hist, **kw)
    assert detect_drift([10.0] * 12 + [1.0]) and not detect_drift([10.0] * 12 + [1.0], direction="up")
    with pytest.raises(ValueError, match="direction"):
        VariabilityMonitor(4, device="cpu", drift_direction="sideways")
    fired = []
    mon = VariabilityMonitor(4, device="cpu", interval_s=0.01, out_dir=str(tmp_path), probe_floats=1 << 10,
                             on_drift=fired.append, drift_consecutive=1)
    for _ in range(3):
        gbps, lat = mon.sample()
        assert gbps > 0 and lat > 0
    mon.start()
    with pytest.raises(RuntimeError, match="already running"):
        mon.start()
    mon.stop()
    summary = mon.summary()
    assert summary["samples"] >= 4 and summary["bw_min_gbps"] <= summary["bw_median_gbps"] <= summary["bw_max_gbps"]
    for name, trace in (("bandwidth.txt", mon.bandwidth_trace), ("latency.txt", mon.latency_trace)):
        loaded = load_trace(str(tmp_path / name))
        assert loaded == jvar.load_trace(str(tmp_path / name))
        assert [v for _, v in loaded] == [float(f"{v:.9g}") for _, v in trace]
