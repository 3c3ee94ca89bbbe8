"""The closed loop: drift detection → triage → re-calibration → re-rank → hot
swap (the port of :mod:`adapcc_tpu.adapt.controller`).

``AdaptationController`` ties the passive halves together over one live
:class:`~adapcc_tpu_torch.comm.engine.CollectiveEngine` (and, optionally, a
:class:`~adapcc_tpu_torch.ddp.trainer.DDPTrainer`):

1. **Detect**: a :class:`DriftDetector` reads the measurements already
   flowing (no probe traffic).
2. **Triage**: congestion re-routes under a transient contended model and
   restores the incumbent when the window clears; degradation goes on.
3. **Re-calibrate**: fired windows invert into α-β corrections of a link
   class, decay-merged into the calibration artifact.
4. **Re-rank**: :meth:`Synthesizer.resynthesize` re-runs the ranking under
   the corrected costs, the incumbent first.
5. **Swap**: under the hysteresis gate (the challenger's predicted steady
   state beats the incumbent's by ``hysteresis_margin``, on at least a full
   window of evidence) the top candidates are prepared through the
   :class:`~adapcc_tpu_torch.elastic.StandbyPlanCache` and adopted by one
   ``advance_epoch``, so the first dispatch after it is a ``cache_hit``;
   ``DDPTrainer.adopt_strategy`` swaps the training step alike.

``ADAPCC_ADAPT=off|detect|swap`` gates the loop (env > the explicit mode >
off; a typo raises): ``detect`` reports the swap it would make, ``swap``
makes it.  In the port the warm prepares host plans and dispatches zeros on
the engine's device (there is nothing to compile), so ``aot_warm_s`` and
``stall_s`` time that preparation and the adoption.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from adapcc_tpu_torch.adapt.detector import DriftDetector, DriftReport
from adapcc_tpu_torch.adapt.recalibrate import calibration_of, drift_correction
from adapcc_tpu_torch.comm.mesh import DeviceLike

#: the adaptation loop's mode env: off (default) | detect | swap
ADAPT_MODE_ENV = "ADAPCC_ADAPT"

ADAPT_MODES = ("off", "detect", "swap")


def adapt_mode(explicit: Optional[str] = None) -> str:
    """``ADAPCC_ADAPT`` > ``explicit`` > "off"; a malformed value raises (a
    typo silently running unadapted would void the drill it drives)."""
    env = os.environ.get(ADAPT_MODE_ENV)
    value = env if env is not None and env.strip() else explicit
    if value is None:
        return "off"
    mode = str(value).strip().lower()
    if mode not in ADAPT_MODES:
        raise ValueError(f"{ADAPT_MODE_ENV}={value!r}: expected one of {'|'.join(ADAPT_MODES)}")
    return mode


@dataclass
class AdaptationReport:
    """What one :meth:`AdaptationController.maybe_adapt` pass did."""

    mode: str
    #: "off" | "no-drift" | "uninvertible" | "incumbent-wins" |
    #: "hysteresis" | "would-swap" (detect mode) | "swapped" |
    #: "congestion-would-reroute" (detect mode) | "congestion-reroute" |
    #: "congestion-hysteresis" | "congestion-active" |
    #: "congestion-sustained" | "congestion-cleared"
    outcome: str
    #: the triage verdict of a fired pass: "congestion" | "degradation" |
    #: None (no drift, or uninvertible evidence)
    triage: Optional[str] = None
    drift: Optional[DriftReport] = None
    recalibrated: bool = False
    calibration_source: Optional[str] = None
    ranked: List[dict] = field(default_factory=list)
    incumbent_fingerprint: Optional[str] = None
    incumbent_pred_s: Optional[float] = None
    winner_label: Optional[str] = None
    winner_fingerprint: Optional[str] = None
    winner_pred_s: Optional[float] = None
    swapped: bool = False
    epoch: Optional[int] = None
    #: "dcn" when only the leader level of a composed two-level incumbent
    #: was re-solved (the pod level kept)
    resolved_level: Optional[str] = None
    #: the warm's walltime (before the swap, off its critical path)
    aot_warm_s: Optional[float] = None
    #: the swap's stall: advance_epoch and the trainer's adoption
    stall_s: Optional[float] = None
    trainer_adopt_hit: Optional[bool] = None

    @property
    def fired(self) -> bool:
        return self.drift is not None and self.drift.drifted

    def to_row(self) -> dict:
        return {
            "mode": self.mode,
            "outcome": self.outcome,
            "triage": self.triage,
            "fired": self.fired,
            "recalibrated": self.recalibrated,
            "calibration": self.calibration_source,
            "incumbent": self.incumbent_fingerprint,
            "incumbent_pred_us": (round(self.incumbent_pred_s * 1e6, 3)
                                  if self.incumbent_pred_s is not None else None),
            "winner": self.winner_fingerprint,
            "winner_label": self.winner_label,
            "winner_pred_us": round(self.winner_pred_s * 1e6, 3) if self.winner_pred_s is not None else None,
            "swapped": self.swapped,
            "epoch": self.epoch,
            "resolved_level": self.resolved_level,
            "aot_warm_s": self.aot_warm_s,
            "stall_s": self.stall_s,
            "trainer_adopt_hit": self.trainer_adopt_hit,
        }


class AdaptationController:
    """One engine's closed adaptation loop (module doc).

    Host work until a swap: detection, triage, re-calibration and the
    re-rank dispatch nothing; the ``swap`` mode's warm dispatches zeros of
    ``warm_shape``/``warm_dtype`` on ``device`` (the card unless the caller
    passes one) under each candidate, off the swap's critical path."""

    def __init__(
        self,
        engine,
        synthesizer,
        detector: Optional[DriftDetector] = None,
        trainer: Optional[Any] = None,
        trainer_prewarm: Optional[Callable[[Any], Any]] = None,
        mode: Optional[str] = None,
        calibration_path: Optional[str] = None,
        cost_model=None,
        db=None,
        fingerprint: Optional[str] = None,
        nbytes: int = 16 << 20,
        parallel_degree: int = 1,
        top_k: int = 2,
        hysteresis_margin: float = 0.1,
        min_samples: Optional[int] = None,
        warm_shape: Tuple[int, ...] = (1024,),
        warm_dtype: torch.dtype = torch.float32,
        decay: float = 0.5,
        congestion_profile=None,
        sim_engine: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        adapt_mode(mode)  # validate the env and the explicit mode now
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if hysteresis_margin < 0:
            raise ValueError(f"hysteresis_margin must be >= 0, got {hysteresis_margin}")
        self.engine = engine
        self.synthesizer = synthesizer
        self.trainer = trainer
        self.trainer_prewarm = trainer_prewarm
        self.explicit_mode = mode
        self.calibration_path = calibration_path
        self.db = db
        self.nbytes = int(nbytes)
        self.parallel_degree = max(1, int(parallel_degree))
        self.top_k = int(top_k)
        self.hysteresis_margin = float(hysteresis_margin)
        self.warm_shape = tuple(warm_shape)
        self.warm_dtype = warm_dtype
        self.decay = float(decay)
        #: the replay engine of the re-rank (None: the arg/env/auto funnel)
        self.sim_engine = sim_engine
        world = engine.world_size
        ips = dict(engine.strategy.trees[0].ips or {})
        if fingerprint is None:
            from adapcc_tpu_torch.tuner.db import topology_fingerprint

            fingerprint = topology_fingerprint(world, ips or None)
        self.fingerprint = fingerprint
        if cost_model is None:
            from adapcc_tpu_torch.sim.calibrate import DEFAULT_CALIBRATION_PATH, load_or_default

            cost_model = load_or_default(calibration_path or DEFAULT_CALIBRATION_PATH, world=world,
                                         fingerprint=fingerprint)
        if cost_model.ips is None and ips:
            cost_model = cost_model.with_ips(ips)
        self._model = cost_model
        self.detector = detector if detector is not None else DriftDetector(world, fingerprint, cost_model=cost_model)
        self.min_samples = int(min_samples) if min_samples is not None else self.detector.window
        from adapcc_tpu_torch.elastic.standby import StandbyPlanCache

        self.cache = StandbyPlanCache(engine, nbytes=float(self.nbytes), cost_model=cost_model, device=device)
        self.swaps = 0
        self.reports: List[AdaptationReport] = []
        #: set exactly while a transient re-route is live: (the incumbent to
        #: restore, the verdict)
        self._congestion: Optional[Tuple[Any, Any]] = None
        #: the congestion-injection funnel's profile
        self._profile = None
        #: the tick funnel's pricing policy per (factors, model)
        self._tick_policies: Dict[Any, Any] = {}
        if congestion_profile is not None:
            self.attach_congestion_profile(congestion_profile)
        # two payload decades for the probe cells: the triage needs two
        # sizes to separate bandwidth contention from degradation.  A bucket
        # already at the 4 KiB floor would collapse both probes into one
        # cell, so the top probe stretches to 4096× the floor instead
        from adapcc_tpu_torch.tuner.db import size_bucket

        top = size_bucket(self.nbytes)
        lo = max(4096, top >> 8)
        self._probe_sizes: Tuple[int, ...] = (lo, top if top > lo else lo << 12)

    # -- mode ------------------------------------------------------------------

    @property
    def mode(self) -> str:
        return adapt_mode(self.explicit_mode)

    # -- feeds -----------------------------------------------------------------

    def observe(self, key, seconds: float, ts: Optional[float] = None, nbytes: Optional[int] = None) -> None:
        self.detector.observe(key, seconds, ts=ts, nbytes=nbytes)

    def observe_step(self, seconds: float, nbytes: int) -> None:
        self.detector.observe_step(seconds, nbytes)

    def ingest_trace(self, trace) -> Tuple[int, int]:
        return self.detector.ingest_trace(trace)

    def refresh(self) -> None:
        """Re-sync the detector from the attached tuning database."""
        if self.db is not None:
            self.detector.ingest_db(self.db)

    def check(self) -> DriftReport:
        self.refresh()
        return self.detector.check()

    # -- the congestion-injection funnel ----------------------------------------

    @property
    def rerouted(self) -> bool:
        """True exactly while a transient congestion re-route is live."""
        return self._congestion is not None

    def attach_congestion_profile(self, profile) -> None:
        """Arm the congestion funnel (``ADAPCC_CONGESTION_PROFILE``):
        :meth:`tick` feeds the detector contended priced samples a step."""
        if profile.world != self.engine.world_size:
            raise ValueError(f"congestion profile world {profile.world} != engine world {self.engine.world_size}")
        self._profile = profile

    def _tick_policy(self, factors):
        """The pricing policy of one step's factors, cached per factors and
        live model (tick() runs once a training step)."""
        from adapcc_tpu_torch.tuner.db import TuningDatabase
        from adapcc_tpu_torch.tuner.policy import TuningPolicy

        fkey = tuple(sorted(factors.items()))
        cached = self._tick_policies.get(fkey)
        if cached is not None and cached[0] is self._model:
            return cached[1]
        model = self._model.contended(factors) if factors else self._model
        policy = TuningPolicy(TuningDatabase(persist=False), self.engine.world_size, self.detector.topology,
                              cost_model=model)
        self._tick_policies[fkey] = (self._model, policy)
        return policy

    def _priced(self, policy, key, nbytes: int) -> Optional[float]:
        try:
            pred = policy.prior_time(key, int(nbytes))
        except (KeyError, ValueError):
            return None
        return pred if pred > 0 else None

    def tick(self, step: int) -> None:
        """Feed one step of the attached profile: each probe cell observes
        its price under that step's contended model (β scaled, α intact),
        so a window fires with the congestion signature and a healthy step
        feeds the evidence of its end.  No-op without a profile."""
        if self._profile is None:
            return
        factors = self._profile.factors_at(int(step))
        policy = self._tick_policy(factors)
        for nbytes in self._probe_sizes:
            key = self.detector.probe_key(nbytes)
            pred = self._priced(policy, key, nbytes)
            if pred is not None:
                self.detector.observe(key, pred, nbytes=nbytes)

    # -- the loop --------------------------------------------------------------

    def _base_calibration(self):
        """The merge base: the artifact when it exists and was fitted on
        this fabric and world, else the live model as a calibration."""
        from adapcc_tpu_torch.sim.calibrate import Calibration

        if self.calibration_path and os.path.exists(self.calibration_path):
            try:
                base = Calibration.load(self.calibration_path)
            except (OSError, ValueError, KeyError, TypeError):
                base = None  # an unusable artifact: fall through
            if base is not None and (base.world == self.engine.world_size
                                     and (base.fingerprint is None or base.fingerprint == self.fingerprint)):
                return base
        return calibration_of(self._model, fingerprint=self.fingerprint, samples=0)

    def _done(self, report: AdaptationReport) -> AdaptationReport:
        self.reports.append(report)
        return report

    def _adopt(self, report: AdaptationReport, strategy) -> None:
        """One ``advance_epoch`` and the trainer's adoption, timed."""
        t1 = time.perf_counter()
        report.epoch = self.cache.adopt(strategy)
        if self.trainer is not None:
            report.trainer_adopt_hit = self.trainer.adopt_strategy(strategy)
        report.stall_s = time.perf_counter() - t1
        report.swapped = True
        self.swaps += 1

    def _adapt_leader_level(self, report: AdaptationReport, plan, incumbent, drift, mode: str) -> AdaptationReport:
        """Re-solve only the inter-host leader level under the corrected
        model, gate it and swap through the standby cache; the pod level is
        carried over by identity."""
        from adapcc_tpu_torch.sim.cost_model import DCN, ICI, two_level_allreduce_time
        from adapcc_tpu_torch.strategy.hierarchy import resolve_leader_level

        model = self._model
        new = resolve_leader_level(plan, model, nbytes=self.nbytes)
        ici, dcn = model.classes[ICI], model.classes[DCN]
        inc_s = two_level_allreduce_time(plan.sketch.num_pods, plan.sketch.pod_size, self.nbytes, ici, dcn,
                                         pod_algo=plan.pod_algo, leader_algo=plan.leader_algo)
        report.resolved_level = "dcn"
        report.incumbent_pred_s = inc_s
        report.winner_label = f"two-level[{new.leader_algo}]"
        report.winner_pred_s = new.predicted_s
        report.ranked = [
            {"label": report.winner_label, "pred_us": round(new.predicted_s * 1e6, 3)},
            {"label": "incumbent", "pred_us": round(inc_s * 1e6, 3)},
        ]
        if new.strategy.fingerprint() == incumbent.fingerprint():
            report.outcome = "incumbent-wins"
            report.winner_fingerprint = incumbent.fingerprint()
            return self._done(report)
        report.winner_fingerprint = new.strategy.fingerprint()
        evidence = max((s.count for s in drift.fired), default=0)
        if new.predicted_s >= inc_s * (1.0 - self.hysteresis_margin) or evidence < self.min_samples:
            report.outcome = "hysteresis"
            return self._done(report)
        if mode == "detect":
            report.outcome = "would-swap"
            return self._done(report)
        self._swap_stages(report, new.strategy, report.winner_label, new.predicted_s)
        report.outcome = "swapped"
        return self._done(report)

    def _swap_stages(self, report: AdaptationReport, winner_strategy, label: str, predicted_s: float,
                     warm_extra=()) -> None:
        """The swap's tail: warm the winner (and ``warm_extra``), the
        trainer's prewarm, one ``advance_epoch``, the trainer's adoption;
        then the detector starts over after a wall-clock watermark."""
        t0 = time.perf_counter()
        self.cache.warm_strategy(winner_strategy, self.warm_shape, self.warm_dtype, label=label,
                                 predicted_s=predicted_s)
        for cand in warm_extra:
            self.cache.warm_strategy(cand.strategy, self.warm_shape, self.warm_dtype, label=cand.label,
                                     predicted_s=cand.seconds)
        if self.trainer_prewarm is not None:
            self.trainer_prewarm(winner_strategy)
        report.aot_warm_s = time.perf_counter() - t0
        self._adopt(report, winner_strategy)
        self.detector.reset(watermark=time.time())

    def _congestion_pass(self, mode: str) -> AdaptationReport:
        """One pass while a re-route is live: the feeds are read against the
        unchanged calibration, and the incumbent is restored once a full
        window reads healthy (the full window is the restore's hysteresis)."""
        incumbent, verdict = self._congestion
        drift = self.check()
        report = AdaptationReport(mode=mode, outcome="congestion-active", triage="congestion", drift=drift,
                                  incumbent_fingerprint=self.engine.strategy.fingerprint(),
                                  winner_fingerprint=incumbent.fingerprint())
        if not drift.signals:
            return self._done(report)  # no full window yet
        if drift.drifted:
            report.outcome = "congestion-sustained"
            return self._done(report)
        # cleared: the incumbent's prepared plans never left the engine's
        # cache, so the restore's first dispatch is warm
        self._adopt(report, incumbent)
        report.outcome = "congestion-cleared"
        report.winner_label = "incumbent-restored"
        self._congestion = None
        self.detector.reset(watermark=time.time())
        return self._done(report)

    def _reroute_congestion(self, report: AdaptationReport, verdict, drift, mode: str,
                            incumbent) -> AdaptationReport:
        """Re-route off the contended class under a transient contended
        model: the calibration artifact stays byte for byte, the detector
        keeps its healthy reference, and the incumbent is kept for the
        restore.  A composed two-level incumbent under inter-host congestion
        re-solves its leader level; a flat one escapes to the two-level
        hierarchy where the ip table has one; anything else re-ranks the
        synthesizer's pool under the contended costs."""
        from adapcc_tpu_torch.adapt.triage import contended_view
        from adapcc_tpu_torch.sim.cost_model import DCN, ICI, two_level_allreduce_time
        from adapcc_tpu_torch.strategy.hierarchy import plan_of, resolve_leader_level

        contended = contended_view(self._model, verdict)
        evidence = max((s.count for s in drift.fired), default=0)
        plan = plan_of(incumbent)
        sketch = None
        if plan is None and verdict.link_class == DCN:
            from adapcc_tpu_torch.strategy.hierarchy import resolve_sketch

            try:
                sketch = resolve_sketch(self.engine.world_size, self.synthesizer.ip_table)
            except ValueError:
                sketch = None  # a ragged or flat layout: no hierarchy to escape to
        if plan is not None and verdict.link_class == DCN:
            new = resolve_leader_level(plan, contended, nbytes=self.nbytes)
            ici, dcn = contended.classes[ICI], contended.classes[DCN]
            inc_s = two_level_allreduce_time(plan.sketch.num_pods, plan.sketch.pod_size, self.nbytes, ici, dcn,
                                             pod_algo=plan.pod_algo, leader_algo=plan.leader_algo)
            report.resolved_level = "dcn"
            winner_strategy = new.strategy
            winner_label = f"two-level[{new.leader_algo}]+congestion"
            winner_s = new.predicted_s
            report.ranked = [
                {"label": winner_label, "pred_us": round(winner_s * 1e6, 3)},
                {"label": "incumbent", "pred_us": round(inc_s * 1e6, 3)},
            ]
            warm_extra = ()
        elif sketch is not None:
            # a flat incumbent: the two-level plan ships 1/pod_size of the
            # payload over the contended class, which no flat shape matches;
            # both arms priced by the solver under the contended costs
            from adapcc_tpu_torch.strategy.hierarchy import synthesize_two_level

            tl = synthesize_two_level(sketch, contended, nbytes=self.nbytes, num_trans=self.parallel_degree)
            inc_s = tl.flat_pred_s
            winner_strategy = tl.strategy
            winner_label = f"two-level[{tl.pod_algo}/{tl.leader_algo}]+congestion"
            winner_s = tl.predicted_s
            report.ranked = [
                {"label": winner_label, "pred_us": round(winner_s * 1e6, 3)},
                {"label": "incumbent", "pred_us": round(inc_s * 1e6, 3)},
            ]
            warm_extra = ()
        else:
            ranked = self.synthesizer.resynthesize(contended, self.nbytes, parallel_degree=self.parallel_degree,
                                                   incumbent=incumbent, provenance="congestion-reroute",
                                                   engine=self.sim_engine)
            report.ranked = [{"label": r.label, "pred_us": round(r.seconds * 1e6, 3)} for r in ranked]
            winner = ranked[0]
            inc_s = next((r.seconds for r in ranked if r.label == "incumbent"), None)
            winner_strategy = winner.strategy
            winner_label = winner.label
            winner_s = winner.seconds
            warm_extra = [r for r in ranked[1:self.top_k]
                          if r.strategy is not None and r.strategy is not incumbent
                          and r.strategy is not winner_strategy]
        report.incumbent_pred_s = inc_s
        report.winner_label = winner_label
        report.winner_pred_s = winner_s
        if winner_strategy is None or winner_strategy.fingerprint() == incumbent.fingerprint():
            report.outcome = "incumbent-wins"
            report.winner_fingerprint = incumbent.fingerprint()
            return self._done(report)
        report.winner_fingerprint = winner_strategy.fingerprint()
        if inc_s is None or winner_s >= inc_s * (1.0 - self.hysteresis_margin) or evidence < self.min_samples:
            report.outcome = "congestion-hysteresis"
            return self._done(report)
        if mode == "detect":
            report.outcome = "congestion-would-reroute"
            return self._done(report)
        self._swap_stages(report, winner_strategy, winner_label, winner_s, warm_extra)
        report.outcome = "congestion-reroute"
        self._congestion = (incumbent, verdict)
        return self._done(report)

    def maybe_adapt(self) -> AdaptationReport:
        """One pass of the loop (module doc): a function of the fed samples,
        reported stage by stage."""
        mode = self.mode
        if mode == "off":
            return self._done(AdaptationReport(mode=mode, outcome="off"))
        if self._congestion is not None:
            return self._congestion_pass(mode)
        drift = self.check()
        incumbent = self.engine.strategy
        report = AdaptationReport(mode=mode, outcome="no-drift", drift=drift,
                                  incumbent_fingerprint=incumbent.fingerprint())
        if not drift.drifted:
            return self._done(report)
        # -- triage: congestion re-routes, degradation re-calibrates ----------
        from adapcc_tpu_torch.adapt.triage import classify_drift

        verdict = classify_drift(drift, self._model)
        if verdict is not None:
            report.triage = verdict.kind
            if verdict.kind == "congestion":
                return self._reroute_congestion(report, verdict, drift, mode, incumbent)
        # -- re-calibrate ------------------------------------------------------
        from adapcc_tpu_torch.sim.calibrate import merge_calibration

        correction = drift_correction(drift, self._model, fingerprint=self.fingerprint)
        if correction is None:
            # drift without link algebra (a ddp_step compute slowdown): a
            # re-rank under the unchanged model would let a compute
            # regression swap the communication strategy; report it
            report.outcome = "uninvertible"
            return self._done(report)
        merged = merge_calibration(self._base_calibration(), correction, decay=self.decay)
        if self.calibration_path:
            merged.save(self.calibration_path)
        model = merged.cost_model()
        ips = dict(incumbent.trees[0].ips or {})
        if model.ips is None and ips:
            model = model.with_ips(ips)
        self._model = model
        # the corrected model becomes the reference: windows consistent
        # with it stop firing
        self.detector.set_cost_model(model)
        self.cache.cost_model = model
        report.recalibrated = True
        report.calibration_source = merged.source
        # -- drift localization: an inter-host-only correction of a composed
        # two-level incumbent re-solves the leader level alone ----------------
        from adapcc_tpu_torch.sim.cost_model import DCN
        from adapcc_tpu_torch.strategy.hierarchy import plan_of

        plan = plan_of(incumbent)
        if plan is not None and set(correction.classes) == {DCN}:
            return self._adapt_leader_level(report, plan, incumbent, drift, mode)
        # -- re-rank -----------------------------------------------------------
        ranked = self.synthesizer.resynthesize(self._model, self.nbytes, parallel_degree=self.parallel_degree,
                                               incumbent=incumbent, engine=self.sim_engine)
        report.ranked = [{"label": r.label, "pred_us": round(r.seconds * 1e6, 3)} for r in ranked]
        winner = ranked[0]
        inc_s = next((r.seconds for r in ranked if r.label == "incumbent"), None)
        report.incumbent_pred_s = inc_s
        report.winner_label = winner.label
        report.winner_pred_s = winner.seconds
        if winner.strategy is None or winner.strategy.fingerprint() == incumbent.fingerprint():
            report.outcome = "incumbent-wins"
            report.winner_fingerprint = incumbent.fingerprint()
            return self._done(report)
        report.winner_fingerprint = winner.strategy.fingerprint()
        # -- the hysteresis gate: beat the incumbent by the margin, on a full
        # window of evidence ---------------------------------------------------
        evidence = max((s.count for s in drift.fired), default=0)
        if inc_s is None or winner.seconds >= inc_s * (1.0 - self.hysteresis_margin) or evidence < self.min_samples:
            report.outcome = "hysteresis"
            return self._done(report)
        if mode == "detect":
            report.outcome = "would-swap"
            return self._done(report)
        # -- swap: the watermark keeps the retired plan's samples, still in
        # the attached database, out of the next windows -----------------------
        challengers = [r for r in ranked if r.strategy is not None and r.strategy is not incumbent
                       and r.strategy is not winner.strategy]
        self._swap_stages(report, winner.strategy, winner.label, winner.seconds,
                          warm_extra=challengers[:max(0, self.top_k - 1)])
        report.outcome = "swapped"
        return self._done(report)
