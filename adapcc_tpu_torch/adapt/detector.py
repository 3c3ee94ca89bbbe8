"""Passive drift detection from measurements that already flow (the port of
:mod:`adapcc_tpu.adapt.detector`).

The paper re-profiles every ``profile_freq`` steps with active probes; this
module takes the same signal from the dispatch walltimes the plan tuner
already records: the engine's :class:`~adapcc_tpu_torch.tuner.measure.
DispatchTimer` samples, dispatch-trace events carrying ``duration_s``, and
the ``tuning.jsonl`` history (:class:`TuningDatabase`).

One bounded rolling window per plan cell (the tuner's key) is compared, once
full, by its **median** against the calibration's price of that cell
(:meth:`TuningPolicy.prior_time`, the tuner prior's own pricing).  A sample
is normalized by the price at its true payload where the feed knows it, else
at the bucket (the database keeps only the bucket, which reads a payload
just above a power of two as healthier than it is, never as drift).  A
window whose median ratio reaches ``ADAPCC_DRIFT_FACTOR`` fires.

Cells no link model prices (``ddp_step`` walltimes carry the step's
compute) compare against a frozen baseline instead: the first full window's
median.  No probe traffic, no randomness and no clock in the decision: the
trajectory is a function of the fed samples.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from adapcc_tpu_torch.tuner.db import TuningDatabase, TuningKey

#: measured-median ÷ prediction ratio at which a full window fires
DRIFT_FACTOR_ENV = "ADAPCC_DRIFT_FACTOR"
DEFAULT_DRIFT_FACTOR = 2.0

#: samples a rolling window holds (a cell fires on a full one)
DRIFT_WINDOW_ENV = "ADAPCC_DRIFT_WINDOW"
DEFAULT_DRIFT_WINDOW = 8

#: primitives the calibration prices; the others (ddp_step, ...) detect
#: against a frozen baseline
PRICED_PRIMITIVES = ("allreduce", "reduce_scatter", "all_gather", "all_to_all")


def resolve_drift_factor(explicit: Optional[float] = None) -> float:
    """``ADAPCC_DRIFT_FACTOR`` > ``explicit`` > the default; must be > 1,
    and a malformed value raises."""
    env = os.environ.get(DRIFT_FACTOR_ENV)
    value = env if env is not None and env.strip() else explicit
    if value is None:
        return DEFAULT_DRIFT_FACTOR
    try:
        factor = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"{DRIFT_FACTOR_ENV}/factor={value!r}: expected a number > 1") from None
    if factor <= 1.0:
        raise ValueError(f"{DRIFT_FACTOR_ENV}/factor={factor} must be > 1: at <= 1 every healthy window would read "
                         "as drift")
    return factor


def resolve_drift_window(explicit: Optional[int] = None) -> int:
    """``ADAPCC_DRIFT_WINDOW`` > ``explicit`` > the default; must be >= 2,
    and a malformed value raises."""
    env = os.environ.get(DRIFT_WINDOW_ENV)
    value = env if env is not None and env.strip() else explicit
    if value is None:
        return DEFAULT_DRIFT_WINDOW
    try:
        window = int(str(value).strip())
    except (TypeError, ValueError):
        raise ValueError(f"{DRIFT_WINDOW_ENV}/window={value!r}: expected an integer >= 2") from None
    if window < 2:
        raise ValueError(f"{DRIFT_WINDOW_ENV}/window={window} must be >= 2: a one-sample median is the single "
                         "noisy dispatch the window exists to absorb")
    return window


def _median(xs: List[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    mid = n // 2
    if n % 2:
        return ys[mid]
    return 0.5 * (ys[mid - 1] + ys[mid])


@dataclass(frozen=True)
class DriftSignal:
    """One cell's verdict at check time."""

    key: TuningKey
    median_s: float
    reference_s: float
    #: "calibration" (the priced prediction) | "baseline" (the frozen first window)
    reference: str
    ratio: float
    count: int
    fired: bool

    def to_row(self) -> dict:
        return {
            **self.key.to_dict(),
            "median_us": round(self.median_s * 1e6, 3),
            "reference_us": round(self.reference_s * 1e6, 3),
            "reference": self.reference,
            "ratio": round(self.ratio, 6),
            "count": self.count,
            "fired": self.fired,
        }


@dataclass
class DriftReport:
    """Every full-window cell one :meth:`DriftDetector.check` saw."""

    factor: float
    window: int
    signals: List[DriftSignal] = field(default_factory=list)

    @property
    def fired(self) -> List[DriftSignal]:
        return [s for s in self.signals if s.fired]

    @property
    def drifted(self) -> bool:
        return any(s.fired for s in self.signals)

    def to_rows(self) -> List[dict]:
        return [s.to_row() for s in self.signals]


class DriftDetector:
    """Rolling-window drift detector over tuner plan cells (module doc).

    ``cost_model`` anchors the predictions (default: the calibration
    artifact through ``load_or_default``); after a re-calibration the
    controller hands the corrected model to :meth:`set_cost_model`, so a
    model that caught up with the fabric stops firing."""

    def __init__(
        self,
        world: int,
        topology: str = "adapt",
        cost_model=None,
        factor: Optional[float] = None,
        window: Optional[int] = None,
    ) -> None:
        self.world = int(world)
        self.topology = topology
        self.factor = resolve_drift_factor(factor)
        self.window = resolve_drift_window(window)
        self._cost_model = cost_model
        self._policy = None  # the pricing view, built at first use
        #: priced cells hold sample ÷ price ratios, the others seconds
        self._windows: Dict[TuningKey, Deque[float]] = {}
        self._baseline: Dict[TuningKey, float] = {}
        #: a cell's bucket price (None: unpriced), dropped on set_cost_model
        self._ref: Dict[TuningKey, Optional[float]] = {}
        #: timestamp floor of the timestamped feeds, set by reset() after a
        #: swap: the retired plan's samples never re-enter
        self._watermark = float("-inf")
        self.ingested = 0
        self.skipped = 0

    # -- pricing ---------------------------------------------------------------

    def _pricing(self):
        """A throwaway in-memory :class:`TuningPolicy`, so a cell is priced
        by the tuner prior's own term."""
        if self._policy is None:
            from adapcc_tpu_torch.tuner.policy import TuningPolicy

            self._policy = TuningPolicy(TuningDatabase(persist=False), self.world, self.topology,
                                        cost_model=self._cost_model)
        return self._policy

    def set_cost_model(self, cost_model) -> None:
        """Re-anchor on a corrected model.  Priced windows are dropped
        (their ratios were taken under the retired price); baseline windows
        keep their model-free reference."""
        priced = [k for k in self._windows if self.predicted_s(k) is not None]
        for k in priced:
            del self._windows[k]
        self._cost_model = cost_model
        self._policy = None
        self._ref.clear()

    def _price_at(self, key: TuningKey, nbytes: int) -> Optional[float]:
        if key.primitive not in PRICED_PRIMITIVES:
            return None
        try:
            pred = self._pricing().prior_time(key, int(nbytes))
        except (KeyError, ValueError):
            return None
        return pred if pred > 0 else None

    def predicted_s(self, key: TuningKey) -> Optional[float]:
        """The calibration's seconds for one cell at its bucket, or None
        where nothing prices it (cached a key)."""
        if key in self._ref:
            return self._ref[key]
        pred = self._price_at(key, key.size_bucket)
        self._ref[key] = pred
        return pred

    # -- feeds -----------------------------------------------------------------

    def _freeze_baseline(self, key: TuningKey) -> None:
        win = self._windows.get(key)
        if (win is not None and len(win) >= self.window and key not in self._baseline
                and self.predicted_s(key) is None):
            self._baseline[key] = _median(list(win))

    def observe(self, key: TuningKey, seconds: float, ts: Optional[float] = None,
                nbytes: Optional[int] = None) -> None:
        """Feed one measured dispatch.  ``nbytes`` (the true per-rank
        payload, where known) prices the sample at its size; a ``ts`` before
        the watermark is skipped, an untimestamped sample always enters."""
        s = float(seconds)
        if s < 0:
            raise ValueError(f"negative duration {s}")
        if ts is not None and float(ts) < self._watermark:
            self.skipped += 1
            return
        ref = self.predicted_s(key)
        if ref is not None:
            per = ref
            if nbytes is not None and int(nbytes) != key.size_bucket:
                per = self._price_at(key, int(nbytes)) or ref
            value = s / per
        else:
            value = s
        win = self._windows.get(key)
        if win is None:
            win = self._windows[key] = deque(maxlen=self.window)
        win.append(value)
        self.ingested += 1
        self._freeze_baseline(key)

    def probe_key(self, nbytes: int, path: str = "xla") -> TuningKey:
        """The priced cell of one payload: the plain allreduce on ``path``,
        one spelling for the congestion funnel, the triage drills and the
        fabric sweep."""
        from adapcc_tpu_torch.tuner.db import size_bucket

        return TuningKey(primitive="allreduce", size_bucket=size_bucket(max(1, int(nbytes))), world=self.world,
                         topology=self.topology, path=path, chunk_bytes=0, wire_dtype="off")

    def observe_step(self, seconds: float, nbytes: int, label: str = "ddp_step") -> TuningKey:
        """Feed one training step's walltime, as an unpriced cell (it
        detects against its frozen baseline)."""
        from adapcc_tpu_torch.tuner.db import size_bucket

        key = TuningKey(primitive=label, size_bucket=size_bucket(max(1, int(nbytes))), world=self.world,
                        topology=self.topology, path="step", chunk_bytes=0, wire_dtype="off")
        self.observe(key, seconds)
        return key

    def ingest_db(self, db: TuningDatabase) -> Tuple[int, int]:
        """Re-sync windows from a tuning database: each key of this world
        takes its newest ``window`` samples at or after the watermark (so
        ingesting one database twice changes nothing); other worlds' keys
        are counted.  Returns ``(ingested_keys, skipped_keys)``."""
        ingested = skipped = 0
        for key in db.keys():
            if key.world != self.world:
                skipped += 1
                self.skipped += len(db.timed_samples(key))
                continue
            timed = db.timed_samples(key)
            samples = [s for ts, s in timed if ts >= self._watermark]
            self.skipped += len(timed) - len(samples)
            samples = samples[-self.window:]
            if not samples:
                skipped += 1
                continue
            ref = self.predicted_s(key)
            win = self._windows[key] = deque(maxlen=self.window)
            for s in samples:
                # the database keeps the bucket only: bucket-priced
                win.append(float(s) / ref if ref is not None else float(s))
            self.ingested += len(samples)
            self._freeze_baseline(key)
            ingested += 1
        return ingested, skipped

    def ingest_trace(self, trace) -> Tuple[int, int]:
        """Feed a recorded :class:`CollectiveTrace` (or events): those with
        ``duration_s`` land in their cells through the tuner replay's own
        keying.  Returns ``(ingested_events, skipped_events)``."""
        from adapcc_tpu_torch.tuner.measure import replay_trace

        tmp = TuningDatabase(persist=False)
        ingested, skipped = replay_trace(trace, tmp, self.world, self.topology)
        # ingest_db counts what it drops itself; add only the unkeyed events
        self.skipped += skipped
        self.ingest_db(tmp)
        return ingested, skipped

    # -- decision --------------------------------------------------------------

    def check(self) -> DriftReport:
        """Evaluate every full window."""
        report = DriftReport(factor=self.factor, window=self.window)
        for key in sorted(self._windows):
            win = self._windows[key]
            if len(win) < self.window:
                continue
            med = _median(list(win))
            pred = self.predicted_s(key)
            if pred is not None:
                # priced windows hold ratios; seconds are reported at the
                # bucket's price, the α-β inversion's reference
                reference, ref_s = "calibration", pred
                ratio, median_s = med, med * pred
            else:
                base = self._baseline.get(key)
                if base is None or base <= 0:
                    continue
                reference, ref_s = "baseline", base
                ratio, median_s = med / base, med
            report.signals.append(DriftSignal(key=key, median_s=median_s, reference_s=ref_s, reference=reference,
                                              ratio=ratio, count=len(win), fired=ratio >= self.factor))
        return report

    def reset(self, watermark: Optional[float] = None) -> None:
        """Drop every window and baseline (after a swap); ``watermark``
        also floors the timestamped feeds."""
        self._windows.clear()
        self._baseline.clear()
        if watermark is not None:
            self._watermark = float(watermark)

    def __repr__(self) -> str:
        return (f"DriftDetector(world={self.world}, factor={self.factor}, window={self.window}, "
                f"cells={len(self._windows)})")
