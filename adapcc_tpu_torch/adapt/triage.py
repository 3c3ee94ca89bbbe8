"""Congestion against degradation, over a fired drift report (the port of
:mod:`adapcc_tpu.adapt.triage`).

A congested link must not be "fixed" by rewriting the α-β calibration: when
the neighbour's traffic leaves, the artifact would remember a fabric that no
longer exists.  So a fired report is classified first:

- **congestion**: the fitted β passed the drift factor while α stayed
  within a band of a class's calibrated α (the shape of
  :func:`~adapcc_tpu_torch.sim.cost_model.contended_coeffs`).  The answer is
  a transient re-route off the hot class, the calibration left byte for
  byte, and the incumbent restored when the window clears.
- **degradation**: anything else (both terms stretched, α-led drift), and
  all evidence at a single payload size, which cannot separate α from β: a
  degradation read as congestion would re-route for ever and never fix the
  model, the worse failure.

Separating α from β needs full windows at two or more payload sizes; the
controller's congestion funnel feeds two decades for that reason.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from adapcc_tpu_torch.adapt.detector import DriftReport
from adapcc_tpu_torch.adapt.recalibrate import _hop_points
from adapcc_tpu_torch.sim.cost_model import (
    LinkCostModel,
    bottleneck_ring_coeffs,
    bottleneck_ring_link,
    fit_alpha_beta,
)

#: congestion leaves the fitted α within this factor of the class's
CONGESTION_ALPHA_BAND = 1.5

#: the fitted β must grow at least this much (the default drift factor)
CONGESTION_BETA_SEPARATION = 2.0

TRIAGE_KINDS = ("congestion", "degradation")


@dataclass(frozen=True)
class TriageVerdict:
    """One fired drift report's classification."""

    kind: str                 #: "congestion" | "degradation"
    link_class: str           #: the link class the fitted evidence names
    alpha_ratio: float        #: fitted α ÷ calibrated α
    beta_ratio: float         #: fitted β ÷ calibrated β
    #: the evidence spanned >= 2 payload sizes (False forces "degradation")
    separable: bool

    @property
    def factor(self) -> float:
        """The contention factor a congestion verdict carries: β's growth."""
        return self.beta_ratio

    def to_row(self) -> dict:
        return {
            "kind": self.kind,
            "link_class": self.link_class,
            "alpha_ratio": round(self.alpha_ratio, 6),
            "beta_ratio": round(self.beta_ratio, 6),
            "separable": self.separable,
        }


def classify_drift(report: DriftReport, model: LinkCostModel, alpha_band: float = CONGESTION_ALPHA_BAND,
                   separation: float = CONGESTION_BETA_SEPARATION) -> Optional[TriageVerdict]:
    """Classify a fired drift report (module doc), or None where no fired
    signal carries link algebra (the controller's ``uninvertible``).  The
    per-hop inversion is the re-calibration's, so the two never disagree."""
    if alpha_band < 1.0:
        raise ValueError(f"alpha_band must be >= 1, got {alpha_band}")
    if separation <= 1.0:
        raise ValueError(f"separation must be > 1, got {separation}: at <= 1 healthy noise would classify as "
                         "congestion")
    fired_points, _samples = _hop_points(report.fired, model.world)
    if not fired_points:
        return None
    # the fit spans every full priced window, fired or not: a small payload
    # that stayed healthy is the α-intact half of the congestion signature
    points, _ = _hop_points([s for s in report.signals if s.reference == "calibration"], model.world)
    link = bottleneck_ring_link(model, model.world)
    cls = model.link_class_of(*link)
    current = bottleneck_ring_coeffs(model, model.world)
    distinct_sizes = {round(b, 3) for b, _ in points}
    if len(distinct_sizes) < 2:
        nbytes, seconds = fired_points[0]
        predicted = current.time(nbytes)
        ratio = seconds / predicted if predicted > 0 else 1.0
        return TriageVerdict(kind="degradation", link_class=cls, alpha_ratio=ratio, beta_ratio=ratio,
                             separable=False)
    fitted = fit_alpha_beta(points)
    # name the class whose healthy α the fit reproduces (two-sided, within
    # the band): congestion leaves the pacing hop's α intact, so a contended
    # intra-host class that overtook the inter-host bottleneck fits the
    # intra-host α.  An α between classes matches none and keeps the
    # bottleneck's class, where the α test below reads degradation
    if fitted.alpha > 0:
        candidates = [(c, co) for c, co in model.classes.items()
                      if co.alpha > 0 and max(fitted.alpha / co.alpha, co.alpha / fitted.alpha) <= alpha_band]
        if len(candidates) == 1:
            cls, current = candidates[0]
        elif len(candidates) > 1 and not any(c == cls for c, _ in candidates):
            cls, current = min(candidates, key=lambda item: abs(math.log(fitted.alpha / item[1].alpha)))
    alpha_ratio = fitted.alpha / current.alpha if current.alpha > 0 else 1.0
    beta_ratio = fitted.beta / current.beta if current.beta > 0 else 1.0
    # α intact both ways: one far below the anchor says the anchor is wrong
    alpha_intact = max(alpha_ratio, 1.0 / alpha_ratio) <= alpha_band if alpha_ratio > 0 else False
    congestion = alpha_intact and beta_ratio >= separation and beta_ratio > alpha_ratio
    return TriageVerdict(kind="congestion" if congestion else "degradation", link_class=cls,
                         alpha_ratio=alpha_ratio, beta_ratio=beta_ratio, separable=True)


def contended_view(model: LinkCostModel, verdict: TriageVerdict) -> LinkCostModel:
    """The transient cost model a congestion verdict implies: the named
    class contended by the fitted β growth, never merged nor saved."""
    if verdict.kind != "congestion":
        raise ValueError(f"contended_view needs a congestion verdict, got {verdict.kind!r}")
    return model.contended({verdict.link_class: max(1.0, verdict.factor)})
