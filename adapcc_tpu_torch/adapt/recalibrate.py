"""α-β re-calibration from passively observed collective timings (the port of
:mod:`adapcc_tpu.adapt.recalibrate`).

The detector says that measured medians left the priced prediction; this
module turns the same medians into corrected link coefficients:

1. **Invert**: each fired ring-shaped cell gives per-hop ``(bytes,
   seconds)`` points through the battery calibration's algebra
   (``calibrate._RING_STRUCTURE``: an allreduce is ``2(w−1)`` hops of
   ``n/w`` bytes).  Two or more payload sizes go through
   :func:`~adapcc_tpu_torch.sim.cost_model.fit_alpha_beta`; one size cannot
   separate α from β and stretches both by the observed ratio.
2. **Localize**: a lockstep collective is paced by its slowest ring hop, so
   the correction lands on that hop's link class.
3. **Merge**: the correction, stamped with the fabric's fingerprint, the
   sample count and its source, is folded into the artifact with decay by
   :func:`~adapcc_tpu_torch.sim.calibrate.merge_calibration`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from adapcc_tpu_torch.adapt.detector import DriftReport, DriftSignal
from adapcc_tpu_torch.sim.calibrate import _RING_STRUCTURE, Calibration
from adapcc_tpu_torch.sim.cost_model import (
    LinkCoeffs,
    LinkCostModel,
    bottleneck_ring_coeffs,
    bottleneck_ring_link,
    fit_alpha_beta,
)


def _hop_points(signals: List[DriftSignal], world: int) -> Tuple[List[Tuple[float, float]], int]:
    """Ring-shaped, calibration-referenced signals → per-hop (bytes,
    seconds) points and the samples behind them."""
    points: List[Tuple[float, float]] = []
    total = 0
    for sig in signals:
        structure = _RING_STRUCTURE.get(sig.key.primitive)
        if structure is None or sig.reference != "calibration":
            continue
        rounds_fn, byte_fn = structure
        rounds = float(rounds_fn(world))
        if rounds <= 0:
            continue
        per_hop_bytes = byte_fn(world) * float(sig.key.size_bucket) / rounds
        points.append((per_hop_bytes, sig.median_s / rounds))
        total += sig.count
    return points, total


def drift_correction(report: DriftReport, model: LinkCostModel, fingerprint: Optional[str] = None,
                     source: str = "drift-recal") -> Optional[Calibration]:
    """A drift report → a correction :class:`Calibration` of the bottleneck
    link class, or None when no fired signal can be inverted (baseline
    cells carry no link algebra).

    It holds only the corrected class, so a merge leaves the others; the
    per-link fits of that class ride along, each stretched by the same
    ratios (``LinkCostModel.coeffs`` prefers a link's own fit, which would
    otherwise mask a class-only correction)."""
    world = model.world
    points, samples = _hop_points(report.fired, world)
    if not points:
        return None
    link = bottleneck_ring_link(model, world)
    cls = model.link_class_of(*link)
    current = bottleneck_ring_coeffs(model, world)
    distinct_sizes = {round(b, 3) for b, _ in points}
    if len(distinct_sizes) >= 2:
        corrected = fit_alpha_beta(points)
    else:
        nbytes, seconds = points[0]
        predicted = current.time(nbytes)
        ratio = seconds / predicted if predicted > 0 else 1.0
        corrected = current.scaled(max(1e-9, ratio))

    def _ratio(new: float, old: float) -> float:
        return new / old if old > 0 else 1.0

    ra = _ratio(corrected.alpha, current.alpha)
    rb = _ratio(corrected.beta, current.beta)
    links = {link_: LinkCoeffs(c.alpha * ra, c.beta * rb) for link_, c in model.links.items()
             if model.link_class_of(*link_) == cls}
    return Calibration(world=world, classes={cls: corrected}, links=links, ips=model.ips, source=source,
                       fingerprint=fingerprint, samples=max(1, samples))


def corrected_model(report: DriftReport, base: Calibration, decay: float = 0.5, fingerprint: Optional[str] = None,
                    source: str = "drift-recal") -> Tuple[Optional[Calibration], LinkCostModel]:
    """Invert ``report`` against ``base``'s model and decay-merge the
    correction in.  Returns ``(merged_or_None, model)``: the merged model,
    or ``base``'s unchanged where nothing inverts."""
    from adapcc_tpu_torch.sim.calibrate import merge_calibration

    base_model = base.cost_model()
    correction = drift_correction(report, base_model, fingerprint=fingerprint, source=source)
    if correction is None:
        return None, base_model
    merged = merge_calibration(base, correction, decay=decay)
    return merged, merged.cost_model()


def calibration_of(model: LinkCostModel, **stamps) -> Calibration:
    """A live cost model as a :class:`Calibration` (the merge base where no
    artifact exists yet), stamped with ``fingerprint=``, ``samples=``,
    ``source=`` as the caller knows them."""
    return Calibration(world=model.world, classes=dict(model.classes), links=dict(model.links),
                       ips=dict(model.ips) if model.ips else None, source=stamps.pop("source", model.source),
                       **stamps)
