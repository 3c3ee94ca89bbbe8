"""The α-β cost model and its calibration artifacts (the port of the parts
of :mod:`adapcc_tpu.sim` the plan tuner and the gradient hook use; the
event-replay simulator comes in a later slice)."""

from adapcc_tpu_torch.sim.calibrate import (
    Calibration,
    calibrate_from_matrices,
    load_calibration,
    load_or_default,
)
from adapcc_tpu_torch.sim.cost_model import DCN, ICI, LinkCoeffs, LinkCostModel, fit_alpha_beta

__all__ = [
    "Calibration",
    "DCN",
    "ICI",
    "LinkCoeffs",
    "LinkCostModel",
    "calibrate_from_matrices",
    "fit_alpha_beta",
    "load_calibration",
    "load_or_default",
]
