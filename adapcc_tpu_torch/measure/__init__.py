"""Measurement harnesses, the port of :mod:`adapcc_tpu.measure`: the
per-step worker-skew probe, the throughput meter and the gradient-noise-scale
estimator."""

from adapcc_tpu_torch.measure.gns import (
    GNSEstimator,
    ddp_grad_sq_norms,
    gns_from_norms,
    stacked_grad_sq_norms,
    tree_sq_norm,
)
from adapcc_tpu_torch.measure.throughput import ThroughputMeter
from adapcc_tpu_torch.measure.wait_time import WaitTimeProbe, emulate_heterogeneous_steps

__all__ = [
    "GNSEstimator",
    "ThroughputMeter",
    "WaitTimeProbe",
    "ddp_grad_sq_norms",
    "emulate_heterogeneous_steps",
    "gns_from_norms",
    "stacked_grad_sq_norms",
    "tree_sq_norm",
]
