"""Measurement harnesses (the port of :mod:`adapcc_tpu.measure`, so far its
per-step worker-skew probe; throughput and gradient-noise-scale come with
the measurement slice)."""

from adapcc_tpu_torch.measure.wait_time import WaitTimeProbe, emulate_heterogeneous_steps

__all__ = ["WaitTimeProbe", "emulate_heterogeneous_steps"]
