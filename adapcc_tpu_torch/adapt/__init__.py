"""The closed online adaptation loop (the port of :mod:`adapcc_tpu.adapt`).

The paper re-profiles every ``profile_freq`` steps and re-synthesizes when
the links drift.  This package closes that loop from the measurements that
already flow, with no probe traffic on the hot path:

- :mod:`~adapcc_tpu_torch.adapt.detector`: passive drift windows over the
  tuner's plan cells (``ADAPCC_DRIFT_FACTOR`` / ``ADAPCC_DRIFT_WINDOW``);
- :mod:`~adapcc_tpu_torch.adapt.recalibrate`: fired windows inverted into
  per-class α-β corrections, decay-merged into the calibration artifact;
- :mod:`~adapcc_tpu_torch.adapt.triage`: congestion against degradation;
  congestion re-routes under a transient model and restores the incumbent;
- :mod:`~adapcc_tpu_torch.adapt.controller`: the re-rank, the hysteresis
  gate, the standby cache's warm and one ``advance_epoch``
  (``ADAPCC_ADAPT=off|detect|swap``);
- :mod:`~adapcc_tpu_torch.adapt.fabric`: two prioritized jobs on one
  simulated topology (``ADAPCC_JOB_PRIORITY``) and their frontier.
"""

from adapcc_tpu_torch.adapt.controller import (
    ADAPT_MODE_ENV,
    ADAPT_MODES,
    AdaptationController,
    AdaptationReport,
    adapt_mode,
)
from adapcc_tpu_torch.adapt.detector import (
    DEFAULT_DRIFT_FACTOR,
    DEFAULT_DRIFT_WINDOW,
    DRIFT_FACTOR_ENV,
    DRIFT_WINDOW_ENV,
    DriftDetector,
    DriftReport,
    DriftSignal,
    resolve_drift_factor,
    resolve_drift_window,
)
from adapcc_tpu_torch.adapt.fabric import (
    JOB_PRIORITIES,
    JOB_PRIORITY_ENV,
    FabricJob,
    FabricPlan,
    SharedFabric,
    job_priority,
)
from adapcc_tpu_torch.adapt.recalibrate import calibration_of, corrected_model, drift_correction
from adapcc_tpu_torch.adapt.triage import TriageVerdict, classify_drift, contended_view

__all__ = [
    "ADAPT_MODE_ENV",
    "ADAPT_MODES",
    "AdaptationController",
    "AdaptationReport",
    "DEFAULT_DRIFT_FACTOR",
    "DEFAULT_DRIFT_WINDOW",
    "DRIFT_FACTOR_ENV",
    "DRIFT_WINDOW_ENV",
    "DriftDetector",
    "DriftReport",
    "DriftSignal",
    "FabricJob",
    "FabricPlan",
    "JOB_PRIORITIES",
    "JOB_PRIORITY_ENV",
    "SharedFabric",
    "TriageVerdict",
    "adapt_mode",
    "calibration_of",
    "classify_drift",
    "contended_view",
    "corrected_model",
    "drift_correction",
    "job_priority",
    "resolve_drift_factor",
    "resolve_drift_window",
]
