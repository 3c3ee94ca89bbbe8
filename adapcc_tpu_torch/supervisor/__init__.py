"""Autonomous supervisor daemon (the port of :mod:`adapcc_tpu.supervisor`).

Out-of-band failure handling for the elastic + adaptation loops: ranks
lease liveness through the coordinator's heartbeat RPC, a per-rank
healthy → suspected → dead state machine confirms real cross-process
silence, every decision is write-ahead journaled (fsync'd) before
actuation, and a deterministic chaos harness (SIGKILL / SIGSTOP
duty-cycle / heartbeat drop-delay) drives the whole loop against real
processes.
"""

from adapcc_tpu_torch.supervisor.chaos import (
    BeatChaos,
    ChaosAction,
    ChaosInjector,
    wall_schedule,
)
from adapcc_tpu_torch.supervisor.daemon import (
    SUPERVISOR_ENV,
    Supervisor,
    supervisor_enabled,
)
from adapcc_tpu_torch.supervisor.journal import Decision, DecisionJournal
from adapcc_tpu_torch.supervisor.liveness import (
    DEAD,
    HEALTHY,
    HEARTBEAT_GRACE_ENV,
    HEARTBEAT_PERIOD_ENV,
    SUSPECTED,
    LivenessConfig,
    LivenessTable,
)

__all__ = [
    "BeatChaos",
    "ChaosAction",
    "ChaosInjector",
    "DEAD",
    "Decision",
    "DecisionJournal",
    "HEALTHY",
    "HEARTBEAT_GRACE_ENV",
    "HEARTBEAT_PERIOD_ENV",
    "LivenessConfig",
    "LivenessTable",
    "SUPERVISOR_ENV",
    "SUSPECTED",
    "Supervisor",
    "supervisor_enabled",
    "wall_schedule",
]
