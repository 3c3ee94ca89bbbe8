"""Elastic fault tolerance: the detect → re-plan → hot-swap loop (the port of
:mod:`adapcc_tpu.elastic`).

- :mod:`~adapcc_tpu_torch.elastic.faults` — deterministic fault injection
  (``FaultPlan``; the ``ADAPCC_FAULT_PLAN`` env artifact);
- :mod:`~adapcc_tpu_torch.elastic.worldview` — the coordinator's explicit
  ``WorldView`` (alive set, relay set, epoch) and the slow-rank rule;
- :mod:`~adapcc_tpu_torch.elastic.standby` — sim-ranked degraded plans
  (one-rank-down, one-host-down) prepared on the engine at setup, so a world
  shrink is a dispatch-time cache-key switch.

The out-of-band authority that drives the loop is
:mod:`adapcc_tpu_torch.supervisor`.  ZeRO-1's elastic state (shard
re-balance and replicas) comes with the ZeRO-1 elastic-state slice.
"""

from adapcc_tpu_torch.elastic.faults import (
    DEFAULT_SLOWDOWN,
    FAULT_PLAN_ENV,
    FaultEvent,
    FaultPlan,
    FaultState,
    load_fault_plan,
)
from adapcc_tpu_torch.elastic.standby import StandbyPlan, StandbyPlanCache, degraded_scenarios, reemit_for_active
from adapcc_tpu_torch.elastic.worldview import (
    HEARTBEAT_TIMEOUT_ENV,
    SLOW_RANK_FACTOR_ENV,
    WorldView,
    slow_ranks_from_medians,
)

__all__ = [
    "DEFAULT_SLOWDOWN",
    "FAULT_PLAN_ENV",
    "FaultEvent",
    "FaultPlan",
    "FaultState",
    "HEARTBEAT_TIMEOUT_ENV",
    "SLOW_RANK_FACTOR_ENV",
    "StandbyPlan",
    "StandbyPlanCache",
    "WorldView",
    "degraded_scenarios",
    "load_fault_plan",
    "reemit_for_active",
    "slow_ranks_from_medians",
]
