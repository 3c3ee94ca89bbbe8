"""Elastic fault tolerance: the detect → re-plan → hot-swap loop (the port of
:mod:`adapcc_tpu.elastic`).

- :mod:`~adapcc_tpu_torch.elastic.faults` — deterministic fault injection
  (``FaultPlan``; the ``ADAPCC_FAULT_PLAN`` env artifact);
- :mod:`~adapcc_tpu_torch.elastic.worldview` — the coordinator's explicit
  ``WorldView`` (alive set, relay set, epoch) and the slow-rank rule;
- :mod:`~adapcc_tpu_torch.elastic.standby` — sim-ranked degraded plans
  (one-rank-down, one-host-down) prepared on the engine at setup, so a world
  shrink is a dispatch-time cache-key switch;
- :mod:`~adapcc_tpu_torch.elastic.rebalance` — ZeRO-1 shard re-balance on a
  world change (shrink, grow-back, replica repair), validated through the
  checkpoint layout-tag funnel;
- :mod:`~adapcc_tpu_torch.elastic.redundancy` — k-replicated ZeRO-1 shards
  (``ADAPCC_SHARD_REPLICAS``): ring-neighbour, host-disjoint holders fed
  after every step, so a dead rank's optimizer rows come back from a holder
  instead of a checkpoint reload.

The out-of-band authority that drives the loop is
:mod:`adapcc_tpu_torch.supervisor`.
"""

from adapcc_tpu_torch.elastic.faults import (
    DEFAULT_SLOWDOWN,
    FAULT_PLAN_ENV,
    FaultEvent,
    FaultPlan,
    FaultState,
    load_fault_plan,
)
from adapcc_tpu_torch.elastic.rebalance import (
    gather_zero1_pair,
    grow_zero1_trainer_state,
    rebalance_zero1_pair,
    recover_zero1_trainer_state,
    reshard_zero1_snapshot,
    shrink_zero1_trainer_state,
)
from adapcc_tpu_torch.elastic.redundancy import (
    DEFAULT_SHARD_REPLICAS,
    SHARD_REPLICAS_ENV,
    ShardReplicaStore,
    replica_placement,
    shard_replicas,
)
from adapcc_tpu_torch.elastic.standby import StandbyPlan, StandbyPlanCache, degraded_scenarios, reemit_for_active
from adapcc_tpu_torch.elastic.worldview import (
    HEARTBEAT_TIMEOUT_ENV,
    SLOW_RANK_FACTOR_ENV,
    WorldView,
    slow_ranks_from_medians,
)

__all__ = [
    "DEFAULT_SHARD_REPLICAS",
    "DEFAULT_SLOWDOWN",
    "FAULT_PLAN_ENV",
    "FaultEvent",
    "FaultPlan",
    "FaultState",
    "HEARTBEAT_TIMEOUT_ENV",
    "SHARD_REPLICAS_ENV",
    "SLOW_RANK_FACTOR_ENV",
    "ShardReplicaStore",
    "StandbyPlan",
    "StandbyPlanCache",
    "WorldView",
    "degraded_scenarios",
    "gather_zero1_pair",
    "grow_zero1_trainer_state",
    "load_fault_plan",
    "rebalance_zero1_pair",
    "recover_zero1_trainer_state",
    "reemit_for_active",
    "replica_placement",
    "reshard_zero1_snapshot",
    "shard_replicas",
    "shrink_zero1_trainer_state",
    "slow_ranks_from_medians",
]
