"""Utilities (the port of :mod:`adapcc_tpu.utils`, so far its metrics
registry and collective trace)."""

from adapcc_tpu_torch.utils.observability import (
    CollectiveTrace,
    MetricsRegistry,
    TraceEvent,
    nearest_rank_percentile,
    parse_track_log,
)

__all__ = ["CollectiveTrace", "MetricsRegistry", "TraceEvent", "nearest_rank_percentile", "parse_track_log"]
