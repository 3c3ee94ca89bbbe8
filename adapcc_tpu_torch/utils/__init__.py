"""Utilities (the port of :mod:`adapcc_tpu.utils`): the training meters,
the metrics registry, the collective trace, the profiler context and the
training-log scraper."""

from adapcc_tpu_torch.utils.observability import (
    AverageMeter,
    CollectiveTrace,
    MetricsRegistry,
    ProgressMeter,
    TraceEvent,
    nearest_rank_percentile,
    parse_track_log,
    parse_training_log,
    profiler_trace,
)

__all__ = [
    "AverageMeter",
    "CollectiveTrace",
    "MetricsRegistry",
    "ProgressMeter",
    "TraceEvent",
    "nearest_rank_percentile",
    "parse_track_log",
    "parse_training_log",
    "profiler_trace",
]
