"""Pipeline-parallel training plane.

The port of :mod:`adapcc_tpu.pipe`: ``partition`` splits GPT-2 across
stages, ``schedule`` lays GPipe/1F1B tick tables and re-emits them as
verifiable ``compiler/`` programs, ``executor`` runs the table with a real
backward through the stacked engine's ``pipe_send``, and ``forward`` is the
forward-only building block."""

from adapcc_tpu_torch.pipe.forward import pipeline_apply
from adapcc_tpu_torch.pipe.partition import (
    PipelineStage,
    StagePartition,
    composed_loss,
    merge_params,
    partition_gpt2,
    split_params,
    stage_forward,
)
from adapcc_tpu_torch.pipe.schedule import (
    DEFAULT_PIPE_SCHEDULE,
    PIPE_SCHEDULE_ENV,
    PIPE_SCHEDULES,
    PipelineSchedule,
    PipeTask,
    pipeline_program,
    pipeline_schedule,
    resolve_pipe_schedule,
)
from adapcc_tpu_torch.pipe.executor import (
    PipelineExecutor,
    PipelineReport,
    sync_tied_embedding,
)

__all__ = [
    "DEFAULT_PIPE_SCHEDULE",
    "PIPE_SCHEDULE_ENV",
    "PIPE_SCHEDULES",
    "PipeTask",
    "PipelineExecutor",
    "PipelineReport",
    "PipelineSchedule",
    "PipelineStage",
    "StagePartition",
    "composed_loss",
    "merge_params",
    "partition_gpt2",
    "pipeline_apply",
    "pipeline_program",
    "pipeline_schedule",
    "resolve_pipe_schedule",
    "split_params",
    "stage_forward",
    "sync_tied_embedding",
]
