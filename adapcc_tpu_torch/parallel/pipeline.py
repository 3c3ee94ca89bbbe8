"""Deprecated location: the forward pipeline block lives in
``adapcc_tpu_torch.pipe.forward``.  This alias keeps old imports working
and warns once a process, as JAX's ``adapcc_tpu.parallel.pipeline`` does."""

from __future__ import annotations

import warnings
from typing import Any, Callable

import torch

from adapcc_tpu_torch.parallel.axis import Mesh
from adapcc_tpu_torch.pipe.forward import pipeline_apply as _pipeline_apply

_MOVED_WARNED = False


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    batch: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "stages",
    num_microbatches: int = 4,
) -> torch.Tensor:
    """Deprecated alias of :func:`adapcc_tpu_torch.pipe.forward.pipeline_apply`:
    warns once (a long loop must not drown in a warning a call), then
    delegates unchanged."""
    global _MOVED_WARNED
    if not _MOVED_WARNED:
        _MOVED_WARNED = True
        warnings.warn(
            "adapcc_tpu_torch.parallel.pipeline moved to adapcc_tpu_torch.pipe.forward; "
            "import pipeline_apply from there",
            DeprecationWarning,
            stacklevel=2,
        )
    return _pipeline_apply(stage_fn, stacked_params, batch, mesh, axis_name=axis_name,
                           num_microbatches=num_microbatches)
