"""Stage partitioner: GPT-2 split across a pipeline ``stages`` axis.

The port of :mod:`adapcc_tpu.pipe.partition`.  It owns the model side of
the pipeline plane: which transformer blocks, plus the embedding front and
the tied-head back, live on which stage; how a GPT-2's parameters split
into per-stage modules; and the per-stage forward the executor
differentiates.

A stage is a :class:`PipelineStage`, an ``nn.Module`` holding the port's
own modules under the GPT-2's names: stage 0 its ``wte`` and ``wpe``
embeddings, every stage its blocks ``h{i}`` (the port's
:class:`~adapcc_tpu_torch.models.gpt2.Block`), the last stage ``ln_f`` and
``head_wte``, a copy of the token embedding for the tied LM head.  The
stage forward repeats :class:`~adapcc_tpu_torch.models.gpt2.GPT2`'s forward
piece by piece, so the composed stages are the single-stage model's math
(:func:`composed_loss` is its loss bit for bit).

Weight tying across the cut: after the backward drain the executor routes
the head copy's gradient back to stage 0 (the Megatron-LM embedding-grad
exchange) and adds it to ``wte``'s, and :func:`~adapcc_tpu_torch.pipe.
executor.sync_tied_embedding` refreshes the copy after an update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from adapcc_tpu_torch.models.gpt2 import GPT2, LN_EPS, Block, GPT2Config, _layer_norm, lm_loss


@dataclass(frozen=True)
class StagePartition:
    """A contiguous block split: stage ``s`` runs blocks
    ``[block_ranges[s][0], block_ranges[s][1])``; ``param_counts`` is the
    per-stage parameter count including the embedding/head residents."""

    num_stages: int
    n_layer: int
    block_ranges: Tuple[Tuple[int, int], ...]
    param_counts: Tuple[int, ...]

    def blocks_of(self, stage: int) -> range:
        lo, hi = self.block_ranges[stage]
        return range(lo, hi)


def _module_sizes(cfg: GPT2Config) -> Dict[str, int]:
    """Parameter counts of the GPT-2's top modules, from a model on the meta
    device (shapes only, nothing allocated)."""
    sizes: Dict[str, int] = {}
    for name, p in GPT2(cfg, device="meta", seed=None).named_parameters():
        top = name.split(".", 1)[0]
        sizes[top] = sizes.get(top, 0) + p.numel()
    return sizes


def partition_gpt2(cfg: GPT2Config, num_stages: int) -> StagePartition:
    """Split ``cfg.n_layer`` blocks over ``num_stages`` contiguous stages
    with balanced parameter counts: every stage gets ``n_layer //
    num_stages`` blocks and the remainder goes one block at a time to the
    lightest stage (the embedding weighs on stage 0, the tied head on the
    last).  Refuses more stages than blocks, dropout and sequence
    parallelism, in JAX's words."""
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if num_stages > cfg.n_layer:
        raise ValueError(
            f"un-splittable layout: {cfg.n_layer} transformer blocks cannot "
            f"feed {num_stages} pipeline stages (each stage needs >= 1 block)"
        )
    if cfg.dropout != 0.0:
        raise ValueError("pipeline parallelism requires dropout == 0")
    if cfg.sp_axis is not None:
        raise ValueError(
            "pipeline parallelism does not compose with sequence "
            "parallelism (cfg.sp_axis must be None)"
        )

    sizes = _module_sizes(cfg)
    block_size = sizes["h0"]
    embed_size = sizes["wte"] + sizes["wpe"]
    head_size = sizes["wte"] + sizes["ln_f"]  # head_wte copy + final norm

    counts = [cfg.n_layer // num_stages] * num_stages
    extra = cfg.n_layer - sum(counts)
    overhead = [0.0] * num_stages
    overhead[0] += embed_size
    if num_stages > 1:
        overhead[-1] += head_size
    else:
        overhead[0] += sizes["ln_f"]
    for _ in range(extra):
        # lightest stage first; ties break toward the earlier stage
        load = [overhead[s] + counts[s] * block_size for s in range(num_stages)]
        s = min(range(num_stages), key=lambda i: (load[i], i))
        counts[s] += 1

    ranges: List[Tuple[int, int]] = []
    lo = 0
    for s in range(num_stages):
        ranges.append((lo, lo + counts[s]))
        lo += counts[s]
    param_counts = tuple(int(overhead[s]) + counts[s] * block_size for s in range(num_stages))
    return StagePartition(
        num_stages=num_stages,
        n_layer=cfg.n_layer,
        block_ranges=tuple(ranges),
        param_counts=param_counts,
    )


# -- per-stage modules ---------------------------------------------------------


class PipelineStage(nn.Module):
    """One stage's parameters under the GPT-2's names (module docstring).
    Its values come from :func:`split_params`, which builds it on the meta
    device and assigns them."""

    def __init__(self, cfg: GPT2Config, partition: StagePartition, stage: int, device=None) -> None:
        super().__init__()
        if stage == 0:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
            self.wpe = nn.Embedding(cfg.max_seq, cfg.d_model, device=device)
        for i in partition.blocks_of(stage):
            self.add_module(f"h{i}", Block(cfg, device=device))
        if stage == partition.num_stages - 1:
            self.ln_f = nn.LayerNorm(cfg.d_model, eps=LN_EPS, device=device)
            if partition.num_stages > 1:
                self.head_wte = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)


def split_params(model: GPT2, partition: StagePartition, device=None) -> List[PipelineStage]:
    """Split a GPT-2 into per-stage modules holding copies of its
    parameters, in their dtypes, on ``device`` (default: the model's).  The
    last stage's ``head_wte`` starts as a copy of ``wte``; the executor
    keeps the two tied."""
    state = model.state_dict()
    if device is None:
        device = state["wte.weight"].device
    stages = []
    for s in range(partition.num_stages):
        stage = PipelineStage(model.cfg, partition, s, device="meta")
        own = {}
        for name in stage.state_dict():
            src = "wte.weight" if name == "head_wte.weight" else name
            own[name] = state[src].detach().to(device, copy=True)
        stage.load_state_dict(own, assign=True)
        stages.append(stage)
    return stages


def merge_params(stage_params: List[PipelineStage], partition: StagePartition) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_params`: the GPT-2's flat ``state_dict``
    (stage 0's ``wte`` is authoritative, the ``head_wte`` copy is
    dropped)."""
    flat: Dict[str, torch.Tensor] = {}
    for stage in stage_params:
        for name, value in stage.state_dict().items():
            if not name.startswith("head_wte."):
                flat[name] = value
    return flat


# -- the per-stage forward -----------------------------------------------------


def stage_forward(
    cfg: GPT2Config,
    partition: StagePartition,
    stage: int,
    stage_params: PipelineStage,
    x: Optional[torch.Tensor],
    tokens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One stage's forward: stage 0 embeds (``tokens`` required, ``x``
    ignored), each stage runs its blocks, and the last stage applies the
    final norm and the tied head and returns the LM loss against
    ``tokens``.  Middle stages map activations to activations."""
    S = partition.num_stages
    if stage == 0:
        if tokens is None:
            raise ValueError("stage 0 embeds: tokens is required")
        T = tokens.shape[1]
        pos = torch.arange(T, device=tokens.device)
        x = stage_params.wte(tokens).to(cfg.dtype) + stage_params.wpe(pos).to(cfg.dtype)[None]
    for i in partition.blocks_of(stage):
        x = getattr(stage_params, f"h{i}")(x)
    if stage == S - 1:
        if tokens is None:
            raise ValueError("last stage computes the loss: tokens is required")
        x = _layer_norm(stage_params.ln_f, x)
        head = stage_params.head_wte.weight if S > 1 else stage_params.wte.weight
        logits = (x.to(cfg.dtype) @ head.to(cfg.dtype).T).float()
        return lm_loss(logits, tokens)
    return x


def composed_loss(
    cfg: GPT2Config,
    partition: StagePartition,
    stage_params: List[PipelineStage],
    tokens: torch.Tensor,
) -> torch.Tensor:
    """Every stage in order, no pipeline: the single-process baseline the
    executor is held against."""
    x: Optional[torch.Tensor] = None
    for s in range(partition.num_stages):
        x = stage_forward(cfg, partition, s, stage_params[s], x, tokens)
    return x  # the last stage returned the scalar loss


__all__ = [
    "PipelineStage",
    "StagePartition",
    "composed_loss",
    "merge_params",
    "partition_gpt2",
    "split_params",
    "stage_forward",
]
