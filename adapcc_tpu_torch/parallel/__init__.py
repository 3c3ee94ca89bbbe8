"""Parallelism beyond data parallelism: sequence (ring attention, Ulysses,
the sequence-parallel GPT-2), tensor, expert, the forward pipeline, FSDP
per rank and ZeRO-1's sharded optimizer.

The port of :mod:`adapcc_tpu.parallel`, under JAX's names.  Where JAX names
a ``shard_map`` axis, the port passes an
:class:`~adapcc_tpu_torch.parallel.axis.Axis` (per rank over a process
group, or stacked in one process).  ``pipeline_apply`` is the pipeline
plane's forward block (:mod:`adapcc_tpu_torch.pipe.forward`), as JAX
re-exports it here.
"""

from adapcc_tpu_torch.parallel.axis import Axis, Mesh
from adapcc_tpu_torch.parallel.expert import expert_parallel_moe, moe_capacity
from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer, zero1_train_step
from adapcc_tpu_torch.parallel.fsdp_rank import (
    FSDPParams,
    fsdp_shardings,
    fsdp_tp_shardings,
    fsdp_tp_train_step,
    fsdp_train_step,
    shard_fsdp,
)
from adapcc_tpu_torch.parallel.gpt2_sp import gpt2_sp_loss_and_grad, gpt2_sp_train_step, local_tokens
from adapcc_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
    ring_attention_shard,
)
from adapcc_tpu_torch.parallel.tensor import (
    column_parallel_dense,
    gpt2_tp_rules,
    row_parallel_dense,
    shard_tree,
    tree_shardings,
)
from adapcc_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_shard
from adapcc_tpu_torch.pipe.forward import pipeline_apply

__all__ = [
    "Axis",
    "Mesh",
    "expert_parallel_moe",
    "moe_capacity",
    "pipeline_apply",
    "gpt2_sp_loss_and_grad",
    "gpt2_sp_train_step",
    "local_tokens",
    "reference_attention",
    "ring_attention",
    "ring_attention_shard",
    "ulysses_attention",
    "ulysses_attention_shard",
    "column_parallel_dense",
    "row_parallel_dense",
    "gpt2_tp_rules",
    "tree_shardings",
    "shard_tree",
    "FSDPParams",
    "Zero1Optimizer",
    "fsdp_shardings",
    "fsdp_tp_shardings",
    "fsdp_tp_train_step",
    "fsdp_train_step",
    "shard_fsdp",
    "zero1_train_step",
]
