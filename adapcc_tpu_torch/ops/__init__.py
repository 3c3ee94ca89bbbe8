"""The hot ops: flash attention on its Hopper kernels, and the chunked
(online-softmax) vocabulary cross-entropy.

JAX's exports, but for ``flash_attention`` itself: here that name stays the
kernels' module (``from adapcc_tpu_torch.ops import flash_attention as
fa``), and the function is ``adapcc_tpu_torch.ops.flash_attention.
flash_attention``."""

from adapcc_tpu_torch.ops.chunked_ce import (
    chunked_lm_loss,
    chunked_softmax_xent,
    chunked_softmax_xent_shard,
)
from adapcc_tpu_torch.ops.flash_attention import flash_attention_with_lse

__all__ = [
    "flash_attention_with_lse",
    "chunked_lm_loss",
    "chunked_softmax_xent",
    "chunked_softmax_xent_shard",
]
