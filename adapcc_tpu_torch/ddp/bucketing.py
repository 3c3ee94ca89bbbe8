"""Gradient bucketing: a list of leaves ↔ buckets of at most a cap of bytes.

The port of :mod:`adapcc_tpu.ddp.bucketing` on a list of tensors in place of
a pytree.  The reference leans on torch DDP's bucketing (``bucket_cap_mb=100``,
train_ddp.py:35-37) and sizes chunks per bucket (buckets over 10 MB get 4 MB
chunks, smaller ones a quarter of their size, commu.py:401-403).

Bucket membership, and each bucket's split across a strategy's trees, are
positional, and on a multi-tree strategy the tree that carries an element
sets its add order.  So to give the JAX package's bits the leaves must come
in the JAX package's leaf order and layout: for a model of the port, the
flax tree's leaves sorted by path, each ``Linear.weight`` transposed into
its ``Dense`` kernel (``models/convert.py::flax_paths``;
``DDPTrainer._flax_layout``).  A bucket of mixed dtypes is concatenated in
the promoted dtype, as ``jnp.concatenate`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from adapcc_tpu_torch.primitives import CHUNK_HEURISTIC_THRESHOLD, DEFAULT_CHUNK_BYTES


@dataclass(frozen=True)
class BucketPlan:
    """Static assignment of leaves to buckets: ``leaf_bucket[i]`` is leaf
    ``i``'s bucket, ``bucket_sizes[b]`` bucket ``b``'s element count,
    ``chunk_bytes[b]`` its chunk size by the reference heuristic."""

    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_bucket: Tuple[int, ...]
    bucket_sizes: Tuple[int, ...]
    chunk_bytes: Tuple[int, ...]
    #: per-bucket payload bytes
    bucket_bytes: Tuple[int, ...] = ()
    #: how many single leaves exceeded the cap on their own (each lands in a
    #: bucket of its own, as in torch DDP)
    oversized_leaves: int = 0

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def total_bytes(self) -> int:
        return int(sum(self.bucket_bytes))


def _chunk_heuristic(nbytes: int) -> int:
    """Reference chunk sizing (commu.py:401-403)."""
    if nbytes > CHUNK_HEURISTIC_THRESHOLD:
        return DEFAULT_CHUNK_BYTES
    return max(nbytes // 4, 1)


def build_bucket_plan(leaves: Sequence[torch.Tensor], bucket_cap_mb: float = 100.0) -> BucketPlan:
    """Fill buckets greedily to the cap in reverse leaf order (torch DDP
    buckets in roughly backward-completion order, last layers first)."""
    if not leaves:
        raise ValueError(
            "build_bucket_plan: no gradient leaves, nothing to bucket "
            "(did a filter strip every parameter?)"
        )
    cap = int(bucket_cap_mb * 1024 * 1024)
    leaf_bucket = [0] * len(leaves)
    bucket_sizes: List[int] = []
    bucket_bytes: List[int] = []
    oversized = 0
    cur_bucket = -1
    cur_bytes = cap + 1  # force a new bucket on the first leaf
    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        nbytes = leaf.numel() * leaf.element_size()
        if nbytes > cap:
            oversized += 1
        if cur_bytes + nbytes > cap and cur_bytes > 0:
            cur_bucket += 1
            bucket_sizes.append(0)
            bucket_bytes.append(0)
            cur_bytes = 0
        leaf_bucket[i] = cur_bucket
        bucket_sizes[cur_bucket] += leaf.numel()
        bucket_bytes[cur_bucket] += nbytes
        cur_bytes += nbytes
    return BucketPlan(
        leaf_shapes=tuple(tuple(leaf.shape) for leaf in leaves),
        leaf_bucket=tuple(leaf_bucket),
        bucket_sizes=tuple(bucket_sizes),
        chunk_bytes=tuple(_chunk_heuristic(b) for b in bucket_bytes),
        bucket_bytes=tuple(bucket_bytes),
        oversized_leaves=oversized,
    )


def flatten_to_buckets(plan: BucketPlan, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pack the leaves into one 1-D tensor per bucket (a bucket of one leaf
    may be a view of it)."""
    parts: List[List[torch.Tensor]] = [[] for _ in range(plan.num_buckets)]
    for i, leaf in enumerate(leaves):
        parts[plan.leaf_bucket[i]].append(leaf.reshape(-1))
    return [torch.cat(p) if len(p) > 1 else p[0] for p in parts]


def unflatten_from_buckets(plan: BucketPlan, buckets: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The leaves back out of the bucket tensors: views, in each bucket's
    dtype."""
    offsets = [0] * plan.num_buckets
    leaves = []
    for i, shape in enumerate(plan.leaf_shapes):
        b = plan.leaf_bucket[i]
        n = 1
        for d in shape:
            n *= d
        leaves.append(buckets[b][offsets[b]:offsets[b] + n].view(shape))
        offsets[b] += n
    return leaves
