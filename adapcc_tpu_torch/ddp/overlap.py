"""Overlapped gradient sync: per-bucket collectives behind other work.

The port of :mod:`adapcc_tpu.ddp.overlap`.  Where the JAX package hands XLA
two independent subgraphs and lets its async collectives and scheduler
interleave them, the port issues the work so that it really runs beside
compute on the card:

1. **Microbatch-pipelined sync** (``"microbatch"``,
   :func:`microbatch_pipelined_sync`): while microbatch ``i``'s forward and
   backward run on the current stream, microbatch ``i - 1``'s gradient delta
   is synced on a side CUDA stream; an event joins the two before the delta
   is added into the float32 accumulator.  Only the last delta's sync (the
   drain) has no compute left to hide behind.  Wire volume grows to
   ``accum`` gradient-sized syncs a step.

2. **Per-bucket rolling sync** (``"bucket"``, :func:`rolling_bucket_sync`):
   every bucket of the hook's :class:`~adapcc_tpu_torch.ddp.bucketing.
   BucketPlan` is split at its ``chunk_bytes`` into independent collectives
   (:func:`~adapcc_tpu_torch.comm.engine.chunked_psum_shard` /
   :func:`~adapcc_tpu_torch.comm.engine.chunked_allreduce_shard`), all of
   them issued with ``async_op=True`` before any is waited on; the hook waits
   on a bucket only when it copies that bucket's leaves out, so those copies
   run beside the later buckets' collectives.  Values are the unchunked
   sync's bit for bit.

On a CPU world over gloo the same code runs, synchronously: the values are
the contract there.  ``ADAPCC_OVERLAP`` overrides the caller's mode; a
malformed value raises.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from adapcc_tpu_torch.comm.ring import resolve_chunk_bytes
from adapcc_tpu_torch.primitives import ReduceOp

#: env override for the overlap mode (off | microbatch | bucket)
OVERLAP_ENV = "ADAPCC_OVERLAP"

#: the schedulable overlap modes, risk order ("off" first so candidate
#: tie-breaks keep the non-overlapped plane)
OVERLAP_MODES = ("off", "bucket", "microbatch")


def resolve_overlap_mode(overlap: Optional[str] = None) -> str:
    """The overlap schedule in force: the ``ADAPCC_OVERLAP`` sweep override
    wins, then the caller's mode, then ``"off"``.  A malformed value raises:
    a typo silently falling back to the default would invalidate an overlap
    A/B."""
    env = os.environ.get(OVERLAP_ENV)
    if env is not None and env.strip():
        value = env.strip().lower()
        if value not in OVERLAP_MODES:
            raise ValueError(f"{OVERLAP_ENV}={env!r}: expected one of {OVERLAP_MODES}")
        return value
    if overlap is None:
        return "off"
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap={overlap!r}: expected one of {OVERLAP_MODES}")
    return overlap


# --------------------------------------------------------------------------- #
# mechanism 2: per-bucket rolling sync (per rank, over a process group)
# --------------------------------------------------------------------------- #


def rolling_bucket_sync(
    buckets: Sequence[torch.Tensor],
    chunk_bytes: Sequence[int],
    active_mask: Optional[torch.Tensor],
    *,
    mode: str,
    strategy: Any,
    op: ReduceOp = ReduceOp.SUM,
    group=None,
) -> List[Any]:
    """Each bucket as independent chunked collectives at its
    ``chunk_bytes`` (``ADAPCC_RING_CHUNK_BYTES`` overrides, in the engine's
    chunked entry points).  ``mode`` is the data plane the hook resolved:
    ``"psum"`` (flat collectives; ``active_mask=None`` is the full world) or
    ``"schedule"`` (strategy-tree allreduce; None = everyone active).

    Returns one :class:`~adapcc_tpu_torch.comm.engine.PendingCollective` a
    bucket (JAX returns the synced buckets), every bucket issued before this
    returns: ``wait()`` on bucket ``b`` gives its result and leaves the later
    buckets' collectives running."""
    from adapcc_tpu_torch.comm.engine import chunked_allreduce_shard, chunked_psum_shard

    if len(buckets) != len(chunk_bytes):
        raise ValueError(
            f"{len(buckets)} buckets but {len(chunk_bytes)} chunk sizes: the bucket plan and its "
            "chunk table must describe one layout"
        )
    out: List[Any] = []
    for bucket, cb in zip(buckets, chunk_bytes):
        if mode == "psum":
            out.append(chunked_psum_shard(bucket, active_mask, op=op, chunk_bytes=cb,
                                          world=strategy.world_size, group=group, async_op=True))
        else:
            mask = active_mask if active_mask is not None else torch.ones(strategy.world_size, dtype=torch.bool)
            out.append(chunked_allreduce_shard(bucket, mask, strategy, op=op, chunk_bytes=cb, group=group,
                                               async_op=True))
    return out


# --------------------------------------------------------------------------- #
# mechanism 1: microbatch-pipelined sync
# --------------------------------------------------------------------------- #


def _sync_beside(sync_fn: Callable, delta: List[torch.Tensor], side: Optional["torch.cuda.Stream"]):
    """``(synced, done)``: ``sync_fn(delta)`` issued on the ``side`` stream
    once the current stream has produced ``delta``, and the event that marks
    its end (None and a plain call without a side stream)."""
    if side is None:
        return sync_fn(delta), None
    ready = torch.cuda.Event()
    ready.record()
    side.wait_event(ready)
    with torch.cuda.stream(side):
        synced = sync_fn(delta)
        done = torch.cuda.Event()
        done.record(side)
    return synced, done


def microbatch_pipelined_sync(
    vg: Callable[[Any], Tuple[torch.Tensor, List[torch.Tensor]]],
    micro: Sequence[Any],
    sync_fn: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    accum: int,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The pipelined accumulation (mechanism 1 of docs/OVERLAP.md).

    ``vg(mb) -> (loss, grads)`` is one microbatch's forward and backward,
    its gradients tensors of their own (the next call must not overwrite
    them: the trainer detaches them from ``p.grad``); ``micro`` holds the
    ``accum`` microbatches; ``sync_fn`` is the hook's allreduce with the mask
    bound (it may work in place).  Microbatch ``i - 1``'s delta is synced
    on a side stream while microbatch ``i`` computes; the synced deltas are
    summed in float32 in microbatch order; one drain sync covers the last.

    Returns ``(mean loss in float32, synced mean gradients in each delta's
    dtype)``.  By linearity this is the sequential path's sync of the
    summed gradients; only the float32 order of the adds differs (a sum of
    synced deltas against a sync of summed deltas), so parity holds to the
    accumulation-order tolerance, and bit for bit where the sync is the
    identity (one rank).

    A delta stays referenced until the current stream has waited for its
    sync's event, so the caching allocator cannot hand its memory to the
    next backward while the side stream still reads it."""
    if accum < 2:
        raise ValueError(
            f"microbatch pipelining needs accum >= 2, got {accum}: with a single microbatch there is "
            "no later compute to hide the sync behind (use overlap='bucket' or 'off')"
        )
    loss0, prev = vg(micro[0])
    side = torch.cuda.Stream(prev[0].device) if prev and prev[0].is_cuda else None
    loss_sum = loss0.to(torch.float32)
    acc = [torch.zeros_like(g, dtype=torch.float32) for g in prev]
    for i in range(1, accum):
        synced, done = _sync_beside(sync_fn, prev, side)
        loss, delta = vg(micro[i])
        if done is not None:
            torch.cuda.current_stream().wait_event(done)
        for a, s in zip(acc, synced):
            a.add_(s)
        loss_sum = loss_sum + loss.to(torch.float32)
        prev = delta
    drained = sync_fn(prev)  # the drain: the one sync with nothing to hide behind
    synced = [((a + d.to(torch.float32)) / accum).to(d.dtype) for a, d in zip(acc, drained)]
    return loss_sum / accum, synced


# --------------------------------------------------------------------------- #
# flat-vector chunk table (ZeRO-1's chunked reduce-scatter / all-gather)
# --------------------------------------------------------------------------- #


def even_chunk_bounds(total: int, n_chunks: int) -> List[Tuple[int, int]]:
    """``(offset, length)`` table splitting ``total`` elements into
    ``n_chunks`` near-equal contiguous chunks (the remainder spread over the
    leading chunks): the split ZeRO-1's chunked collectives use."""
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    n = max(1, min(int(n_chunks), max(1, total)))
    base, rem = divmod(total, n)
    bounds: List[Tuple[int, int]] = []
    off = 0
    for i in range(n):
        length = base + (1 if i < rem else 0)
        bounds.append((off, length))
        off += length
    return bounds


def overlap_chunk_count(nbytes: int, chunk_bytes: Optional[int]) -> int:
    """How many independent collectives an ``nbytes`` payload splits into at
    ``chunk_bytes`` (``ADAPCC_RING_CHUNK_BYTES`` overrides: one precedence
    ladder for every chunk knob)."""
    cb = resolve_chunk_bytes(chunk_bytes)
    return max(1, -(-int(nbytes) // cb))
