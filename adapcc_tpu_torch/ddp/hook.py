"""Gradient-sync hook: the port of :class:`adapcc_tpu.ddp.hook.GradSyncHook`.

The reference's torch-DDP comm hook negotiates the step's active set with
the coordinator, then runs the adaptive allreduce per gradient bucket with
AVG semantics over the active ranks (commu.py:385-435).  The port keeps the
two halves of the JAX hook:

- **host half** (:meth:`GradSyncHook.negotiate`): the step's ``[world]``
  active mask, negotiated with the coordinator through the
  ``communicator`` (:class:`~adapcc_tpu_torch.communicator.Communicator`);
  without one, everyone is active.
- **device half** (:meth:`GradSyncHook.sync`): allreduce the gradients with
  the mask, on one of two data planes:

  - ``"psum"`` (what a strategy on one host group resolves to): one
    collective per gradient tensor, subset semantics by masking;
  - ``"schedule"`` (a strategy over several host groups, or the fast path
    not allowed): the gradients, in the JAX package's leaf order and layout
    (``order``, ``transposed``), packed into buckets of at most
    ``bucket_cap_mb`` (:mod:`adapcc_tpu_torch.ddp.bucketing`; the plan is
    recorded at the first sync), each bucket one strategy-tree allreduce
    with relay masks (``engine.allreduce_shard``), unpacked back.

  The wire codecs apply to the gradients before either plane: ``bf16``
  casts each gradient for the collective and back, ``int8`` replaces each
  contribution with its block-wise ``decode(encode(·))`` value before the
  float32 collective, and :meth:`GradSyncHook.sync_error_feedback` banks
  each rank's quantization error for the next step.
  :meth:`GradSyncHook.sync_deferred` is the async relay mode's sync: a rank
  masked out of a step banks its gradients for its next active step.

  ``overlap="bucket"`` (:mod:`adapcc_tpu_torch.ddp.overlap`) buckets the
  gradients on either plane and issues every bucket as chunked collectives
  at its chunk size before waiting on any; ``"microbatch"`` is the
  trainer's schedule and leaves the sync unchanged.

The first bucketed sync records the bucket plan into the observability
sinks (``trace``, a :class:`~adapcc_tpu_torch.utils.observability.
CollectiveTrace`, and ``metrics``, a :class:`~adapcc_tpu_torch.utils.
observability.MetricsRegistry`; with a communicator and no sink of its own,
the communicator's): counts and the byte histogram into the registry, the
table with the cost model's ``exposed_comm_s`` floor into a ``grad_sync``
trace event.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from adapcc_tpu_torch.comm import engine
from adapcc_tpu_torch.comm.ring import resolve_chunk_bytes
from adapcc_tpu_torch.ddp.bucketing import BucketPlan, build_bucket_plan, flatten_to_buckets, unflatten_from_buckets
from adapcc_tpu_torch.ddp.overlap import resolve_overlap_mode, rolling_bucket_sync
from adapcc_tpu_torch.models.convert import from_flax_layout, to_flax_layout
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE, error_feedback_step, get_codec, resolve_wire_dtype
from adapcc_tpu_torch.strategy.ir import Strategy


class GradSyncHook:
    def __init__(
        self,
        strategy: Strategy,
        op: ReduceOp = ReduceOp.AVG,
        bucket_cap_mb: float = 100.0,
        use_xla_fastpath: bool = True,
        communicator: Optional[Any] = None,
        mode: str = "auto",
        compress: str = "off",
        error_feedback: bool = False,
        quant_block_size: int = DEFAULT_BLOCK_SIZE,
        overlap: str = "off",
        trace: Optional[Any] = None,
        metrics: Optional[Any] = None,
    ) -> None:
        """``mode``: ``"psum"`` = one masked allreduce per gradient tensor;
        ``"schedule"`` = the bucketed strategy-tree allreduce, buckets of at
        most ``bucket_cap_mb``;
        ``"auto"`` = psum when the fast path is allowed and the strategy
        spans one host group, schedule otherwise.  ``use_xla_fastpath``
        keeps the reference's name for "the flat collective is allowed".

        ``compress`` names a codec of the registry (``off|bf16|int8``) or
        ``"strategy"`` for ``Strategy.wire_dtype``; ``ADAPCC_WIRE_DTYPE``
        overrides either (:meth:`effective_compress`).  ``error_feedback``
        carries each rank's quantization error into the next step through
        :meth:`sync_error_feedback`; the trainer threads the residual.

        ``overlap`` (``ADAPCC_OVERLAP`` overrides, resolved here):
        ``"bucket"`` takes the bucketed path on either plane, every bucket
        as chunked collectives at the plan's per-bucket ``chunk_bytes``
        (``ADAPCC_RING_CHUNK_BYTES`` overrides), bit for bit the unchunked
        sync; ``"microbatch"`` is the trainer's schedule and leaves this
        hook's sync as it is.
        """
        if mode not in ("auto", "psum", "schedule"):
            raise ValueError(f"mode {mode!r} not in auto|psum|schedule")
        self.overlap = resolve_overlap_mode(overlap)
        if compress != "strategy":
            get_codec(compress)  # an unknown name raises, listing the codecs
        if quant_block_size < 1:
            raise ValueError(f"quant_block_size must be >= 1, got {quant_block_size}")
        self.strategy = strategy
        self.op = op
        self.bucket_cap_mb = bucket_cap_mb
        self.use_xla_fastpath = use_xla_fastpath
        self.communicator = communicator
        self.mode = mode
        self.compress = compress
        self.error_feedback = error_feedback
        self.quant_block_size = quant_block_size
        self._trace = trace
        self._metrics = metrics
        self._plan: Optional[BucketPlan] = None
        #: (size, chunk_bytes) per bucket of the plan recorded at the first
        #: schedule-plane sync
        self.recorded_buckets: List[Tuple[int, int]] = []

    def _resolved_mode(self) -> str:
        if self.mode != "auto":
            return self.mode
        if not self.use_xla_fastpath:
            return "schedule"
        ips = set()
        for t in self.strategy.trees:
            ips |= set(t.ips.values())
        return "psum" if len(ips) <= 1 else "schedule"

    # -- host half -------------------------------------------------------------

    def negotiate(self, step: int) -> torch.Tensor:
        """Coordinator round-trip → this step's ``[world]`` active mask.

        The reference's per-step sequence: ``update_relay(step)`` (the
        controller heartbeat), then the first bucket's ``hook_fetch`` (the
        rent-or-buy freeze).  The coordinator speaks process ranks, the mask
        indexes ranks.  Without a communicator or coordinator, everyone is
        active."""
        world = self.strategy.world_size
        if self.communicator is None or self.communicator._hooker is None:
            return torch.ones((world,), dtype=torch.bool)
        self.communicator.update_relay(step)
        active_processes = self.communicator.hook_ready(step)
        active = self.communicator.chips_of_processes(active_processes)
        mask = torch.zeros((world,), dtype=torch.bool)
        mask[[r for r in active if 0 <= r < world]] = True
        return mask

    # -- device half -----------------------------------------------------------

    def effective_compress(self) -> str:
        """The codec this hook runs: ``ADAPCC_WIRE_DTYPE`` > (``"strategy"``:
        the strategy's ``wire_dtype``) > ``compress``, the engine's ladder,
        so hook and engine never disagree about a strategy's codec."""
        return resolve_wire_dtype(self.strategy.wire_dtype if self.compress == "strategy" else self.compress)

    def _codec_apply(self, g: torch.Tensor, transposed: bool = False) -> torch.Tensor:
        """The codec's wire value of ``g``; ``transposed``: ``g`` is the
        JAX package's leaf in another layout (a ``Linear`` or ``Conv2d``
        weight against a ``Dense`` or ``Conv`` kernel,
        :func:`~adapcc_tpu_torch.models.convert.to_flax_layout`), and the
        int8 blocks follow the leaf's layout."""
        apply = get_codec(self.effective_compress()).apply
        if transposed:
            return from_flax_layout(apply(to_flax_layout(g), self.quant_block_size))
        return apply(g, self.quant_block_size)

    def resolved_chunk_bytes(self) -> List[int]:
        """The per-bucket chunk sizes in force: ``ADAPCC_RING_CHUNK_BYTES`` >
        the recorded plan's heuristic.  Needs a recorded plan."""
        if self._plan is None:
            raise ValueError(
                "no recorded bucket plan yet: resolved_chunk_bytes() reads the table the first "
                "schedule-plane sync records"
            )
        return [resolve_chunk_bytes(c) for c in self._plan.chunk_bytes]

    def reset_plan(self) -> None:
        """Drop the recorded bucket table (the model's structure changed)."""
        self._plan = None
        self.recorded_buckets = []

    def _record_plan(self, plan: BucketPlan, data_plane: str) -> None:
        """The bucket plan into the sinks, once a plan: counts and the byte
        histogram into the metrics registry; the table, with the resolved
        chunk sizes and the cost model's ``exposed_comm_s`` floor for the
        overlap schedule, as a ``grad_sync`` trace event."""
        metrics = self._metrics
        if metrics is None and self.communicator is not None:
            metrics = getattr(self.communicator, "metrics", None)
        trace = self._trace
        if trace is None and self.communicator is not None:
            trace = getattr(getattr(self.communicator, "engine", None), "trace", None)
        if metrics is not None:
            metrics.gauge("bucket_plan.num_buckets", plan.num_buckets)
            metrics.gauge("bucket_plan.total_bytes", plan.total_bytes)
            if plan.oversized_leaves:
                metrics.incr("bucket_plan.oversized_leaves", plan.oversized_leaves)
            for b in plan.bucket_bytes:
                # the byte histogram rides the timing reservoir (p50/p99)
                metrics.observe("bucket_plan.bucket_bytes", float(b))
        if trace is not None:
            from adapcc_tpu_torch.sim.calibrate import load_or_default
            from adapcc_tpu_torch.sim.cost_model import bottleneck_ring_coeffs, exposed_comm_floor_s

            world = self.strategy.world_size
            coeffs = bottleneck_ring_coeffs(load_or_default(world=world), world)
            wd = self.effective_compress()
            trace.record(
                "grad_sync", f"{data_plane}[{self.overlap}]", plan.total_bytes,
                buckets=plan.num_buckets,
                bucket_bytes=list(plan.bucket_bytes),
                plan_chunk_bytes=list(plan.chunk_bytes),
                chunk_bytes=self.resolved_chunk_bytes(),
                oversized_leaves=plan.oversized_leaves,
                overlap=self.overlap,
                wire_dtype=wd,
                exposed_comm_s=exposed_comm_floor_s(world, plan.total_bytes, coeffs, overlap=self.overlap,
                                                    bucket_bytes=plan.bucket_bytes, wire_dtype=wd),
            )

    def _bucket_plan(self, leaves: List[torch.Tensor], data_plane: str) -> BucketPlan:
        if self._plan is None:
            # the first sync records the bucket table (the reference's
            # step-0/1 record phase, commu.py:409-418)
            self._plan = build_bucket_plan(leaves, self.bucket_cap_mb)
            self.recorded_buckets = list(zip(self._plan.bucket_sizes, self._plan.chunk_bytes))
            self._record_plan(self._plan, data_plane)
        return self._plan

    def _rolling_sync(self, grads: List[torch.Tensor], active_mask: Optional[torch.Tensor],
                      transposed: Sequence[bool], order: Sequence[int], plane: str) -> List[torch.Tensor]:
        """The per-bucket rolling sync: every bucket's chunk collectives
        issued first, then bucket by bucket a wait and the copies of its
        leaves out, which run beside the later buckets' collectives."""
        leaves = [to_flax_layout(grads[i]) if transposed[i] else grads[i] for i in order]
        plan = self._bucket_plan(leaves, plane)
        pending = rolling_bucket_sync(flatten_to_buckets(plan, leaves), plan.chunk_bytes, active_mask,
                                      mode=plane, strategy=self.strategy, op=self.op)
        members: List[List[Tuple[int, int]]] = [[] for _ in pending]
        for j, i in enumerate(order):
            members[plan.leaf_bucket[j]].append((j, i))
        for b, handle in enumerate(pending):
            synced, off = handle.wait(), 0
            for j, i in members[b]:  # a bucket holds its leaves in leaf order
                shape = plan.leaf_shapes[j]
                leaf = synced[off:off + grads[i].numel()].view(shape)
                off += grads[i].numel()
                grads[i].copy_(from_flax_layout(leaf) if transposed[i] else leaf)
        return grads

    def _sync_impl(self, grads: List[torch.Tensor], active_mask: Optional[torch.Tensor],
                   transposed: Sequence[bool], order: Optional[Sequence[int]]) -> List[torch.Tensor]:
        plane = self._resolved_mode()
        if self.overlap == "bucket":
            return self._rolling_sync(grads, active_mask, transposed,
                                      range(len(grads)) if order is None else order, plane)
        if plane == "psum":
            if active_mask is None:
                return [engine.allreduce(g, self.op) for g in grads]
            return [engine.masked_psum_shard(g, active_mask, self.op) for g in grads]
        if active_mask is None:
            active_mask = torch.ones((self.strategy.world_size,), dtype=torch.bool)
        order = range(len(grads)) if order is None else order
        leaves = [to_flax_layout(grads[i]) if transposed[i] else grads[i] for i in order]
        plan = self._bucket_plan(leaves, plane)
        synced = [engine.allreduce_shard(b, active_mask, self.strategy, self.op)
                  for b in flatten_to_buckets(plan, leaves)]
        for i, leaf in zip(order, unflatten_from_buckets(plan, synced)):
            grads[i].copy_(from_flax_layout(leaf) if transposed[i] else leaf)
        return grads

    def sync(self, grads: List[torch.Tensor], active_mask: Optional[torch.Tensor],
             transposed: Optional[Sequence[bool]] = None,
             order: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """Allreduce each gradient tensor in place and return them.

        ``active_mask=None`` means statically full-world: a plain allreduce
        (AVG over the world).  With a mask, inactive ranks contribute zero
        and AVG divides by the active count.  Under ``bf16`` the collective
        runs on bfloat16 copies, cast back into the gradients; under ``int8``
        each contribution is replaced by its wire value first, quantized in
        the JAX leaf's layout where ``transposed[i]`` says gradient ``i`` is
        that leaf's transpose.  The schedule plane buckets the gradients as
        the JAX leaves: in ``order`` (indices into ``grads``; None = as
        given), each in the leaf's layout; so do ``overlap="bucket"``'s
        buckets on the psum plane.  A bucket's dtype is its leaves' promoted
        dtype; the results are cast back into the gradients.
        """
        transposed = transposed or [False] * len(grads)
        codec = self.effective_compress()
        if codec == "bf16":
            wire = [g.to(torch.bfloat16) for g in grads]
            for g, w in zip(grads, self._sync_impl(wire, active_mask, transposed, order)):
                g.copy_(w)
            return grads
        if codec != "off":
            for g, t in zip(grads, transposed):
                g.copy_(self._codec_apply(g, t))
        return self._sync_impl(grads, active_mask, transposed, order)

    def sync_error_feedback(
        self, grads: List[torch.Tensor], residual: List[torch.Tensor], active_mask: Optional[torch.Tensor],
        transposed: Optional[Sequence[bool]] = None, order: Optional[Sequence[int]] = None,
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Error-feedback sync: ``(synced, new_residual)``.  The wire carries
        ``codec(grads + residual)`` and each rank banks the difference, in
        float32, for the next step; the wire and the synced gradients keep
        each gradient's dtype (the residual absorbs the cast's error too).
        ``transposed`` and ``order`` as in :meth:`sync`."""
        transposed = transposed or [False] * len(grads)
        new_residual = []
        for g, r, t in zip(grads, residual, transposed):
            # g + r promotes to the float32 of the residual
            wire, kept = error_feedback_step(g, r, lambda c: self._codec_apply(c, t).to(g.dtype))
            new_residual.append(kept)
            g.copy_(wire)
        return self._sync_impl(grads, active_mask, transposed, order), new_residual

    def sync_deferred(
        self, grads: List[torch.Tensor], deferred: List[torch.Tensor], active_mask: torch.Tensor,
        transposed: Optional[Sequence[bool]] = None, order: Optional[Sequence[int]] = None,
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Async (non-BSP) relay sync: ``(synced, new_deferred)``.

        The reference's non-BSP mode replays a straggler's recorded buckets
        through relay ranks so its gradients still land (commu.py:160-170,
        427-431).  Here the replay is a per-rank bank: every rank's
        contribution is ``grads + deferred`` (each in the gradient's dtype);
        a rank masked out of this step banks that sum for its next active
        step, when the masked allreduce folds it into the average, and an
        active rank leaves with a cleared bank.  The bank is one tensor per
        gradient, in the gradient's layout; ``transposed`` and ``order`` as
        in :meth:`sync`.  This process's rank is its place in the default
        process group."""
        contrib = [g + d for g, d in zip(grads, deferred)]
        active = bool(active_mask[dist.get_rank()])
        # banked before the sync, which reduces the contributions in place
        new_deferred = [torch.zeros_like(c) if active else c.clone() for c in contrib]
        return self.sync(contrib, active_mask, transposed, order), new_deferred
