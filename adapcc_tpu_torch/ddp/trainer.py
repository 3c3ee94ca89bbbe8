"""DDP trainer: data-parallel train step with the adaptive gradient sync.

The port of :class:`adapcc_tpu.ddp.trainer.DDPTrainer`.  Each process holds
a replica of the model and its own batch shard; a step is forward, backward,
:meth:`GradSyncHook.sync` of the gradients, then the optimizer step, applied
identically on every rank (the reference's train_ddp.py:30-58 template).

Where the JAX trainer compiles one ``shard_map`` program over the global
batch and returns new state, the port runs eagerly in each process: ``step``
takes this rank's shard, updates the model and optimizer of the
:class:`TrainState` in place, and returns this rank's loss.

``sync_mode`` picks the hook's data plane: ``"psum"``, ``"schedule"`` (the
bucketed strategy-tree allreduce, gradients bucketed in the JAX package's
leaf order and layout, :meth:`DDPTrainer._flax_layout`) or ``"auto"``.
``grad_compress`` puts a wire codec on the gradient sync (the hook's
``compress``), and ``error_feedback=True`` threads this rank's float32
quantization residual from step to step (one tensor per parameter, in
``model.parameters()`` order).

A ``communicator`` with a coordinator (:meth:`Communicator.
enable_coordinator`) makes every step negotiate its active set (the hook's
``negotiate``), and the first step pushes the trainer's gradient volume into
the coordinator's rent-or-buy cost model.

``accum_steps`` splits each rank's batch into that many microbatches, one
forward and backward each, their gradients summed in float32 in microbatch
order and averaged (the JAX trainer's accumulation scan, run in sequence).
``overlap`` (:mod:`adapcc_tpu_torch.ddp.overlap`; ``ADAPCC_OVERLAP``
overrides) picks the sync schedule: ``"bucket"`` syncs bucket by bucket in
chunked collectives, in the JAX package's leaf order and layout on either
plane; ``"microbatch"`` syncs each microbatch's gradient on a side stream
while the next microbatch computes.

``tune=True`` (:mod:`adapcc_tpu_torch.tuner`) times each step to
completion into the tuning database under the executed cell (the hook's
wire codec × the overlap schedule), the first step of each new
configuration discarded as its warmup, and every ``tune_every`` steps lets
the policy re-choose the codec and the schedule, adopting a winner for the
next step.  ``ADAPCC_TUNER=off`` turns it off; ``record`` measures without
steering.

``bsp=False`` is the async relay mode: a rank masked out of a step banks
its gradients (the hook's ``sync_deferred``) and contributes them at its next
active step; it needs a dynamic mask, and refuses error feedback and
``overlap="microbatch"``.  ``attach_supervisor`` hands the step's mask to an
out-of-band supervisor, whose strategy swaps arrive through
``adopt_strategy``; ``prewarm`` builds a standby strategy's configuration
without touching the training state.

``zero1=True`` shards the optimizer state per rank (ZeRO-1 without the
ring): the hook still allreduces the gradients, on whichever plane it has;
each rank then takes its slice of the flat synced gradient in the JAX
package's flat layout (:mod:`adapcc_tpu_torch.parallel.fsdp`), updates its
``[N/world]`` float32 master row and its optimizer state, and one
``all_gather_into_tensor`` rebuilds the replicated parameters.  Rank
``r``'s master and moments are row ``r`` of the JAX trainer's ``[world,
N/world]`` state; the state comes from :meth:`DDPTrainer.init_state`.
``shard_replicas=k`` (``ADAPCC_SHARD_REPLICAS`` overrides) sends each
rank's rows to its ``k`` holders after every step, stamped with the state's
step (:mod:`adapcc_tpu_torch.elastic.redundancy`).  ``zero1_ring=True``
waits for the per-process ring.

``optax.adamw`` and ``torch.optim.AdamW`` differ in one default that
matters: optax decays weights by 1e-4, torch by 1e-2.  :func:`adamw` builds
the torch optimizer with optax's defaults; ``adamw(mu_dtype=torch.bfloat16)``
builds :class:`AdamW`, which follows optax's ``scale_by_adam`` order and
stores the first moment in ``mu_dtype``; so does a learning rate given as a
schedule (:func:`warmup_cosine_decay_schedule`, evaluated at the count of
updates before this one, so the first update of a warmup from 0 moves
nothing) or a ``clip_norm`` (optax's ``clip_by_global_norm`` ahead of it:
every gradient scaled by ``max_norm / norm`` when the global norm reaches
``max_norm``, with no epsilon, where ``clip_grad_norm_`` adds 1e-6).
:func:`adam` and :func:`sgd` are ``optax.adam`` and ``optax.sgd`` (with
momentum, optax's ``trace``) as torch optimizers.

``measure_gns=True`` (world ≥ 2) contrasts each rank's squared gradient
norm, averaged over the world, with the synced gradient's
(:func:`~adapcc_tpu_torch.measure.gns.ddp_grad_sq_norms`) at every
full-world step into a :class:`~adapcc_tpu_torch.measure.gns.GNSEstimator`
(``trainer.gns``).  A model's buffers (BatchNorm's running statistics),
which its loss updates in place, are always bound as
``TrainState.model_state`` by name (JAX's ``model_state`` collection), so
checkpoints carry them; JAX's ``stateful_loss`` flag, which changes its
loss's signature, changes nothing here and is accepted for its signature.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

import torch
import torch.distributed as dist
from torch import nn

from adapcc_tpu_torch.comm.mesh import World
from adapcc_tpu_torch.ddp.hook import GradSyncHook
from adapcc_tpu_torch.ddp.overlap import OVERLAP_ENV, microbatch_pipelined_sync, resolve_overlap_mode
from adapcc_tpu_torch.measure.gns import GNSEstimator, tree_sq_norm
from adapcc_tpu_torch.models.convert import flax_paths
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.primitives import not_ported as _not_ported
from adapcc_tpu_torch.quant.codec import WIRE_DTYPE_ENV
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.tuner import CollectiveTuner
from adapcc_tpu_torch.tuner.measure import sync_device, sync_outputs
from adapcc_tpu_torch.tuner.policy import NO_CHUNK, hook_overlap_of, hook_path

if TYPE_CHECKING:
    from adapcc_tpu_torch.elastic.redundancy import ShardReplicaStore
    from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer

Optimizer = torch.optim.Optimizer
OptimizerFactory = Callable[[Iterable[nn.Parameter]], Optimizer]


Schedule = Callable[[int], float]


@dataclass(frozen=True)
class WarmupCosineDecay:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (warmup included), in float32 as optax
    computes it."""

    init_value: float
    peak_value: float
    warmup_steps: int
    decay_steps: int
    end_value: float = 0.0
    exponent: float = 1.0

    def __call__(self, count: int) -> float:
        f32 = np.float32
        if count < self.warmup_steps:
            frac = f32(1) - f32(count) / f32(self.warmup_steps)
            return float(f32(self.init_value - self.peak_value) * frac + f32(self.peak_value))
        t = min(count - self.warmup_steps, self.decay_steps - self.warmup_steps)
        alpha = f32(0.0 if self.peak_value == 0.0 else self.end_value / self.peak_value)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * f32(t) / f32(self.decay_steps - self.warmup_steps)))
        decayed = (f32(1) - alpha) * cosine ** f32(self.exponent) + alpha
        return float(f32(self.peak_value) * decayed)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0, exponent: float = 1.0) -> WarmupCosineDecay:
    """``optax.warmup_cosine_decay_schedule``: a learning rate a count of
    updates."""
    return WarmupCosineDecay(init_value, peak_value, warmup_steps, decay_steps, end_value, exponent)


def adamw(
    learning_rate: Union[float, Schedule],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    mu_dtype: Optional[torch.dtype] = None,
    clip_norm: Optional[float] = None,
) -> OptimizerFactory:
    """``optax.adamw`` with its defaults, as a factory of torch AdamW; with
    ``mu_dtype``, a schedule for ``learning_rate`` or ``clip_norm``, of
    :class:`AdamW` (optax's order; the first moment stored in ``mu_dtype``,
    else in the parameter's dtype; ``clip_norm`` optax's
    ``clip_by_global_norm`` chained in front)."""

    def make(params: Iterable[nn.Parameter]) -> Optimizer:
        if mu_dtype is not None or callable(learning_rate) or clip_norm is not None:
            return AdamW(params, learning_rate, b1, b2, eps, weight_decay, mu_dtype, clip_norm)
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay
        )

    return make


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> OptimizerFactory:
    """``optax.adam`` with its defaults, as a factory of torch Adam."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps)


def sgd(learning_rate: float, momentum: Optional[float] = None) -> OptimizerFactory:
    """``optax.sgd``: with ``momentum``, optax's ``trace`` (``t = g +
    momentum·t``, the first trace the gradient itself, torch's buffer)."""
    return lambda params: torch.optim.SGD(params, lr=learning_rate, momentum=momentum or 0.0)


class AdamW(torch.optim.Optimizer):
    """``optax.adamw(mu_dtype=...)`` operation for operation, as
    ``scale_by_adam``, ``add_decayed_weights`` and ``scale_by_learning_rate``
    chain it: ``mu = (1 - b1)·g + b1·mu`` (``b1·mu`` in the stored dtype,
    ``b1`` rounded to it first, as JAX multiplies by a weak scalar), ``nu = (1 - b2)·g² + b2·nu``, the
    bias-corrected update from that ``mu`` and ``nu``, then ``mu`` cast to
    ``mu_dtype`` for storage; ``p + (-lr)·(update + wd·p)``.  The state keys
    are ``torch.optim.AdamW``'s (``step``, ``exp_avg``, ``exp_avg_sq``), so
    checkpoints and the converters read both alike."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 mu_dtype: Optional[torch.dtype] = torch.bfloat16, clip_norm: Optional[float] = None) -> None:
        #: the learning rate a count of updates (None: the groups' ``lr``)
        self.schedule: Optional[Schedule] = lr if callable(lr) else None
        self.clip_norm = clip_norm
        super().__init__(params, dict(lr=0.0 if callable(lr) else lr, betas=(b1, b2), eps=eps,
                                      weight_decay=weight_decay, mu_dtype=mu_dtype))

    def _clip_scale(self) -> Optional[torch.Tensor]:
        """optax's ``clip_by_global_norm``: the global norm over every
        gradient, or None below ``clip_norm``."""
        if self.clip_norm is None:
            return None
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        return norm if bool(norm >= self.clip_norm) else None

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        norm = self._clip_scale()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=group["mu_dtype"])
                    st["exp_avg_sq"] = torch.zeros_like(p)
                g = p.grad
                if norm is not None:
                    g = (g / norm.to(g.dtype)) * self.clip_norm
                lr = group["lr"] if self.schedule is None else self.schedule(int(st["step"]))
                # optax's operations in its order, each rounded once; in
                # place where a temporary would be the size of p.  JAX casts
                # the weak scalar b1 to mu's dtype before the product
                mu = g * (1 - b1)
                mu.add_(st["exp_avg"] * torch.tensor(b1, dtype=st["exp_avg"].dtype))
                g2 = g * g
                nu = st["exp_avg_sq"].mul_(b2).add_(g2.mul_(1 - b2))
                del g2
                st["step"] += 1
                count = torch.tensor(int(st["step"]), dtype=torch.int32)
                bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** count).to(device=p.device, dtype=mu.dtype)
                bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** count).to(device=p.device, dtype=nu.dtype)
                update = torch.div(nu, bc2).sqrt_().add_(group["eps"])
                update = torch.div(mu, bc1).div_(update)
                update.add_(p * group["weight_decay"]).mul_(-lr)
                p.add_(update.to(p.dtype))
                del update
                st["exp_avg"] = mu.to(group["mu_dtype"] or p.dtype)
        return None

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, which casts every
        floating state tensor to its parameter's dtype, then the first
        moment back to ``mu_dtype`` (exact: its values came from there)."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p)
                if st and "exp_avg" in st:
                    st["exp_avg"] = st["exp_avg"].to(group["mu_dtype"] or p.dtype)


@dataclass
class TrainState:
    """The model replica, its optimizer and the step count (updated in place)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    #: ZeRO-1 (``DDPTrainer(zero1=True).init_state``): this rank's float32
    #: ``[N/world]`` master row, the one tensor ``optimizer`` updates
    master: Optional[torch.Tensor] = None
    #: the model's buffers by name (BatchNorm's running statistics: JAX's
    #: ``model_state``), the module's own tensors, which a stateful loss
    #: updates in place; empty for a model without buffers
    model_state: Dict[str, torch.Tensor] = field(default_factory=dict)

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerFactory,
               model_state: Optional[Dict[str, torch.Tensor]] = None) -> "TrainState":
        return cls(model=model, optimizer=tx(model.parameters()), step=0,
                   model_state=bind_model_state(model, model_state))


@torch.no_grad()
def bind_model_state(model: nn.Module, model_state: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The model's buffers by name, after copying ``model_state`` (a
    checkpoint's, JAX's ``model_state``) into them when given."""
    buffers = dict(model.named_buffers())
    if model_state:
        if sorted(model_state) != sorted(buffers):
            raise ValueError(f"model_state {sorted(model_state)} does not match the model's buffers "
                             f"{sorted(buffers)}")
        for name, value in model_state.items():
            if value is not buffers[name]:
                buffers[name].copy_(value)
    return buffers


def _first_leaf(batch: Any) -> torch.Tensor:
    """The first tensor of a batch (alone, or in a tuple, list or dict)."""
    while isinstance(batch, (tuple, list, dict)):
        batch = next(iter(batch.values())) if isinstance(batch, dict) else batch[0]
    return batch


class DDPTrainer:
    """``loss_fn(model, batch) -> scalar`` is evaluated per rank on that
    rank's batch shard; gradient sync and the optimizer step are the
    trainer's business."""

    def __init__(
        self,
        loss_fn: Callable[[nn.Module, Any], torch.Tensor],
        tx: OptimizerFactory,
        mesh: World,
        strategy: Strategy,
        use_xla_fastpath: bool = True,
        communicator: Optional[Any] = None,
        sync_mode: str = "auto",
        measure_gns: bool = False,
        bsp: bool = True,
        # let step() take a runtime active mask even without a coordinator
        # (workloads injecting their own skew signal; tests)
        dynamic_mask: Optional[bool] = None,
        accum_steps: int = 1,
        zero1: bool = False,
        zero1_ring: bool = False,
        shard_replicas: Optional[int] = None,
        grad_compress: str = "off",
        error_feedback: bool = False,
        tune: bool = False,
        overlap: str = "off",
        tuner: Optional[CollectiveTuner] = None,
        tune_every: int = 16,
        stateful_loss: bool = False,  # JAX's signature; the buffers are always bound
    ) -> None:
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if error_feedback and not bsp:
            raise ValueError(
                "error_feedback=True requires BSP mode: the async relay bank already defers "
                "gradient mass, and the quantization residual on top would carry it twice"
            )
        self.accum_steps = accum_steps
        self.overlap = resolve_overlap_mode(overlap)
        if self.overlap == "microbatch":
            # guard rails of the pipelined accumulation: each combination
            # below would silently change what a step computes
            if accum_steps < 2:
                raise ValueError(
                    "overlap='microbatch' needs accum_steps >= 2: with one microbatch there is no "
                    "later compute to hide the sync behind (use overlap='bucket')"
                )
            if not bsp:
                raise ValueError(
                    "overlap='microbatch' requires BSP mode: the async relay's deferred bank folds "
                    "into ONE sync per step, which the per-microbatch pipeline would re-sync accum times"
                )
            if error_feedback:
                raise ValueError(
                    "overlap='microbatch' with error_feedback=True would apply the codec (and bank "
                    "its residual) per microbatch delta — a different quantization loop than the one "
                    "the residual compensates; use overlap='bucket' (residual threads unchanged) or "
                    "drop error_feedback"
                )
            if measure_gns:
                raise ValueError(
                    "overlap='microbatch' never materializes the unsynced accumulated gradient the "
                    "GNS estimator contrasts; use overlap='bucket' or drop measure_gns"
                )
        self.zero1 = zero1
        if zero1_ring and not zero1:
            raise ValueError("zero1_ring=True requires zero1=True")
        if zero1_ring:
            raise _not_ported(
                "ZeRO-1 on the ring in DDPTrainer (one process per card)",
                "the per-process ring slice (IPC peer tables, one process per card); zero1=True without the "
                "ring runs, and the single-controller ZeRO-1 ring step is "
                "adapcc_tpu_torch.parallel.fsdp.zero1_train_step",
            )
        from adapcc_tpu_torch.elastic.redundancy import shard_replicas as _shard_replicas

        # env > explicit arg > off, resolved now so a malformed env dies here
        self.shard_replicas = _shard_replicas(default=0 if shard_replicas is None else int(shard_replicas))
        if self.shard_replicas and not zero1:
            raise ValueError(
                "shard_replicas > 0 requires zero1=True: replicated DDP state has no single-owner "
                "optimizer shard to replicate (every rank already holds everything)"
            )
        #: the replica set (built at init_state when armed)
        self.replica_store: Optional[ShardReplicaStore] = None
        #: the ZeRO-1 optimizer geometry (built at init_state)
        self._zero1_opt: Optional[Zero1Optimizer] = None
        if measure_gns and mesh.world_size < 2:
            raise ValueError(
                "measure_gns needs a multi-device mesh: the estimator contrasts "
                "per-rank (small-batch) vs allreduced (big-batch) gradients"
            )
        self.measure_gns = measure_gns
        self._gns: Optional[GNSEstimator] = None
        self._gns_pending: List[torch.Tensor] = []
        #: this step's local squared gradient norm (measure_gns)
        self._gns_local: Optional[torch.Tensor] = None
        #: async relay: the bank holds a missed step's gradients
        self._bank_dirty = False
        if strategy.world_size != mesh.world_size:
            raise ValueError(
                f"strategy for {strategy.world_size} ranks on a world of {mesh.world_size}"
            )
        self.loss_fn = loss_fn
        self.tx = tx
        self.mesh = mesh
        self.hook = GradSyncHook(
            strategy,
            op=ReduceOp.AVG,
            use_xla_fastpath=use_xla_fastpath,
            communicator=communicator,
            mode=sync_mode,
            compress=grad_compress,
            error_feedback=error_feedback,
            overlap=self.overlap,
        )
        if error_feedback and self.hook.effective_compress() == "off":
            # the residual of a no-op codec is zero, but the bank would still
            # hold a float32 copy of every parameter
            raise ValueError(
                "error_feedback=True with an 'off' wire codec banks an identically-zero "
                "residual; pass grad_compress='int8' (or 'strategy' / set ADAPCC_WIRE_DTYPE) "
                "or drop error_feedback"
            )
        self.error_feedback = error_feedback
        #: this rank's error-feedback bank: one float32 tensor per parameter
        #: (created at the first step), replaced every step
        self._residual: Optional[List[torch.Tensor]] = None
        self.bsp = bsp
        #: the async relay's bank (``bsp=False``): one tensor per parameter in
        #: its dtype (created at the first step), replaced every step
        self._deferred: Optional[List[torch.Tensor]] = None
        #: an attached out-of-band supervisor (:meth:`attach_supervisor`)
        self._supervisor: Optional[Any] = None
        # a coordinator-attached or async-relay trainer takes a mask every step
        self._dynamic_mask = (bool(dynamic_mask) if dynamic_mask is not None
                              else communicator is not None or not bsp)
        if not bsp and not self._dynamic_mask:
            raise ValueError("async relay (bsp=False) needs a runtime active mask")
        if communicator is not None and not self._dynamic_mask:
            raise ValueError(
                "a coordinator-attached trainer must run a dynamic-mask step: "
                "dynamic_mask=False would silently discard the negotiated active set"
            )
        self._coord_calibrated = False
        self._host_step = 0
        # the overlap schedules this trainer can run (the tuner's ddp_step
        # grid is narrowed to these)
        modes = ["off", "bucket"]
        if accum_steps >= 2 and bsp and not error_feedback and not measure_gns:
            modes.append("microbatch")
        self._overlap_modes = tuple(modes)
        # -- tuning: an attached communicator's tuner is reused, so engine
        # dispatches and step times share one database
        if tune_every < 1:
            raise ValueError(f"tune_every must be >= 1, got {tune_every}")
        self.tune_every = tune_every
        if tune and tuner is None:
            tuner = getattr(communicator, "tuner", None)
        if tune and tuner is None:
            tuner = CollectiveTuner.for_mesh(mesh)
        if tune and tuner.explicit_mode is None:
            # tune=True is an explicit opt-in: with ADAPCC_TUNER unset the
            # tuner chooses; a caller's explicit mode stands, and the env
            # overrides either
            tuner = tuner.with_mode("choose")
        self.tune = tune
        self.tuner = tuner if tune else None
        self._grad_bytes: Optional[int] = None
        #: configurations stepped so far (strategy, codec, overlap); a new
        #: one is a new build generation, whose first step pays the
        #: kernels' build and first launches and is not recorded
        self._built: set = set()
        self._build_gen = 0

    @staticmethod
    def _transposed(model: nn.Module) -> List[bool]:
        """Per parameter: a ``Linear`` or ``Conv2d`` weight, the JAX
        package's ``Dense`` or ``Conv`` kernel in another layout, whose
        layout the codec's blocks follow."""
        paths = flax_paths(model)
        return [paths[name][1] for name, _ in model.named_parameters()]

    @staticmethod
    def _flax_layout(model: nn.Module) -> Tuple[List[int], List[bool]]:
        """``(order, transposed)``: the parameters' indices in the flax
        tree's leaf order (paths sorted, as ``jax.tree_util`` sorts dict
        keys) and, per parameter, whether its flax leaf is its transpose.
        The schedule plane's buckets are positional, so they follow it."""
        paths = flax_paths(model)
        names = [name for name, _ in model.named_parameters()]
        order = sorted(range(len(names)), key=lambda i: paths[names[i]][0])
        return order, [paths[name][1] for name in names]

    def _grads(self, model: nn.Module) -> List[torch.Tensor]:
        """Every parameter's gradient; an unused parameter gets zeros, as
        ``jax.grad`` gives it (the optimizer then still decays it)."""
        grads = []
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        return grads

    def _sync_layout(self, model: nn.Module) -> Tuple[Optional[List[int]], Optional[List[bool]]]:
        """``(order, transposed)`` for the hook: the flax leaf order and
        layout wherever the sync buckets (the schedule plane, or
        ``overlap="bucket"`` on either plane), else the layout the codec's
        blocks follow (None without a codec)."""
        if self.hook._resolved_mode() == "schedule" or self.hook.overlap == "bucket":
            return self._flax_layout(model)
        return None, None if self.hook.effective_compress() == "off" else self._transposed(model)

    def _to_microbatches(self, batch: Any) -> List[Any]:
        """The ``accum_steps`` microbatches of ``batch``: each ``[B, ...]``
        tensor (alone or in a tuple, list or dict) split into ``B/accum``-row
        slices, in order."""
        accum = self.accum_steps

        def split(x: Any) -> List[Any]:
            if isinstance(x, dict):
                parts = {k: split(v) for k, v in x.items()}
                return [{k: v[i] for k, v in parts.items()} for i in range(accum)]
            if isinstance(x, (tuple, list)):
                parts = [split(v) for v in x]
                return [type(x)(p[i] for p in parts) for i in range(accum)]
            b = x.shape[0]
            if b % accum:
                raise ValueError(f"per-rank batch {b} not divisible by accum_steps {accum}")
            return list(x.reshape((accum, b // accum) + tuple(x.shape[1:])))

        return split(batch)

    def _delta(self, model: nn.Module, mb: Any) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One microbatch's ``(loss, gradients)``, the gradients detached
        from the parameters so the next backward writes new tensors."""
        model.zero_grad(set_to_none=True)
        loss = self.loss_fn(model, mb)
        loss.backward()
        grads = self._grads(model)
        model.zero_grad(set_to_none=True)
        return loss.detach(), grads

    def _value_and_grad(self, model: nn.Module, batch: Any) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """This rank's loss and gradients (in each ``p.grad``), accumulated
        over ``accum_steps`` microbatches when above 1: gradients summed in
        float32 in microbatch order from zeros, divided by ``accum`` and cast
        to each parameter's dtype; the loss the float32 sum over ``accum``
        (the JAX trainer's scan, in sequence)."""
        loss, grads = self._accumulate(model, batch)
        if self.measure_gns:
            self._gns_local = tree_sq_norm(grads)
        return loss, grads

    def _accumulate(self, model: nn.Module, batch: Any) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        accum = self.accum_steps
        if accum == 1:
            model.zero_grad(set_to_none=True)
            loss = self.loss_fn(model, batch)
            loss.backward()
            return loss.detach(), self._grads(model)
        params = list(model.parameters())
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for mb in self._to_microbatches(batch):
            loss, grads = self._delta(model, mb)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_sum = loss_sum + loss.to(torch.float32)
        for p, a in zip(params, acc):
            p.grad = (a / accum).to(p.dtype)
        return loss_sum / accum, [p.grad for p in params]

    def _loss_and_synced(self, model: nn.Module, batch: Any, active_mask, order, transposed
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """This rank's loss and synced gradients (left in each ``p.grad``)
        on the plain sync paths: accumulate, then sync; or under
        ``overlap="microbatch"`` the pipelined accumulation."""
        if self.overlap != "microbatch":
            loss, grads = self._value_and_grad(model, batch)
            return loss, self.hook.sync(grads, active_mask, transposed, order)
        loss, synced = microbatch_pipelined_sync(
            lambda mb: self._delta(model, mb),
            self._to_microbatches(batch),
            lambda g: self.hook.sync(g, active_mask, transposed, order),
            self.accum_steps,
        )
        for p, g in zip(model.parameters(), synced):
            p.grad = g
        return loss, synced

    def _step(self, state: TrainState, batch: Any, active_mask) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        order, transposed = self._sync_layout(state.model)
        if self.error_feedback:
            loss, grads = self._value_and_grad(state.model, batch)
            if self._residual is None:
                # float32 whatever the parameter dtype: a narrow bank would
                # lose the very mass it defers
                self._residual = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
            synced, self._residual = self.hook.sync_error_feedback(grads, self._residual, active_mask, transposed,
                                                                   order)
        elif not self.bsp:
            loss, grads = self._value_and_grad(state.model, batch)
            if self._deferred is None:
                self._deferred = [torch.zeros_like(g) for g in grads]
            synced, self._deferred = self.hook.sync_deferred(grads, self._deferred, active_mask, transposed, order)
            for g, s in zip(grads, synced):
                g.copy_(s)
        else:
            loss, synced = self._loss_and_synced(state.model, batch, active_mask, order, transposed)
        if self.measure_gns:
            self._record_gns(batch, synced, active_mask)
        self._apply_synced(state, synced)
        return loss

    # -- gradient noise scale ----------------------------------------------------

    def _record_gns(self, batch: Any, synced: List[torch.Tensor], active_mask) -> None:
        """JAX's ``_record_gns``: this step's ``(E|G_b|², |G_B|²)`` (the AVG
        all-reduce runs every step, a collective) kept for the estimator
        when every rank contributed; in async relay mode the first step after
        a miss is skipped too (its synced gradient folds in banked ones)."""
        small = self._gns_local
        world = self.mesh.world_size
        dist.all_reduce(small)
        norms = torch.stack([small / world, tree_sq_norm(synced)])
        if self._gns is None:
            b_small = _first_leaf(batch).shape[0]
            self._gns = GNSEstimator(b_small=b_small, b_big=b_small * world)
        full = active_mask is None or bool(torch.as_tensor(active_mask).all())
        contaminated = (not self.bsp) and self._bank_dirty
        if not self.bsp:
            self._bank_dirty = not full
        if full and not contaminated:
            self._gns_pending.append(norms.detach())
            # bound retained device buffers on runs that never read `gns`
            if len(self._gns_pending) > 256:
                self._flush_gns()

    def _flush_gns(self) -> None:
        if self._gns is not None and self._gns_pending:
            pending, self._gns_pending = self._gns_pending, []
            for small, big in torch.stack(pending).cpu().tolist():
                self._gns.update(small, big)

    @property
    def gns(self) -> Optional[GNSEstimator]:
        """The GNS estimator (flushes buffered per-step norms on access)."""
        self._flush_gns()
        return self._gns

    # -- ZeRO-1 --------------------------------------------------------------------

    def _zero1_overlap(self) -> str:
        """The ZeRO-1 all-gather's schedule the trainer's overlap implies:
        any overlapped trainer schedule chunks it too."""
        return "bucket" if self.overlap != "off" else "off"

    def init_state(self, model: nn.Module, model_state: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """The trainer's state: the replicated optimizer normally; with
        ``zero1=True`` this rank's float32 master row of the flat layout and
        the optimizer over it alone (row ``rank`` of the JAX trainer's
        ``[world, N/world]`` state), and, with ``shard_replicas``, the
        replica set.  ``model_state`` (a checkpoint's) is copied into the
        model's buffers, which the state then holds."""
        if not self.zero1:
            return TrainState.create(model, self.tx, model_state)
        from adapcc_tpu_torch.elastic.redundancy import ShardReplicaStore
        from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer

        world = self.mesh.world_size
        opt = self._zero1_opt = Zero1Optimizer(self.tx, world, tuner=self.tuner, overlap=self._zero1_overlap())
        master, optimizer = opt.init_row(model, self.mesh.rank)
        if self.shard_replicas:
            self.replica_store = ShardReplicaStore(world, ips=self.hook.strategy.trees[0].ips,
                                                   replicas=self.shard_replicas)
        return TrainState(model=model, optimizer=optimizer, step=0, master=master,
                          model_state=bind_model_state(model, model_state))

    def checkpoint_extra(self, extra: Optional[dict] = None) -> dict:
        """A checkpoint's ``extra`` for this trainer's state: with
        ``zero1=True`` stamped with the optimizer's layout tag, which the
        checkpoint's layout guard enforces on every load."""
        if not self.zero1:
            return dict(extra or {})
        if self._zero1_opt is None:
            raise ValueError(
                "call init_state(model) before checkpoint_extra(): the layout tag records the constructed "
                "optimizer's geometry"
            )
        return self._zero1_opt.checkpoint_extra(extra)

    def _check_state(self, state: TrainState) -> None:
        """Catch the common ZeRO-1 misuse (``TrainState.create``'s replicated
        optimizer) before it fails deeper in."""
        if not self.zero1:
            return
        opt = self._zero1_opt
        row = state.master
        ok = (opt is not None and opt._meta is not None and isinstance(row, torch.Tensor) and row.dim() == 1
              and row.numel() * opt.world == opt._meta.padded)
        if not ok:
            raise ValueError(
                "zero1=True needs the sharded (master row [N/world], optimizer over it) state from "
                "trainer.init_state(model) — got a replicated optimizer state (TrainState.create?)"
            )

    @torch.no_grad()
    def _apply_synced(self, state: TrainState, synced: List[torch.Tensor]) -> None:
        """The optimizer tail of every step.  ZeRO-1: every rank holds the
        same synced gradient, so its slice of the flat gradient is a local
        read; the update touches only its row and one all-gather rebuilds
        the replicated parameters.  After it, with replicas armed, this
        rank's rows go to their holders stamped with the state's step."""
        if not self.zero1:
            state.optimizer.step()
            state.step += 1
            return
        from adapcc_tpu_torch.parallel.fsdp import _flatten, local_grad_shard
        from adapcc_tpu_torch.parallel.zero1_rank import zero1_apply_shard_rank

        opt = self._zero1_opt
        meta, world = opt._meta, opt.world
        names = [name for name, _ in state.model.named_parameters()]
        flat_g = _flatten(dict(zip(names, synced)), meta)
        g_row = local_grad_shard(flat_g, meta, world, self.mesh.rank)
        state.model.zero_grad(set_to_none=True)
        zero1_apply_shard_rank(state.optimizer, state.master, g_row, meta, state.model,
                               overlap_chunks=opt.overlap_chunks(meta.padded // world))
        del flat_g, g_row
        state.step += 1
        if self.replica_store is not None:
            self.replica_store.exchange(state.master, state.optimizer, state.step, self.mesh.rank)

    def step(
        self,
        state: TrainState,
        batch: Any,
        step_idx: Optional[int] = None,
        active_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, torch.Tensor]:
        """One training step on this rank's batch shard.  Returns
        ``(state, loss)``: the state updated in place, this rank's loss.

        ``active_mask`` (``[world]`` bools) sets the ranks whose gradients
        count this step; it needs a ``dynamic_mask=True`` trainer.
        """
        self._check_state(state)
        if not self._coord_calibrated:
            # rent-or-buy calibration: this trainer's gradient volume and the
            # bootstrap's profiled link bandwidth replace the coordinator's
            # default cost constants; latched on success (False: no server in
            # this process yet, or no profile), so a later step retries
            comm = self.hook.communicator
            if comm is None:
                self._coord_calibrated = True
            else:
                grad_bytes = sum(p.numel() * p.element_size() for p in state.model.parameters())
                self._coord_calibrated = comm.calibrate_coordinator(float(grad_bytes))
        idx = self._host_step if step_idx is None else step_idx
        self._host_step = idx + 1
        if active_mask is not None and not self._dynamic_mask:
            raise ValueError(
                "this trainer runs a static full-world step; pass "
                "dynamic_mask=True to drive explicit active masks"
            )
        if active_mask is None and self._supervisor is not None:
            # supervised: the daemon owns detect → decide → swap, and the step
            # takes the mask of its last actuated view
            active_mask = torch.as_tensor(self._supervisor.current_mask(), dtype=torch.bool)
        if self._dynamic_mask and active_mask is None:
            active_mask = self.hook.negotiate(idx)
        key = self._program_key()
        if key not in self._built:
            self._built.add(key)
            self._build_gen += 1
        if not self._tuning():
            return state, self._step(state, batch, active_mask)
        sync_device(next(state.model.parameters()).device)
        t0 = time.perf_counter()
        loss = self._step(state, batch, active_mask)
        sync_outputs(loss)
        self._tune_observe(state, time.perf_counter() - t0)
        return state, loss

    # -- tuning ------------------------------------------------------------------

    def _tuning(self) -> bool:
        """Per-step tuning is live: ``tune=True`` and a tuner that records
        (``ADAPCC_TUNER=off`` turns it off everywhere)."""
        return self.tune and self.tuner is not None and self.tuner.recording

    def _program_key(self, strategy: Optional[Strategy] = None) -> tuple:
        """What a step's configuration is: the strategy, the wire codec and
        the overlap schedule (the JAX trainer's compiled-step key)."""
        s = strategy if strategy is not None else self.hook.strategy
        return (s.fingerprint(), self.hook.effective_compress(), self.overlap)

    # -- strategy swaps: re-synthesis and elastic failover ------------------------

    def rebuild(self, strategy: Strategy) -> None:
        """Swap in a new strategy for the next step (the bucket plan is
        recorded again at its first sync).  A configuration already built
        (stepped or prewarmed) starts no new build generation."""
        self.hook.strategy = strategy
        self.hook.reset_plan()

    @property
    def recompiles(self) -> int:
        """Build generations so far: configurations stepped or prewarmed
        (the JAX trainer's count of compiled step programs).  A failover
        onto a prewarmed strategy must not move it."""
        return self._build_gen

    def prewarm(self, strategy: Strategy, state: TrainState, batch: Any = None,
                active_mask: Optional[torch.Tensor] = None) -> bool:
        """Build what a step under the standby ``strategy`` keys on, so a
        later :meth:`adopt_strategy` is a switch with nothing derived on the
        failover step: the configuration's build generation, the hook's
        bucket plan and the schedule plane's merged plan for the standby
        strategy on the real gradient shapes.  It syncs zeros shaped like
        the gradients through the hook (a collective: every rank calls it,
        as it calls ``step``), never through the optimizer, so the model,
        the optimizer's state and the deferred and residual banks are left
        bit for bit as they were (the JAX trainer's throwaway step would
        update the port's state in place).  ``batch`` is taken for the JAX
        trainer's signature; the shapes are the parameters'.  Returns False
        when the configuration was already built."""
        saved = self.hook.strategy
        # the key resolves under the swapped strategy: a "strategy" codec is
        # the standby's
        self.hook.strategy = strategy
        try:
            key = self._program_key()
            if key in self._built:
                return False
            if self._dynamic_mask and active_mask is None:
                active_mask = torch.ones((strategy.world_size,), dtype=torch.bool)
            order, transposed = self._sync_layout(state.model)
            zeros = [torch.zeros_like(p) for p in state.model.parameters()]
            self.hook.sync(zeros, active_mask, transposed, order)
            self._built.add(key)
            self._build_gen += 1
        finally:
            self.hook.strategy = saved
        return True

    def attach_supervisor(self, supervisor) -> "DDPTrainer":
        """Hand membership to an out-of-band
        :class:`~adapcc_tpu_torch.supervisor.Supervisor`: every ``step``
        without an explicit ``active_mask`` takes its last actuated mask,
        and its strategy swaps arrive through :meth:`adopt_strategy`.  Needs
        a dynamic-mask trainer."""
        if supervisor is not None and not self._dynamic_mask:
            raise ValueError(
                "a supervised trainer needs dynamic_mask=True: the supervisor's world changes arrive as "
                "runtime masks, and a static full-world step could not shrink without a retrace"
            )
        self._supervisor = supervisor
        return self

    def adopt_strategy(self, strategy: Strategy) -> bool:
        """Hot-swap the step onto ``strategy``: True when its configuration
        was already built (stepped or prewarmed), False when the next step
        builds it."""
        self.rebuild(strategy)
        return self._program_key() in self._built

    def _step_cell(self, grad_bytes: int):
        """The database cell the current configuration's step times pool
        under: the hook's wire codec × the overlap schedule (``hook_path``),
        inside ``TuningPolicy.candidates("ddp_step")`` narrowed to this
        trainer's schedules."""
        return self.tuner.key_for("ddp_step", grad_bytes, hook_path(self.overlap), NO_CHUNK,
                                  self.hook.effective_compress())

    def _tune_observe(self, state: TrainState, seconds: float) -> None:
        """Record one step's walltime; every ``tune_every`` steps let the
        policy re-choose the codec and the overlap schedule, and adopt a
        winner for the next step (the policy's hysteresis keeps that rare).
        The steps of every cell share one compute, so their medians
        compare."""
        if self._grad_bytes is None:
            self._grad_bytes = sum(p.numel() * p.element_size() for p in state.model.parameters())
        grad_bytes = self._grad_bytes
        self.tuner.observe_dispatch(self._step_cell(grad_bytes), ("ddp_step", self._build_gen), seconds)
        if not self.tuner.choosing or self._host_step % self.tune_every:
            return
        if os.environ.get(WIRE_DTYPE_ENV, "").strip():
            # the env pins the executed codec: keep measuring the pinned
            # cell, never adopt
            return
        # error feedback cannot run the 'off' codec: keep it out of the
        # grid, or the explorer pins on a cell that never gets samples
        wire_dtypes = (tuple(w for w in self.tuner.policy.wire_dtypes if w != "off")
                       if self.error_feedback else None)
        # an ADAPCC_OVERLAP pin collapses the overlap axis the same way
        overlap_modes = (self.overlap,) if os.environ.get(OVERLAP_ENV, "").strip() else self._overlap_modes
        plan = self.tuner.choose("ddp_step", grad_bytes, wire_dtypes=wire_dtypes, overlap_modes=overlap_modes)
        wd, ov = plan.wire_dtype, hook_overlap_of(plan.key.path)
        if wd == self.hook.effective_compress() and ov == self.overlap:
            return
        self.hook.compress = wd
        self.overlap = self.hook.overlap = ov
        self.hook.reset_plan()

    def scan_steps(self, state: TrainState, batch: Any, n_steps: int) -> Tuple[TrainState, torch.Tensor]:
        """``n_steps`` full-world steps on one batch; returns ``(state,
        losses [n_steps])`` for this rank.  Static full world only, as in
        the reference."""
        if self._dynamic_mask or self.measure_gns:
            raise ValueError(
                "scan_steps runs a static full-world program: incompatible "
                "with dynamic_mask, async relay (bsp=False), and measure_gns"
            )
        if self.error_feedback:
            raise ValueError(
                "scan_steps does not thread the error-feedback residual across scanned steps; "
                "use step() with error_feedback=True"
            )
        self._check_state(state)
        losses = [self._step(state, batch, None) for _ in range(n_steps)]
        self._host_step += n_steps
        return state, torch.stack(losses)
