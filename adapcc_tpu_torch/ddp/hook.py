"""Gradient-sync hook: the port of :class:`adapcc_tpu.ddp.hook.GradSyncHook`.

The reference's torch-DDP comm hook negotiates the step's active set with
the coordinator, then runs the adaptive allreduce per gradient bucket with
AVG semantics over the active ranks (commu.py:385-435).  The port keeps the
two halves of the JAX hook:

- **host half** (:meth:`GradSyncHook.negotiate`): the step's ``[world]``
  active mask; without a coordinator everyone is active.
- **device half** (:meth:`GradSyncHook.sync`): allreduce the gradients with
  the mask.  This slice ports the ``"psum"`` data plane (one collective per
  gradient tensor, subset semantics by masking), which is what a strategy on
  one host group resolves to.  The bucketed ``"schedule"`` plane, the wire
  codecs, overlapped sync and error feedback come in later slices and raise
  here.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from adapcc_tpu_torch.comm import engine
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.primitives import not_ported as _not_ported
from adapcc_tpu_torch.strategy.ir import Strategy


class GradSyncHook:
    def __init__(
        self,
        strategy: Strategy,
        op: ReduceOp = ReduceOp.AVG,
        use_xla_fastpath: bool = True,
        communicator: Optional[Any] = None,
        mode: str = "auto",
        compress: str = "off",
        error_feedback: bool = False,
        overlap: str = "off",
    ) -> None:
        """``mode``: ``"psum"`` = one masked allreduce per gradient tensor;
        ``"schedule"`` = the bucketed strategy-tree allreduce (later slice);
        ``"auto"`` = psum when the fast path is allowed and the strategy
        spans one host group, schedule otherwise.  ``use_xla_fastpath``
        keeps the reference's name for "the flat collective is allowed".
        """
        if mode not in ("auto", "psum", "schedule"):
            raise ValueError(f"mode {mode!r} not in auto|psum|schedule")
        if communicator is not None:
            raise _not_ported("a coordinator-attached hook (communicator=)", "the Communicator facade slice")
        if compress != "off":
            raise _not_ported(f"compress={compress!r}", "the quantized-wire slice")
        if error_feedback:
            raise _not_ported("error_feedback", "the quantized-wire slice")
        if overlap != "off":
            raise _not_ported(f"overlap={overlap!r}", "the overlapped-sync slice")
        self.strategy = strategy
        self.op = op
        self.use_xla_fastpath = use_xla_fastpath
        self.mode = mode

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
        """The step's active mask.  Without a coordinator everyone is
        active (``communicator`` is not ported yet, so always)."""
        return torch.ones((self.strategy.world_size,), dtype=torch.bool)

    # -- device half -----------------------------------------------------------

    def sync(self, grads: List[torch.Tensor], active_mask: Optional[torch.Tensor]) -> List[torch.Tensor]:
        """Allreduce each gradient tensor in place and return them.

        ``active_mask=None`` means statically full-world: a plain allreduce
        (AVG over the world).  With a mask, inactive ranks contribute zero
        and AVG divides by the active count.
        """
        if self._resolved_mode() != "psum":
            raise _not_ported(
                "the bucketed 'schedule' data plane (strategy trees over several "
                "host groups, or use_xla_fastpath=False)",
                "the engine's strategy-tree plane",
            )
        if active_mask is None:
            return [engine.allreduce(g, self.op) for g in grads]
        return [engine.masked_psum_shard(g, active_mask, self.op) for g in grads]
