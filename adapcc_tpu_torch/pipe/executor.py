"""Pipeline executor: a verified tick table run with a real backward.

The port of :mod:`adapcc_tpu.pipe.executor`, in the JAX engine's
single-controller form: every stage's module lives in this process (on one
card, or the CPU) and every stage-to-stage hop goes through the stacked
engine's :meth:`~adapcc_tpu_torch.comm.engine.CollectiveEngine.pipe_send`.

It runs the same :class:`~adapcc_tpu_torch.pipe.schedule.PipelineSchedule`
the verifier certified, tick by tick, one task a stage a tick.  JAX's
``jax.vjp`` stash becomes autograd's graph:

- a forward task keeps its stage output and its input leaf (the receiving
  stage takes the hopped activation as ``detach().requires_grad_()``, so
  each stage's graph ends at its own input);
- a backward task pulls the upstream gradient through that graph with
  ``torch.autograd.grad`` (the last stage seeds with ones), adds the
  parameter gradients to the stage's running sums in microbatch order and
  sends its input's gradient back through ``pipe_send``.

Each stage's backwards run in microbatch order under GPipe and under 1F1B,
so both schedules add the same gradients in the same order: their results
are equal bit for bit.  The tied-embedding gradient rides one
``tied_embed`` hop after the drain, so the hops counted equal the program's
``total_sends()``.  The stash's high-water mark (count and bytes) is
measured, so 1F1B's window ``min(m, stages − s)`` against GPipe's ``m`` is
an observable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.compiler.verify import verify_program
from adapcc_tpu_torch.models.gpt2 import GPT2Config
from adapcc_tpu_torch.pipe.partition import PipelineStage, StagePartition, stage_forward
from adapcc_tpu_torch.pipe.schedule import (
    PIPE_PRIMITIVE,
    PipelineSchedule,
    pipeline_program,
    pipeline_schedule,
    resolve_pipe_schedule,
)
from adapcc_tpu_torch.tuner.measure import sync_outputs

Grads = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class PipelineReport:
    """What one pipelined step actually did."""

    schedule: str
    stages: int
    microbatches: int
    ticks: int
    hops: int
    stash_peak: Tuple[int, ...]        #: per-stage peak in-flight stash count
    stash_peak_bytes: Tuple[int, ...]  #: per-stage peak stashed activation bytes
    bubble_fraction: float
    step_time_s: float


def _div(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` as a true division (torch on CUDA turns a division by a
    Python scalar into a multiply by its reciprocal)."""
    return t / torch.full((), n, dtype=t.dtype, device=t.device)


class PipelineExecutor:
    """Drive GPT-2 stages over a pipeline schedule through the stacked
    engine: rank ``s`` is stage ``s``, extra ranks idle.  ``schedule``
    resolves env > argument > the tuner's ``pipe_step`` cell > default
    (:func:`~adapcc_tpu_torch.pipe.schedule.resolve_pipe_schedule`).
    ``device`` is the stages' device (default: the card); the tuner cells
    are fingerprinted with it."""

    def __init__(
        self,
        cfg: GPT2Config,
        partition: StagePartition,
        engine: Any,
        *,
        num_microbatches: int = 4,
        schedule: Optional[str] = None,
        tuner_db: Optional[Any] = None,
        device: DeviceLike = None,
    ) -> None:
        if num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")
        S = partition.num_stages
        if engine.world_size < S:
            raise ValueError(f"engine world {engine.world_size} cannot host {S} stages")
        self.cfg = cfg
        self.partition = partition
        self.engine = engine
        self.num_microbatches = int(num_microbatches)
        self.tuner_db = tuner_db
        self.device = resolve_device(device)
        self.topology = ""
        if tuner_db is not None:
            # the lookup must spell the topology slot the recorder stamps
            from adapcc_tpu_torch.tuner.db import mesh_fingerprint

            self.topology = mesh_fingerprint(self.device, world=engine.world_size)
        self.schedule_kind = resolve_pipe_schedule(
            schedule,
            tuner_db=tuner_db,
            world=engine.world_size,
            microbatches=num_microbatches,
            topology=self.topology,
        )
        self.schedule: PipelineSchedule = pipeline_schedule(S, self.num_microbatches, self.schedule_kind)
        if S > 1:
            # the executor runs the verified object: the hop program comes
            # from the same tick table and is certified up front
            self.program = pipeline_program(self.schedule, world=engine.world_size, tied_embedding=True)
            verify_program(self.program)
        else:
            self.program = None

    # -- one pipelined step ----------------------------------------------------

    def _hop(self, value: torch.Tensor, src: int, dst: int, kind: str, mb: Optional[int],
             tick: Optional[int]) -> torch.Tensor:
        """One payload src → dst through the engine: stacked into the
        ``[world, ...]`` layout, the row moved, read back at ``dst`` (a
        tensor of its own, as JAX's ``moved[dst]``)."""
        w = self.engine.world_size
        buf = torch.zeros((w, *value.shape), dtype=value.dtype, device=value.device)
        buf[src] = value.detach()
        moved = self.engine.pipe_send(buf, src=src, dst=dst, kind=kind, mb=mb, tick=tick)
        return moved[dst].clone()

    def forward_backward(
        self,
        stage_params: List[PipelineStage],
        tokens: torch.Tensor,
        *,
        grad_sync: Optional[Callable[[Grads], Grads]] = None,
    ) -> Tuple[torch.Tensor, List[Grads], PipelineReport]:
        """One pipelined forward/backward over ``tokens`` ``[B, T]``.

        Returns ``(loss, stage_grads, report)``: the mean microbatch loss
        (detached); per stage, ``{parameter name: gradient}`` scaled to the
        full-batch mean (stage 0's ``wte.weight`` includes the tied head's
        gradient routed back from the last stage, whose ``head_wte.weight``
        entry is zeros: stage 0 owns the shared tensor); and the report.
        ``grad_sync``, when given, maps each stage's gradients before they
        are returned (the DP×PP attach point)."""
        t0 = time.perf_counter()
        S = self.partition.num_stages
        M = self.num_microbatches
        B = tokens.shape[0]
        if B % M != 0:
            raise ValueError(f"batch {B} is not divisible into {M} microbatches")
        mb_tokens = tokens.reshape(M, B // M, *tokens.shape[1:])
        cfg, part = self.cfg, self.partition
        names = [[n for n, _ in stage.named_parameters()] for stage in stage_params]
        params = [[p for _, p in stage.named_parameters()] for stage in stage_params]

        fwd_inbox: Dict[Tuple[int, int], torch.Tensor] = {}
        bwd_inbox: Dict[Tuple[int, int], torch.Tensor] = {}
        stash: List[Dict[int, Tuple[torch.Tensor, Optional[torch.Tensor]]]] = [dict() for _ in range(S)]
        stash_bytes: List[Dict[int, int]] = [dict() for _ in range(S)]
        peak = [0] * S
        peak_bytes = [0] * S
        losses: List[Optional[torch.Tensor]] = [None] * M
        grads: List[Optional[List[torch.Tensor]]] = [None] * S
        hops = 0

        def accumulate(s: int, g: Tuple[torch.Tensor, ...]) -> None:
            grads[s] = list(g) if grads[s] is None else [a + b for a, b in zip(grads[s], g)]

        for t, row in enumerate(self.schedule.ticks):
            for s, task in enumerate(row):
                if task is None:
                    continue
                m = task.mb
                if task.kind == "fwd":
                    if s == 0:
                        x = None
                        out = stage_forward(cfg, part, 0, stage_params[0], None, mb_tokens[m])
                        in_bytes = out.numel() * out.element_size()
                    else:
                        x = fwd_inbox.pop((s, m))
                        toks = mb_tokens[m] if s == S - 1 else None
                        out = stage_forward(cfg, part, s, stage_params[s], x, toks)
                        in_bytes = x.numel() * x.element_size()
                    stash[s][m] = (out, x)
                    stash_bytes[s][m] = in_bytes
                    peak[s] = max(peak[s], len(stash[s]))
                    peak_bytes[s] = max(peak_bytes[s], sum(stash_bytes[s].values()))
                    if s == S - 1:
                        losses[m] = out.detach()
                    else:
                        moved = self._hop(out, s, s + 1, "activation", m, t)
                        fwd_inbox[(s + 1, m)] = moved.requires_grad_()
                        hops += 1
                else:  # bwd
                    out, x = stash[s].pop(m)
                    stash_bytes[s].pop(m)
                    upstream = torch.ones((), dtype=out.dtype, device=out.device) if s == S - 1 \
                        else bwd_inbox.pop((s, m))
                    inputs = params[s] + ([x] if s > 0 else [])
                    pulled = torch.autograd.grad(out, inputs, upstream)
                    del out
                    accumulate(s, pulled[:len(params[s])])
                    if s > 0:
                        bwd_inbox[(s - 1, m)] = self._hop(pulled[-1], s, s - 1, "grad", m, t)
                        hops += 1

        assert not fwd_inbox and not bwd_inbox and all(not st for st in stash), \
            "pipeline drain left in-flight state (schedule/executor drift)"

        # the microbatch-mean loss and gradients (each microbatch loss is a
        # mean over its tokens; equal sizes make sum/M the full-batch mean)
        loss = _div(sum(losses[1:], losses[0]), M)
        out_grads: List[Grads] = [
            {n: _div(g, M) for n, g in zip(names[s], grads[s])} for s in range(S)
        ]

        if S > 1:
            # the Megatron-style tied-embedding exchange: the head copy's
            # gradient rides one hop back to the owner of wte
            head_g = out_grads[S - 1]["head_wte.weight"]
            arrived = self._hop(head_g, S - 1, 0, "tied_embed", None, None)
            hops += 1
            out_grads[0]["wte.weight"] = out_grads[0]["wte.weight"] + arrived
            out_grads[S - 1]["head_wte.weight"] = torch.zeros_like(head_g)
            assert self.program is not None
            assert hops == self.program.total_sends(), (
                f"executor ran {hops} hops but the verified program has "
                f"{self.program.total_sends()} sends"
            )

        if grad_sync is not None:
            out_grads = [grad_sync(gs) for gs in out_grads]

        sync_outputs((loss, out_grads))
        step_time = time.perf_counter() - t0
        if self.tuner_db is not None:
            self._record_tuner_sample(step_time)
        report = PipelineReport(
            schedule=self.schedule_kind,
            stages=S,
            microbatches=M,
            ticks=self.schedule.num_ticks,
            hops=hops,
            stash_peak=tuple(peak),
            stash_peak_bytes=tuple(peak_bytes),
            bubble_fraction=self.schedule.bubble_fraction,
            step_time_s=step_time,
        )
        return loss, out_grads, report

    def _record_tuner_sample(self, seconds: float) -> None:
        from adapcc_tpu_torch.tuner.db import TuningKey, size_bucket
        from adapcc_tpu_torch.tuner.policy import pipe_path

        key = TuningKey(
            primitive=PIPE_PRIMITIVE,
            size_bucket=size_bucket(0),
            world=self.engine.world_size,
            topology=self.topology,
            path=pipe_path(self.schedule_kind),
            chunk_bytes=self.num_microbatches,
            wire_dtype="off",
        )
        self.tuner_db.record(key, seconds)


@torch.no_grad()
def sync_tied_embedding(stage_params: List[PipelineStage]) -> None:
    """Refresh the last stage's ``head_wte`` copy from stage 0's ``wte``
    after an optimizer update, the other half of the weight tie (the
    gradient half is in :meth:`PipelineExecutor.forward_backward`)."""
    if len(stage_params) > 1 and hasattr(stage_params[-1], "head_wte"):
        stage_params[-1].head_wte.weight.copy_(stage_params[0].wte.weight)


__all__ = ["PipelineExecutor", "PipelineReport", "sync_tied_embedding"]
