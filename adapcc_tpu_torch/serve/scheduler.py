"""The continuous batcher: per-request admission into fixed decode slots
(the port of :mod:`adapcc_tpu.serve.scheduler`).

One :class:`GPT2Server` owns ``slots`` decode lanes over a stacked
tensor-parallel world.  Each engine step advances **every occupied lane by
one token**: lanes still inside their prompt force-feed the next prompt
token (prefill), lanes past it sample (decode), so prefill and decode
interleave in one step and admission never waits for a batch boundary.

The step is the ``generate`` loop's body with the position generalized to
a per-slot one and the EOS latch moved to the host:

- every occupied lane draws from its own generator on every step, prefill
  steps too, which keeps a lane's stream that of a one-at-a-time
  ``generate`` run seeded alike;
- a sampled EOS at a generated position latches the stream: every later
  position is EOS, so the lane is **evicted at once** and its remaining
  tokens filled on the host;
- completion (position ``total − 1`` written) frees the slot at the end of
  the step; admission happens at the start of a step.

Latency runs on two clocks: the deterministic **step clock** (sojourn and
TTFT in decode steps, byte-reproducible) and the wall clock (per-step and
per-request seconds through the
:class:`~adapcc_tpu_torch.utils.observability.MetricsRegistry` reservoir,
what SLO attainment reads).  A request's SLO clock starts at its arrival,
not its admission.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from adapcc_tpu_torch.models.gpt2 import GPT2
from adapcc_tpu_torch.serve import resolve_serve_slo_ms, resolve_serve_slots
from adapcc_tpu_torch.serve.kv_cache import SlotKVCache
from adapcc_tpu_torch.serve.model import TPDecodeModel
from adapcc_tpu_torch.serve.trace import ArrivalTrace, RequestSpec
from adapcc_tpu_torch.utils.observability import MetricsRegistry, nearest_rank_percentile


@dataclass
class Request:
    """A live request (the scheduler-side spelling of a RequestSpec)."""

    req_id: int
    prompt: List[int]
    max_new_tokens: int
    seed: int
    arrival_step: int = 0

    @classmethod
    def from_spec(cls, spec: RequestSpec) -> "Request":
        return cls(req_id=spec.req_id, prompt=list(spec.prompt), max_new_tokens=spec.max_new_tokens,
                   seed=spec.seed, arrival_step=spec.arrival_step)

    @property
    def total(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclass
class RequestResult:
    """One served request: the token stream and its latency ledger."""

    req_id: int
    tokens: List[int]
    prompt_len: int
    arrival_step: int
    admitted_step: int
    #: step at which the first *generated* token was written
    first_token_step: int = -1
    completed_step: int = -1
    #: True when the stream ended on a latched EOS before max_new_tokens
    eos_evicted: bool = False
    #: wall seconds from ARRIVAL to completion (the SLO clock)
    wall_s: float = 0.0

    @property
    def sojourn_steps(self) -> int:
        """Arrival → completion in decode steps (queue wait included)."""
        return self.completed_step - self.arrival_step

    @property
    def ttft_steps(self) -> int:
        """Arrival → first generated token, in decode steps."""
        return self.first_token_step - self.arrival_step

    @property
    def generated(self) -> List[int]:
        return self.tokens[self.prompt_len:]


@dataclass
class Lane:
    """One occupied decode slot's host state."""

    req: Request
    admitted_step: int
    #: tokens written so far (prompt pre-filled); grows to req.total
    tokens: np.ndarray = field(default=None)  # type: ignore[assignment]
    #: loop position: index of the token the NEXT step feeds
    pos: int = 0
    first_token_step: int = -1
    wall_t0: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)

    @classmethod
    def admit(cls, req: Request, clock: int) -> "Lane":
        lane = cls(req=req, admitted_step=clock)
        lane.tokens = np.zeros((req.total,), np.int64)
        lane.tokens[: len(req.prompt)] = np.asarray(req.prompt, np.int64)
        lane.wall_t0 = time.perf_counter()
        return lane

    def advance(self, sampled: int, clock: int, eos_id: Optional[int]) -> Optional[str]:
        """The generate loop's host half for this lane after one step ending
        at ``clock + 1``: the forced prompt token or the sampled one is
        written.  Returns ``"eos"`` (a sampled EOS latched before the end:
        the tail is filled with EOS), ``"done"`` (position ``total − 1``
        written) or None."""
        t = self.pos
        if t + 1 >= self.prompt_len:
            self.tokens[t + 1] = sampled
            if t + 1 == self.prompt_len:
                # the step that wrote it ends at clock+1, as completed_step
                self.first_token_step = clock + 1
        self.pos = t + 1
        wrote_eos = eos_id is not None and t + 1 >= self.prompt_len and int(self.tokens[t + 1]) == eos_id
        if wrote_eos and self.pos < self.req.total - 1:
            self.tokens[self.pos + 1:] = eos_id
            return "eos"
        if self.pos == self.req.total - 1:
            return "done"
        return None


def validate_request(req: Request, cfg) -> None:
    """The submit-time checks both serving planes make, so they reject the
    same traffic."""
    if req.total > cfg.max_seq:
        raise ValueError(f"request {req.req_id}: {req.total} tokens > max_seq={cfg.max_seq} cache slots")
    if req.max_new_tokens < 1:
        raise ValueError(f"request {req.req_id}: max_new_tokens must be >= 1")
    if not req.prompt:
        raise ValueError(f"request {req.req_id}: empty prompt")
    bad = [t for t in req.prompt if not 0 <= t < cfg.vocab_size]
    if bad:
        raise ValueError(f"request {req.req_id}: prompt token(s) {bad[:3]} outside vocab_size={cfg.vocab_size}")


def step_inputs(lanes: Dict[int, Lane], rows: List[int], slots: int, device: torch.device):
    """The step's ``tok [slots, 1]`` and ``pos [slots]`` on ``device``: each
    computed lane's next token and position, zeros elsewhere."""
    tok = np.zeros((slots, 1), np.int64)
    pos = np.zeros((slots,), np.int64)
    for s in rows:
        lane = lanes[s]
        tok[s, 0] = lane.tokens[lane.pos]
        pos[s] = lane.pos
    return torch.from_numpy(tok).to(device), torch.from_numpy(pos).to(device)


def pct(xs, q: float) -> int:
    """Nearest-rank percentile of sorted step counts, as an int."""
    return int(nearest_rank_percentile(xs, q))


def result_of(lane: Lane, clock: int, eos_evicted: bool, wall: float) -> RequestResult:
    req = lane.req
    return RequestResult(
        req_id=req.req_id, tokens=[int(x) for x in lane.tokens], prompt_len=len(req.prompt),
        arrival_step=req.arrival_step, admitted_step=lane.admitted_step, first_token_step=lane.first_token_step,
        completed_step=clock + 1, eos_evicted=eos_evicted, wall_s=wall,
    )


class GPT2Server:
    """Continuous-batching GPT-2 server over a stacked world of ``world``
    ranks on the device of ``model`` (a port
    :class:`~adapcc_tpu_torch.models.gpt2.GPT2`).

    ``algo`` goes to every decode-step ``engine.all_reduce``: ``"auto"``
    (default) lets the calibrated crossover or the tuner pick the plane;
    ``ADAPCC_COLL_ALGO`` still outranks it.  Sampling parameters are
    server-wide, as ``generate``'s arguments are.
    """

    def __init__(
        self,
        model: GPT2,
        world: int,
        slots: Optional[int] = None,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: Optional[int] = None,
        algo: Optional[str] = "auto",
        engine=None,
        trace=None,
        metrics: Optional[MetricsRegistry] = None,
        slo_ms: Optional[float] = None,
    ) -> None:
        self.cfg = model.cfg
        self.model = model
        self.world = int(world)
        self.slots = resolve_serve_slots(slots)
        self.eos_id = eos_id
        self.algo = algo
        self.slo_ms = resolve_serve_slo_ms(slo_ms)
        if engine is None:
            from adapcc_tpu_torch.comm.engine import CollectiveEngine
            from adapcc_tpu_torch.strategy.ir import Strategy

            engine = CollectiveEngine(self.world, Strategy.ring(self.world), trace=trace)
        self.engine = engine
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tp = TPDecodeModel(model, self.world, temperature=temperature, top_k=top_k, top_p=top_p)
        self.device = self.tp.device
        self.cache = SlotKVCache(self.cfg, self.world, self.slots, device=self.device, metrics=self.metrics)
        self.clock = 0
        self._pending: Deque[Request] = deque()
        self._lanes: Dict[int, Lane] = {}
        self._free: List[int] = list(range(self.slots))
        self._results: Dict[int, RequestResult] = {}
        #: req_id → wall time its arrival step was first reached: the SLO
        #: clock starts at ARRIVAL, or queue wait would be invisible to
        #: attainment in the overload regime the SLO exists for
        self._arrival_wall: Dict[int, float] = {}
        #: one generator a slot, reseeded at admission
        self._gens = [torch.Generator(device=self.device) for _ in range(self.slots)]

    # -- admission -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        validate_request(req, self.cfg)
        self._pending.append(req)

    def submit_trace(self, trace: ArrivalTrace) -> None:
        if trace.world != self.world:
            raise ValueError(
                f"arrival trace was authored for world={trace.world} but this server runs world={self.world}"
            )
        for spec in trace.requests:
            self.submit(Request.from_spec(spec))

    def _admit(self) -> None:
        while self._free and self._pending and self._pending[0].arrival_step <= self.clock:
            req = self._pending.popleft()
            slot = self._free.pop(0)
            self._lanes[slot] = Lane.admit(req, self.clock)
            self.cache.clear_slot(slot)
            self._gens[slot].manual_seed(req.seed)
            self.metrics.incr("serve.admitted")

    # -- the decode step -------------------------------------------------------

    def step(self) -> int:
        """Admit, then advance every occupied lane by one token.  Returns the
        number of lanes that made progress (0: an idle tick)."""
        now = time.perf_counter()
        for req in self._pending:
            # the SLO clock starts when the arrival step is reached, even if
            # no slot is free yet
            if req.arrival_step > self.clock:
                break  # arrival-sorted FIFO (the discipline _admit assumes)
            self._arrival_wall.setdefault(req.req_id, now)
        self._admit()
        active = sorted(self._lanes)
        if not active:
            self.clock += 1
            return 0
        t0 = time.perf_counter()
        tok, pos = step_inputs(self._lanes, active, self.slots, self.device)
        sampled = self.tp.decode_step(self.engine, self.cache.layers, tok, pos, self._gens, active,
                                      algo=self.algo).tolist()
        self.metrics.observe("serve.step_s", time.perf_counter() - t0)
        self.metrics.gauge("serve.slots_busy", len(active))
        self.metrics.gauge("serve.queue_depth", len(self._pending))
        for s, token in zip(active, sampled):
            self._advance_lane(s, int(token))
        self.clock += 1
        return len(active)

    def _advance_lane(self, slot: int, sampled: int) -> None:
        """Write the lane's next token; evict on a latched EOS, complete at
        the last position."""
        outcome = self._lanes[slot].advance(sampled, self.clock, self.eos_id)
        if outcome == "eos":
            self.metrics.incr("serve.evicted_eos")
            self._complete(slot, eos_evicted=True)
        elif outcome == "done":
            self._complete(slot, eos_evicted=False)

    def _complete(self, slot: int, eos_evicted: bool) -> None:
        lane = self._lanes.pop(slot)
        self._free.append(slot)
        self._free.sort()
        self.cache.release_slot(slot, used_tokens=lane.pos + 1, evicted=eos_evicted)
        wall = time.perf_counter() - self._arrival_wall.pop(lane.req.req_id, lane.wall_t0)
        result = result_of(lane, self.clock, eos_evicted, wall)
        self._results[result.req_id] = result
        self.metrics.incr("serve.completed")
        self.metrics.observe("serve.sojourn_steps", result.sojourn_steps)
        if result.first_token_step >= 0:
            self.metrics.observe("serve.ttft_steps", result.ttft_steps)
        self.metrics.observe("serve.sojourn_s", wall)

    # -- the drive loop --------------------------------------------------------

    def run(self, max_steps: Optional[int] = None) -> List[RequestResult]:
        """Step until every submitted request completes, or raise once
        ``max_steps`` elapse: an under-budgeted drive must not return a
        partial ledger as if it were the full one."""
        budget = max_steps if max_steps is not None else 1_000_000
        steps = 0
        while self._pending or self._lanes:
            if steps >= budget:
                raise RuntimeError(
                    f"serve run exceeded max_steps={budget} with {len(self._pending)} queued / "
                    f"{len(self._lanes)} in-flight requests"
                )
            self.step()
            steps += 1
        return self.results()

    def results(self) -> List[RequestResult]:
        return [self._results[k] for k in sorted(self._results)]

    def summary(self) -> dict:
        """The serving ledger: step-clock percentiles and the wall-clock SLO
        attainment."""
        res = self.results()
        snap = self.metrics.snapshot()
        out: dict = {
            "requests": len(res),
            "slots": self.slots,
            "world": self.world,
            "steps": self.clock,
            "kv_cache": self.cache.layout(),
            "kv_cache_stats": self.cache.stats(),
        }
        if res:
            sojourns = sorted(r.sojourn_steps for r in res)
            ttfts = sorted(r.ttft_steps for r in res if r.first_token_step >= 0)
            out["p50_sojourn_steps"] = pct(sojourns, 0.50)
            out["p99_sojourn_steps"] = pct(sojourns, 0.99)
            if ttfts:
                out["p50_ttft_steps"] = pct(ttfts, 0.50)
                out["p99_ttft_steps"] = pct(ttfts, 0.99)
        step_t = snap["timings"].get("serve.step_s")
        if step_t:
            out["p50_step_ms"] = step_t["p50_s"] * 1e3
            out["p99_step_ms"] = step_t["p99_s"] * 1e3
        if self.slo_ms is not None and res:
            within = sum(1 for r in res if r.wall_s * 1e3 <= self.slo_ms)
            out["slo_ms"] = self.slo_ms
            out["slo_attainment"] = within / len(res)
        return out
