"""The disaggregated serving cluster: two pods, one router, traced KV
streams (the port of :mod:`adapcc_tpu.serve.disagg.cluster`).

Topology: a **prefill pod** and a **decode pod** of equal tensor-parallel
world (equal worlds keep the head-sharded page layout ``[world, slots,
max_seq, Hl, hd]`` migration-compatible without a reshard), each with its
own :class:`~adapcc_tpu_torch.comm.engine.CollectiveEngine` (both recording
into ONE shared trace) and its own
:class:`~adapcc_tpu_torch.serve.kv_cache.SlotKVCache`; one
:class:`~adapcc_tpu_torch.serve.model.TPDecodeModel` computes both pods'
steps.  On one card both pods are stacked worlds on the model's device.

Request lifecycle:

1. **admit → prefill**: FIFO admission into a free prefill slot, the
   slot's generator seeded with the request's seed, as the colocated
   batcher admits.  The lane force-feeds its prompt one token a step; the
   step that feeds position ``prompt_len − 1`` samples the **first
   generated token** (TTFT lands in the prefill pod).
2. **migrate**: the finished prefill's pages, only the filled prefix
   ``[:prompt_len]``, ride :meth:`CollectiveEngine.kv_transfer` into a
   zeroed decode slot, together with the generator's state.  With no free
   decode slot the lane **waits resident** in its prefill slot, out of the
   prefill steps and its generator untouched, never dropped.
3. **decode**: the decode pod streams the remaining tokens with the
   colocated step semantics (EOS latch included).

A lane's tokens depend only on its prompt, its generator's draws and the
(exact) layer math over its own pages, never on the clock or its
neighbours: a lane draws once for each step it computes, the state moves
with the pages, and the float32 (``"off"``) wire moves the pages bit for
bit, so the streams equal the colocated ``GPT2Server``'s.  The int8 wire
breaks page exactness on purpose; it is gated by the token-level KL probe
(:func:`measure_token_kl`) at construction.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from adapcc_tpu_torch.comm.engine import KV_TRANSFER_CHUNK_BYTES, CollectiveEngine
from adapcc_tpu_torch.models.gpt2 import GPT2
from adapcc_tpu_torch.serve import resolve_serve_slo_ms, resolve_serve_slots
from adapcc_tpu_torch.serve.disagg import KV_KL_BOUND_ENV, resolve_kv_kl_bound, resolve_kv_wire_dtype
from adapcc_tpu_torch.serve.kv_cache import SlotKVCache
from adapcc_tpu_torch.serve.model import TPDecodeModel
from adapcc_tpu_torch.serve.scheduler import (
    Lane, Request, RequestResult, pct, result_of, step_inputs, validate_request,
)
from adapcc_tpu_torch.serve.trace import ArrivalTrace
from adapcc_tpu_torch.strategy.ir import Strategy
from adapcc_tpu_torch.utils.observability import MetricsRegistry

#: pod ids stamped on every kv_transfer trace event
PREFILL_POD = 0
DECODE_POD = 1


class Pool:
    """One pod: an engine, a slot cache, lanes and a generator a slot."""

    def __init__(self, name: str, model: GPT2, world: int, slots: int, trace=None,
                 engine: Optional[CollectiveEngine] = None) -> None:
        self.name = name
        self.cfg = model.cfg
        self.world = int(world)
        self.slots = int(slots)
        self.device = model.wte.weight.device
        if engine is None:
            engine = CollectiveEngine(self.world, Strategy.ring(self.world), trace=trace)
        self.engine = engine
        #: per-pod registry so the two pods' kv_cache.* ledgers stay split
        self.cache_metrics = MetricsRegistry()
        self.lanes: Dict[int, Lane] = {}
        self.reset()

    def reset(self) -> None:
        """(Re)build the pod's serving state: fresh pages, every slot free,
        fresh generators.  This is also the pod-death path: the
        cache-metrics registry survives, so its counters accumulate across
        a rebuild."""
        self.cache = SlotKVCache(self.cfg, self.world, self.slots, device=self.device, metrics=self.cache_metrics)
        self.lanes = {}
        self.free: List[int] = list(range(self.slots))
        self.gens = [torch.Generator(device=self.device) for _ in range(self.slots)]


@torch.no_grad()
def measure_token_kl(model: GPT2, world: int, wire_dtype: str, prompt: Optional[List[int]] = None,
                     block_size: Optional[int] = None) -> float:
    """Token-level KL (nats) a lossy KV wire would inflict on the first
    decode-pod step: prefill a deterministic probe prompt (engine-free: the
    stacked partial's sum stands in for the allreduce, the same
    concatenation), then compute the next-token distribution twice, over
    the exact pages and over ``codec.apply``'d pages (what ``kv_transfer``
    would move), and return ``KL(p_exact ‖ p_codec)``.  ``"off"`` returns
    exactly 0.0."""
    from adapcc_tpu_torch.quant import get_codec
    from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE

    codec = get_codec(wire_dtype)
    if codec.name == "off":
        return 0.0
    cfg = model.cfg
    block = int(block_size) if block_size is not None else DEFAULT_BLOCK_SIZE
    tp = TPDecodeModel(model, world)
    if prompt is None:
        plen = max(1, min(8, cfg.max_seq - 2))
        prompt = [1 + (i % (cfg.vocab_size - 1)) for i in range(plen)]
    plen = len(prompt)
    if plen + 1 >= cfg.max_seq:
        raise ValueError(
            f"KL probe prompt of {plen} tokens leaves no room for a generated token under max_seq={cfg.max_seq}"
        )
    cache = SlotKVCache(cfg, world, 1, device=tp.device)

    def step(layers: List[Tuple[torch.Tensor, torch.Tensor]], tok: int, pos_i: int) -> torch.Tensor:
        pos = torch.tensor([pos_i], device=tp.device)
        x = tp.embed(torch.tensor([[tok]], device=tp.device), pos)
        for layer in range(cfg.n_layer):
            k_pages, v_pages = layers[layer]
            partial = tp.attn_partial(layer, x, k_pages, v_pages, pos)
            # the allreduce's sum, without an engine: an exact concatenation
            x = tp.post_attn(layer, x, partial.sum(dim=0))
        return tp.logits(x)

    logits = None
    for i, tok in enumerate(prompt):
        logits = step(cache.layers, int(tok), i)
    first_token = int(torch.argmax(logits[0, 0]))

    def distorted() -> List[Tuple[torch.Tensor, torch.Tensor]]:
        out = []
        for k_pages, v_pages in cache.layers:
            kq, vq = k_pages.clone(), v_pages.clone()
            kq[:, :, :plen] = codec.apply(k_pages[:, :, :plen], block).to(k_pages.dtype)
            vq[:, :, :plen] = codec.apply(v_pages[:, :, :plen], block).to(v_pages.dtype)
            out.append((kq, vq))
        return out

    lossy_layers = distorted()
    exact = step(cache.layers, first_token, plen)
    lossy = step(lossy_layers, first_token, plen)
    lp_exact = torch.log_softmax(exact[0, 0].float(), dim=-1)
    lp_lossy = torch.log_softmax(lossy[0, 0].float(), dim=-1)
    kl = torch.sum(torch.exp(lp_exact) * (lp_exact - lp_lossy))
    return max(float(kl), 0.0)


class ClusterRouter:
    """Routes requests through the two-pod disaggregated cluster.

    The surface mirrors :class:`~adapcc_tpu_torch.serve.scheduler.GPT2Server`
    (``submit`` / ``submit_trace`` / ``step`` / ``run`` / ``results`` /
    ``summary``); ``summary`` also splits latency per pool and carries the
    KV-stream ledger.  ``prefill_world`` and ``decode_world`` are the pods'
    stacked worlds, on the device of ``model``.
    """

    def __init__(
        self,
        model: GPT2,
        prefill_world: int,
        decode_world: int,
        prefill_slots: Optional[int] = None,
        decode_slots: Optional[int] = None,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: Optional[int] = None,
        algo: Optional[str] = "auto",
        trace=None,
        metrics: Optional[MetricsRegistry] = None,
        slo_ms: Optional[float] = None,
        kv_wire_dtype: Optional[str] = None,
        kv_kl_bound: Optional[float] = None,
        kv_block_size: Optional[int] = None,
        kv_chunk_bytes: int = KV_TRANSFER_CHUNK_BYTES,
    ) -> None:
        pw, dw = int(prefill_world), int(decode_world)
        if pw != dw:
            raise ValueError(
                f"prefill pod world={pw} != decode pod world={dw}: equal TP worlds are what keep the "
                "head-sharded KV page layout migration-compatible without a reshard"
            )
        self.cfg = model.cfg
        self.model = model
        self.pool_world = pw
        #: ranks across both pods: the budget the colocated baseline gets in
        #: an equal-rank comparison
        self.world = 2 * pw
        self.eos_id = eos_id
        self.algo = algo
        self.slo_ms = resolve_serve_slo_ms(slo_ms)
        self.trace = trace
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.kv_wire_dtype = resolve_kv_wire_dtype(kv_wire_dtype)
        self.kv_block_size = kv_block_size
        self.kv_chunk_bytes = int(kv_chunk_bytes)
        self.kv_kl: Optional[float] = None
        if self.kv_wire_dtype != "off":
            bound = resolve_kv_kl_bound(kv_kl_bound)
            self.kv_kl = measure_token_kl(model, pw, self.kv_wire_dtype, block_size=kv_block_size)
            if self.kv_kl > bound:
                raise ValueError(
                    f"KV wire dtype {self.kv_wire_dtype!r} rejected: measured token-level KL {self.kv_kl:.3e} "
                    f"nats exceeds the acceptance bound {bound:.3e} ({KV_KL_BOUND_ENV}); serve the bit-exact "
                    "fp32 wire ('off') or raise the bound deliberately"
                )
            self.kv_kl_bound = bound
        self.tp = TPDecodeModel(model, pw, temperature=temperature, top_k=top_k, top_p=top_p)
        self.prefill = Pool("prefill", model, pw, resolve_serve_slots(prefill_slots), trace=trace)
        self.decode = Pool("decode", model, dw, resolve_serve_slots(decode_slots), trace=trace)
        self.clock = 0
        self._pending: Deque[Request] = deque()
        #: prefill slots whose lane finished prefill and awaits a decode slot
        #: (FIFO by readiness; out of the prefill steps)
        self._ready: Deque[int] = deque()
        self._results: Dict[int, RequestResult] = {}
        self._arrival_wall: Dict[int, float] = {}
        #: req_id → router step the request entered the decode pod
        self._migrated: Dict[int, int] = {}
        self._kv_transfers = 0
        self._kv_payload_bytes = 0
        self._kv_wire_bytes = 0

    # -- admission -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """The colocated server's checks: the two planes reject the same
        traffic."""
        validate_request(req, self.cfg)
        self._pending.append(req)

    def submit_trace(self, trace: ArrivalTrace) -> None:
        if trace.world != self.world:
            raise ValueError(
                f"arrival trace was authored for world={trace.world} but this cluster runs world={self.world} "
                f"(2 pods x {self.pool_world})"
            )
        for spec in trace.requests:
            self.submit(Request.from_spec(spec))

    def _admit(self) -> None:
        pool = self.prefill
        while pool.free and self._pending and self._pending[0].arrival_step <= self.clock:
            req = self._pending.popleft()
            slot = pool.free.pop(0)
            pool.lanes[slot] = Lane.admit(req, self.clock)
            pool.cache.clear_slot(slot)
            pool.gens[slot].manual_seed(req.seed)
            self.metrics.incr("serve.admitted")

    # -- the cluster step ------------------------------------------------------

    def step(self) -> int:
        """One router tick: admit into prefill, advance both pods by one
        token, then migrate every finished prefill a decode slot can take.
        Returns the number of lanes that computed."""
        now = time.perf_counter()
        for req in self._pending:
            if req.arrival_step > self.clock:
                break  # arrival-sorted FIFO (the discipline _admit assumes)
            self._arrival_wall.setdefault(req.req_id, now)
        self._admit()
        n = self._step_pool(self.prefill, set(self._ready))
        n += self._step_pool(self.decode, set())
        self._migrate_ready()
        self.clock += 1
        return n

    def _step_pool(self, pool: Pool, frozen: set) -> int:
        """Advance one pod's occupied lanes but the ``frozen`` ones (finished
        prefills awaiting a decode slot: they neither compute nor draw) by
        one token."""
        active = sorted(s for s in pool.lanes if s not in frozen)
        if not active:
            return 0
        t0 = time.perf_counter()
        tok, pos = step_inputs(pool.lanes, active, pool.slots, pool.device)
        sampled = self.tp.decode_step(pool.engine, pool.cache.layers, tok, pos, pool.gens, active,
                                      algo=self.algo).tolist()
        self.metrics.observe(f"serve.{pool.name}.step_s", time.perf_counter() - t0)
        self.metrics.gauge(f"serve.{pool.name}.slots_busy", len(active))
        self.metrics.gauge("serve.queue_depth", len(self._pending))
        for s, token in zip(active, sampled):
            self._advance(pool, s, int(token))
        return len(active)

    def _advance(self, pool: Pool, slot: int, sampled: int) -> None:
        """The colocated lane advance, with one more outcome: a prefill lane
        that just wrote its first generated token (and neither completed nor
        latched EOS) becomes *ready* and queues for migration."""
        lane = pool.lanes[slot]
        outcome = lane.advance(sampled, self.clock, self.eos_id)
        if outcome == "eos":
            self.metrics.incr("serve.evicted_eos")
            self._complete(pool, slot, eos_evicted=True)
        elif outcome == "done":
            # max_new_tokens == 1 completes inside the prefill pod: no
            # migration is owed
            self._complete(pool, slot, eos_evicted=False)
        elif pool is self.prefill and lane.pos >= lane.prompt_len:
            self._ready.append(slot)

    def _migrate_ready(self) -> None:
        """Move finished prefills into free decode slots, FIFO: pages (the
        filled prefix only) through the traced ``kv_transfer`` stream, the
        generator's state by copy.  A migrated lane decodes its next token
        on the next tick; lanes the decode pod cannot take yet stay
        queued."""
        while self._ready and self.decode.free:
            slot = self._ready.popleft()
            lane = self.prefill.lanes.pop(slot)
            p = lane.pos  # == prompt_len: rows [0, p) are the filled prefix
            pages = [(k[:, slot, :p], v[:, slot, :p]) for k, v in self.prefill.cache.layers]
            moved = self.prefill.engine.kv_transfer(
                pages, src_pod=PREFILL_POD, dst_pod=DECODE_POD, wire_dtype=self.kv_wire_dtype,
                block_size=self.kv_block_size, chunk_bytes=self.kv_chunk_bytes, dst_device=self.decode.device,
            )
            dslot = self.decode.free.pop(0)
            self.decode.cache.clear_slot(dslot)
            for (k, v), (mk, mv) in zip(self.decode.cache.layers, moved):
                k[:, dslot, :p] = mk
                v[:, dslot, :p] = mv
            # the generator's state migrates with the pages
            self.decode.gens[dslot].set_state(self.prefill.gens[slot].get_state())
            self.prefill.cache.release_slot(slot, used_tokens=p, evicted=False)
            self.prefill.free.append(slot)
            self.prefill.free.sort()
            self._migrated[lane.req.req_id] = self.clock + 1
            self.decode.lanes[dslot] = lane
            payload = sum(k.numel() * k.element_size() + v.numel() * v.element_size() for k, v in pages)
            self._kv_transfers += 1
            self._kv_payload_bytes += payload
            self._kv_wire_bytes += self._wire_bytes(pages)
            self.metrics.incr("serve.migrated")

    def _wire_bytes(self, pages) -> int:
        if self.kv_wire_dtype == "off":
            return sum(k.numel() * k.element_size() + v.numel() * v.element_size() for k, v in pages)
        from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE
        from adapcc_tpu_torch.sim.cost_model import wire_bytes_per_element

        block = int(self.kv_block_size) if self.kv_block_size is not None else DEFAULT_BLOCK_SIZE
        per_elem = wire_bytes_per_element(self.kv_wire_dtype, block)
        return int(sum((k.numel() + v.numel()) * per_elem for k, v in pages))

    def _complete(self, pool: Pool, slot: int, eos_evicted: bool) -> None:
        lane = pool.lanes.pop(slot)
        pool.free.append(slot)
        pool.free.sort()
        pool.cache.release_slot(slot, used_tokens=lane.pos + 1, evicted=eos_evicted)
        wall = time.perf_counter() - self._arrival_wall.pop(lane.req.req_id, lane.wall_t0)
        result = result_of(lane, self.clock, eos_evicted, wall)
        self._results[result.req_id] = result
        self.metrics.incr("serve.completed")
        self.metrics.observe("serve.sojourn_steps", result.sojourn_steps)
        if result.first_token_step >= 0:
            self.metrics.observe("serve.ttft_steps", result.ttft_steps)
        self.metrics.observe("serve.sojourn_s", wall)

    # -- failure injection -----------------------------------------------------

    def kill_decode_pool(self) -> List[int]:
        """Decode-pod death, mid-stream: every in-flight decode lane's request
        re-enters the *front* of the prefill queue with its original arrival
        step (FIFO order among the victims kept) and the pod is rebuilt.
        Nothing is dropped; the re-prefill draws the same stream again from
        the request's seed, so the victims' tokens are unchanged; their TTFT
        is the casualty."""
        victims = [self.decode.lanes[s].req.req_id for s in sorted(self.decode.lanes)]
        for s in sorted(self.decode.lanes, reverse=True):
            lane = self.decode.lanes[s]
            self._pending.appendleft(lane.req)
            self._migrated.pop(lane.req.req_id, None)
        self.decode.reset()
        self.metrics.incr("serve.decode_pod_deaths")
        self.metrics.incr("serve.re_prefilled", len(victims))
        return victims

    # -- fabric integration ----------------------------------------------------

    def kv_stream_fabric_job(self, fabric, name: str = "kv_stream", priority: Optional[str] = "high"):
        """Register the router's cumulative KV-stream traffic with a
        :class:`~adapcc_tpu_torch.adapt.fabric.SharedFabric` (wire bytes,
        with a 1-byte floor so a cold router still registers); serving is
        latency-critical, hence priority ``"high"``."""
        return fabric.add_job(name, priority=priority, nbytes=max(1, int(self._kv_wire_bytes)), degree=1)

    # -- the drive loop --------------------------------------------------------

    def run(self, max_steps: Optional[int] = None) -> List[RequestResult]:
        """Step until every submitted request completes, or raise once
        ``max_steps`` elapse."""
        budget = max_steps if max_steps is not None else 1_000_000
        steps = 0
        while self._pending or self.prefill.lanes or self.decode.lanes:
            if steps >= budget:
                raise RuntimeError(
                    f"serve run exceeded max_steps={budget} with {len(self._pending)} queued / "
                    f"{len(self.prefill.lanes)} prefill / {len(self.decode.lanes)} decode in-flight requests"
                )
            self.step()
            steps += 1
        return self.results()

    def results(self) -> List[RequestResult]:
        return [self._results[k] for k in sorted(self._results)]

    def summary(self) -> dict:
        """The disaggregated ledger: the colocated summary's step-clock
        percentiles split per pool (TTFT is prefill-pod latency; decode
        residency runs migration → completion), the KV-stream ledger and
        per-pod cache stats."""
        res = self.results()
        out: dict = {
            "requests": len(res),
            "world": self.world,
            "steps": self.clock,
            "disagg": True,
            "pools": {
                "prefill": {"world": self.prefill.world, "slots": self.prefill.slots},
                "decode": {"world": self.decode.world, "slots": self.decode.slots},
            },
            "kv_cache": self.decode.cache.layout(),
            "kv_cache_stats": {"prefill": self.prefill.cache.stats(), "decode": self.decode.cache.stats()},
            "kv_stream": {
                "wire_dtype": self.kv_wire_dtype,
                "transfers": self._kv_transfers,
                "payload_bytes": self._kv_payload_bytes,
                "wire_bytes": self._kv_wire_bytes,
                "chunk_bytes": self.kv_chunk_bytes,
            },
        }
        if self.kv_kl is not None:
            out["kv_stream"]["token_kl"] = self.kv_kl
            out["kv_stream"]["kl_bound"] = self.kv_kl_bound
        if res:
            sojourns = sorted(r.sojourn_steps for r in res)
            ttfts = sorted(r.ttft_steps for r in res if r.first_token_step >= 0)
            out["p50_sojourn_steps"] = pct(sojourns, 0.50)
            out["p99_sojourn_steps"] = pct(sojourns, 0.99)
            if ttfts:
                # arrival → first token: queue wait + prefill-pod service
                out["p50_ttft_steps"] = pct(ttfts, 0.50)
                out["p99_ttft_steps"] = pct(ttfts, 0.99)
                out["pools"]["prefill"]["p50_sojourn_steps"] = pct(ttfts, 0.50)
                out["pools"]["prefill"]["p99_sojourn_steps"] = pct(ttfts, 0.99)
            decode_res = sorted(r.completed_step - self._migrated[r.req_id] for r in res if r.req_id in self._migrated)
            if decode_res:
                # migration → completion: decode-pod residency
                out["pools"]["decode"]["p50_sojourn_steps"] = pct(decode_res, 0.50)
                out["pools"]["decode"]["p99_sojourn_steps"] = pct(decode_res, 0.99)
        snap = self.metrics.snapshot()
        for pool in ("prefill", "decode"):
            step_t = snap["timings"].get(f"serve.{pool}.step_s")
            if step_t:
                out["pools"][pool]["p50_step_ms"] = step_t["p50_s"] * 1e3
                out["pools"][pool]["p99_step_ms"] = step_t["p99_s"] * 1e3
        if self.slo_ms is not None and res:
            within = sum(1 for r in res if r.wall_s * 1e3 <= self.slo_ms)
            out["slo_ms"] = self.slo_ms
            out["slo_attainment"] = within / len(res)
        return out
