"""Timing harness: engine dispatches → tuning-database samples.

The port of :mod:`adapcc_tpu.tuner.measure`.  Two feeds produce samples:

- **live**: the engine, the trainer and the ZeRO-1 step hand
  :meth:`DispatchTimer.observe` the walltime of each dispatch, from the
  call to the completion of its work (a device sync before the clock is
  read), whenever a tuner records.  The first observation of each cache
  token is discarded: it paid the kernels' build and first launch, not the
  plan's steady-state cost.
- **offline**: :func:`replay_trace` turns the ``duration_s`` of a recorded
  :class:`~adapcc_tpu_torch.utils.observability.CollectiveTrace` (or of a
  parsed ``track.txt``) into samples, keyed as the live feed keys them.

A sample is the walltime, not the device time: the host's share of a
dispatch is a cost the tuner has to rank too.
"""

from __future__ import annotations

import time
from typing import Any, Hashable, Iterable, List, Optional, Set, Tuple, Union

import torch

from adapcc_tpu_torch.tuner.db import TuningDatabase, TuningKey, size_bucket


def sync_device(device: Any) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sync_outputs(out: Any) -> None:
    """Wait for the device work behind ``out``: a device sync for each card
    that holds one of its tensors (a tensor, or one nested in a tuple, list
    or dict).  Nothing waits on the CPU."""
    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    for device in devices:
        sync_device(device)


def timed_call(fn, *args, warmup: int = 1, iters: int = 3) -> List[float]:
    """Walltime samples of ``fn(*args)``: ``warmup`` calls discarded (the
    build and first launch), then ``iters`` timed calls, each waited to
    completion."""
    if warmup < 0 or iters < 1:
        raise ValueError(f"need warmup >= 0 and iters >= 1, got {warmup}/{iters}")
    for _ in range(warmup):
        sync_outputs(fn(*args))
    out: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync_outputs(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


class DispatchTimer:
    """Warmup-aware funnel from live dispatches into the database: the
    first observation of each ``cache_token`` is dropped."""

    def __init__(self, db: TuningDatabase) -> None:
        self.db = db
        self._warmed: Set[Hashable] = set()
        #: observations discarded as warmup
        self.discarded = 0
        #: observations recorded
        self.recorded = 0

    def observe(self, key: TuningKey, cache_token: Hashable, seconds: float) -> bool:
        """Record one dispatch walltime; False when it was discarded as its
        token's warmup."""
        if cache_token not in self._warmed:
            self._warmed.add(cache_token)
            self.discarded += 1
            return False
        self.db.record(key, seconds)
        self.recorded += 1
        return True

    def reset(self) -> None:
        """Forget warmup state (an engine ``clear()``)."""
        self._warmed.clear()


# --------------------------------------------------------------------------- #
# offline feed: CollectiveTrace replay
# --------------------------------------------------------------------------- #

#: impl prefixes of the ring plane's kernels and of their plain version
_RING_IMPLS = ("cuda_ring[", "plain_ring[")


def _key_from_event(event: Any, world: int, topology: str) -> Optional[TuningKey]:
    """TraceEvent → TuningKey, or None when the event carries no timing or
    has no plan cell (a schedule dispatch, a flat gather or scatter)."""
    extra = getattr(event, "extra", None) or {}
    if "duration_s" not in extra:
        return None
    impl = getattr(event, "impl", "")
    per_rank = int(extra.get("per_rank_bytes", 0))
    if per_rank <= 0:
        # stacked nbytes = world × the per-rank payload
        per_rank = max(1, int(event.nbytes) // max(1, world))
    from adapcc_tpu_torch.tuner.policy import (
        A2A_XLA_PATH, ALGO_PATHS, NO_CHUNK, QUANT_PATH, TORCH_FUSED_IMPL, XLA_PATH,
    )

    def key(path: str, chunk: int, wire: str) -> TuningKey:
        return TuningKey(primitive=event.primitive, size_bucket=size_bucket(per_rank), world=world,
                         topology=topology, path=path, chunk_bytes=chunk, wire_dtype=wire)

    for prefix in _RING_IMPLS:
        if impl.startswith(prefix):
            path = impl[len(prefix):-1]
            # a fused codec dispatch spells the codec into the impl
            # ("cuda_ring[hbm-stream+int8]"); the extras carry it too
            wire = "off"
            if "+" in path:
                path, wire = path.split("+", 1)
            # vmem is one cell whatever the budget (the grid's vocabulary)
            chunk = NO_CHUNK if path == "vmem" else int(extra.get("chunk_bytes", 0))
            return key(path, chunk, str(extra.get("wire_dtype", wire)))
    if impl.startswith("quant_ring["):
        return key(QUANT_PATH, NO_CHUNK, str(extra.get("wire_dtype", impl[len("quant_ring["):-1])))
    if impl in ALGO_PATHS:
        return key(impl, NO_CHUNK, "off")
    if event.primitive == "allreduce" and impl == TORCH_FUSED_IMPL:
        # the flat fast path: the xla cell's measurable arm
        return key(XLA_PATH, NO_CHUNK, "off")
    if event.primitive == "all_to_all" and impl in ("torch_flat", A2A_XLA_PATH, "two_level"):
        # the flat exchange (the port's torch_flat, JAX's xla) and the
        # two-level one: the all_to_all cells the engine records
        return key(A2A_XLA_PATH if impl == "torch_flat" else impl, NO_CHUNK, "off")
    return None


def replay_trace(
    trace: Union[Any, Iterable[Any]],
    db: TuningDatabase,
    world: int,
    topology: str,
) -> Tuple[int, int]:
    """Feed a recorded :class:`CollectiveTrace` (or an iterable of
    :class:`TraceEvent`, e.g. from ``parse_track_log``) into ``db``.
    Returns ``(ingested, skipped)``: skipped events carry no ``duration_s``
    or have no plan cell."""
    events = trace.events() if hasattr(trace, "events") else list(trace)
    ingested = skipped = 0
    for ev in events:
        k = _key_from_event(ev, world, topology)
        if k is None:
            skipped += 1
            continue
        db.record(k, float(ev.extra["duration_s"]), ts=float(ev.ts))
        ingested += 1
    return ingested, skipped
