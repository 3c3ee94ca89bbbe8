"""Observability: the metrics registry and the collective dispatch trace.

The port of :mod:`adapcc_tpu.utils.observability`'s sinks, value for value:

- :func:`nearest_rank_percentile`, the one percentile convention every
  consumer quotes (the registry, the trace summary, the tuning database);
- :class:`MetricsRegistry`: counters, gauges and timings with a bounded,
  deterministically seeded reservoir for p50/p99;
- :class:`CollectiveTrace` of :class:`TraceEvent`: one event per engine
  dispatch (the reference's ``log/track.txt``), a bounded ring that evicts
  its oldest event, dumped as ``track.txt`` lines (read back by
  :func:`parse_track_log`) or as a ``chrome://tracing`` file;
- the training meters :class:`AverageMeter` and :class:`ProgressMeter`
  (the reference's accuracy_benchmark.py:470-539);
- :func:`profiler_trace`, a ``torch.profiler`` capture written under a log
  directory (JAX's ``jax.profiler`` trace), and :func:`parse_training_log`,
  the ``(step, value)`` scraper of free-form training logs.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import re
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple


# --- training meters (accuracy_benchmark.py:470-539) --------------------------


class AverageMeter:
    """Tracks current value, running average, sum, count."""

    def __init__(self, name: str, fmt: str = ":f") -> None:
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """``[ 10/500] loss 0.61 (0.73)  acc 81.2 (76.9)``-style progress lines."""

    def __init__(self, num_batches: int, meters: Sequence[AverageMeter], prefix: str = "") -> None:
        num_digits = len(str(num_batches // 1))
        self._batch_fmt = "[" + "{:" + str(num_digits) + "d}" + "/" + str(num_batches) + "]"
        self.meters = list(meters)
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self._batch_fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print(line)
        return line


def nearest_rank_percentile(sorted_samples: Sequence[float], q: float) -> float:
    """The nearest-rank percentile of ``sorted_samples`` (ascending, not
    empty): the convention every percentile of the package uses."""
    rank = max(0, int(-(-q * len(sorted_samples) // 1)) - 1)
    return sorted_samples[min(rank, len(sorted_samples) - 1)]


class MetricsRegistry:
    """Named counters, gauges and timings with JSON export; thread-safe.

    A timing keeps its count, total and max exactly, and a reservoir of at
    most :attr:`RESERVOIR_SIZE` samples (Vitter's algorithm R, seeded) for
    the p50/p99 of :meth:`snapshot`: two identical runs snapshot identical
    percentiles."""

    RESERVOIR_SIZE = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._timings: Dict[str, Dict[str, Any]] = {}
        self._rng = random.Random(0x5EED)

    def incr(self, name: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += by

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Host walltime of the block into the ``name`` timing.  The block
        must wait for any device work it times."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, seconds: float) -> None:
        """Record an externally measured duration into the ``name`` timing."""
        s = float(seconds)
        with self._lock:
            t = self._timings.get(name)
            if t is None:
                t = self._timings[name] = {"count": 0, "total": 0.0, "max": s, "reservoir": []}
            t["count"] += 1
            t["total"] += s
            t["max"] = max(t["max"], s)
            res = t["reservoir"]
            if len(res) < self.RESERVOIR_SIZE:
                res.append(s)
            else:
                j = self._rng.randrange(t["count"])
                if j < self.RESERVOIR_SIZE:
                    res[j] = s

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            timings = {}
            for k, t in self._timings.items():
                if not t["count"]:
                    continue
                res = sorted(t["reservoir"])
                timings[k] = {
                    "count": t["count"],
                    "total_s": t["total"],
                    "mean_s": t["total"] / t["count"],
                    "max_s": t["max"],
                    "p50_s": nearest_rank_percentile(res, 0.50),
                    "p99_s": nearest_rank_percentile(res, 0.99),
                }
            return {"counters": dict(self._counters), "gauges": dict(self._gauges), "timings": timings}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


@dataclass
class TraceEvent:
    ts: float
    primitive: str
    impl: str
    nbytes: int
    step: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)


class CollectiveTrace:
    """The engine's dispatch record: which collective ran, on how many
    bytes, under which implementation, one event a call.  At ``capacity``
    the oldest event is evicted for each new one (``dropped`` counts them),
    so a long run's trace ends in its steady state."""

    def __init__(self, capacity: int = 100_000) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: "deque[TraceEvent]" = deque(maxlen=capacity)
        self._dropped = 0

    def record(self, primitive: str, impl: str, nbytes: int, step: Optional[int] = None, **extra: Any) -> None:
        ev = TraceEvent(time.time(), primitive, impl, nbytes, step, extra)
        with self._lock:
            if len(self._events) >= self.capacity:
                self._dropped += 1  # the deque evicts its oldest on append
            self._events.append(ev)

    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def dump(self, path: str) -> None:
        """``track.txt`` lines: ``ts primitive impl nbytes step {extra}``."""
        with open(path, "w") as f:
            for e in self.events():
                f.write(f"{e.ts:.6f} {e.primitive} {e.impl} {e.nbytes} "
                        f"{-1 if e.step is None else e.step} {json.dumps(e.extra)}\n")

    def impl_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per impl: dispatches, how many carried a measured ``duration_s``,
        and the nearest-rank p50/p99 of those (None with nothing timed)."""
        grouped: Dict[str, List[float]] = {}
        counts: Dict[str, int] = {}
        for e in self.events():
            counts[e.impl] = counts.get(e.impl, 0) + 1
            if "duration_s" in e.extra:
                grouped.setdefault(e.impl, []).append(float(e.extra["duration_s"]))
        out: Dict[str, Dict[str, Any]] = {}
        for impl, count in sorted(counts.items()):
            timed = sorted(grouped.get(impl, []))
            out[impl] = {
                "count": count,
                "timed": len(timed),
                "p50_s": nearest_rank_percentile(timed, 0.50) if timed else None,
                "p99_s": nearest_rank_percentile(timed, 0.99) if timed else None,
            }
        return out

    def dump_chrome_trace(self, path: str, impl_summary: bool = True) -> str:
        """``chrome://tracing`` / Perfetto JSON: one complete ("X") event a
        dispatch, with its measured ``duration_s`` as extent (a timed event
        is recorded when the dispatch completes, so it starts that much
        earlier) and the plan's provenance in its args; with
        ``impl_summary``, one slice an impl on track 1 spanning its first
        to last dispatch, carrying :meth:`impl_summary`'s numbers."""
        events = self.events()
        trace_events = []
        spans: Dict[str, List[float]] = {}
        for e in events:
            dur_us = float(e.extra.get("duration_s", 0.0)) * 1e6
            start, end = e.ts * 1e6 - dur_us, e.ts * 1e6
            span = spans.setdefault(e.impl, [start, end])
            span[0], span[1] = min(span[0], start), max(span[1], end)
            args: Dict[str, Any] = {"impl": e.impl, "nbytes": e.nbytes}
            if e.step is not None:
                args["step"] = e.step
            for k in ("chunk_bytes", "stage_bytes", "wire_dtype", "wire_bytes"):
                if k in e.extra:
                    args[k] = e.extra[k]
            tuner = e.extra.get("tuner")
            if isinstance(tuner, dict):
                args["tuner_source"] = tuner.get("source")
                args["tuner_applied"] = tuner.get("applied")
                args["tuner_chosen"] = tuner.get("chosen")
            trace_events.append({"name": e.primitive, "cat": "collective", "ph": "X", "ts": start,
                                 "dur": dur_us, "pid": 0, "tid": 0, "args": args})
        if impl_summary:
            for impl, stats in self.impl_summary().items():
                lo, hi = spans[impl]
                args = {"count": stats["count"], "timed": stats["timed"]}
                if stats["p50_s"] is not None:
                    args["p50_us"] = stats["p50_s"] * 1e6
                    args["p99_us"] = stats["p99_s"] * 1e6
                trace_events.append({"name": f"summary:{impl}", "cat": "summary", "ph": "X", "ts": lo,
                                     "dur": max(hi - lo, 1.0), "pid": 0, "tid": 1, "args": args})
            trace_events.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": 1,
                                 "args": {"name": "per-impl summary (p50/p99)"}})
        with open(path, "w") as f:
            json.dump({"traceEvents": trace_events, "displayTimeUnit": "ms"}, f, sort_keys=True)
        return path


def parse_track_log(path: str) -> List[TraceEvent]:
    """Read a :meth:`CollectiveTrace.dump` file back into events."""
    out: List[TraceEvent] = []
    with open(path) as f:
        for line in f:
            parts = line.split(" ", 5)
            if len(parts) != 6:
                continue
            step = int(parts[4])
            out.append(TraceEvent(ts=float(parts[0]), primitive=parts[1], impl=parts[2], nbytes=int(parts[3]),
                                  step=None if step < 0 else step, extra=json.loads(parts[5])))
    return out


# --- torch profiler -------------------------------------------------------------


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace (host ops, and the card's kernels
    and copies where CUDA is available) of the block, written as a Chrome
    trace ``trace.json`` under ``log_dir``; yields the profiler (its
    ``key_averages()`` summarise the capture)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# --- training-log post-processors (process_log.py/process_gns.py) -------------

_FLOAT = r"([-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)"


def parse_training_log(path: str, key: str = "loss", pattern: Optional[str] = None) -> List[Tuple[int, float]]:
    """Scrape ``(step, value)`` pairs out of a free-form training log.

    The default pattern matches ``... step <N> ... <key> <float>`` or
    ``<key>: <float>`` lines (the shapes the reference's process_log.py and
    process_gns.py scrape); ``pattern`` with two groups (step, value) takes
    other formats.
    """
    if pattern is None:
        pattern = rf"step\s*[:=]?\s*(\d+).*?{re.escape(key)}\s*[:=]?\s*{_FLOAT}"
    rx = re.compile(pattern)
    out: List[Tuple[int, float]] = []
    with open(path) as f:
        for line in f:
            m = rx.search(line)
            if m:
                out.append((int(m.group(1)), float(m.group(2))))
    return out
