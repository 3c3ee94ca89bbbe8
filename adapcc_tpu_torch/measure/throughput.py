"""Training-throughput measurement (units-test/throughput.py analog), the
port of :mod:`adapcc_tpu.measure.throughput`.

The meter wraps any step callable: it synchronizes the device before it
reads the clock at either end of a step (the card runs asynchronously, as
XLA dispatch does), keeps per-step wall times, and reports mean/median
throughput excluding warmup (the reference's first-op CUDA-cache caveat,
README.md:106-107).
"""

from __future__ import annotations

import csv
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class ThroughputMeter:
    def __init__(self, samples_per_step: int, warmup_steps: int = 1) -> None:
        self.samples_per_step = samples_per_step
        self.warmup_steps = warmup_steps
        self.step_times: List[float] = []

    def timed_step(self, fn: Callable[[], Any]) -> Any:
        """Run one step, the card (where there is one) synchronized before
        each clock read."""
        _sync()
        t0 = time.perf_counter()
        out = fn()
        _sync()
        self.step_times.append(time.perf_counter() - t0)
        return out

    def _measured(self) -> List[float]:
        return self.step_times[self.warmup_steps:]

    def summary(self) -> Dict[str, float]:
        times = self._measured()
        if not times:
            return {"steps": 0.0, "samples_per_s": 0.0, "mean_step_s": 0.0, "median_step_s": 0.0}
        mean = sum(times) / len(times)
        return {
            "steps": float(len(times)),
            "samples_per_s": self.samples_per_step / mean,
            "mean_step_s": mean,
            "median_step_s": statistics.median(times),
        }

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "step_time_s", "samples_per_s"])
            for i, t in enumerate(self.step_times):
                w.writerow([i, f"{t:.6f}", f"{self.samples_per_step / t:.3f}"])

    def run(self, step_fn: Callable[[int], Any], num_steps: int, probe: Optional[Any] = None,
            rank: int = 0) -> Dict[str, float]:
        """Time ``num_steps`` calls of ``step_fn(i)``; optionally stamp a
        :class:`~adapcc_tpu_torch.measure.wait_time.WaitTimeProbe` per step
        (the reference couples both measurements in one harness)."""
        for i in range(num_steps):
            self.timed_step(lambda: step_fn(i))
            if probe is not None:
                probe.stamp(i, rank)
        return self.summary()
