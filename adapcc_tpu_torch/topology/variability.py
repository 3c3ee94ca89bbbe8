"""Long-horizon network-variability probes (the port of
:mod:`adapcc_tpu.topology.variability`, the reference's cloud/ study).

The reference characterizes cloud interconnect variability with iperf probes
every 5 s for hours, logging timestamped bandwidth and latency readings to
trace files (cloud/band_profile.py:16-30): the evidence behind periodic
re-adaptation (``profile_freq``).  Here a background thread samples the
world with the online profiler's one-hop offset probe
(:class:`~adapcc_tpu_torch.topology.profile.NetworkProfiler`) and appends to
trace files of the same shape; :func:`detect_drift` over the trace says when
a re-profile and re-synthesis are worth their cost.  On one card every rank
shares the device, so a reading is a device-memory copy, not a link.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from adapcc_tpu_torch.comm.mesh import DeviceLike
from adapcc_tpu_torch.topology.profile import LATENCY_PROBE_FLOATS, NetworkProfiler, bandwidth_gbps

#: the trailing-median window of drift detection (samples)
_DRIFT_WINDOW = 12


def detect_drift(
    history: Sequence[float],
    threshold: float = 0.3,
    window: int = _DRIFT_WINDOW,
    consecutive: int = 1,
    direction: str = "both",
) -> bool:
    """Have the newest ``consecutive`` readings each left the median of the
    ``window`` readings before them by more than ``threshold`` (relative)?
    ``consecutive > 1`` asks for a sustained departure, so one noisy probe
    cannot trigger a re-synthesis; ``direction`` is ``"down"`` (a degraded
    link), ``"up"`` or ``"both"``."""
    if direction not in ("down", "up", "both"):
        raise ValueError(f"direction must be down/up/both, got {direction!r}")
    if consecutive < 1:
        raise ValueError(f"consecutive must be >= 1, got {consecutive}")
    if len(history) < consecutive + 1:
        return False
    base = statistics.median(history[-window - consecutive:-consecutive])
    if base <= 0:
        return False
    for v in history[-consecutive:]:
        rel = (v - base) / base
        if direction == "down":
            hit = rel < -threshold
        elif direction == "up":
            hit = rel > threshold
        else:
            hit = abs(rel) > threshold
        if not hit:
            return False
    return True


class VariabilityMonitor:
    """Periodic probes with timestamped traces over a world of
    ``world_size`` ranks on ``device`` (the card unless the caller passes
    one).

    A sample is one ring-offset-1 round (every neighbour pair at once): a
    small payload's time is the latency, a large one's the bandwidth.
    ``on_drift`` is called from the monitor's thread when
    :func:`detect_drift` fires on the bandwidth trace."""

    def __init__(
        self,
        world_size: int,
        device: DeviceLike = None,
        interval_s: float = 5.0,
        out_dir: Optional[str] = None,
        probe_floats: int = 1 << 18,
        drift_threshold: float = 0.3,
        on_drift: Optional[Callable[[float], None]] = None,
        max_samples: int = 100_000,
        drift_consecutive: int = 1,
        drift_direction: str = "both",
    ) -> None:
        # a bad drift setting fails here, not later on the monitor's thread
        if drift_direction not in ("down", "up", "both"):
            raise ValueError(f"drift_direction must be down/up/both, got {drift_direction!r}")
        if drift_consecutive < 1:
            raise ValueError(f"drift_consecutive must be >= 1, got {drift_consecutive}")
        self.interval_s = interval_s
        self.out_dir = out_dir
        self.drift_threshold = drift_threshold
        self.drift_consecutive = drift_consecutive
        self.drift_direction = drift_direction
        self.on_drift = on_drift
        #: in-memory traces keep the newest ``max_samples`` (the files keep all)
        self.max_samples = max_samples
        self.bandwidth_trace: List[Tuple[float, float]] = []  # (ts, GB/s)
        self.latency_trace: List[Tuple[float, float]] = []  # (ts, s)
        profiler = NetworkProfiler(world_size, device, warmup=1, iters=1)
        self._bw_probe = profiler.make_probe(1, probe_floats)
        self._lat_probe = profiler.make_probe(1, LATENCY_PROBE_FLOATS)
        self._probe_bytes = probe_floats * 4
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    # -- sampling --------------------------------------------------------------

    def sample(self) -> Tuple[float, float]:
        """One (bandwidth GB/s, latency s) reading over the neighbour pairs."""
        t_lat = self._lat_probe()
        gbps = bandwidth_gbps(self._probe_bytes, self._bw_probe())
        ts = time.time()
        self.bandwidth_trace.append((ts, gbps))
        self.latency_trace.append((ts, t_lat))
        for trace in (self.bandwidth_trace, self.latency_trace):
            if len(trace) > self.max_samples:
                del trace[:-self.max_samples]
        if self.out_dir:
            self._append(os.path.join(self.out_dir, "bandwidth.txt"), ts, gbps)
            self._append(os.path.join(self.out_dir, "latency.txt"), ts, t_lat)
        if self.on_drift is not None and detect_drift(
                [v for _, v in self.bandwidth_trace[-_DRIFT_WINDOW - self.drift_consecutive:]],
                self.drift_threshold, consecutive=self.drift_consecutive, direction=self.drift_direction):
            self.on_drift(gbps)
        return gbps, t_lat

    @staticmethod
    def _append(path: str, ts: float, value: float) -> None:
        # %g keeps the significant digits of µs-scale latencies
        with open(path, "a") as f:
            f.write(f"{ts:.3f} {value:.9g}\n")

    # -- background loop -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("monitor already running")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                self.sample()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="adapcc-varmon")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- analysis --------------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        """Min, median and max of the bandwidth trace."""
        values = [v for _, v in self.bandwidth_trace]
        if not values:
            return {"samples": 0.0}
        return {
            "samples": float(len(values)),
            "bw_min_gbps": min(values),
            "bw_median_gbps": statistics.median(values),
            "bw_max_gbps": max(values),
        }


def load_trace(path: str) -> List[Tuple[float, float]]:
    """Read a ``ts value`` trace file back."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                out.append((float(parts[0]), float(parts[1])))
    return out
