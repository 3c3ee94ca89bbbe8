"""Network profiling: latency/bandwidth matrices from probe transfers.

The port of :mod:`adapcc_tpu.topology.profile`, in the JAX package's stacked
form.  The reference times ``cudaMemcpyPeerAsync`` per GPU pair and paired
MPI probes across nodes (csrc/profile.cu:163-334); the JAX package times
one-hop ``ppermute`` rounds of the mesh axis.  Here the offset-``o`` probe
moves every row of a ``[world, n]`` float32 tensor to row ``(r + o) %
world`` on the world's device, timed by CUDA events on the card and by the
host clock on the CPU.  All rows of a stacked world share one device, so on
one card a probe measures device-memory copies, not links.  The CSV artifact
(``topo_profile_<rank>``, rows ``src,dst,type,value``) is the reference's.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Callable, Tuple

import numpy as np
import torch

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device

#: probe payloads, mirroring the reference's probe sizes: 64 floats for
#: latency, 1M floats for inter-node bandwidth (profile.cu:120-158)
LATENCY_PROBE_FLOATS = 64
BANDWIDTH_PROBE_FLOATS = 1 << 20

_LAT, _BW = "lat", "bw"


def bandwidth_gbps(nbytes: int, seconds: float) -> float:
    """Transfer rate in GB/s (decimal), guarded against zero timings."""
    return nbytes / max(seconds, 1e-9) / 1e9


class NetworkProfiler:
    """Measures per-link latency (s) and bandwidth (GB/s) over a stacked
    world of ``world_size`` ranks on ``device`` (the card unless the caller
    passes ``"cpu"``)."""

    def __init__(self, world_size: int, device: DeviceLike = None, warmup: int = 1, iters: int = 3):
        self.world = int(world_size)
        self.device = resolve_device(device)
        self.warmup = warmup
        self.iters = iters

    # -- probe programs --------------------------------------------------------

    def _offset_shift_fn(self, offset: int, n_floats: int) -> Tuple[Callable[[], torch.Tensor], torch.Tensor]:
        """``(shift, x)``: ``shift()`` moves every rank's row of ``x`` one
        hop to ``(rank + offset) % world`` and returns the moved tensor, a
        full ring-offset round, so one timing exercises every pair of that
        offset class at once."""
        world, o = self.world, offset % self.world
        x = torch.zeros((world, n_floats), dtype=torch.float32, device=self.device)
        out = torch.empty_like(x)

        def shift() -> torch.Tensor:
            out[o:].copy_(x[:world - o])
            if o:
                out[:o].copy_(x[world - o:])
            return out

        return shift, x

    def _elapsed(self, fn: Callable[[], torch.Tensor]) -> float:
        """Mean seconds of ``iters`` back-to-back calls."""
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / self.iters
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
        return (time.perf_counter() - t0) / self.iters

    def make_probe(self, offset: int, n_floats: int) -> Callable[[], float]:
        """A reusable zero-arg probe: each call times one ring-offset round
        and returns seconds; the warmup runs on the first call only."""
        fn, _ = self._offset_shift_fn(offset, n_floats)
        warmed = False

        def probe() -> float:
            nonlocal warmed
            if not warmed:
                for _ in range(self.warmup):
                    fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                warmed = True
            return self._elapsed(fn)

        return probe

    # -- matrix profiling ------------------------------------------------------

    def profile(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (latency_matrix [s], bandwidth_matrix [GB/s]), world×world.

        The offset-``o`` round fills all pairs with ``dst − src ≡ o (mod
        world)``, so every off-diagonal pair is covered."""
        world = self.world
        lat = np.zeros((world, world))
        bw = np.zeros((world, world))
        if world == 1:
            return lat, bw
        for offset in range(1, world):
            t_lat = self.make_probe(offset, LATENCY_PROBE_FLOATS)()
            t_bw = self.make_probe(offset, BANDWIDTH_PROBE_FLOATS)()
            gbps = bandwidth_gbps(BANDWIDTH_PROBE_FLOATS * 4, t_bw)
            for src in range(world):
                dst = (src + offset) % world
                lat[src][dst] = t_lat
                bw[src][dst] = gbps
        return lat, bw

    # -- artifacts -------------------------------------------------------------

    def dump(self, out_dir: str, rank: int = 0) -> str:
        """Write ``topo_profile_<rank>`` CSV rows ``src,dst,type,value``
        (artifact contract of profile.cu:336-357)."""
        os.makedirs(out_dir, exist_ok=True)
        lat, bw = self.profile()
        path = os.path.join(out_dir, f"topo_profile_{rank}")
        with open(path, "w") as f:
            for src in range(self.world):
                for dst in range(self.world):
                    if src == dst:
                        continue
                    f.write(f"{src},{dst},{_LAT},{lat[src][dst]:.9f}\n")
                    f.write(f"{src},{dst},{_BW},{bw[src][dst]:.6f}\n")
        return path


def gather_topo_profile(topology_dir: str, world: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge ``topo_profile_*`` CSVs into lat/bw matrices (analog of
    ``_gather_topo_profile``, commu.py:246-270)."""
    lat = np.zeros((world, world))
    bw = np.zeros((world, world))
    for path in sorted(glob.glob(os.path.join(topology_dir, "topo_profile_*"))):
        with open(path) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) != 4:
                    continue
                src, dst, typ, val = int(parts[0]), int(parts[1]), parts[2], float(parts[3])
                if not (0 <= src < world and 0 <= dst < world):
                    continue  # stale artifact from a different world size
                if typ == _LAT:
                    lat[src][dst] = val
                elif typ == _BW:
                    bw[src][dst] = val
    return lat, bw
