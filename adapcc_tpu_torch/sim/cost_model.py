"""Per-link α-β transfer cost model: the prior the plan tuner ranks by and
the hook prices its overlap schedules with.

The port of the part of :mod:`adapcc_tpu.sim.cost_model` that the tuner
(:mod:`adapcc_tpu_torch.tuner.policy`), the gradient hook, the simulator's
ranking (the lower bounds, the ``sim-rank`` codec choice), the failover
pricing and the adaptation loop (contention: β scaled, α intact; the
synthesizer's matrices of a model; the adaptation arms) call, formula for
formula.  One point-to-point transfer of ``n`` bytes costs

    t(n) = α + β·n          α = fixed latency [s], β = inverse bandwidth [s/B]

and the collectives' closed forms build on the slowest ring hop
(:func:`bottleneck_ring_coeffs`).  Links are classed ``ICI`` (one host's
fast domain: NVLink here) or ``DCN`` (between hosts: the network) by the
rank → ip table; the class keys keep the JAX package's spelling, since they
are the vocabulary of calibration artifacts, which load in both packages.

The defaults are the H100's, never a TPU's: every number below names its
source.  Any calibration artifact (:mod:`adapcc_tpu_torch.sim.calibrate`)
replaces the link classes.  ``hbm_bytes_per_s`` and ``codec_bytes_per_s``
arguments left at None take this module's default at call time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from adapcc_tpu_torch.topology.profile import BANDWIDTH_PROBE_FLOATS, LATENCY_PROBE_FLOATS

#: link-class labels (the JAX package's keys: intra-host, inter-host)
ICI = "ici"
DCN = "dcn"

#: probe payload sizes in bytes (float32 probes, topology/profile.py)
LATENCY_PROBE_BYTES = LATENCY_PROBE_FLOATS * 4
BANDWIDTH_PROBE_BYTES = BANDWIDTH_PROBE_FLOATS * 4

#: α as a world-4 prior: the median walltime of one whole 4-byte-a-rank
#: ``ring_allreduce`` dispatch on one card (Python engine, planner, one K1a
#: launch, device sync: 233.17 µs) spread over the 2·(4−1) hops of a world-4
#: ring, measured by ``chip_smoke.py`` phase 14(d) on an NVIDIA H100 80GB
#: HBM3 at a 700.00 W ``nvidia-smi`` power limit (38.861 µs in one run,
#: 29.4 µs in another).  It is a per-dispatch host cost, not a per-hop link
#: latency: ``α·2(w−1)`` reproduces it only at world 4 and overstates it at
#: larger worlds.  Splitting dispatch overhead from a per-hop α needs two
#: cards, which no run has had yet.
MEASURED_ALPHA_S = 38.861e-6

#: fallback coefficients when nothing was ever measured: the intra-host
#: class is NVLink 4, 450 GB/s a direction on an H100 SXM5 (NVIDIA data
#: sheet: 900 GB/s bidirectional), with the world-4 α above; the inter-host
#: class a 400 Gb/s NIC (50 GB/s, ConnectX-7 NDR data sheet), whose α was
#: never measured and borrows the intra-host prior.
DEFAULT_COEFFS = {
    ICI: (MEASURED_ALPHA_S, 1.0 / 450e9),
    DCN: (MEASURED_ALPHA_S, 1.0 / 50e9),
}

#: HBM streaming rate pricing a staged kernel's local traffic: H100 SXM5
#: 80GB HBM3, 3.35 TB/s (NVIDIA data sheet)
DEFAULT_HBM_BYTES_PER_S = 3.35e12

#: throughput of one elementwise codec pass over float32 payload bytes: the
#: int8 codec's quantize and dequantize (``quant/codec.py::timed_roundtrip``,
#: p50 2.7559 and 1.0960 ms) on the GPT-2's 642.6 MiB-a-rank gradient,
#: payload bytes over their mean, measured by ``chip_smoke.py`` phase 14(d)
#: on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (bf16's passes ran
#: at 1399.30 GB/s: int8, the slower codec, prices both)
DEFAULT_CODEC_BYTES_PER_S = 349.88e9

#: quantization block the pricing assumes when none is given (the codec's)
DEFAULT_QUANT_BLOCK = 256

#: wire codecs the pricing knows, "off" first
WIRE_DTYPE_CANDIDATES = ("off", "bf16", "int8")

#: overlap schedules the pricing knows (``ddp/overlap.py::OVERLAP_MODES``)
OVERLAP_MODE_CANDIDATES = ("off", "bucket", "microbatch")

#: allreduce algorithms the pricing knows (the engine's ``algo`` values but
#: ``auto`` and ``ir``)
COLL_ALGO_CANDIDATES = ("ring", "rd", "tree")

Link = Tuple[int, int]


@dataclass(frozen=True)
class LinkCoeffs:
    """α [s] + β [s/byte] for one link (or one link class)."""

    alpha: float
    beta: float

    def time(self, nbytes: float) -> float:
        return self.alpha + self.beta * float(nbytes)

    def scaled(self, factor: float) -> "LinkCoeffs":
        """Both terms slowed by ``factor`` (a degraded link)."""
        return LinkCoeffs(self.alpha * factor, self.beta * factor)


def fit_alpha_beta(points: Sequence[Tuple[float, float]]) -> LinkCoeffs:
    """Least-squares line ``t = α + β·bytes`` through (bytes, seconds)
    points; negative coefficients clamp to zero, and one point is read as
    pure latency."""
    pts = [(float(b), float(t)) for b, t in points]
    if not pts:
        raise ValueError("need at least one (bytes, seconds) probe point")
    if len(pts) == 1:
        return LinkCoeffs(alpha=max(0.0, pts[0][1]), beta=0.0)
    a = np.array([[1.0, b] for b, _ in pts])
    y = np.array([t for _, t in pts])
    (alpha, beta), *_ = np.linalg.lstsq(a, y, rcond=None)
    return LinkCoeffs(alpha=max(0.0, float(alpha)), beta=max(0.0, float(beta)))


class LinkCostModel:
    """Prices point-to-point transfers: per-link coefficients where probed,
    class means elsewhere, :data:`DEFAULT_COEFFS` as the last resort."""

    def __init__(
        self,
        world: int,
        links: Optional[Mapping[Link, LinkCoeffs]] = None,
        classes: Optional[Mapping[str, LinkCoeffs]] = None,
        ips: Optional[Mapping[int, str]] = None,
        source: str = "unspecified",
    ) -> None:
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.links: Dict[Link, LinkCoeffs] = dict(links or {})
        self.classes: Dict[str, LinkCoeffs] = {cls: LinkCoeffs(*DEFAULT_COEFFS[cls]) for cls in (ICI, DCN)}
        self.classes.update(classes or {})
        self.ips = dict(ips) if ips else None
        #: provenance carried into artifacts ("matrices", "synthetic", ...)
        self.source = source

    def link_class_of(self, src: int, dst: int) -> str:
        """Directed link → class by the ip table; without one everything is
        one fast domain (ICI)."""
        if self.ips is None:
            return ICI
        return ICI if self.ips.get(src) == self.ips.get(dst) else DCN

    def coeffs(self, src: int, dst: int) -> LinkCoeffs:
        hit = self.links.get((src, dst))
        if hit is not None:
            return hit
        return self.classes[self.link_class_of(src, dst)]

    def time_for(self, src: int, dst: int, nbytes: float) -> float:
        """Seconds to move ``nbytes`` over (src → dst), uncontended."""
        return self.coeffs(src, dst).time(nbytes)

    @classmethod
    def from_matrices(
        cls,
        lat: np.ndarray,
        bw: np.ndarray,
        ips: Optional[Mapping[int, str]] = None,
        source: str = "matrices",
    ) -> "LinkCostModel":
        """Per-link (α, β) from the profiler's matrices: ``lat[s][d]`` the
        small probe's time [s], ``bw[s][d]`` the large probe's rate [GB/s].
        A pair without usable readings takes its class's coefficients, and
        each probed class's mean is refitted from its links."""
        lat = np.asarray(lat, dtype=float)
        bw = np.asarray(bw, dtype=float)
        world = lat.shape[0]
        if lat.shape != (world, world) or bw.shape != (world, world):
            raise ValueError(f"expected square world matrices, got {lat.shape}/{bw.shape}")
        model = cls(world, ips=ips, source=source)
        per_class: Dict[str, list] = {ICI: [], DCN: []}
        for s in range(world):
            for d in range(world):
                if s == d:
                    continue
                points = []
                if lat[s][d] > 0:
                    points.append((LATENCY_PROBE_BYTES, lat[s][d]))
                if bw[s][d] > 0:
                    points.append((BANDWIDTH_PROBE_BYTES, BANDWIDTH_PROBE_BYTES / (bw[s][d] * 1e9)))
                if not points:
                    continue
                coeffs = fit_alpha_beta(points)
                model.links[(s, d)] = coeffs
                per_class[model.link_class_of(s, d)].append(coeffs)
        for cls_name, fitted in per_class.items():
            if fitted:
                model.classes[cls_name] = LinkCoeffs(
                    alpha=float(np.mean([c.alpha for c in fitted])),
                    beta=float(np.mean([c.beta for c in fitted])),
                )
        return model

    def degraded(self, slow_ranks: Sequence[int], slowdown: float) -> "LinkCostModel":
        """A copy with every link touching a slow rank ``slowdown`` ≥ 1 times
        dearer (both terms): the straggler scenario the relay rule prices."""
        if slowdown < 1.0:
            raise ValueError(f"slowdown must be >= 1, got {slowdown}")
        model = LinkCostModel(self.world, dict(self.links), dict(self.classes), self.ips, source=self.source)
        for r in set(slow_ranks):
            for other in range(self.world):
                if other == r:
                    continue
                for link in ((r, other), (other, r)):
                    model.links[link] = self.coeffs(*link).scaled(slowdown)
        return model

    def contended(self, class_factors: Mapping[str, float]) -> "LinkCostModel":
        """A copy with the named link classes' bandwidth cut by their factor:
        congestion, not degradation.  β scales (a neighbour's traffic takes
        a share of the bandwidth), α stays (the wire's latency survives),
        on the class coefficients and on the per-link fits of those classes
        alike.  :meth:`degraded` stretches both terms: that α/β signature is
        what the congestion-against-degradation triage separates."""
        for cls_name, factor in class_factors.items():
            if cls_name not in self.classes:
                raise ValueError(f"unknown link class {cls_name!r}; expected one of {sorted(self.classes)}")
            if factor < 1.0:
                raise ValueError(f"contention factor must be >= 1, got {factor} for class {cls_name!r}")
        classes = {cls_name: (contended_coeffs(c, class_factors[cls_name]) if cls_name in class_factors else c)
                   for cls_name, c in self.classes.items()}
        links = {link: (contended_coeffs(c, class_factors[self.link_class_of(*link)])
                        if self.link_class_of(*link) in class_factors else c)
                 for link, c in self.links.items()}
        joined = ",".join(f"{cls}x{f:g}" for cls, f in sorted(class_factors.items()))
        return LinkCostModel(self.world, links=links, classes=classes, ips=self.ips,
                             source=f"{self.source}+contended[{joined}]")

    def with_ips(self, ips: Optional[Mapping[int, str]]) -> "LinkCostModel":
        """A copy pricing the same coefficients under ``ips``'s host layout."""
        return LinkCostModel(self.world, links=self.links, classes=self.classes, ips=ips, source=self.source)

    def to_graphs(self) -> Tuple[list, list]:
        """(bandwidth [GB/s], latency [s]) matrices read off the
        coefficients: the synthesizer's input spelling of this model, so the
        candidate shapes of an online re-rank are synthesized for the
        network the replay prices."""
        w = self.world
        bw = [[0.0] * w for _ in range(w)]
        lat = [[0.0] * w for _ in range(w)]
        for s in range(w):
            for d in range(w):
                if s == d:
                    continue
                c = self.coeffs(s, d)
                lat[s][d] = c.alpha
                bw[s][d] = 1.0 / (c.beta * 1e9) if c.beta > 0 else 1e6
        return bw, lat

    @classmethod
    def from_topo_profile_dir(cls, topology_dir: str, world: int,
                              ips: Optional[Mapping[int, str]] = None) -> "LinkCostModel":
        """Fit from the ``topo_profile_*`` CSV shards the bootstrap writes."""
        from adapcc_tpu_torch.topology.profile import gather_topo_profile

        lat, bw = gather_topo_profile(topology_dir, world)
        return cls.from_matrices(lat, bw, ips, source=f"profile:{topology_dir}")

    @classmethod
    def uniform(
        cls,
        world: int,
        alpha: float = DEFAULT_COEFFS[ICI][0],
        beta: float = DEFAULT_COEFFS[ICI][1],
        ips: Optional[Mapping[int, str]] = None,
        source: str = "synthetic",
    ) -> "LinkCostModel":
        """Every intra-host link identical: the default with no artifact."""
        return cls(world, classes={ICI: LinkCoeffs(alpha, beta)}, ips=ips, source=source)

    def __repr__(self) -> str:
        return f"LinkCostModel(world={self.world}, links={len(self.links)}, source={self.source!r})"


def _hbm_rate(rate: Optional[float]) -> float:
    return DEFAULT_HBM_BYTES_PER_S if rate is None else rate


def _codec_rate(rate: Optional[float]) -> float:
    return DEFAULT_CODEC_BYTES_PER_S if rate is None else rate


def bottleneck_ring_link(model: LinkCostModel, world: Optional[int] = None) -> Link:
    """The slowest (r → r+1) hop: the link that paces a lockstep ring."""
    w = model.world if world is None else int(world)
    if w < 2:
        return (0, 0)  # degenerate ring
    ring_links = [(r, (r + 1) % w) for r in range(w)]
    return max(ring_links, key=lambda link: model.coeffs(*link).time(1 << 20))


def bottleneck_ring_coeffs(model: LinkCostModel, world: Optional[int] = None) -> LinkCoeffs:
    """The slowest ring hop's coefficients: every ring-shaped price (the
    tuner's prior, the hook's exposed floor) is judged there."""
    return model.coeffs(*bottleneck_ring_link(model, world))


def staged_ring_allreduce_time(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    chunk_bytes: float,
    hbm_bytes_per_s: Optional[float] = None,
) -> float:
    """Latency of the staged ring allreduce (the ``hbm-stream`` path): each
    of the ``2·(world−1)`` steps moves one ``nbytes/world`` chunk as
    ``ceil(chunk / chunk_bytes)`` tiles, a tile one local read (fill), one
    hop and two local moves (reduce-scatter's accumulate) or one (the
    all-gather's adopt), plus the one-time seed copy of the payload."""
    if world < 2:
        return 0.0
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    hbm_rate = _hbm_rate(hbm_bytes_per_s)
    chunk = nbytes / world
    tiles = max(1, int(-(-chunk // chunk_bytes)))
    tile_bytes = chunk / tiles
    hbm = tile_bytes / hbm_rate
    wire = coeffs.time(tile_bytes)
    rs_iter = hbm + wire + 2.0 * hbm       # fill + hop + accumulate in/out
    ag_iter = hbm + wire + hbm             # fill + hop + adopt write
    seed = nbytes / hbm_rate               # input → work buffer
    return seed + (world - 1) * tiles * (rs_iter + ag_iter)


# --------------------------------------------------------------------------- #
# lower bounds: the latency and bandwidth floors no schedule beats, against
# which every ranked candidate's optimality gap is stated
# --------------------------------------------------------------------------- #

#: collectives the lower bounds cover (``sim.replay.COLLECTIVES``; repeated
#: here because replay imports this module)
_LB_COLLECTIVES = ("allreduce", "reduce", "broadcast")


def fastest_coeffs(model: LinkCostModel) -> LinkCoeffs:
    """The smallest α and the smallest β any link offers, taken apart: the
    intra-host class, the inter-host class where an ip table routes over it,
    and every per-link fit."""
    coeffs = [model.classes[ICI]]
    if model.ips is not None:
        coeffs.append(model.classes[DCN])
    coeffs.extend(model.links.values())
    return LinkCoeffs(alpha=min(c.alpha for c in coeffs), beta=min(c.beta for c in coeffs))


def _check_lb_collective(collective: str) -> None:
    if collective not in _LB_COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r}; expected one of {_LB_COLLECTIVES}")


def latency_lower_bound(model: LinkCostModel, collective: str = "allreduce", world: Optional[int] = None) -> float:
    """``α·⌈log₂ p⌉``: the informed set at best doubles a message start, each
    start at least the cheapest α.  ``world`` is the participant count of a
    relay-masked collective."""
    _check_lb_collective(collective)
    p = model.world if world is None else int(world)
    if p <= 1:
        return 0.0
    return math.ceil(math.log2(p)) * fastest_coeffs(model).alpha


def bandwidth_lower_bound(model: LinkCostModel, nbytes: float, collective: str = "allreduce",
                          world: Optional[int] = None) -> float:
    """The byte floor of the busiest port at the cheapest β: ``2(p−1)/p·n``
    for an allreduce, ``(p−1)/p·n`` for a reduce or a broadcast."""
    _check_lb_collective(collective)
    p = model.world if world is None else int(world)
    n = float(nbytes)
    if p <= 1 or n <= 0:
        return 0.0
    factor = 2.0 * (p - 1) / p if collective == "allreduce" else (p - 1) / p
    return factor * n * fastest_coeffs(model).beta


def collective_lower_bound(model: LinkCostModel, nbytes: float, collective: str = "allreduce",
                           world: Optional[int] = None) -> float:
    """Latency floor plus bandwidth floor (they bound disjoint costs)."""
    return latency_lower_bound(model, collective, world) + bandwidth_lower_bound(model, nbytes, collective, world)


def optimality_gap(seconds: float, lower_bound_s: float) -> float:
    """``seconds / LB − 1``; 0 where the bound is degenerate.  Never clamped:
    a negative gap would mean the bound is wrong."""
    if lower_bound_s <= 0:
        return 0.0
    return seconds / lower_bound_s - 1.0


def contended_lower_bound(model: LinkCostModel, nbytes: float, factors: Dict[str, float],
                          collective: str = "allreduce", world: Optional[int] = None) -> float:
    """The floor of a congestion window itself: :func:`collective_lower_bound`
    on :meth:`LinkCostModel.contended`.  A congested measurement gapped
    against the healthy floor would carry the contention factor in its gap."""
    return collective_lower_bound(model.contended(factors), nbytes, collective, world)


def contended_coeffs(coeffs: LinkCoeffs, factor: float) -> LinkCoeffs:
    """One link under background traffic: a neighbour taking
    ``(factor−1)/factor`` of the bandwidth leaves β × factor, α untouched
    (contrast :meth:`LinkCoeffs.scaled`, a degraded link)."""
    if factor < 1.0:
        raise ValueError(f"contention factor must be >= 1 (1 = no contention), got {factor}")
    return LinkCoeffs(coeffs.alpha, coeffs.beta * factor)


def congested_ring_allreduce_time(world: int, nbytes: float, coeffs: LinkCoeffs, factor: float,
                                  wire_dtype: str = "off") -> float:
    """The ring allreduce with its bottleneck hop contended by ``factor``
    (1 is the healthy price)."""
    return quantized_ring_allreduce_time(world, nbytes, contended_coeffs(coeffs, factor), wire_dtype)


def congested_two_level_allreduce_time(num_pods: int, pod_size: int, nbytes: float, ici: LinkCoeffs,
                                       dcn: LinkCoeffs, dcn_factor: float = 1.0, ici_factor: float = 1.0,
                                       pod_algo: str = "rs-ag", leader_algo: str = "tree") -> float:
    """The composed two-level allreduce with each level's class contended:
    the term the leader level's congestion re-solve prices."""
    return two_level_allreduce_time(num_pods, pod_size, nbytes, contended_coeffs(ici, ici_factor),
                                    contended_coeffs(dcn, dcn_factor), pod_algo=pod_algo, leader_algo=leader_algo)


def wire_bytes_per_element(wire_dtype: str, block_size: int = DEFAULT_QUANT_BLOCK, elem_bytes: float = 4.0) -> float:
    """Wire bytes of one payload element under a codec: the payload's own,
    a bf16 cast, or int8 codes plus the block's float32 scale."""
    if wire_dtype == "off":
        return float(elem_bytes)
    if wire_dtype == "bf16":
        return 2.0
    if wire_dtype == "int8":
        return 1.0 + 4.0 / block_size
    raise ValueError(f"unknown wire_dtype {wire_dtype!r}; expected one of {WIRE_DTYPE_CANDIDATES}")


def quantized_ring_allreduce_time(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    wire_dtype: str = "int8",
    block_size: int = DEFAULT_QUANT_BLOCK,
    codec_bytes_per_s: Optional[float] = None,
) -> float:
    """Latency of the unfused codec ring allreduce: each of the ``world −
    1`` reduce-scatter hops pays an encode, the compressed chunk's wire time
    and a decode-and-accumulate (3 codec passes), each all-gather hop the
    wire and a decode (1 pass).  ``"off"`` pays no codec pass: the plain
    chunked ring."""
    if world < 2:
        return 0.0
    chunk_bytes = nbytes / world
    elems = chunk_bytes / 4.0
    wire_chunk = elems * wire_bytes_per_element(wire_dtype, block_size)
    codec_pass = 0.0 if wire_dtype == "off" else chunk_bytes / _codec_rate(codec_bytes_per_s)
    rs_hop = 3.0 * codec_pass + coeffs.time(wire_chunk)
    ag_hop = 1.0 * codec_pass + coeffs.time(wire_chunk)
    return (world - 1) * (rs_hop + ag_hop)


def choose_wire_dtype(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    block_size: int = DEFAULT_QUANT_BLOCK,
    candidates: Sequence[str] = WIRE_DTYPE_CANDIDATES,
    codec_bytes_per_s: Optional[float] = None,
) -> Tuple[str, Dict[str, float]]:
    """The cheapest wire codec of a ring allreduce on ``coeffs`` (the
    ``sim-rank`` policy's codec): ``(winner, {codec: seconds})``, ties to the
    earlier candidate, so ``"off"`` survives an equal alternative."""
    if not candidates:
        raise ValueError("need at least one wire_dtype candidate")
    times = {wd: quantized_ring_allreduce_time(world, nbytes, coeffs, wd, block_size, codec_bytes_per_s)
             for wd in candidates}
    winner = min(candidates, key=lambda wd: times[wd])
    return winner, times


def fused_quantized_ring_allreduce_time(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    chunk_bytes: float,
    wire_dtype: str = "int8",
    block_size: int = DEFAULT_QUANT_BLOCK,
    hbm_bytes_per_s: Optional[float] = None,
    codec_bytes_per_s: Optional[float] = None,
) -> float:
    """Latency of the fused codec ring (the codec inside the staged
    kernels): a step is the 3-stage pipeline makespan over its tiles, ``fill
    + (tiles − 1)·max(wire, fill, drain) + wire + drain``, the fill a local
    read and an encode, the wire the compressed tile, the drain a
    decode-accumulate (two local moves, two codec passes) in the
    reduce-scatter or a decode-adopt (one and one) in the all-gather; plus
    the seed copy.  ``"off"`` is refused: :func:`staged_ring_allreduce_time`
    prices that kernel."""
    if wire_dtype == "off":
        raise ValueError(
            "fused pricing needs a wire codec; the 'off' staged kernel is priced by staged_ring_allreduce_time"
        )
    if world < 2:
        return 0.0
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    hbm_rate = _hbm_rate(hbm_bytes_per_s)
    chunk = nbytes / world
    tiles = max(1, int(-(-chunk // chunk_bytes)))
    tile_bytes = chunk / tiles
    wire_tile = (tile_bytes / 4.0) * wire_bytes_per_element(wire_dtype, block_size)
    hbm = tile_bytes / hbm_rate
    codec = tile_bytes / _codec_rate(codec_bytes_per_s)
    wire = coeffs.time(wire_tile)
    rs_fill = hbm + codec               # stage-in + encode
    rs_drain = 2.0 * hbm + 2.0 * codec  # accumulate read/write + decode-accumulate
    ag_fill = hbm + codec               # stage-in + encode
    ag_drain = hbm + codec              # decode + adopt write
    rs_step = rs_fill + (tiles - 1) * max(wire, rs_fill, rs_drain) + wire + rs_drain
    ag_step = ag_fill + (tiles - 1) * max(wire, ag_fill, ag_drain) + wire + ag_drain
    seed = nbytes / hbm_rate
    return seed + (world - 1) * (rs_step + ag_step)


# --------------------------------------------------------------------------- #
# overlapped-step pricing (ddp/overlap.py)
# --------------------------------------------------------------------------- #


def _bucket_comm_times(
    world: int,
    grad_bytes: float,
    coeffs: LinkCoeffs,
    bucket_bytes: Optional[Sequence[float]],
    wire_dtype: str,
) -> Tuple[float, ...]:
    """One ring time a bucket (or one for the whole gradient without a
    plan), each a bottleneck-link ring allreduce under the codec."""
    payloads = tuple(float(b) for b in bucket_bytes) if bucket_bytes else (float(grad_bytes),)
    if any(b < 0 for b in payloads):
        raise ValueError(f"bucket bytes must be >= 0, got {list(payloads)}")
    return tuple(quantized_ring_allreduce_time(world, b, coeffs, wire_dtype) for b in payloads)


def _serial_pipeline(ready: Sequence[float], costs: Sequence[float]) -> float:
    """Makespan of transfers released at ``ready[i]`` onto one serial wire."""
    t = 0.0
    for r, c in zip(ready, costs):
        t = max(t, r) + c
    return t


def overlapped_step_time(
    world: int,
    grad_bytes: float,
    coeffs: LinkCoeffs,
    compute_s: float,
    accum: int = 1,
    overlap: str = "off",
    bucket_bytes: Optional[Sequence[float]] = None,
    wire_dtype: str = "off",
) -> Dict[str, float]:
    """Step time under one overlap schedule: ``"off"`` syncs after all
    compute; ``"bucket"`` releases the buckets across the last microbatch's
    backward and drains them as rolling collectives; ``"microbatch"`` syncs
    every microbatch's full delta behind the next one's compute (``accum``×
    the wire volume).  Returns ``{step_time_s, compute_s, comm_s,
    exposed_comm_s, fill_s, drain_s}``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    if compute_s < 0:
        raise ValueError(f"compute_s must be >= 0, got {compute_s}")
    if overlap not in OVERLAP_MODE_CANDIDATES:
        raise ValueError(f"overlap={overlap!r}: expected one of {OVERLAP_MODE_CANDIDATES}")
    sync = _bucket_comm_times(world, grad_bytes, coeffs, bucket_bytes, wire_dtype)
    sync_total = sum(sync)
    compute_s = float(compute_s)
    if overlap == "off":
        comm = sync_total
        step = compute_s + comm
        fill, drain = 0.0, comm
    elif overlap == "bucket":
        comm = sync_total
        n = len(sync)
        window = compute_s / accum
        start = compute_s - window
        ready = [start + window * (i + 1) / n for i in range(n)]
        step = max(compute_s, _serial_pipeline(ready, sync))
        fill, drain = window / n, sync[-1]
    else:  # microbatch
        comm = sync_total * accum
        c = compute_s / accum
        ready = [c * (i + 1) for i in range(accum) for _ in sync]
        costs = list(sync) * accum
        step = max(compute_s, _serial_pipeline(ready, costs))
        fill, drain = c, sync_total
    return {
        "step_time_s": step,
        "compute_s": compute_s,
        "comm_s": comm,
        "exposed_comm_s": max(0.0, step - compute_s),
        "fill_s": fill,
        "drain_s": drain,
    }


def exposed_comm_floor_s(
    world: int,
    grad_bytes: float,
    coeffs: LinkCoeffs,
    overlap: str = "off",
    bucket_bytes: Optional[Sequence[float]] = None,
    wire_dtype: str = "off",
) -> float:
    """The exposed communication of a step as compute grows without bound:
    ``"off"`` the whole sync, ``"bucket"`` the last bucket's collective,
    ``"microbatch"`` the final delta's full sync.  The hook records it as
    ``exposed_comm_s`` beside the bucket plan."""
    if overlap not in OVERLAP_MODE_CANDIDATES:
        raise ValueError(f"overlap={overlap!r}: expected one of {OVERLAP_MODE_CANDIDATES}")
    sync = _bucket_comm_times(world, grad_bytes, coeffs, bucket_bytes, wire_dtype)
    if overlap == "bucket":
        return sync[-1]
    return sum(sync)


# --------------------------------------------------------------------------- #
# latency-plane pricing: recursive doubling, binomial trees, all-to-all
# --------------------------------------------------------------------------- #


def _ring_hops(distance: int, world: int) -> int:
    """Physical hops of a logical exchange at distance ``d`` on the ring
    embedding (wraparound both ways)."""
    d = int(distance) % int(world)
    return min(d, world - d)


def _rd_half_time(world: int, nbytes: float, coeffs: LinkCoeffs) -> float:
    """One recursive-halving half (distances p/2 … 1, messages n/2 … n/p,
    each serialized over its hop distance); a non-power-of-two world adds
    one full-payload fold-in transfer."""
    world = int(world)
    if world < 2:
        return 0.0
    total = 0.0
    p = 1 << (world.bit_length() - 1)
    if p != world:
        total += coeffs.time(nbytes)
    d = p // 2
    msg = float(nbytes) / 2.0
    while d >= 1:
        total += coeffs.alpha + coeffs.beta * _ring_hops(d, p) * msg
        d //= 2
        msg /= 2.0
    return total


def recursive_doubling_allreduce_time(world: int, nbytes: float, coeffs: LinkCoeffs) -> float:
    """Recursive-halving reduce-scatter + recursive-doubling all-gather on
    the ring embedding: ``2·log2(p)·α`` fixed cost, a hop-serialized
    bandwidth slope."""
    return 2.0 * _rd_half_time(world, nbytes, coeffs)


def recursive_halving_reduce_scatter_time(world: int, nbytes: float, coeffs: LinkCoeffs) -> float:
    """The recursive-halving reduce-scatter (``comm/latency.py::
    rd_reduce_scatter_shard``): the RS half of the rd allreduce.  ``nbytes``
    is the full payload before the scatter."""
    return _rd_half_time(world, nbytes, coeffs)


def recursive_doubling_all_gather_time(world: int, nbytes: float, coeffs: LinkCoeffs) -> float:
    """The recursive-doubling all-gather (``rd_all_gather_shard``): the
    halving schedule's (distance, size) pairs mirrored, so the same cost.
    ``nbytes`` is the full payload after the gather."""
    return _rd_half_time(world, nbytes, coeffs)


def binomial_tree_time(world: int, nbytes: float, coeffs: LinkCoeffs) -> float:
    """One binomial-tree phase (a broadcast or a reduce): ``ceil(log2 p)``
    rounds, the full payload over each round's hop distance.  A tree
    allreduce is two phases."""
    world = int(world)
    if world < 2:
        return 0.0
    total = 0.0
    d = 1
    while d < world:
        total += coeffs.alpha + coeffs.beta * _ring_hops(d, world) * float(nbytes)
        d *= 2
    return total


def all_to_all_time(world: int, nbytes: float, coeffs: LinkCoeffs) -> float:
    """A flat all-to-all as the linear-shift schedule: ``world − 1`` rounds,
    round ``k`` one ``nbytes/world`` block over ``min(k, p−k)`` hops
    (``nbytes``: one rank's whole send volume)."""
    world = int(world)
    if world < 2:
        return 0.0
    block = float(nbytes) / world
    total = 0.0
    for k in range(1, world):
        total += coeffs.alpha + coeffs.beta * _ring_hops(k, world) * block
    return total


def allreduce_crossover_bytes(world: int, coeffs: LinkCoeffs) -> float:
    """The payload where the ring catches up with recursive doubling: both
    are affine in ``n``, so the break-even is exact.  0.0 when rd never
    wins, ``inf`` when it always does."""
    world = int(world)
    if world < 2:
        return 0.0

    def ring(n: float) -> float:
        return quantized_ring_allreduce_time(world, n, coeffs, "off")

    def rd(n: float) -> float:
        return recursive_doubling_allreduce_time(world, n, coeffs)

    probe = float(1 << 20)
    ring_a, rd_a = ring(0.0), rd(0.0)
    ring_slope = (ring(probe) - ring_a) / probe
    rd_slope = (rd(probe) - rd_a) / probe
    if rd_a >= ring_a:
        return 0.0
    if rd_slope <= ring_slope:
        return float("inf")
    return (ring_a - rd_a) / (rd_slope - ring_slope)


def choose_allreduce_algo(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    candidates: Sequence[str] = COLL_ALGO_CANDIDATES,
) -> Tuple[str, Dict[str, float]]:
    """The cheapest allreduce algorithm for one payload on the model:
    ``(winner, {algo: seconds})``, ties broken by candidate order (the ring
    first)."""
    if not candidates:
        raise ValueError("need at least one collective-algorithm candidate")
    pricing = {
        "ring": lambda: quantized_ring_allreduce_time(world, nbytes, coeffs, "off"),
        "rd": lambda: recursive_doubling_allreduce_time(world, nbytes, coeffs),
        "tree": lambda: 2.0 * binomial_tree_time(world, nbytes, coeffs),
    }
    unknown = [c for c in candidates if c not in pricing]
    if unknown:
        raise ValueError(f"unknown algorithm(s) {unknown}; expected a subset of {COLL_ALGO_CANDIDATES}")
    times = {c: pricing[c]() for c in candidates}
    return min(candidates, key=lambda c: times[c]), times


# --------------------------------------------------------------------------- #
# two-level pricing (strategy/hierarchy.py): RS within the node, allreduce
# across the node leaders, AG within the node, against the flat ring
# --------------------------------------------------------------------------- #

#: the composed plan's schedules a level (``strategy/hierarchy.py``'s
#: ``POD_ALGOS`` / ``LEADER_ALGOS``)
TWO_LEVEL_POD_ALGOS = ("rs-ag", "replicate")
TWO_LEVEL_LEADER_ALGOS = ("tree", "rs-ag")


def two_level_leader_time(num_pods: int, nbytes: float, dcn: LinkCoeffs, algo: str = "tree") -> float:
    """One allreduce of ``nbytes`` a leader across the pod leaders on the
    inter-host class: ``tree`` is ``2·ceil(log2 P)`` rounds of the full
    payload (a switched fabric: no hop serialization), ``rs-ag`` the
    segmented leader ring, ``2·(P−1)`` rounds of ``nbytes/P``."""
    P = int(num_pods)
    if P < 2:
        return 0.0
    if algo == "tree":
        rounds = (P - 1).bit_length()  # ceil(log2 P)
        return 2.0 * rounds * dcn.time(nbytes)
    if algo == "rs-ag":
        return 2.0 * (P - 1) * (dcn.alpha + dcn.beta * float(nbytes) / P)
    raise ValueError(f"unknown leader algo {algo!r}; expected one of {TWO_LEVEL_LEADER_ALGOS}")


def two_level_allreduce_time(
    num_pods: int,
    pod_size: int,
    nbytes: float,
    ici: LinkCoeffs,
    dcn: LinkCoeffs,
    pod_algo: str = "rs-ag",
    leader_algo: str = "tree",
) -> float:
    """The composed two-level allreduce: ``2·(I−1)`` intra-pod hops of
    ``n/I`` plus the leader level's allreduce of what the pod algorithm
    leaves it: ``n/I`` under ``rs-ag``, the whole ``n`` under
    ``replicate`` (the slice-local reduction, then the full payload across
    the leaders)."""
    P, I = int(num_pods), int(pod_size)
    if P < 1 or I < 1:
        raise ValueError(f"need num_pods/pod_size >= 1, got {P}x{I}")
    if P * I < 2:
        return 0.0
    if pod_algo not in TWO_LEVEL_POD_ALGOS:
        raise ValueError(f"unknown pod algo {pod_algo!r}; expected one of {TWO_LEVEL_POD_ALGOS}")
    n = float(nbytes)
    ici_phases = 2.0 * (I - 1) * ici.time(n / I) if I > 1 else 0.0
    leader_payload = n / I if pod_algo == "rs-ag" else n
    return ici_phases + two_level_leader_time(P, leader_payload, dcn, leader_algo)


def choose_two_level(
    num_pods: int, pod_size: int, nbytes: float, ici: LinkCoeffs, dcn: LinkCoeffs,
) -> Tuple[str, Dict[str, float]]:
    """Two-level against flat for one layout and payload: ``(winner,
    {"two_level": s, "flat": s})``, the two-level arm the best of both pod
    algorithms by their leader schedules, the flat arm the lockstep ring
    paced by the inter-host class; one pod is flat (priced on the
    intra-host class); a tie keeps flat."""
    P, I = int(num_pods), int(pod_size)
    if P < 2:
        flat = quantized_ring_allreduce_time(max(P * I, 1), nbytes, ici, "off")
        return "flat", {"two_level": flat, "flat": flat}
    two = min(
        two_level_allreduce_time(P, I, nbytes, ici, dcn, pod_algo=pa, leader_algo=la)
        for pa in TWO_LEVEL_POD_ALGOS
        for la in TWO_LEVEL_LEADER_ALGOS
    )
    flat = quantized_ring_allreduce_time(P * I, nbytes, dcn, "off")
    return ("two_level" if two < flat else "flat"), {"two_level": two, "flat": flat}


def two_level_crossover_pods(
    pod_size: int, nbytes: float, ici: LinkCoeffs, dcn: LinkCoeffs, max_pods: int = 4096,
) -> Optional[int]:
    """The smallest power-of-two pod count at which the composed plan beats
    the flat ring for this payload, or None within ``max_pods``."""
    P = 2
    while P <= max_pods:
        if choose_two_level(P, pod_size, nbytes, ici, dcn)[0] == "two_level":
            return P
        P *= 2
    return None


def ring_allreduce_time(world: int, nbytes: float, coeffs: LinkCoeffs, chunks: int = 1) -> float:
    """The chain-tree ("ring"-schedule) allreduce with ``chunks`` pipelined
    chunks: ``(2·(w−1) + chunks − 1)·(α + β·nbytes/chunks)``."""
    if world < 2:
        return 0.0
    per_hop = coeffs.time(nbytes / chunks)
    return (2 * (world - 1) + chunks - 1) * per_hop


def schedule_program_time(program, nbytes: float, coeffs: LinkCoeffs, per_dispatch_s: float = 0.0) -> float:
    """Analytical latency of a ``compiler.ScheduleProgram``: its rounds are
    barriers, so the sum over rounds of the slowest link of the round.  In a
    round, sends on one directed (src, dst) link serialize (their bytes one
    ``α + β·bytes`` transfer) and distinct links run at once; a send carries
    ``span`` chunks of ``nbytes / chunks``, so an optimized program and its
    source price alike.  ``per_dispatch_s`` adds that many seconds for each
    transfer the lowering issues (``compiler.lower.round_dispatch_counts``),
    which prices the coalesce pass's fewer dispatches.  The segmented ring
    prices at ``2(w−1)·(α + β·n/w)``, the pipelined bidirectional ring at
    ``2(w−1)·(α + β·n/(2w))``."""
    if program.world < 2:
        return 0.0
    seg = float(nbytes) / max(1, program.chunks)
    total = 0.0
    for round_steps in program.rounds:
        link_bytes: Dict[Tuple[int, int], float] = {}
        for step in round_steps:
            if step.kind == "send":
                link = (step.rank, step.peer)
                link_bytes[link] = link_bytes.get(link, 0.0) + seg * step.span
        if link_bytes:
            total += max(coeffs.time(b) for b in link_bytes.values())
    if per_dispatch_s:
        from adapcc_tpu_torch.compiler.lower import round_dispatch_counts

        total += per_dispatch_s * float(sum(round_dispatch_counts(program)))
    return total


# --------------------------------------------------------------------------- #
# pipeline-parallel pricing (adapcc_tpu_torch/pipe): bubble, step time, stash
# --------------------------------------------------------------------------- #


def pipeline_bubble_fraction(stages: int, microbatches: int) -> float:
    """Idle fraction of a GPipe/1F1B pipeline step: ``(s−1)/(m+s−1)``.

    Both schedules run the same ``2·(m+s−1)`` ticks over ``2·m`` useful
    tasks a stage, so the bubble does not depend on the schedule; the
    schedules differ in memory (:func:`pipeline_stash_bytes`)."""
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    return (stages - 1) / (microbatches + stages - 1)


def pipeline_step_time(
    stages: int,
    microbatches: int,
    fwd_time_s: float,
    hop_bytes: float,
    coeffs: LinkCoeffs,
    bwd_ratio: float = 2.0,
) -> float:
    """Latency of one pipelined forward/backward step: ``2·(m+s−1)`` ticks,
    each one stage task (``fwd_time_s`` a forward, ``bwd_ratio`` times that
    a backward) plus one α+β hop of ``hop_bytes``.  GPipe and 1F1B price
    the same here (same ticks, same hops a tick)."""
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if fwd_time_s < 0 or hop_bytes < 0 or bwd_ratio < 0:
        raise ValueError(
            "fwd_time_s, hop_bytes, and bwd_ratio must be non-negative"
        )
    if stages == 1:
        # no hops: m forwards and m backwards, back to back
        return microbatches * fwd_time_s * (1.0 + bwd_ratio)
    ticks = microbatches + stages - 1
    hop = coeffs.time(hop_bytes)
    fwd_half = ticks * (fwd_time_s + hop)
    bwd_half = ticks * (fwd_time_s * bwd_ratio + hop)
    return fwd_half + bwd_half


def pipeline_stash_bytes(
    stages: int,
    microbatches: int,
    schedule: str,
    stage: int,
    act_bytes: float,
) -> float:
    """Peak stashed-activation bytes at ``stage``, the closed form of the
    executor's measured high-water mark (``PipelineReport.stash_peak``):
    GPipe stashes every microbatch, ``m·act_bytes``; 1F1B bounds the window
    to ``min(m, stages − stage)``."""
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if not 0 <= stage < stages:
        raise ValueError(
            f"stage must be in [0, {stages}), got {stage}"
        )
    from adapcc_tpu_torch.pipe.schedule import PIPE_SCHEDULES  # deferred: pipe prices through here

    if schedule not in PIPE_SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}: expected one of "
            f"{PIPE_SCHEDULES}"
        )
    if schedule == "gpipe":
        return microbatches * float(act_bytes)
    return min(microbatches, stages - stage) * float(act_bytes)


# --------------------------------------------------------------------------- #
# failover pricing: detection latency, the plan-swap stall and the degraded
# steady state, the three terms a world shrink costs
# --------------------------------------------------------------------------- #

#: a plan swap when the standby cache holds the prepared plan: a cache-key
#: switch and the dispatch.  The JAX package's round-number prior, kept so
#: the two packages price a fault plan alike; it was never measured on the
#: card (``chip_smoke.py`` phase 17 times the port's swap beside it)
DEFAULT_PLAN_SWAP_DISPATCH_S = 250e-6

#: a cold plan swap's extra cost, the JAX package's round-number prior for a
#: trace and compile of the degraded schedule (the port derives round tables
#: instead of compiling; phase 17 times that too)
DEFAULT_COLD_COMPILE_S = 2.0

#: re-synthesis walltime folded into a full rebuild (the JAX package's prior)
DEFAULT_RESYNTHESIS_S = 0.1


def detection_latency_s(heartbeat_timeout_s: float, step_time_s: float = 0.0) -> float:
    """From a rank dying to the coordinator knowing: half a step (the death
    lands uniformly inside one) plus the heartbeat timeout."""
    if heartbeat_timeout_s < 0 or step_time_s < 0:
        raise ValueError("heartbeat timeout / step time must be >= 0")
    return 0.5 * step_time_s + heartbeat_timeout_s


def supervised_detection_latency_s(heartbeat_period_s: float, heartbeat_timeout_s: float, grace: int,
                                   sweep_period_s: float = 0.0) -> float:
    """From a rank dying to the supervisor confirming it dead: half a
    heartbeat period, the suspicion timeout, ``grace`` further periods and
    half a sweep period."""
    if heartbeat_period_s <= 0 or heartbeat_timeout_s < 0 or sweep_period_s < 0:
        raise ValueError("heartbeat period must be > 0, timeout/sweep period >= 0")
    if grace < 1:
        raise ValueError(f"grace must be >= 1, got {grace}")
    return 0.5 * heartbeat_period_s + heartbeat_timeout_s + grace * heartbeat_period_s + 0.5 * sweep_period_s


def plan_swap_stall_s(standby_cached: bool, dispatch_s: Optional[float] = None,
                      compile_s: Optional[float] = None) -> float:
    """The failover step's stall: the dispatch of a prepared plan, plus the
    cold preparation where the standby cache did not hold it.  Arguments
    left at None take this module's defaults at call time."""
    dispatch = DEFAULT_PLAN_SWAP_DISPATCH_S if dispatch_s is None else dispatch_s
    compile_ = DEFAULT_COLD_COMPILE_S if compile_s is None else compile_s
    return dispatch if standby_cached else dispatch + compile_


def failover_cost(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    n_down: int = 1,
    slowdown: Optional[float] = None,
    heartbeat_timeout_s: float = 1.0,
    step_time_s: float = 0.0,
    standby_cached: bool = True,
    wire_dtype: str = "off",
) -> Dict[str, float]:
    """One fault end to end: ``healthy_s`` (the full-world ring),
    ``undetected_s`` (a slow rank stretching every hop, or a dead one
    costing the heartbeat timeout a step), ``degraded_s`` (the ring of the
    ``world − n_down`` survivors), ``degraded_ratio``, the one-time
    ``detection_s`` and ``swap_s``, and ``failover_total_s`` (their sum)."""
    if world < 2:
        raise ValueError(f"failover pricing needs world >= 2, got {world}")
    if not 0 < n_down < world:
        raise ValueError(f"n_down must be in (0, {world}), got {n_down}")
    healthy = quantized_ring_allreduce_time(world, nbytes, coeffs, wire_dtype)
    if slowdown is not None:
        undetected = quantized_ring_allreduce_time(world, nbytes, coeffs.scaled(slowdown), wire_dtype)
    else:
        # a dead rank's ring never completes: until detection every step
        # burns the heartbeat timeout
        undetected = heartbeat_timeout_s
    degraded = quantized_ring_allreduce_time(world - n_down, nbytes, coeffs, wire_dtype)
    detection = detection_latency_s(heartbeat_timeout_s, step_time_s)
    swap = plan_swap_stall_s(standby_cached)
    return {
        "healthy_s": healthy,
        "undetected_s": undetected,
        "degraded_s": degraded,
        "degraded_ratio": degraded / healthy if healthy > 0 else 1.0,
        "detection_s": detection,
        "swap_s": swap,
        "failover_total_s": detection + swap,
    }


def full_rebuild_stall_s(world: int, coeffs: LinkCoeffs, compile_s: Optional[float] = None,
                         synthesis_s: Optional[float] = None) -> float:
    """One ``reconstruct_topology`` cycle: every directed pair's two probes,
    re-synthesis and the cold preparation of the new schedule."""
    world = int(world)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    compile_ = DEFAULT_COLD_COMPILE_S if compile_s is None else compile_s
    synthesis = DEFAULT_RESYNTHESIS_S if synthesis_s is None else synthesis_s
    probes = world * max(0, world - 1) * (coeffs.time(LATENCY_PROBE_BYTES) + coeffs.time(BANDWIDTH_PROBE_BYTES))
    return probes + synthesis + compile_


def adaptation_cost(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    stale_steady_s: float,
    adapted_steady_s: float,
    standby_cached: bool = True,
    compile_s: Optional[float] = None,
    synthesis_s: Optional[float] = None,
) -> Dict[str, float]:
    """One drift incident's choices: keep the stale strategy, hot-swap to
    the re-ranked one through the standby cache, or rebuild.  The steady
    states are the caller's per-step predictions under the corrected costs;
    returns both one-time stalls, the gain a step and each arm's break-even
    step count (``inf`` without a gain)."""
    if stale_steady_s < 0 or adapted_steady_s < 0:
        raise ValueError("steady-state predictions must be >= 0")
    hot = plan_swap_stall_s(standby_cached)
    full = full_rebuild_stall_s(world, coeffs, compile_s, synthesis_s)
    gain = stale_steady_s - adapted_steady_s
    return {
        "stale_steady_s": float(stale_steady_s),
        "adapted_steady_s": float(adapted_steady_s),
        "gain_per_step_s": gain,
        "hot_swap_stall_s": hot,
        "full_rebuild_stall_s": full,
        "hot_swap_break_even_steps": hot / gain if gain > 0 else float("inf"),
        "full_rebuild_break_even_steps": full / gain if gain > 0 else float("inf"),
    }


# --------------------------------------------------------------------------- #
# recovery: a dead rank's ZeRO-1 shard repaired from its replica, or a
# checkpoint reload
# --------------------------------------------------------------------------- #

#: shared-filesystem read rate a checkpoint reload pays: the JAX package's
#: round-number prior, kept so the two packages price recovery alike; never
#: measured for the port
DEFAULT_CKPT_BYTES_PER_S = 1e9


def replication_overhead_time(world: int, state_bytes: float, coeffs: LinkCoeffs, replicas: int = 1) -> float:
    """Per-step wire cost of k-replicated ZeRO-1 shards
    (:func:`adapcc_tpu_torch.elastic.redundancy.replica_placement`): each
    rank sends its ``state_bytes / world`` rows to each of its ``replicas``
    holders, concurrently over its own outbound hop, so the bottleneck link
    carries ``replicas · state_bytes / world`` a step.  ``replicas=0`` is
    free."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if state_bytes < 0:
        raise ValueError(f"state_bytes must be >= 0, got {state_bytes}")
    if replicas < 0:
        raise ValueError(f"replicas must be >= 0, got {replicas}")
    if replicas == 0:
        return 0.0
    if replicas >= world:
        raise ValueError(f"replicas={replicas} needs world > replicas (got {world})")
    return coeffs.time(replicas * state_bytes / world)


def replica_repair_time(world: int, state_bytes: float, coeffs: LinkCoeffs, standby_cached: bool = True) -> float:
    """Repair of one dead rank's shard from its replica: the holder sends
    the lost ``state_bytes / world`` rows back over one hop, plus the plan
    swap onto the re-balanced layout.  No reload and no lost step."""
    if world < 2:
        raise ValueError(f"repair pricing needs world >= 2, got {world}")
    if state_bytes < 0:
        raise ValueError(f"state_bytes must be >= 0, got {state_bytes}")
    return coeffs.time(state_bytes / world) + plan_swap_stall_s(standby_cached)


def checkpoint_reload_time(state_bytes: float, lost_steps: float, step_time_s: float,
                           ckpt_bytes_per_s: Optional[float] = None) -> float:
    """The reload arm for the same death: read all ``state_bytes`` back from
    storage, then redo the ``lost_steps`` since the last save."""
    if state_bytes < 0 or lost_steps < 0 or step_time_s < 0:
        raise ValueError("state_bytes / lost_steps / step_time_s must be >= 0")
    rate = DEFAULT_CKPT_BYTES_PER_S if ckpt_bytes_per_s is None else ckpt_bytes_per_s
    if rate <= 0:
        raise ValueError(f"ckpt_bytes_per_s must be > 0, got {rate}")
    return state_bytes / rate + lost_steps * step_time_s


def recovery_cost(
    world: int,
    nbytes: float,
    coeffs: LinkCoeffs,
    state_bytes: Optional[float] = None,
    replicas: int = 1,
    save_interval_steps: int = 100,
    step_time_s: Optional[float] = None,
    wire_dtype: str = "off",
    standby_cached: bool = True,
    ckpt_bytes_per_s: Optional[float] = None,
) -> Dict[str, float]:
    """One rank death priced both ways: ``baseline_step_comm_s`` (the
    healthy ring), ``replication_overhead_s`` and its ratio to the
    baseline, ``replica_repair_s``, ``ckpt_reload_s`` (the full read plus
    ``save_interval / 2`` redone steps), ``repair_speedup`` (reload over
    repair) and ``overhead_break_even_steps`` (steps between failures above
    which the replicas cost more than one repair saves).  ``state_bytes``
    defaults to ``3 · nbytes`` (float32 master and two Adam moments),
    ``step_time_s`` to the ring's time."""
    if world < 2:
        raise ValueError(f"recovery pricing needs world >= 2, got {world}")
    if save_interval_steps < 1:
        raise ValueError(f"save_interval_steps must be >= 1, got {save_interval_steps}")
    if state_bytes is None:
        state_bytes = 3.0 * float(nbytes)
    baseline = quantized_ring_allreduce_time(world, nbytes, coeffs, wire_dtype)
    if step_time_s is None:
        step_time_s = baseline
    overhead = replication_overhead_time(world, state_bytes, coeffs, replicas)
    repair = replica_repair_time(world, state_bytes, coeffs, standby_cached)
    reload = checkpoint_reload_time(state_bytes, save_interval_steps / 2.0, step_time_s, ckpt_bytes_per_s)
    saved = reload - repair
    return {
        "baseline_step_comm_s": baseline,
        "replication_overhead_s": overhead,
        "replication_overhead_ratio": overhead / baseline if baseline > 0 else 0.0,
        "replica_repair_s": repair,
        "ckpt_reload_s": reload,
        "repair_speedup": reload / repair if repair > 0 else float("inf"),
        "overhead_break_even_steps": saved / overhead if overhead > 0 and saved > 0 else float("inf"),
    }


# --------------------------------------------------------------------------- #
# serving-plane queueing (adapcc_tpu_torch/serve): arrival rate × decode
# slots × per-token step time → the latency/throughput frontier
# --------------------------------------------------------------------------- #

#: per-layer compute of one decode step of the serving GPT-2 when no measured
#: figure is given: the full-width model's (12 layers, d_model 1024, 16
#: heads, vocab 16384, max_seq 512, float32) world-4 × 8-slot decode step
#: with the per-layer allreduce left out (its median synced walltime, head
#: and sampling included, over the 12 layers), measured by ``chip_smoke.py``
#: phase 22a on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (43.356
#: ms a step).  Host-bound: the step issues its products a slot row at a
#: time (``serve/model.py``), so this is mostly launch cost, not arithmetic
DEFAULT_DECODE_COMPUTE_S_PER_LAYER = 3.61302e-3


def decode_step_time(
    world: int,
    slots: int,
    n_layer: int,
    d_model: int,
    coeffs: LinkCoeffs,
    itemsize: int = 4,
    algo: Optional[str] = None,
    compute_s_per_layer: Optional[float] = None,
) -> Dict[str, object]:
    """Price ONE continuous-batching decode step: per layer, the
    head-sharded attention's compute (``compute_s_per_layer``, default
    :data:`DEFAULT_DECODE_COMPUTE_S_PER_LAYER` at call time) plus the
    per-token combine, a ``slots × d_model`` allreduce; under ``algo=None``
    ("auto") :func:`choose_allreduce_algo` prices the algorithm the engine
    would choose.

    Returns ``step_time_s``, the per-dispatch ``collective_bytes``
    (``slots · d_model · itemsize``: the decode plane is float32), the
    chosen or priced ``algo`` and the comm/compute split.  ``world < 2``
    has no fabric: the collective term is zero and ``algo`` is
    ``"none"``."""
    if compute_s_per_layer is None:
        compute_s_per_layer = DEFAULT_DECODE_COMPUTE_S_PER_LAYER
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if n_layer < 1 or d_model < 1:
        raise ValueError(f"n_layer={n_layer} / d_model={d_model} must be >= 1")
    if itemsize < 1:
        raise ValueError(f"itemsize must be >= 1, got {itemsize}")
    if compute_s_per_layer < 0:
        raise ValueError(f"compute_s_per_layer must be >= 0, got {compute_s_per_layer}")
    nbytes = float(slots * d_model * itemsize)
    if int(world) < 2:
        chosen, coll = "none", 0.0
    elif algo is None:
        chosen, times = choose_allreduce_algo(world, nbytes, coeffs)
        coll = times[chosen]
    else:
        chosen = algo
        _, times = choose_allreduce_algo(world, nbytes, coeffs, (algo,))
        coll = times[algo]
    comm_s = n_layer * coll
    compute_s = n_layer * compute_s_per_layer
    return {
        "step_time_s": comm_s + compute_s,
        "collective_bytes": int(nbytes),
        "algo": chosen,
        "comm_s": comm_s,
        "compute_s": compute_s,
    }


def simulate_serve_queue(arrival_steps: Sequence[int], service_steps: Sequence[int], slots: int) -> list:
    """Replay the continuous batcher's admission discipline on the integer
    step clock (the queueing twin of ``GPT2Server.step``): FIFO admission at
    ``max(arrival, earliest slot-free step)``, a lane holds its slot for
    ``service_steps`` (``total − 1``) and completes at ``admitted +
    service``, and a completed lane's slot admits from the completion step
    itself.  Returns one ``(arrival, admitted, completed)`` a request, in
    input order; EOS eviction is not modeled (an upper bound on every
    sojourn)."""
    import heapq

    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if len(arrival_steps) != len(service_steps):
        raise ValueError(
            f"{len(arrival_steps)} arrivals vs {len(service_steps)} service times: every request needs "
            "exactly one of each"
        )
    if any(a < 0 for a in arrival_steps):
        raise ValueError("arrival steps must be >= 0")
    if any(s < 1 for s in service_steps):
        raise ValueError("service steps must be >= 1 (a request that decodes nothing is not serving traffic)")
    if list(arrival_steps) != sorted(arrival_steps):
        raise ValueError("arrival steps must be sorted (the batcher admits FIFO)")
    free = [0] * int(slots)
    heapq.heapify(free)
    out = []
    for arrival, service in zip(arrival_steps, service_steps):
        admitted = max(int(arrival), heapq.heappop(free))
        completed = admitted + int(service)
        heapq.heappush(free, completed)
        out.append((int(arrival), admitted, completed))
    return out


def _pct(xs: Sequence[int], q: float) -> int:
    from adapcc_tpu_torch.utils.observability import nearest_rank_percentile

    return int(nearest_rank_percentile(xs, q))


def serve_queue_metrics(
    arrival_steps: Sequence[int],
    service_steps: Sequence[int],
    slots: int,
    step_time_s: float,
    slo_ms: Optional[float] = None,
    generated_steps: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """The latency/throughput ledger of one (trace × slots × step time)
    cell: nearest-rank ``p50/p99_sojourn_steps`` (arrival → completion,
    queue wait included) and the same in ms at ``step_time_s``,
    ``p99_queue_steps`` (arrival → admission), ``throughput_tok_s``
    (generated tokens per second of makespan with ``generated_steps``,
    else engine token-steps), ``utilization`` (occupied lane-steps over
    ``slots × makespan``) and, with ``slo_ms``, ``slo_attainment``."""
    if step_time_s <= 0:
        raise ValueError(f"step_time_s must be > 0, got {step_time_s}")
    if generated_steps is not None:
        if len(generated_steps) != len(service_steps):
            raise ValueError(f"{len(generated_steps)} generated budgets vs {len(service_steps)} service times")
        if any(g < 1 or g > s for g, s in zip(generated_steps, service_steps)):
            raise ValueError("each generated budget must be in [1, service_steps]")
    triples = simulate_serve_queue(arrival_steps, service_steps, slots)
    sojourns = sorted(c - a for a, _, c in triples)
    queues = sorted(adm - a for a, adm, _ in triples)
    makespan = max(c for _, _, c in triples)
    busy = sum(service_steps)
    tokens = sum(generated_steps) if generated_steps is not None else busy
    out: Dict[str, float] = {
        "requests": float(len(triples)),
        "makespan_steps": float(makespan),
        "p50_sojourn_steps": float(_pct(sojourns, 0.50)),
        "p99_sojourn_steps": float(_pct(sojourns, 0.99)),
        "p50_sojourn_ms": _pct(sojourns, 0.50) * step_time_s * 1e3,
        "p99_sojourn_ms": _pct(sojourns, 0.99) * step_time_s * 1e3,
        "p99_queue_steps": float(_pct(queues, 0.99)),
        "throughput_tok_s": tokens / (makespan * step_time_s),
        "utilization": busy / float(makespan * slots),
    }
    if slo_ms is not None:
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        within = sum(1 for s in sojourns if s * step_time_s * 1e3 <= slo_ms)
        out["slo_ms"] = float(slo_ms)
        out["slo_attainment"] = within / len(sojourns)
    return out


def simulate_disagg_queue(
    arrival_steps: Sequence[int],
    prefill_steps: Sequence[int],
    decode_steps: Sequence[int],
    prefill_slots: int,
    decode_slots: int,
    transfer_steps: int = 0,
) -> list:
    """Replay the ``ClusterRouter``'s admission discipline on the integer
    step clock (the tandem-queue twin): FIFO admission into a prefill slot,
    the first token ``prefill_steps`` later, migration into a decode slot at
    ``max(first_token, earliest decode-slot-free step)`` (a finished prefill
    holds its prefill slot until then), ``transfer_steps`` of wire, then
    ``decode_steps`` (0: the request completes in the prefill pod).
    Returns one ``(arrival, admitted_prefill, first_token, admitted_decode,
    completed)`` a request, in input order."""
    import heapq

    if prefill_slots < 1 or decode_slots < 1:
        raise ValueError(f"prefill_slots={prefill_slots} / decode_slots={decode_slots} must be >= 1")
    if transfer_steps < 0:
        raise ValueError(f"transfer_steps must be >= 0, got {transfer_steps}")
    if not (len(arrival_steps) == len(prefill_steps) == len(decode_steps)):
        raise ValueError(
            f"{len(arrival_steps)} arrivals vs {len(prefill_steps)} prefill vs {len(decode_steps)} decode "
            "budgets: every request needs exactly one of each"
        )
    if any(a < 0 for a in arrival_steps):
        raise ValueError("arrival steps must be >= 0")
    if any(p < 1 for p in prefill_steps):
        raise ValueError("prefill steps must be >= 1 (every prompt feeds at least one token)")
    if any(d < 0 for d in decode_steps):
        raise ValueError("decode steps must be >= 0")
    if list(arrival_steps) != sorted(arrival_steps):
        raise ValueError("arrival steps must be sorted (the router admits FIFO)")
    prefill_free = [0] * int(prefill_slots)
    decode_free = [0] * int(decode_slots)
    heapq.heapify(prefill_free)
    heapq.heapify(decode_free)
    out = []
    for arrival, prefill, decode in zip(arrival_steps, prefill_steps, decode_steps):
        admitted = max(int(arrival), heapq.heappop(prefill_free))
        first_token = admitted + int(prefill)
        if int(decode) < 1:
            # completes inside the prefill pod: the slot frees at once
            heapq.heappush(prefill_free, first_token)
            out.append((int(arrival), admitted, first_token, first_token, first_token))
            continue
        migrated = max(first_token, heapq.heappop(decode_free))
        heapq.heappush(prefill_free, migrated)  # resident until migration
        admitted_decode = migrated + int(transfer_steps)
        completed = admitted_decode + int(decode)
        heapq.heappush(decode_free, completed)
        out.append((int(arrival), admitted, first_token, admitted_decode, completed))
    return out


def disagg_queue_metrics(
    arrival_steps: Sequence[int],
    prefill_steps: Sequence[int],
    decode_steps: Sequence[int],
    prefill_slots: int,
    decode_slots: int,
    transfer_steps: int,
    prefill_step_time_s: float,
    decode_step_time_s: float,
    slo_ms: Optional[float] = None,
) -> Dict[str, float]:
    """The disaggregated latency/throughput ledger.  The pods step in
    lockstep a router tick, so a step costs ``max(prefill_step_time_s,
    decode_step_time_s)`` (``step_time_s``); TTFT is arrival → first token
    (queue wait and prefill service only), ``p99_decode_wait_steps`` (first
    token → decode admission, transfer included) the migration-stall
    signal; a request generates ``1 + decode_steps`` tokens."""
    if prefill_step_time_s <= 0 or decode_step_time_s <= 0:
        raise ValueError(
            f"step times must be > 0, got prefill={prefill_step_time_s} / decode={decode_step_time_s}"
        )
    rows = simulate_disagg_queue(arrival_steps, prefill_steps, decode_steps, prefill_slots, decode_slots,
                                 transfer_steps)
    tick_s = max(float(prefill_step_time_s), float(decode_step_time_s))
    ttfts = sorted(f - a for a, _, f, _, _ in rows)
    sojourns = sorted(c - a for a, _, _, _, c in rows)
    queues = sorted(adm - a for a, adm, _, _, _ in rows)
    decode_waits = sorted(ad - f for _, _, f, ad, _ in rows)
    makespan = max(c for _, _, _, _, c in rows)
    # prefill residency runs admission → migration (the decode wait
    # included: the waiting lane holds its prefill slot)
    prefill_busy = sum(
        (ad - int(transfer_steps) if d >= 1 else f) - adm
        for (_, adm, f, ad, _), d in zip(rows, decode_steps)
    )
    decode_busy = sum(int(d) for d in decode_steps)
    tokens = sum(1 + int(d) for d in decode_steps)
    out: Dict[str, float] = {
        "requests": float(len(rows)),
        "makespan_steps": float(makespan),
        "step_time_s": tick_s,
        "transfer_steps": float(transfer_steps),
        "p50_ttft_steps": float(_pct(ttfts, 0.50)),
        "p99_ttft_steps": float(_pct(ttfts, 0.99)),
        "p50_ttft_ms": _pct(ttfts, 0.50) * tick_s * 1e3,
        "p99_ttft_ms": _pct(ttfts, 0.99) * tick_s * 1e3,
        "p50_sojourn_steps": float(_pct(sojourns, 0.50)),
        "p99_sojourn_steps": float(_pct(sojourns, 0.99)),
        "p50_sojourn_ms": _pct(sojourns, 0.50) * tick_s * 1e3,
        "p99_sojourn_ms": _pct(sojourns, 0.99) * tick_s * 1e3,
        "p99_queue_steps": float(_pct(queues, 0.99)),
        "p99_decode_wait_steps": float(_pct(decode_waits, 0.99)),
        "throughput_tok_s": tokens / (makespan * tick_s),
        "prefill_utilization": prefill_busy / float(makespan * prefill_slots),
        "decode_utilization": decode_busy / float(makespan * decode_slots),
    }
    if slo_ms is not None:
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        within = sum(1 for s in sojourns if s * tick_s * 1e3 <= slo_ms)
        out["slo_ms"] = float(slo_ms)
        out["slo_attainment"] = within / len(sojourns)
    return out
