"""α-β calibration artifacts: fit, persist, load, merge.

The port of :mod:`adapcc_tpu.sim.calibrate`.  The JSON format is the JAX
package's, key for key, so a ``calibration.json`` written by either package
loads in the other: class coefficients under the shared link-class keys
(``ici``, ``dcn``), an optional per-link table and ip map, and the
provenance stamps.  Three sources fit one: the profiler's matrices, its
``topo_profile_*`` CSV shards, and a hardware battery's sweep rows through
each collective's ring structure.  :func:`merge_calibration` folds a
re-calibration into an artifact with decay, never last-writer-wins.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from adapcc_tpu_torch.sim.cost_model import DCN, ICI, LinkCoeffs, LinkCostModel

CALIBRATION_VERSION = 1

#: where an artifact lives, beside the other topology artifacts
DEFAULT_CALIBRATION_PATH = os.path.join("topology", "calibration.json")

#: serial rounds and per-link byte fraction of each collective's ring form:
#: time ≈ rounds(w)·α + byte_factor(w)·size·β (the byte factors are the
#: nccl-tests busbw corrections, the rounds the ring schedule's depth)
_RING_STRUCTURE = {
    "allreduce": (lambda w: 2 * (w - 1), lambda w: 2 * (w - 1) / w),
    "reduce_scatter": (lambda w: w - 1, lambda w: (w - 1) / w),
    "all_gather": (lambda w: w - 1, lambda w: (w - 1) / w),
    "all_to_all": (lambda w: w - 1, lambda w: (w - 1) / w),
    "broadcast": (lambda w: w - 1, lambda w: 1.0),
    "reduce": (lambda w: w - 1, lambda w: 1.0),
}

#: merge-history entries an artifact keeps, newest last
MAX_PROVENANCE = 8


@dataclass
class Calibration:
    """Serializable α-β calibration: class coefficients, an optional
    per-link table, and provenance (``fingerprint``: the fabric it was
    fitted on; ``samples``: the measurements behind it; ``provenance``: its
    merge history).  The stamps default empty, so unstamped artifacts
    load."""

    world: int
    classes: Dict[str, LinkCoeffs]
    links: Dict[Tuple[int, int], LinkCoeffs] = field(default_factory=dict)
    ips: Optional[Dict[int, str]] = None
    source: str = "unspecified"
    version: int = CALIBRATION_VERSION
    fingerprint: Optional[str] = None
    samples: int = 0
    provenance: Optional[List[str]] = None

    def cost_model(self) -> LinkCostModel:
        return LinkCostModel(self.world, links=self.links, classes=self.classes, ips=self.ips, source=self.source)

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "source": self.source,
            "world": self.world,
            "classes": {cls: {"alpha": c.alpha, "beta": c.beta} for cls, c in self.classes.items()},
            "links": [{"src": s, "dst": d, "alpha": c.alpha, "beta": c.beta}
                      for (s, d), c in sorted(self.links.items())],
            "ips": {str(r): ip for r, ip in (self.ips or {}).items()} or None,
            "fingerprint": self.fingerprint,
            "samples": int(self.samples),
            "provenance": list(self.provenance) if self.provenance else None,
        }

    @classmethod
    def from_dict(cls, obj: Mapping) -> "Calibration":
        version = int(obj.get("version", 0))
        if version != CALIBRATION_VERSION:
            raise ValueError(
                f"calibration artifact version {version} != supported {CALIBRATION_VERSION}; "
                "re-calibrate from traces"
            )
        classes = {name: LinkCoeffs(float(c["alpha"]), float(c["beta"]))
                   for name, c in (obj.get("classes") or {}).items()}
        links = {(int(entry["src"]), int(entry["dst"])): LinkCoeffs(float(entry["alpha"]), float(entry["beta"]))
                 for entry in (obj.get("links") or [])}
        ips_raw = obj.get("ips")
        prov = obj.get("provenance")
        return cls(
            world=int(obj["world"]),
            classes=classes,
            links=links,
            ips={int(r): ip for r, ip in ips_raw.items()} if ips_raw else None,
            source=str(obj.get("source", "unspecified")),
            version=version,
            fingerprint=str(obj["fingerprint"]) if obj.get("fingerprint") else None,
            samples=int(obj.get("samples") or 0),
            provenance=[str(p) for p in prov] if prov else None,
        )

    def save(self, path: str) -> str:
        """Atomic write (tmp + rename)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.rename(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "Calibration":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _from_model(model: LinkCostModel) -> Calibration:
    return Calibration(world=model.world, classes=dict(model.classes), links=dict(model.links), ips=model.ips,
                       source=model.source)


def calibrate_from_matrices(
    lat: np.ndarray,
    bw: np.ndarray,
    ips: Optional[Mapping[int, str]] = None,
    source: str = "matrices",
) -> Calibration:
    """Per-link fit from the profiler's latency [s] and bandwidth [GB/s]
    matrices."""
    return _from_model(LinkCostModel.from_matrices(lat, bw, ips, source=source))


def calibrate_from_profile_dir(topology_dir: str, world: int, ips: Optional[Mapping[int, str]] = None) -> Calibration:
    """Per-link fit from the ``topo_profile_*`` CSV shards on disk."""
    return _from_model(LinkCostModel.from_topo_profile_dir(topology_dir, world, ips))


def _battery_rows(jsonl_path: str) -> List[dict]:
    """The collective-sweep rows of a battery artifact: each record's
    ``rows`` list, else its single ``parsed`` row (which repeats the last
    of ``rows`` where both exist, and would weigh that size twice)."""
    rows: List[dict] = []
    with open(jsonl_path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            candidates = list(rec.get("rows") or [])
            if not candidates and isinstance(rec.get("parsed"), dict):
                candidates.append(rec["parsed"])
            for row in candidates:
                if (isinstance(row, dict) and row.get("collective") in _RING_STRUCTURE and row.get("time_us")
                        and row.get("size_bytes") and int(row.get("world", 0)) >= 2):
                    rows.append(row)
    return rows


def calibrate_from_battery(jsonl_path: str, impls: Tuple[str, ...] = ("xla", "pallas_ring")) -> Optional[Calibration]:
    """One (α, β) fit from a hardware battery's sweep rows of the baseline
    implementations ``impls`` (a schedule under test would calibrate the
    model to its own prediction target).  None when fewer than two rows, or
    a rank-deficient design, cannot separate α from β."""
    rows = [r for r in _battery_rows(jsonl_path) if r.get("impl") in impls]
    if len(rows) < 2:
        return None
    a = []
    y = []
    for r in rows:
        w = int(r["world"])
        rounds_fn, byte_fn = _RING_STRUCTURE[r["collective"]]
        a.append([float(rounds_fn(w)), byte_fn(w) * float(r["size_bytes"])])
        y.append(float(r["time_us"]) * 1e-6)
    if np.linalg.matrix_rank(np.array(a)) < 2:
        return None
    (alpha, beta), *_ = np.linalg.lstsq(np.array(a), np.array(y), rcond=None)
    coeffs = LinkCoeffs(alpha=max(0.0, float(alpha)), beta=max(0.0, float(beta)))
    world = max(int(r["world"]) for r in rows)
    return Calibration(world=world, classes={ICI: coeffs, DCN: LinkCoeffs(*_dcn_guess(coeffs))},
                       source=f"battery:{os.path.basename(jsonl_path)}")


def _dcn_guess(ici: LinkCoeffs) -> Tuple[float, float]:
    """A battery on one host says nothing of the inter-host class: the
    intra-host fit scaled by the defaults' class ratio."""
    from adapcc_tpu_torch.sim.cost_model import DEFAULT_COEFFS

    a_ratio = DEFAULT_COEFFS[DCN][0] / DEFAULT_COEFFS[ICI][0]
    b_ratio = DEFAULT_COEFFS[DCN][1] / DEFAULT_COEFFS[ICI][1]
    return ici.alpha * a_ratio, ici.beta * b_ratio


def merge_calibration(base: Calibration, update: Calibration, decay: float = 0.5) -> Calibration:
    """Fold a re-calibration into an artifact with decay.

    Coefficients blend per class and per link by sample weight: the update
    at its ``samples``, the base discounted by ``decay`` (an unstamped base
    borrows the update's weight).  Classes and links one side alone knows
    survive as they are, so a correction of one class leaves the others.
    The result keeps the sample count and a bounded provenance chain.
    Artifacts of other worlds or other fabrics (fingerprints) refuse."""
    if base.world != update.world:
        raise ValueError(f"cannot merge calibrations across worlds ({base.world} vs {update.world}); "
                         "re-calibrate for this world")
    if base.fingerprint is not None and update.fingerprint is not None and base.fingerprint != update.fingerprint:
        raise ValueError(f"cannot merge calibrations across fabrics (base fitted on {base.fingerprint!r}, "
                         f"update on {update.fingerprint!r}); seed a fresh artifact for this fabric instead")
    if not 0.0 <= decay <= 1.0:
        raise ValueError(f"decay must be in [0, 1], got {decay}")
    w_new = float(max(1, update.samples))
    w_old = decay * float(base.samples if base.samples > 0 else w_new)

    def blend(old: LinkCoeffs, new: LinkCoeffs) -> LinkCoeffs:
        if w_old + w_new <= 0:
            return new
        return LinkCoeffs(alpha=(w_old * old.alpha + w_new * new.alpha) / (w_old + w_new),
                          beta=(w_old * old.beta + w_new * new.beta) / (w_old + w_new))

    classes = dict(base.classes)
    for cls_name, c in update.classes.items():
        classes[cls_name] = blend(base.classes[cls_name], c) if cls_name in base.classes else c
    links = dict(base.links)
    for link, c in update.links.items():
        links[link] = blend(base.links[link], c) if link in base.links else c
    provenance = list(base.provenance or [])
    if not provenance and base.source:
        provenance.append(base.source)
    provenance.append(update.source)
    return Calibration(
        world=base.world,
        classes=classes,
        links=links,
        ips=update.ips if update.ips is not None else base.ips,
        source=f"merged:{update.source}",
        fingerprint=update.fingerprint or base.fingerprint,
        samples=int(round(w_old + w_new)),
        provenance=provenance[-MAX_PROVENANCE:],
    )


def load_calibration(path: str = DEFAULT_CALIBRATION_PATH) -> LinkCostModel:
    """Artifact → cost model (raises if absent or incompatible)."""
    return Calibration.load(path).cost_model()


def _stamp_warning(what: str) -> None:
    print(f"[sim] calibration WARNING: {what}", file=sys.stderr, flush=True)


def load_or_default(
    path: str = DEFAULT_CALIBRATION_PATH,
    world: Optional[int] = None,
    fingerprint: Optional[str] = None,
) -> LinkCostModel:
    """The artifact if it loads, else the defaults (``LinkCostModel.uniform``):
    this entry point prices either way.  An artifact that exists and fails
    to load, was fitted on another fabric (``fingerprint``) or at another
    world says so on stderr; at another world its per-link fits in range
    and its class means price the new world."""
    try:
        cal = Calibration.load(path)
        model = cal.cost_model()
    except (OSError, ValueError, KeyError, TypeError) as e:
        if os.path.exists(path):
            print(f"[sim] calibration artifact {path} unusable ({type(e).__name__}: {e}); "
                  "pricing with synthetic defaults", file=sys.stderr, flush=True)
        return LinkCostModel.uniform(world or 8, source="defaults")
    if fingerprint is not None and cal.fingerprint is not None and cal.fingerprint != fingerprint:
        _stamp_warning(
            f"{path} was fitted on fabric {cal.fingerprint!r} but this world's fingerprint is {fingerprint!r}; "
            "class coefficients still price the sweep, but re-calibrate before trusting a ranking on them"
        )
    if world is not None and world != model.world:
        _stamp_warning(
            f"{path} was fitted at world={model.world}, loading for world={world}; per-link fits outside "
            "the new range fall back to class means"
        )
        ips = None
        if model.ips and all(r in model.ips for r in range(world)):
            ips = {r: model.ips[r] for r in range(world)}
        return LinkCostModel(
            world,
            links={(s, d): c for (s, d), c in model.links.items() if s < world and d < world},
            classes=model.classes,
            ips=ips,
            source=model.source + f"@world{world}",
        )
    return model
