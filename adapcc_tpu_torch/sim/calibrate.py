"""α-β calibration artifacts: fit, persist, load.

The port of :mod:`adapcc_tpu.sim.calibrate`'s artifact half.  The JSON
format is the JAX package's, key for key, so a ``calibration.json`` written
by either package loads in the other: class coefficients under the shared
link-class keys (``ici``, ``dcn``), an optional per-link table and ip map,
and the provenance stamps.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from adapcc_tpu_torch.sim.cost_model import LinkCoeffs, LinkCostModel

CALIBRATION_VERSION = 1

#: where an artifact lives, beside the other topology artifacts
DEFAULT_CALIBRATION_PATH = os.path.join("topology", "calibration.json")


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


def calibrate_from_matrices(
    lat: np.ndarray,
    bw: np.ndarray,
    ips: Optional[Mapping[int, str]] = None,
    source: str = "matrices",
) -> Calibration:
    """Per-link fit from the profiler's latency [s] and bandwidth [GB/s]
    matrices."""
    model = LinkCostModel.from_matrices(lat, bw, ips, source=source)
    return Calibration(world=model.world, classes=dict(model.classes), links=dict(model.links), ips=model.ips,
                       source=model.source)


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
