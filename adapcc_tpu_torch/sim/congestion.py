"""Deterministic background traffic: congestion windows on shared link
classes (the port of :mod:`adapcc_tpu.sim.congestion`; a profile file
written by either package loads in the other unchanged).

A congested link is not a degraded one: a neighbour's traffic takes a share
of the bandwidth for a bounded window and gives it back, while the wire's
latency is mostly untouched.  So the model is a windowed bandwidth cut (β ×
factor, α intact: :func:`adapcc_tpu_torch.sim.cost_model.contended_coeffs`),
and the right answer a re-route, never a re-calibration.

A :class:`CongestionProfile` is the congestion twin of
:class:`~adapcc_tpu_torch.elastic.faults.FaultPlan`: a serializable schedule
of :class:`CongestionWindow` entries, each naming a link class (``ici`` |
``dcn``), a step range and a factor, folded per step, so two runs of one
profile see the same contention timeline.  It is injected at

- the simulated replay
  (:func:`adapcc_tpu_torch.sim.replay.simulate_congestion_profile`), which
  prices every step's collective under that step's contended model;
- the adaptation controller's observation funnel
  (:meth:`adapcc_tpu_torch.adapt.AdaptationController.tick`), which feeds
  the drift detector contended priced samples, so the triage fires
  deterministically.

``ADAPCC_CONGESTION_PROFILE`` names a JSON artifact, loaded through the
funnel ``ADAPCC_FAULT_PLAN`` uses (:mod:`adapcc_tpu_torch.utils.artifacts`):
unset → None, set but broken → loud, another world → loud.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from adapcc_tpu_torch.sim.cost_model import DCN, ICI

#: env var naming a congestion-profile JSON artifact
CONGESTION_PROFILE_ENV = "ADAPCC_CONGESTION_PROFILE"

#: link classes background traffic can contend
CONGESTION_CLASSES = (ICI, DCN)

#: a seeded profile's factor: a neighbour taking 3/4 of the bandwidth
DEFAULT_CONGESTION_FACTOR = 4.0


@dataclass(frozen=True)
class CongestionWindow:
    """Steps in ``[start, until)`` see the named class's bandwidth cut by
    ``factor`` (β × factor, α untouched)."""

    start: int
    until: int
    link_class: str
    factor: float = DEFAULT_CONGESTION_FACTOR

    def __post_init__(self) -> None:
        if self.link_class not in CONGESTION_CLASSES:
            raise ValueError(f"unknown congestion link class {self.link_class!r}; expected one of "
                             f"{CONGESTION_CLASSES}")
        if self.start < 0:
            raise ValueError(f"window start must be >= 0, got {self.start}")
        if self.until <= self.start:
            raise ValueError(f"window [{self.start}, {self.until}) is empty: 'until' must exceed 'start'")
        if self.factor < 1.0:
            raise ValueError(f"congestion factor must be >= 1 (1 = no contention), got {self.factor}")

    def active_at(self, step: int) -> bool:
        return self.start <= step < self.until

    def to_dict(self) -> dict:
        return {"start": self.start, "until": self.until, "link_class": self.link_class, "factor": self.factor}

    @classmethod
    def from_dict(cls, obj: Mapping) -> "CongestionWindow":
        return cls(start=int(obj["start"]), until=int(obj["until"]), link_class=str(obj["link_class"]),
                   factor=float(obj.get("factor", DEFAULT_CONGESTION_FACTOR)))


class CongestionProfile:
    """A serializable schedule of congestion windows for a world of
    ``world`` ranks (every consumer checks it against its own world)."""

    def __init__(self, windows: Sequence[CongestionWindow], world: int, label: str = "congestion-profile") -> None:
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.label = label
        self.windows: Tuple[CongestionWindow, ...] = tuple(
            sorted(windows, key=lambda w: (w.start, w.until, w.link_class)))

    # -- replay ----------------------------------------------------------------

    def active_at(self, step: int) -> List[CongestionWindow]:
        return [w for w in self.windows if w.active_at(step)]

    def factors_at(self, step: int) -> Dict[str, float]:
        """Each class's factor at one step; overlapping windows of one class
        take the largest (the hottest neighbour sets the share)."""
        factors: Dict[str, float] = {}
        for w in self.active_at(step):
            factors[w.link_class] = max(factors.get(w.link_class, 1.0), w.factor)
        return factors

    def healthy_at(self, step: int) -> bool:
        return not self.active_at(step)

    def contended_model(self, model, step: int):
        """The cost model this step's traffic leaves: ``model`` with every
        active window's class contended."""
        factors = self.factors_at(step)
        return model.contended(factors) if factors else model

    def last_step(self) -> int:
        return max((w.until for w in self.windows), default=0)

    def classes(self) -> Tuple[str, ...]:
        return tuple(sorted({w.link_class for w in self.windows}))

    # -- serialization ---------------------------------------------------------

    def to_dict(self) -> dict:
        return {"world": self.world, "label": self.label, "windows": [w.to_dict() for w in self.windows]}

    @classmethod
    def from_dict(cls, obj: Mapping) -> "CongestionProfile":
        return cls(windows=[CongestionWindow.from_dict(w) for w in obj.get("windows", ())],
                   world=int(obj["world"]), label=str(obj.get("label", "congestion-profile")))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "CongestionProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- canned profiles -------------------------------------------------------

    @classmethod
    def seeded(
        cls,
        world: int,
        steps: int,
        seed: int = 0,
        n_windows: int = 2,
        classes: Sequence[str] = (DCN,),
        factor: float = DEFAULT_CONGESTION_FACTOR,
    ) -> "CongestionProfile":
        """``n_windows`` bursts at distinct steps, each 2–4 steps long,
        cycling over ``classes``, drawn from ``seed``: one (world, steps,
        seed) gives one profile, byte for byte (the JAX package's draws)."""
        if steps < 2:
            raise ValueError("a seeded congestion profile needs steps >= 2")
        bad = [c for c in classes if c not in CONGESTION_CLASSES]
        if bad:
            raise ValueError(f"unknown congestion classes {bad}; expected a subset of {CONGESTION_CLASSES}")
        rng = np.random.default_rng(seed)
        n_windows = max(1, min(n_windows, steps // 2))
        starts = sorted(int(s) for s in rng.choice(max(1, steps - 1), size=n_windows, replace=False))
        windows = [CongestionWindow(start=start, until=min(steps, start + 2 + int(rng.integers(0, 3))),
                                    link_class=classes[i % len(classes)], factor=factor)
                   for i, start in enumerate(starts)]
        return cls(windows, world, label=f"seeded:{seed}")

    def __repr__(self) -> str:
        return f"CongestionProfile(world={self.world}, windows={len(self.windows)}, label={self.label!r})"


def load_congestion_profile(world: Optional[int] = None,
                            env: Optional[Mapping[str, str]] = None) -> Optional[CongestionProfile]:
    """The ``ADAPCC_CONGESTION_PROFILE`` funnel: None when unset; a missing
    file, bad JSON or another world raises."""
    from adapcc_tpu_torch.utils.artifacts import load_env_json_artifact

    return load_env_json_artifact(CONGESTION_PROFILE_ENV, CongestionProfile.from_dict, kind="congestion-profile",
                                  world=world, env=env,
                                  mismatch_hint="injecting it as-is would contend another pod's link layout")
