"""Measurement-driven collective plan tuner.

The port of :mod:`adapcc_tpu.tuner`: the cost model ranks candidate plans
*a priori*, and the tuner ranks them by what dispatches actually cost here:

- :mod:`adapcc_tpu_torch.tuner.db`: persistent, schema-versioned JSONL
  database of robust per-plan-cell timing stats (``topology/tuning.jsonl``,
  ``ADAPCC_TUNER_DB`` overrides), interchangeable with the JAX package's;
- :mod:`adapcc_tpu_torch.tuner.measure`: the walltime harness feeding it,
  live from dispatches or offline from a replayed ``CollectiveTrace``;
- :mod:`adapcc_tpu_torch.tuner.policy`: epsilon-greedy selection with the
  cost model as prior, measured medians as posterior, and hysteresis.

Global control: ``ADAPCC_TUNER=off|record|choose`` (a malformed value
raises).  ``record`` times dispatches into the database without changing
them; ``choose`` also lets the policy pick the ring chunk, the wire codec
and (for a training step) the overlap schedule that the caller left open,
under the precedence **env > explicit arg > tuner > strategy**.
"""

from __future__ import annotations

import os
from typing import Hashable, Optional, Sequence

from adapcc_tpu_torch.tuner.db import (
    DEFAULT_DB_PATH,
    SCHEMA_VERSION,
    TUNER_DB_ENV,
    TuningDatabase,
    TuningKey,
    TuningStats,
    mesh_fingerprint,
    resolve_db_path,
    size_bucket,
    topology_fingerprint,
)
from adapcc_tpu_torch.tuner.measure import DispatchTimer, replay_trace, timed_call
from adapcc_tpu_torch.tuner.policy import (
    DEFAULT_CHUNK_GRID,
    TUNER_OBJECTIVE_ENV,
    TUNER_OBJECTIVES,
    TunedPlan,
    TuningPolicy,
    resolve_tuner_objective,
)

#: global tuner mode env: off (default) | record | choose
TUNER_MODE_ENV = "ADAPCC_TUNER"

TUNER_MODES = ("off", "record", "choose")


def tuner_mode(explicit: Optional[str] = None) -> str:
    """The tuner mode in force: ``ADAPCC_TUNER`` env > the caller's
    explicit mode > "off".  A malformed value raises — a typo'd
    ``ADAPCC_TUNER=chose`` silently running untuned would invalidate the
    convergence run it was meant to drive (the ADAPCC_MERGE_ROUNDS
    policy)."""
    env = os.environ.get(TUNER_MODE_ENV)
    value = env if env is not None and env.strip() else explicit
    if value is None:
        return "off"
    mode = value.strip().lower()
    if mode not in TUNER_MODES:
        raise ValueError(
            f"{TUNER_MODE_ENV}={value!r}: expected one of {'|'.join(TUNER_MODES)}"
        )
    return mode


class CollectiveTuner:
    """One fabric's tuner: database + policy + live-dispatch timer.

    ``mode`` here is the *construction-time* default; the env var wins at
    every query so an operator can flip a running job's next engine build
    without code changes.  All heavy state (db load) happens once at
    construction; per-dispatch work is a dict lookup and, in record mode,
    the device sync the measurement semantics require anyway.
    """

    def __init__(
        self,
        world: int,
        topology: str,
        db: Optional[TuningDatabase] = None,
        db_path: Optional[str] = None,
        mode: Optional[str] = None,
        chunk_grid: Sequence[int] = DEFAULT_CHUNK_GRID,
        wire_dtypes: Optional[Sequence[str]] = None,
        cost_model=None,
        policy: Optional[TuningPolicy] = None,
        timer: Optional[DispatchTimer] = None,
        **policy_kwargs,
    ) -> None:
        tuner_mode(mode)  # validate BOTH the env and the explicit mode now
        #: the construction-time default mode (None = env-or-off); the env
        #: always wins at query time
        self.explicit_mode = mode
        self.world = int(world)
        self.topology = topology
        self.db = db if db is not None else TuningDatabase(db_path)
        # an injected policy/timer (the with_mode view path) takes the slot
        # as-is; the grid/codec/cost kwargs configure only a fresh build
        self.policy = (
            policy
            if policy is not None
            else TuningPolicy(
                self.db,
                self.world,
                topology,
                chunk_grid=chunk_grid,
                wire_dtypes=wire_dtypes,
                cost_model=cost_model,
                **policy_kwargs,
            )
        )
        self.timer = timer if timer is not None else DispatchTimer(self.db)

    # -- mode ------------------------------------------------------------------

    @property
    def mode(self) -> str:
        return tuner_mode(self.explicit_mode)

    def with_mode(self, mode: str) -> "CollectiveTuner":
        """A view of THIS tuner with a different default mode: same
        database, same policy (hysteresis), same warmup timer — only the
        env-unset fallback changes.  An explicit opt-in surface (e.g.
        ``DDPTrainer(tune=True)``) uses this so its promise holds without
        ``ADAPCC_TUNER`` being exported, while the env keeps global
        override either way."""
        return CollectiveTuner(
            world=self.world, topology=self.topology, db=self.db, mode=mode,
            policy=self.policy, timer=self.timer,
        )

    @property
    def recording(self) -> bool:
        return self.mode in ("record", "choose")

    @property
    def choosing(self) -> bool:
        return self.mode == "choose"

    # -- the two verbs ---------------------------------------------------------

    def choose(
        self,
        primitive: str,
        nbytes: int,
        dtype: str = "float32",
        wire_dtypes: Optional[Sequence[str]] = None,
        overlap_modes: Optional[Sequence[str]] = None,
        algos: Optional[Sequence[str]] = None,
    ) -> TunedPlan:
        """Commit a plan for one dispatch (policy rules; see
        :class:`adapcc_tpu_torch.tuner.policy.TuningPolicy`).  ``wire_dtypes``
        narrows the codec axis for configurations that cannot legally run
        every codec; ``overlap_modes`` narrows the ddp_step overlap axis
        the same way; ``algos`` narrows the allreduce algorithm axis (an
        ``ADAPCC_COLL_ALGO`` pin at the engine collapses it)."""
        return self.policy.choose(
            primitive, max(1, int(nbytes)), dtype, wire_dtypes,
            overlap_modes, algos,
        )

    def rank_only(
        self,
        primitive: str,
        nbytes: int,
        dtype: str = "float32",
        wire_dtypes: Optional[Sequence[str]] = None,
        overlap_modes: Optional[Sequence[str]] = None,
        algos: Optional[Sequence[str]] = None,
    ) -> TunedPlan:
        """Side-effect-free exploitation view (no exploration, no
        incumbent mutation) — see :meth:`TuningPolicy.rank_only`."""
        return self.policy.rank_only(
            primitive, max(1, int(nbytes)), dtype, wire_dtypes,
            overlap_modes, algos,
        )

    def observe_dispatch(
        self, key: TuningKey, cache_token: Hashable, seconds: float
    ) -> bool:
        """Record one live dispatch walltime (warmup-discarding)."""
        return self.timer.observe(key, cache_token, seconds)

    def key_for(
        self,
        primitive: str,
        nbytes: int,
        path: str,
        chunk_bytes: int,
        wire_dtype: str,
    ) -> TuningKey:
        """The database key for an *executed* configuration — callers hand
        in what actually ran (post-precedence), not what was chosen."""
        return TuningKey(
            primitive=primitive,
            size_bucket=size_bucket(nbytes),
            world=self.world,
            topology=self.topology,
            path=path,
            chunk_bytes=int(chunk_bytes),
            wire_dtype=wire_dtype,
        )

    def reset(self) -> None:
        """Drop hysteresis + warmup state (engine rebuild / re-adaptation)."""
        self.policy.reset()
        self.timer.reset()

    # -- constructors ----------------------------------------------------------

    @classmethod
    def for_mesh(
        cls, mesh, db_path: Optional[str] = None, world: Optional[int] = None, **kwargs
    ) -> "CollectiveTuner":
        """Tuner fingerprinted from a live world (the engine-side spelling):
        a :class:`~adapcc_tpu_torch.comm.mesh.World`, or a device with
        ``world`` its rank count (:func:`mesh_fingerprint`)."""
        n = world if world is not None else mesh.world_size
        return cls(
            world=int(n),
            topology=mesh_fingerprint(mesh, world=n),
            db_path=db_path,
            **kwargs,
        )

    def __repr__(self) -> str:
        return (
            f"CollectiveTuner(world={self.world}, topology={self.topology!r}, "
            f"mode={self.mode!r}, db={self.db!r})"
        )


__all__ = [
    "CollectiveTuner",
    "DEFAULT_CHUNK_GRID",
    "DEFAULT_DB_PATH",
    "DispatchTimer",
    "SCHEMA_VERSION",
    "TUNER_DB_ENV",
    "TUNER_MODE_ENV",
    "TUNER_MODES",
    "TUNER_OBJECTIVE_ENV",
    "TUNER_OBJECTIVES",
    "TunedPlan",
    "TuningDatabase",
    "TuningKey",
    "TuningPolicy",
    "TuningStats",
    "mesh_fingerprint",
    "replay_trace",
    "resolve_db_path",
    "resolve_tuner_objective",
    "size_bucket",
    "timed_call",
    "topology_fingerprint",
    "tuner_mode",
]
