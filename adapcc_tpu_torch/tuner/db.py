"""Persistent tuning database: measured collective costs, keyed by plan cell.

The port of :mod:`adapcc_tpu.tuner.db`, record for record: a
``tuning.jsonl`` written by either package loads in the other.  Only
:func:`mesh_fingerprint` differs, taking the port's world or device.

The reference adapts from *measurements* taken on the live fabric (PAPER.md
step 2-3: profile, then choose), but its profile artifacts are link
matrices — they say what a wire costs, not what a *plan* costs.  This module
stores the missing layer: robust walltime statistics per executed plan cell

    (primitive, payload-size bucket, world, topology fingerprint,
     ring path, chunk_bytes, wire_dtype)

so the policy (:mod:`adapcc_tpu_torch.tuner.policy`) can rank candidate plans by
what dispatches actually cost on *this* world, not by the α-β prior alone.

Storage is append-only JSONL — one sample per line — because the writers
are concurrent: every process of a multi-host job appends to the same file
(or its own copy of it) without coordination, and a deterministic group-by
on load merges whatever interleaving the filesystem produced.  Corrupt
lines and records from other schema versions are *skipped with a loud
warning*, never silently dropped: a tuning database that quietly loses its
history would re-explore cells the world already paid to measure.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

#: bump when the record layout changes; mismatched records are skipped
#: loudly on load (an old database stays readable as "nothing measured")
SCHEMA_VERSION = 1

#: env override for the database path (default ``topology/tuning.jsonl``)
TUNER_DB_ENV = "ADAPCC_TUNER_DB"

DEFAULT_DB_PATH = os.path.join("topology", "tuning.jsonl")

#: samples retained per key after a load/merge — newest win, so a drifting
#: fabric (thermal, degraded link) ages out stale measurements
MAX_SAMPLES_PER_KEY = 128


def resolve_db_path(path: Optional[str] = None) -> str:
    """The database path in force: explicit argument > ``ADAPCC_TUNER_DB``
    env > the default artifact next to the other topology products."""
    if path is not None:
        return path
    env = os.environ.get(TUNER_DB_ENV)
    if env is not None and env.strip():
        return env.strip()
    return DEFAULT_DB_PATH


def size_bucket(nbytes: int) -> int:
    """Payload-size bucket: bytes rounded up to the next power of two.

    Measurements generalize across nearby payloads (a 12 MB and a 14 MB
    allreduce cost the same plan the same), but not across decades — so
    samples pool per power-of-two bucket, the granularity nccl-tests
    sweeps use.
    """
    n = max(1, int(nbytes))
    return 1 << (n - 1).bit_length()


def topology_fingerprint(
    world: int,
    ips: Optional[Mapping[int, str]] = None,
    platform: Optional[str] = None,
) -> str:
    """Stable fabric identity for tuning keys: world size + host layout +
    device platform/kind.  Measurements taken on one fabric must never rank
    plans for another (a median on the card says nothing about a CPU
    run), so the fingerprint is part of every key."""
    h = hashlib.sha256()
    h.update(str(int(world)).encode())
    if ips:
        h.update(repr(sorted((int(r), str(ip)) for r, ip in ips.items())).encode())
    if platform:
        h.update(str(platform).encode())
    return h.hexdigest()[:12]


def device_platform(device: Any) -> str:
    """``"<platform>:<kind>"`` of a device, the spelling the JAX package
    fingerprints a device with: ``"cpu:cpu"`` on the CPU (JAX's CPU device
    kind is ``cpu`` too), ``"gpu:<torch.cuda.get_device_name>"`` on a card."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def mesh_fingerprint(mesh: Any, world: Optional[int] = None) -> str:
    """Fingerprint a live world: the device's platform and kind and the
    world size (the engine-side analog of :func:`topology_fingerprint`).
    ``mesh`` is a :class:`~adapcc_tpu_torch.comm.mesh.World` (its device and
    size) or a device, with ``world`` its rank count (the stacked engine's
    rows)."""
    device = getattr(mesh, "device", mesh)
    n = world if world is not None else getattr(mesh, "world_size", None)
    if n is None:
        raise ValueError("mesh_fingerprint of a device needs world=")
    return topology_fingerprint(int(n), platform=device_platform(device))


@dataclass(frozen=True, order=True)
class TuningKey:
    """One plan cell: what ran, on what fabric, at what size."""

    primitive: str      #: "allreduce" | "reduce_scatter" | "ddp_step" | ...
    size_bucket: int    #: power-of-two per-rank payload bucket (bytes)
    world: int
    topology: str       #: fabric fingerprint (:func:`topology_fingerprint`)
    path: str           #: "vmem" | "hbm-stream" | "quant-ring" | "hook" | ...
    chunk_bytes: int    #: staging granularity; 0 where the path has none
    wire_dtype: str     #: codec registry name ("off" = payload dtype)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "TuningKey":
        return cls(
            primitive=str(obj["primitive"]),
            size_bucket=int(obj["size_bucket"]),
            world=int(obj["world"]),
            topology=str(obj["topology"]),
            path=str(obj["path"]),
            chunk_bytes=int(obj["chunk_bytes"]),
            wire_dtype=str(obj["wire_dtype"]),
        )


@dataclass(frozen=True)
class TuningStats:
    """Robust summary of one cell's samples: median + IQR, not mean + max —
    a single straggler-polluted dispatch must not poison the cell.

    ``p99_s`` is the nearest-rank 99th percentile over the cell's bounded
    sample window (the tuner-side reservoir, newest
    :data:`MAX_SAMPLES_PER_KEY`): the number the tail-aware objective
    (``ADAPCC_TUNER_OBJECTIVE=p99``, docs/TUNER.md §6) ranks cells by —
    a plan that wins the median but fattens the tail must lose there.
    """

    count: int
    median_s: float
    iqr_s: float
    min_s: float
    max_s: float
    p99_s: float

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def _robust_stats(samples: List[float]) -> TuningStats:
    from adapcc_tpu_torch.utils.observability import nearest_rank_percentile

    xs = sorted(samples)

    def q(frac: float) -> float:
        return nearest_rank_percentile(xs, frac)

    return TuningStats(
        count=len(xs),
        median_s=q(0.5),
        iqr_s=q(0.75) - q(0.25),
        min_s=xs[0],
        max_s=xs[-1],
        p99_s=q(0.99),
    )


@dataclass
class _Cell:
    #: (ts, seconds) pairs; kept sorted on read, bounded to newest
    samples: List[Tuple[float, float]] = field(default_factory=list)


class TuningDatabase:
    """Schema-versioned JSONL store of per-plan-cell timing samples.

    - ``record()`` appends one line to the file immediately (append mode:
      concurrent processes interleave whole lines, which the deterministic
      merge on load handles), and updates the in-memory view.
    - ``load()`` re-reads the file, skipping corrupt / version-mismatched
      lines with a loud stderr warning and counting them in
      ``skipped_records``.
    - Per key, only the newest :data:`MAX_SAMPLES_PER_KEY` samples are
      retained, ordered by ``(ts, seconds)`` — a total order independent of
      append interleaving, so every process that loads the same lines sees
      the same statistics.
    """

    def __init__(self, path: Optional[str] = None, persist: bool = True) -> None:
        #: resolved artifact path (still meaningful when persist=False: it
        #: names where a later ``save()`` would land)
        self.path = resolve_db_path(path)
        #: persist=False keeps the db purely in-memory — the sim replay and
        #: unit tests must not write into the repo's topology/ artifacts
        self.persist = persist
        self._cells: Dict[TuningKey, _Cell] = {}
        self.skipped_records = 0
        # the on-disk history is parsed lazily, at the first query/record:
        # a Communicator always owns a tuner, but with ADAPCC_TUNER=off
        # nothing ever asks it anything — construction must not pay a full
        # JSONL parse of a long-lived job's append-only history for that
        self._loaded = not (self.persist and os.path.exists(self.path))
        # one O_APPEND handle reused across records: record() sits on the
        # per-dispatch hot path, where per-sample makedirs+open+close would
        # be repeated filesystem syscalls for one JSONL line.  O_APPEND
        # writes of whole lines stay atomic for concurrent processes.
        self._append_fh = None

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self.load()

    # -- ingestion -------------------------------------------------------------

    def record(
        self, key: TuningKey, seconds: float, ts: Optional[float] = None
    ) -> None:
        """Add one timing sample and (when persisting) append it to disk."""
        self._ensure_loaded()
        s = float(seconds)
        if s < 0:
            raise ValueError(f"negative duration {s}; clocks do not run backwards")
        t = time.time() if ts is None else float(ts)
        self._insert(key, t, s)
        if self.persist:
            line = json.dumps(
                {"v": SCHEMA_VERSION, "key": key.to_dict(), "t_s": s, "ts": t},
                sort_keys=True,
            )
            if self._append_fh is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._append_fh = open(self.path, "a")
            self._append_fh.write(line + "\n")
            self._append_fh.flush()  # other processes merge on their load

    def _insert(self, key: TuningKey, ts: float, seconds: float) -> None:
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _Cell()
        cell.samples.append((ts, seconds))
        if len(cell.samples) > 2 * MAX_SAMPLES_PER_KEY:
            self._trim(cell)

    @staticmethod
    def _trim(cell: _Cell) -> None:
        cell.samples.sort()
        del cell.samples[:-MAX_SAMPLES_PER_KEY]

    # -- load / merge ----------------------------------------------------------

    def load(self, path: Optional[str] = None) -> int:
        """(Re)load from disk, merging concurrent appends deterministically.

        Returns the number of samples ingested.  Lines that fail to parse,
        lack required fields, or carry a different schema version are
        counted in ``skipped_records`` and reported ONCE per load with a
        loud stderr warning — never silently.
        """
        path = path if path is not None else self.path
        self._loaded = True
        self._cells.clear()
        self.skipped_records = 0
        loaded = 0
        bad: List[str] = []
        try:
            f = open(path)
        except FileNotFoundError:
            return 0
        with f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    version = int(obj["v"])
                    if version != SCHEMA_VERSION:
                        raise ValueError(
                            f"schema v{version} != v{SCHEMA_VERSION}"
                        )
                    key = TuningKey.from_dict(obj["key"])
                    self._insert(key, float(obj["ts"]), float(obj["t_s"]))
                    loaded += 1
                except (KeyError, TypeError, ValueError) as e:
                    self.skipped_records += 1
                    if len(bad) < 3:
                        bad.append(f"line {lineno}: {type(e).__name__}: {e}")
        if self.skipped_records:
            print(
                f"[adapcc.tuner] WARNING: skipped {self.skipped_records} "
                f"corrupt/version-mismatched record(s) in {path} "
                f"(first: {'; '.join(bad)})",
                file=sys.stderr,
                flush=True,
            )
        # deterministic merge: per key, sort by (ts, seconds) and keep the
        # newest window — any interleaving of the same appended lines
        # reaches the same state
        for cell in self._cells.values():
            self._trim(cell)
        return loaded

    def merge_from(self, other: "TuningDatabase") -> None:
        """Fold another database's samples in (e.g. per-process shards
        gathered to one artifact); same deterministic bound per key."""
        self._ensure_loaded()
        other._ensure_loaded()
        for key, cell in other._cells.items():
            for ts, s in cell.samples:
                self._insert(key, ts, s)
        for cell in self._cells.values():
            self._trim(cell)

    def save(self, path: Optional[str] = None) -> str:
        """Compact rewrite: one line per retained sample, sorted — the
        maintenance valve for databases grown by long append-only runs."""
        self._ensure_loaded()
        path = path if path is not None else self.path
        if path == self.path and self._append_fh is not None:
            # the compaction rewrite replaces the file the append handle
            # points at; drop it so the next record() reopens the new one
            self._append_fh.close()
            self._append_fh = None
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for key in sorted(self._cells):
                cell = self._cells[key]
                for ts, s in sorted(cell.samples):
                    f.write(
                        json.dumps(
                            {
                                "v": SCHEMA_VERSION,
                                "key": key.to_dict(),
                                "t_s": s,
                                "ts": ts,
                            },
                            sort_keys=True,
                        )
                        + "\n"
                    )
        return path

    # -- queries ---------------------------------------------------------------

    def keys(self) -> List[TuningKey]:
        self._ensure_loaded()
        return sorted(self._cells)

    def count(self, key: TuningKey) -> int:
        self._ensure_loaded()
        cell = self._cells.get(key)
        return len(cell.samples) if cell else 0

    def samples(self, key: TuningKey) -> List[float]:
        self._ensure_loaded()
        cell = self._cells.get(key)
        if not cell:
            return []
        return [s for _, s in sorted(cell.samples)[-MAX_SAMPLES_PER_KEY:]]

    def timed_samples(self, key: TuningKey) -> List[Tuple[float, float]]:
        """``(ts, seconds)`` pairs in the same deterministic order/bound as
        :meth:`samples` — for consumers that must tell WHEN a sample was
        taken (the drift detector's post-swap watermark: evidence recorded
        under a retired plan must not re-fire against its successor)."""
        self._ensure_loaded()
        cell = self._cells.get(key)
        if not cell:
            return []
        return sorted(cell.samples)[-MAX_SAMPLES_PER_KEY:]

    def stats(self, key: TuningKey) -> Optional[TuningStats]:
        xs = self.samples(key)
        if not xs:
            return None
        return _robust_stats(xs)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Artifact rows: one summary dict per key (benchmarks, docs)."""
        out = []
        for key in self.keys():
            stats = self.stats(key)
            assert stats is not None
            out.append({**key.to_dict(), **stats.to_dict()})
        return out

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self._cells)

    def __repr__(self) -> str:
        n = sum(len(c.samples) for c in self._cells.values())
        return (
            f"TuningDatabase(path={self.path!r}, keys={len(self._cells)}, "
            f"samples={n})"
        )


def ingest_iter(
    db: TuningDatabase, records: Iterable[Tuple[TuningKey, float, float]]
) -> int:
    """Bulk-insert ``(key, seconds, ts)`` tuples (offline replay helper)."""
    n = 0
    for key, seconds, ts in records:
        db.record(key, seconds, ts=ts)
        n += 1
    return n
