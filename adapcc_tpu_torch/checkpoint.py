"""Checkpoint and resume, elastic restore: the port of
:mod:`adapcc_tpu.checkpoint` on ``torch.save`` / ``torch.load``.

The reference's story (its elastic imagenet workload) is a mutable
``State`` with ``capture_snapshot`` / ``apply_snapshot``, an atomic save
through a tmp file and a rename, and a rendezvous-time broadcast of the
newest checkpoint from the rank with the largest epoch.  The port keeps the
JAX package's shape of it:

- :class:`TrainCheckpointState` (the layout guard on every load),
  :func:`save_checkpoint` / :func:`load_checkpoint` (one crash-durable file);
- :class:`CheckpointManager`, a directory of steps with retention, whose
  :meth:`~CheckpointManager.save_sharded` has each rank write only its own
  shard (the port's own files, one a rank, not ``torch.distributed.
  checkpoint``) and whose :meth:`~CheckpointManager.restore_sharded` lands
  in the target's layout, re-splitting ZeRO-1 rows for another world;
- :class:`AsyncCheckpointManager`: a manifest of sizes and sha256 sums,
  verified restores, torn tmp directories ignored, keep-last-good
  retention, and an async save whose errors raise at the next call
  (``ADAPCC_ASYNC_CKPT`` gates it for workloads);
- :func:`restore_newest_across_processes`, the rendezvous over the process
  group's own key-value store (``torch.distributed``'s ``Store``), keys
  namespaced by ``ADAPCC_RESTART_GEN`` or ``gen=``, every fetch under the
  ``ADAPCC_RPC_TIMEOUT_S`` deadline; and :func:`run_elastic`, the restart
  supervisor.

The format is the port's own, a ``torch.save`` of the snapshot dict; it does
not read the JAX package's flax msgpack or orbax trees.

``params`` is the model's ``state_dict()``; ``opt_state`` the optimizer's
``state_dict()``, or ``(master, optimizer state_dict)`` for ZeRO-1
(:meth:`~adapcc_tpu_torch.parallel.fsdp.Zero1Optimizer.restore`).  A load
puts every tensor on the device of the state being resumed: where the
resuming state holds a tensor at the same place, on that tensor's device,
elsewhere on the device of its first tensor; a resuming state without any
tensor needs ``device=``.  It never lands on the CPU by default.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import random
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

#: ``extra`` keys that describe the *layout* of the stored tensors: when the
#: in-memory state declares one (``Zero1Optimizer.checkpoint_extra``'s
#: "zero1_layout"), a loaded snapshot must match it exactly
LAYOUT_GUARD_KEYS = ("zero1_layout",)


#: async crash-consistent checkpointing gate for the workloads: ``on``
#: routes saves through :class:`AsyncCheckpointManager`'s background
#: pipeline; malformed raises
ASYNC_CKPT_ENV = "ADAPCC_ASYNC_CKPT"


def async_checkpointing_enabled(explicit: bool = False) -> bool:
    """The ``ADAPCC_ASYNC_CKPT`` funnel: env > explicit flag > off."""
    raw = os.environ.get(ASYNC_CKPT_ENV, "").strip().lower()
    if not raw:
        return bool(explicit)
    if raw in ("on", "1", "true"):
        return True
    if raw in ("off", "0", "false"):
        return False
    raise ValueError(f"{ASYNC_CKPT_ENV}={raw!r}: expected on|off")


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Make a directory entry change (rename, create) durable: the rename
    is atomic but not durable until the parent's metadata is on disk."""
    _fsync_path(path)


def _first_tensor(obj: Any) -> Optional[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return obj
    values = obj.values() if isinstance(obj, dict) else obj if isinstance(obj, (list, tuple)) else ()
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _place(obj: Any, like: Any, device: torch.device) -> Any:
    """``obj`` with every tensor on the device of the tensor at the same
    place in ``like``, else on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(like.device if isinstance(like, torch.Tensor) else device)
    if isinstance(obj, dict):
        like = like if isinstance(like, dict) else {}
        return type(obj)((k, _place(v, like.get(k), device)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        like = like if isinstance(like, (list, tuple)) and len(like) == len(obj) else [None] * len(obj)
        return type(obj)(_place(v, w, device) for v, w in zip(obj, like))
    return obj


@dataclass
class TrainCheckpointState:
    """Everything a worker needs to resume: the reference ``State`` (epoch,
    best metric, model and optimizer state) with a free-form ``extra``."""

    params: Any
    opt_state: Any = None
    epoch: int = -1
    step: int = 0
    best_metric: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)

    def capture_snapshot(self) -> Dict[str, Any]:
        """A serializable dict; :meth:`apply_snapshot` is its inverse."""
        return {
            "epoch": self.epoch,
            "step": self.step,
            "best_metric": self.best_metric,
            "params": self.params,
            "opt_state": self.opt_state,
            "extra": self.extra,
        }

    def apply_snapshot(self, obj: Dict[str, Any]) -> None:
        """Mutate this state from a snapshot.  The layout-guard keys the
        in-memory ``extra`` declares are enforced against the snapshot
        before anything changes: every load goes through here, so a resume
        whose optimizer layout (ring, world, align) differs from the saved
        one raises instead of loading permuted tensors."""
        self._enforce_layout_guard(obj.get("extra"))
        self.epoch = int(obj["epoch"])
        self.step = int(obj["step"])
        self.best_metric = float(obj["best_metric"])
        self.params = obj["params"]
        self.opt_state = obj["opt_state"]
        self.extra = dict(obj.get("extra", {}))

    def _enforce_layout_guard(self, incoming_extra: Any) -> None:
        incoming = dict(incoming_extra or {})
        for key in LAYOUT_GUARD_KEYS:
            expected = (self.extra or {}).get(key)
            if expected is not None and incoming.get(key) != expected:
                raise ValueError(
                    f"checkpoint layout mismatch on extra[{key!r}]: saved={incoming.get(key)!r} vs "
                    f"resuming={expected!r}; restoring would load permuted tensors — resume with the "
                    "matching configuration or re-shard offline"
                )
            if expected is None and incoming.get(key) is not None and self.opt_state is not None:
                # optimizer state saved under a sharded layout this resume
                # never declared; a params-only load (opt_state=None) is
                # unaffected, params are not permuted
                raise ValueError(
                    f"checkpoint carries a layout tag extra[{key!r}] but this resume declares none; "
                    "stamp the resuming state's extra (DDPTrainer.checkpoint_extra() / "
                    "Zero1Optimizer.checkpoint_extra()) so the layout can be verified, or load with "
                    "opt_state=None for params-only use"
                )

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        torch.save(self.capture_snapshot(), buf)
        return buf.getvalue()

    def load_bytes(self, blob: bytes, device: Optional[torch.device] = None) -> None:
        """Load a :meth:`to_bytes` blob, its tensors placed as the module
        docstring says (``device`` overrides the resuming state's)."""
        template = self.capture_snapshot()
        if device is None:
            first = _first_tensor(template["params"])
            first = first if first is not None else _first_tensor(template["opt_state"])
            if first is None:
                raise ValueError(
                    "the resuming state holds no tensor to take a device from; pass device= to "
                    "load_bytes / load_checkpoint / CheckpointManager.restore"
                )
            device = first.device
        raw = torch.load(io.BytesIO(blob), map_location=device, weights_only=True)
        # the guard sees the raw extra before anything is placed or applied
        self._enforce_layout_guard(raw.get("extra") if isinstance(raw, dict) else None)
        self.apply_snapshot(_place(raw, template, device))


# --- single-file atomic checkpoints ------------------------------------------


def save_checkpoint(state: TrainCheckpointState, filename: str, is_best: bool = False) -> None:
    """Atomic and crash-durable save: write a pid-suffixed tmp file, flush
    and fsync it, rename it over ``filename``, then fsync the directory (the
    rename orders the name change; the directory's fsync makes it durable).
    ``is_best`` keeps a ``model_best.ckpt`` copy beside it."""
    checkpoint_dir = os.path.dirname(filename) or "."
    os.makedirs(checkpoint_dir, exist_ok=True)
    # concurrent savers on a shared file system each write their own tmp
    tmp_filename = f"{filename}.tmp.{os.getpid()}"
    with open(tmp_filename, "wb") as f:
        f.write(state.to_bytes())
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp_filename, filename)
    _fsync_dir(checkpoint_dir)
    if is_best:
        best = os.path.join(checkpoint_dir, "model_best.ckpt")
        best_tmp = f"{best}.tmp.{os.getpid()}"
        shutil.copyfile(filename, best_tmp)
        _fsync_path(best_tmp)
        os.rename(best_tmp, best)
        _fsync_dir(checkpoint_dir)


def load_checkpoint(state: TrainCheckpointState, filename: str, device: Optional[torch.device] = None) -> bool:
    """Load ``filename`` into ``state`` if it exists; returns whether it did."""
    if not os.path.isfile(filename):
        return False
    with open(filename, "rb") as f:
        state.load_bytes(f.read(), device)
    return True


# --- newest-checkpoint rendezvous broadcast ----------------------------------

#: bytes a key-value store value carries: a checkpoint blob is cut into
#: values of at most this size
_BLOB_CHUNK_BYTES = 2 * 1024 * 1024


def _default_store() -> Any:
    import torch.distributed as dist

    return dist.distributed_c10d._get_default_store()


def _rendezvous_fetch(store: Any, key: str, what: str, budget_s: float) -> bytes:
    """One rendezvous fetch under the ``ADAPCC_RPC_TIMEOUT_S`` deadline and
    the coordinator's bounded, jittered backoff: a dead peer that never
    publishes ``key`` raises :class:`~adapcc_tpu_torch.coordinator.service.
    CoordinatorUnavailable` naming what was waited for, never an endless
    block inside the restore barrier."""
    from adapcc_tpu_torch.coordinator.service import (
        RPC_BACKOFF_INITIAL_S,
        RPC_BACKOFF_MAX_S,
        RPC_TIMEOUT_ENV,
        CoordinatorUnavailable,
    )

    rng = random.Random(0xCCC ^ hash(key) & 0xFFFF)
    deadline = time.monotonic() + budget_s
    backoff = RPC_BACKOFF_INITIAL_S
    while True:
        if store.check([key]):
            return store.get(key)
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise CoordinatorUnavailable(
                f"elastic rendezvous: {what} got no answer within {budget_s:.3f}s ({RPC_TIMEOUT_ENV} budget) "
                "— a dead peer must surface loudly, not hang the restore barrier"
            )
        time.sleep(min(backoff * (1.0 + rng.random()), RPC_BACKOFF_MAX_S, remaining))
        backoff = min(backoff * 2, RPC_BACKOFF_MAX_S)


def restore_newest_across_processes(
    state: TrainCheckpointState,
    filename: str,
    timeout_ms: int = 120_000,
    gen: Optional[str] = None,
    load_local: bool = True,
    store: Any = None,
    device: Optional[torch.device] = None,
) -> TrainCheckpointState:
    """Elastic-restart restore: load the local checkpoint (if any), then
    adopt the freshest one any process holds.

    One process: the local load.  In a process group every process
    publishes its epoch to the group's key-value store (``store``, default
    the process group's own); the holder of the largest epoch publishes its
    snapshot, cut into values of at most 2 MiB, where some process is
    behind, and every process behind loads it.  Keys live under
    ``adapcc/elastic/g<ADAPCC_RESTART_GEN>``, or ``adapcc/elastic/rejoin/
    g<gen>`` for a rejoining worker's admit generation, so a relaunched
    world never reads an earlier generation's keys.  Every fetch runs
    under the deadline: ``timeout_ms``, capped by ``ADAPCC_RPC_TIMEOUT_S``
    where the operator set it.  ``load_local=False`` skips the local load
    (a caller that restored fresher state another way).  ``device`` places
    a loaded snapshot's tensors (the resuming state's devices otherwise)."""
    import torch.distributed as dist

    if load_local:
        load_checkpoint(state, filename, device)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return state

    from adapcc_tpu_torch.coordinator.service import RPC_TIMEOUT_ENV, rpc_timeout_s

    if gen is None:
        prefix = f"adapcc/elastic/g{os.environ.get('ADAPCC_RESTART_GEN', '0')}"
    else:
        # the admit generation is a coordinator counter, kept apart from
        # the supervisor's restart generations
        prefix = f"adapcc/elastic/rejoin/g{gen}"
    store = _default_store() if store is None else store
    me, n = dist.get_rank(), dist.get_world_size()
    if os.environ.get(RPC_TIMEOUT_ENV, "").strip():
        budget_s = min(rpc_timeout_s(), timeout_ms / 1000.0)
    else:
        budget_s = timeout_ms / 1000.0

    store.set(f"{prefix}/epoch/{me}", str(state.epoch))
    with ThreadPoolExecutor(max_workers=min(32, n)) as pool:
        epochs = list(pool.map(
            lambda p: int(_rendezvous_fetch(store, f"{prefix}/epoch/{p}", f"epoch of peer {p}", budget_s)),
            range(n)))
    max_epoch = max(epochs)
    if max_epoch < 0:
        return state  # nobody has a checkpoint: a fresh start everywhere
    max_rank = epochs.index(max_epoch)
    if me == max_rank and min(epochs) < max_epoch:
        blob = state.to_bytes()
        chunks = [blob[i:i + _BLOB_CHUNK_BYTES] for i in range(0, len(blob), _BLOB_CHUNK_BYTES)] or [b""]
        for i, chunk in enumerate(chunks):
            store.set(f"{prefix}/blob/{i}", chunk)
        # the count last: a reader that sees it finds every chunk
        store.set(f"{prefix}/blob/count", str(len(chunks)))
    elif state.epoch < max_epoch:
        count = int(_rendezvous_fetch(store, f"{prefix}/blob/count",
                                      f"checkpoint blob count from rank {max_rank}", budget_s))
        blob = b"".join(
            _rendezvous_fetch(store, f"{prefix}/blob/{i}", f"checkpoint blob chunk {i}/{count} from rank {max_rank}",
                              budget_s)
            for i in range(count))
        state.load_bytes(blob, device)
    return state


# --- a directory of steps -----------------------------------------------------

_STEP_DIR_RE = re.compile(r"^(\d+)$")
_STATE_FILE = "state.ckpt"
_SHARD_FILE_RE = re.compile(r"^shard-(\d+)-of-(\d+)\.ckpt$")


def _rank_world(rank: Optional[int], world: Optional[int]) -> tuple:
    """``(rank, world)``: the arguments, else the process group's, else a
    world of one."""
    import torch.distributed as dist

    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    return int(rank), int(world)


class CheckpointManager:
    """A directory of steps: ``save(step, state)``, ``latest_step()``,
    ``restore(state, step=None)``, keeping the newest ``max_to_keep``.

    The JAX package's manager runs on orbax; this one keeps its behaviour
    on :func:`save_checkpoint`: one ``<directory>/<step>/state.ckpt`` a step,
    written atomically, the oldest steps beyond ``max_to_keep`` removed
    after each save."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)), _STATE_FILE)

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first (whole or sharded)."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR_RE.match(name)
            if m and any(f == _STATE_FILE or _SHARD_FILE_RE.match(f)
                         for f in os.listdir(os.path.join(self.directory, name))):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _retain(self) -> None:
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def save(self, step: int, state: TrainCheckpointState) -> None:
        save_checkpoint(state, self._path(step))
        self._retain()

    # -- sharded (ZeRO-1) state --------------------------------------------------

    def save_sharded(self, step: int, tree: Any, rank: Optional[int] = None, world: Optional[int] = None,
                     layout: Optional[Mapping[str, Any]] = None) -> None:
        """Save this rank's share of a sharded state: ``tree`` (dicts, lists
        and tuples of tensors, e.g. ``{"master": row, "opt": optimizer.
        state_dict()}``) into ``<step>/shard-<rank>-of-<world>.ckpt``,
        written atomically; no rank ever holds another's shard.
        ``rank`` and ``world`` default to the process group's.  ``layout``
        (a ZeRO-1 layout tag with the flat vector's ``total``) lets
        :meth:`restore_sharded` re-split the rows for another world.  Rank
        0 applies the retention."""
        rank, world = _rank_world(rank, world)
        path = os.path.join(self.directory, str(int(step)), f"shard-{rank}-of-{world}.ckpt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        buf = io.BytesIO()
        torch.save({"tree": tree, "rank": rank, "world": world, "layout": dict(layout or {})}, buf)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        _fsync_dir(os.path.dirname(path))
        if rank == 0:
            self._retain()

    def restore_sharded(self, target: Any, step: Optional[int] = None, rank: Optional[int] = None,
                        world: Optional[int] = None, layout: Optional[Mapping[str, Any]] = None) -> Any:
        """Restore this rank's share into ``target``'s layout: ``target`` is
        this rank's tree (its tensors give the devices).  Saved under the
        same world (and ``layout``), it is this rank's own shard; under
        another world every shard is read and each ZeRO-1 row leaf (a 1-D
        tensor the length of the saved rows) is gathered to the canonical
        flat vector (ring ownership undone, padding dropped) and re-split
        as ``layout`` says (its ``world``, ``ring``, ``align``), this rank's
        row taken; other leaves come from shard 0."""
        from adapcc_tpu_torch.elastic.redundancy import tree_leaves, tree_map

        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint step in {self.directory}")
        rank, world = _rank_world(rank, world)
        d = os.path.join(self.directory, str(int(step)))
        shards = {}
        for f in os.listdir(d):
            m = _SHARD_FILE_RE.match(f)
            if m:
                shards[int(m.group(1))] = (int(m.group(2)), os.path.join(d, f))
        if not shards:
            raise FileNotFoundError(f"step {step} in {self.directory} holds no shard")
        saved_world = {w for w, _ in shards.values()}
        if len(saved_world) != 1 or len(shards) != next(iter(saved_world)):
            raise ValueError(f"step {step}: shards of several worlds or missing shards: {sorted(shards)}")
        saved_world = saved_world.pop()
        device = _first_tensor(target)
        device = device.device if device is not None else torch.device("cpu")

        def load(r: int) -> Dict[str, Any]:
            return torch.load(shards[r][1], map_location="cpu", weights_only=True)

        own = load(rank if rank < saved_world else 0)
        saved_layout = own["layout"]
        want = dict(layout or {})
        same = saved_world == world and all(saved_layout.get(k) == v for k, v in want.items() if k != "total")
        if same:
            return _place(own["tree"], target, device)
        if "total" not in saved_layout or not want:
            raise ValueError(
                f"step {step} was saved by a world of {saved_world}; restoring into a world of {world} "
                "re-splits the rows and needs the saved and the target layout (save_sharded(layout=...), "
                "restore_sharded(layout=...))"
            )
        from adapcc_tpu_torch.elastic.rebalance import _shard_len, _split_rows, _to_canonical_flat

        trees = [own["tree"] if r == rank else load(r)["tree"] for r in range(saved_world)]
        per_shard = [tree_leaves(t) for t in trees]
        old = dict(saved_layout, world=saved_world)
        row_len = _shard_len(int(saved_layout["total"]), saved_world, int(old.get("align", 1)))
        new = dict(want, world=world)
        index = iter(range(len(per_shard[0])))

        def one(t: torch.Tensor) -> torch.Tensor:
            i = next(index)
            if t.dim() != 1 or t.shape[0] != row_len:
                return t
            rows = torch.stack([leaves[i] for leaves in per_shard])
            flat = _to_canonical_flat(rows, old, int(saved_layout["total"]))
            return _split_rows(flat, new)[rank]

        return _place(tree_map(one, trees[0]), target, device)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainCheckpointState, step: Optional[int] = None,
                device: Optional[torch.device] = None) -> bool:
        """Load ``step`` (default: the latest) into ``state``; False when
        there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return False
        return load_checkpoint(state, self._path(step), device)


# --- async crash-consistent step-directory manager ----------------------------

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1
#: the one shard a step holds: the ``torch.save`` bytes of the snapshot
BLOB_NAME = "state.ckpt"

_ASYNC_STEP_RE = re.compile(r"^step-(\d+)$")
_TMP_DIR_RE = re.compile(r"^\.tmp-step-(\d+)-")


class CheckpointCorrupt(ValueError):
    """A published checkpoint failed verification (checksum mismatch, a
    truncated shard, a manifest naming a missing file).  Loud by design:
    restoring a torn artifact silently is what the manifest exists to
    prevent."""


def _host_snapshot(obj: Any) -> Any:
    """``obj`` with every tensor copied to host memory, taken now: a CUDA
    tensor into pinned memory without waiting (the copy is ordered on its
    stream before any later in-place update), a CPU tensor cloned.  Returns
    ``(snapshot, event)``: the event the copies are complete at, or None."""
    event = None

    def copy(t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t.detach(), non_blocking=True)
            return host
        return t.detach().clone()

    def walk(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return copy(x)
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    snap = walk(obj)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        event = torch.cuda.Event()
        event.record()
    return snap, event


class AsyncCheckpointManager:
    """Crash-consistent directory of steps with an async save pipeline and
    content verification (the JAX package's manager, on ``torch.save``).

    One ``step-<n>/`` directory a checkpoint holds the shard
    (:data:`BLOB_NAME`) and a ``MANIFEST.json`` of each shard's size and
    sha256.  A save writes both into ``.tmp-step-<n>-<pid>/`` (each file
    fsync'd), renames that to ``step-<n>/`` and fsyncs the parent, so the one
    legal kind of crash damage is a leftover ``.tmp-*`` directory, which
    every scan ignores.  A published step that fails verification raises
    :class:`CheckpointCorrupt` at restore.

    ``save`` is synchronous; ``save_async`` takes the snapshot on the
    caller's thread (device tensors copied to pinned host memory, ordered
    before the next step's in-place updates) and serializes, checksums and
    publishes on a background thread.  A pipeline error raises at the next
    ``save``, ``save_async``, ``wait`` or ``close``.

    Retention keeps the newest ``max_to_keep`` steps that verify at
    collection time: a newer corrupt directory never evicts the newest good
    step (the corrupt one goes, with a note on stderr)."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.restores = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._spawn_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()

    # -- scan ------------------------------------------------------------------

    def published_steps(self) -> List[int]:
        """Steps with a published (renamed-in) directory, sorted; ``.tmp-*``
        leftovers are ignored."""
        return sorted(int(m.group(1)) for m in map(_ASYNC_STEP_RE.match, os.listdir(self.directory)) if m)

    def torn_saves(self) -> List[str]:
        """Leftover ``.tmp-*`` directories of a crash mid-save: never
        restorable, listed so an operator sees the crash happened."""
        return sorted(name for name in os.listdir(self.directory) if _TMP_DIR_RE.match(name))

    def latest_step(self) -> Optional[int]:
        steps = self.published_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{int(step)}")

    # -- integrity -------------------------------------------------------------

    def _manifest(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self._step_dir(step), MANIFEST_NAME)
        if not os.path.exists(path):
            raise CheckpointCorrupt(
                f"published checkpoint step-{step} has no {MANIFEST_NAME}: the publish protocol writes it before "
                "the rename, so this directory was tampered with — refusing to restore"
            )
        with open(path, encoding="utf-8") as f:
            try:
                manifest = json.load(f)
            except ValueError as e:
                raise CheckpointCorrupt(
                    f"step-{step} {MANIFEST_NAME} is not valid JSON ({e}) — manifest corrupt, refusing to restore"
                ) from e
        if not isinstance(manifest, dict):
            raise CheckpointCorrupt(f"step-{step} {MANIFEST_NAME} holds {type(manifest).__name__}, expected an object")
        if manifest.get("version") != MANIFEST_VERSION:
            raise CheckpointCorrupt(f"step-{step} manifest version {manifest.get('version')!r} != {MANIFEST_VERSION}")
        shards = manifest.get("shards")
        if not isinstance(shards, dict) or not all(
                isinstance(rec, dict) and "bytes" in rec and "sha256" in rec for rec in shards.values()):
            raise CheckpointCorrupt(f"step-{step} manifest shard table is malformed — manifest corrupt, refusing to "
                                    "restore")
        return manifest

    def verify(self, step: int) -> None:
        """Raise :class:`CheckpointCorrupt` unless every shard the manifest
        names exists with the recorded size and sha256."""
        manifest = self._manifest(step)
        d = self._step_dir(step)
        for name, rec in sorted(manifest["shards"].items()):
            path = os.path.join(d, name)
            if not os.path.exists(path):
                raise CheckpointCorrupt(
                    f"step-{step} manifest names shard {name!r} but the file is missing — refusing to restore a "
                    "partial checkpoint"
                )
            with open(path, "rb") as f:
                blob = f.read()
            if len(blob) != int(rec["bytes"]):
                raise CheckpointCorrupt(
                    f"step-{step} shard {name!r} is {len(blob)} bytes, manifest records {rec['bytes']} — truncated "
                    "or torn, refusing to restore"
                )
            digest = hashlib.sha256(blob).hexdigest()
            if digest != rec["sha256"]:
                raise CheckpointCorrupt(
                    f"step-{step} shard {name!r} sha256 {digest[:12]}… != manifest {rec['sha256'][:12]}… — payload "
                    "corrupt, refusing to restore"
                )

    def _verify_quiet(self, step: int) -> bool:
        try:
            self.verify(step)
            return True
        except CheckpointCorrupt:
            return False

    def latest_good_step(self) -> Optional[int]:
        """The newest published step that verifies: what a restart restores
        from when the newest directory is damaged."""
        for step in reversed(self.published_steps()):
            if self._verify_quiet(step):
                return step
        return None

    # -- save pipeline ---------------------------------------------------------

    def _publish(self, step: int, blobs: Dict[str, bytes]) -> None:
        final = self._step_dir(step)
        if os.path.exists(final):
            if self._verify_quiet(step):
                raise ValueError(
                    f"checkpoint step-{step} already published; steps are immutable once committed (save under a "
                    "new step instead)"
                )
            # a resume from latest_good_step() re-runs the steps a newer
            # corrupt directory covers: replacing it is the recovery
            print(f"[adapcc] checkpoint step-{step} exists but fails verification; replacing the corrupt artifact",
                  file=sys.stderr, flush=True)
            shutil.rmtree(final, ignore_errors=True)
        tmp = os.path.join(self.directory, f".tmp-step-{int(step)}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        shards = {}
        for name, blob in sorted(blobs.items()):
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            shards[name] = {"bytes": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}
        with open(os.path.join(tmp, MANIFEST_NAME), "w", encoding="utf-8") as f:
            json.dump({"version": MANIFEST_VERSION, "step": int(step), "shards": shards}, f, indent=2,
                      sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        self._gc(trusted=int(step))

    def _gc(self, trusted: Optional[int] = None) -> None:
        """Keep-last-good retention (class docstring).  Older steps are
        hashed again on every pass on purpose: the corruption it defends
        against happens after publish.  Only ``trusted``, the step this
        call just published from in-memory bytes, skips the re-read."""
        published = self.published_steps()
        good = [s for s in published if s == trusted or self._verify_quiet(s)]
        keep = set(good[-self.max_to_keep:])
        for step in published:
            if step in keep:
                continue
            if step not in good:
                print(f"[adapcc] checkpoint step-{step} failed verification; collecting the corrupt artifact (the "
                      "newest GOOD checkpoint is retained regardless)", file=sys.stderr, flush=True)
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        _fsync_dir(self.directory)

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint pipeline failed on a previous save; the checkpoint it was writing does NOT "
                "exist on disk"
            ) from err

    def save(self, step: int, state: TrainCheckpointState) -> None:
        """Synchronous save: serialize, checksum, publish; durable on return."""
        self.wait()
        self._publish(int(step), {BLOB_NAME: state.to_bytes()})

    def save_async(self, step: int, state: TrainCheckpointState) -> None:
        """Queue one save on the background pipeline and return.  The
        snapshot is taken here, on the caller's thread (module
        :func:`_host_snapshot`): the training loop may update the state in
        place at once."""
        self._raise_pending()
        snapshot, event = _host_snapshot(state.capture_snapshot())
        with self._spawn_lock:
            self._idle.clear()
            self._queue.put((int(step), snapshot, event))
            if self._worker is None:
                self._worker = threading.Thread(target=self._drain, name="adapcc-async-ckpt", daemon=True)
                self._worker.start()

    def _drain(self) -> None:
        while True:
            with self._spawn_lock:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    # the exit decision and save_async's put-and-spawn hold
                    # one lock: an enqueue cannot slip between them
                    self._worker = None
                    self._idle.set()
                    return
            step, snapshot, event = item
            try:
                if event is not None:
                    event.synchronize()
                buf = io.BytesIO()
                torch.save(snapshot, buf)
                self._publish(step, {BLOB_NAME: buf.getvalue()})
            except BaseException as e:  # noqa: BLE001 — raised at the next call
                with self._spawn_lock:
                    self._error = e
                    # later saves would publish out of order around the failure
                    while True:
                        try:
                            self._queue.get_nowait()
                        except queue.Empty:
                            break
                    self._worker = None
                    self._idle.set()
                    return

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every queued save has published (or failed loudly)."""
        if not self._idle.wait(timeout):
            raise TimeoutError(f"async checkpoint pipeline still busy after {timeout}s")
        self._raise_pending()

    # -- restore ---------------------------------------------------------------

    def restore(self, state: TrainCheckpointState, step: Optional[int] = None,
                device: Optional[torch.device] = None) -> bool:
        """Verified restore into ``state``.  ``step=None`` restores the
        newest published step and raises if it is corrupt (fall back
        deliberately with :meth:`latest_good_step`).  False only when no
        checkpoint exists.  Tensors are placed as :meth:`TrainCheckpointState.
        load_bytes` places them."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return False
        elif not os.path.exists(self._step_dir(step)):
            raise FileNotFoundError(f"no published checkpoint step-{step} in {self.directory}")
        self.verify(step)
        with open(os.path.join(self._step_dir(step), BLOB_NAME), "rb") as f:
            state.load_bytes(f.read(), device)
        self.restores += 1
        return True

    def close(self) -> None:
        self.wait()


# --- elastic supervisor -------------------------------------------------------


def run_elastic(
    argv: Sequence[str],
    max_restarts: int = 3,
    restart_delay_s: float = 1.0,
    env: Optional[Dict[str, str]] = None,
    _spawn: Optional[Callable] = None,
) -> int:
    """Supervise a worker command, restarting it on failure up to
    ``max_restarts`` times (``torchrun --max_restarts``).  Each generation
    gets ``ADAPCC_RESTART_GEN`` so rendezvous keys never collide across
    restarts; workers resume through :func:`restore_newest_across_processes`."""
    spawn = _spawn or (lambda cmd, env: subprocess.run(cmd, env=env).returncode)
    for gen in range(max_restarts + 1):
        child_env = {**os.environ, **(env or {}), "ADAPCC_RESTART_GEN": str(gen)}
        rc = spawn(list(argv), child_env)
        if rc == 0:
            return 0
        if gen < max_restarts:
            print(f"=> worker failed (rc={rc}); restart {gen + 1}/{max_restarts}")
            time.sleep(restart_delay_s)
    return rc
