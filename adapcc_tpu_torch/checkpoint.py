"""Checkpoint and resume: the parts of :mod:`adapcc_tpu.checkpoint` a
training loop uses, on ``torch.save`` / ``torch.load``.

The reference's story (its elastic imagenet workload) is a mutable
``State`` with ``capture_snapshot`` / ``apply_snapshot`` and an atomic save
through a tmp file and a rename.  The port keeps the JAX package's shape of
it: :class:`TrainCheckpointState` (the layout guard on every load),
:func:`save_checkpoint` / :func:`load_checkpoint` (one crash-durable file)
and :class:`CheckpointManager` (a directory of steps with retention).  The
format is the port's own, a ``torch.save`` of the snapshot dict; it does not
read the JAX package's flax msgpack or orbax trees.

``params`` is the model's ``state_dict()``; ``opt_state`` the optimizer's
``state_dict()``, or ``(master, optimizer state_dict)`` for ZeRO-1
(:meth:`~adapcc_tpu_torch.parallel.fsdp.Zero1Optimizer.restore`).  A load
puts every tensor on the device of the state being resumed: where the
resuming state holds a tensor at the same place, on that tensor's device,
elsewhere on the device of its first tensor; a resuming state without any
tensor needs ``device=``.  It never lands on the CPU by default.
"""

from __future__ import annotations

import io
import os
import re
import shutil
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

#: ``extra`` keys that describe the *layout* of the stored tensors: when the
#: in-memory state declares one (``Zero1Optimizer.checkpoint_extra``'s
#: "zero1_layout"), a loaded snapshot must match it exactly
LAYOUT_GUARD_KEYS = ("zero1_layout",)


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


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
    _fsync_path(checkpoint_dir)
    if is_best:
        best = os.path.join(checkpoint_dir, "model_best.ckpt")
        best_tmp = f"{best}.tmp.{os.getpid()}"
        shutil.copyfile(filename, best_tmp)
        _fsync_path(best_tmp)
        os.rename(best_tmp, best)
        _fsync_path(checkpoint_dir)


def load_checkpoint(state: TrainCheckpointState, filename: str, device: Optional[torch.device] = None) -> bool:
    """Load ``filename`` into ``state`` if it exists; returns whether it did."""
    if not os.path.isfile(filename):
        return False
    with open(filename, "rb") as f:
        state.load_bytes(f.read(), device)
    return True


# --- a directory of steps -----------------------------------------------------

_STEP_DIR_RE = re.compile(r"^(\d+)$")
_STATE_FILE = "state.ckpt"


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
        """The saved steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR_RE.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, _STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, state: TrainCheckpointState) -> None:
        save_checkpoint(state, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

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
