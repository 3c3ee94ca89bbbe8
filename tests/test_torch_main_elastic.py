"""``main_elastic`` in the port: the supervised worker crashes after
checkpointing epoch 1, restarts, resumes at epoch 2 and ends where an
uninterrupted run ends.

ResNet-18 with SyncBN (``--norm batch``) on the CPU at a small batch: the
restarted worker restores the weights, the optimizer's momentum and the
BatchNorm running statistics (``extra["model_state"]``), so its final
checkpoint equals the uninterrupted run's bit for bit (one process, the
same operations in the same order).  The workers are child processes of
``run_elastic``, as on a real launch.
"""

import subprocess
import sys

import pytest
import torch

from adapcc_tpu_torch.checkpoint import TrainCheckpointState
from adapcc_tpu_torch.comm.mesh import destroy_world

ARGV = ["--device", "cpu", "--model", "resnet18", "--norm", "batch", "--deterministic", "--epochs", "3", "--steps-per-epoch", "1",
        "--batch", "4"]


@pytest.fixture(autouse=True)
def _leave_no_world():
    """A workload joins a process group (a world of one here) and keeps it,
    as JAX's keeps its mesh; leave none behind for the next test in this
    process."""
    yield
    destroy_world()


def _run(tmp_path, tag, crash):
    ckpt = tmp_path / tag / "checkpoint.ckpt"
    argv = [sys.executable, "-m", "adapcc_tpu_torch.workloads.main_elastic", "--supervise", *ARGV,
            "--checkpoint-file", str(ckpt)] + (["--crash-at-epoch", "1"] if crash else [])
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    state = TrainCheckpointState(params=None)
    state.apply_snapshot(torch.load(ckpt, map_location="cpu", weights_only=True))
    return proc.stdout, state


def test_main_elastic_crash_resume_carries_syncbn_state(tmp_path):
    out, crashed = _run(tmp_path, "crash", crash=True)
    assert "=> injected fault at epoch 1" in out and "=> worker failed (rc=17); restart 1/3" in out
    assert "=> resuming from epoch 2" in out
    _, straight = _run(tmp_path, "straight", crash=False)
    assert crashed.epoch == straight.epoch == 2 and crashed.step == straight.step == 3
    stats = crashed.extra["model_state"]
    assert sorted(stats) == sorted(straight.extra["model_state"]) and any(k.endswith(".mean") for k in stats)
    for k, v in stats.items():
        assert torch.equal(v, straight.extra["model_state"][k]), k
    for k, v in crashed.params.items():
        assert torch.equal(v, straight.params[k]), k


def test_main_elastic_refuses_a_checkpoint_of_another_norm(tmp_path):
    from adapcc_tpu_torch.workloads import main_elastic

    ckpt = str(tmp_path / "c.ckpt")
    base = ["--device", "cpu", "--model", "resnet18", "--epochs", "1", "--steps-per-epoch", "1", "--batch", "2",
            "--checkpoint-file", ckpt]
    assert main_elastic.main(base + ["--norm", "group"]) == 0
    destroy_world()
    assert main_elastic.main(base + ["--norm", "batch", "--epochs", "2"]) == 2
