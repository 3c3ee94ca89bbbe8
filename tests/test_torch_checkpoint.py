"""The port's checkpoints (``adapcc_tpu_torch/checkpoint.py``) and ZeRO-1's
layout-guarded restore.

- A resume is bit for bit the run that never stopped: DDP at world 1, and
  the single-controller ZeRO-1 at world 4 on the ring and off it, each
  saved through :class:`CheckpointManager` after a step and restored into a
  fresh model and optimizer.
- The layout guard has JAX's three outcomes on the same ``extra`` dicts, with
  its messages: a mismatched tag raises, a tagged checkpoint into an
  untagged resume that holds optimizer state raises, a params-only load is
  allowed; ``Zero1Optimizer.validate_checkpoint_extra`` against JAX's.
- ``CheckpointManager`` keeps the newest ``max_to_keep`` steps;
  ``save_checkpoint`` leaves no tmp file and keeps ``model_best``; a load
  lands on the resuming state's devices or raises without one.
"""

import os

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.checkpoint import (
    LAYOUT_GUARD_KEYS,
    CheckpointManager,
    TrainCheckpointState,
    load_checkpoint,
    save_checkpoint,
)
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.parallel.fsdp import Zero1Optimizer, zero1_train_step
from adapcc_tpu_torch.strategy.ir import Strategy
from test_torch_ddp import LR, TINY, _tokens

WORLD = 4
RING = {"ring": True, "align": 1024, "world": WORLD}
PLAIN = {"ring": False, "align": 1, "world": WORLD}


def _model(seed=0):
    return GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=seed)


# --------------------------------------------------------------------------- #
# resume bit for bit
# --------------------------------------------------------------------------- #


def test_ddp_resume_is_bit_for_bit(tmp_path):
    world = build_world_mesh(1, device="cpu")
    try:
        tokens = torch.from_numpy(_tokens(1))

        def trainer():
            return DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world, Strategy.ring(1))

        t = trainer()
        state = TrainState.create(_model(), t.tx)
        straight = [t.step(state, tokens)[1] for _ in range(3)]
        final = state.model.state_dict()

        t = trainer()
        state = TrainState.create(_model(), t.tx)
        first = t.step(state, tokens)[1]
        mgr = CheckpointManager(str(tmp_path / "ddp"))
        mgr.save(1, TrainCheckpointState(state.model.state_dict(), state.optimizer.state_dict(), step=1))

        t = trainer()
        fresh = TrainState.create(_model(seed=1), t.tx)
        ckpt = TrainCheckpointState(fresh.model.state_dict(), fresh.optimizer.state_dict())
        assert mgr.restore(ckpt) and ckpt.step == 1
        fresh.model.load_state_dict(ckpt.params)
        fresh.optimizer.load_state_dict(ckpt.opt_state)
        resumed = [first] + [t.step(fresh, tokens)[1] for _ in range(2)]
    finally:
        destroy_world()
    assert torch.equal(torch.stack(straight), torch.stack(resumed))
    assert all(torch.equal(final[k], v) for k, v in fresh.model.state_dict().items())


@pytest.mark.parametrize("ring", [False, True])
def test_zero1_resume_is_bit_for_bit(tmp_path, ring):
    tokens = torch.from_numpy(_tokens(WORLD, seed=3))

    def run(model, opt, master, opt_state, steps):
        step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
        return [step(model, master, opt_state, tokens)[3] for _ in range(steps)]

    model0, opt0 = _model(), Zero1Optimizer(adamw(LR), WORLD, ring=ring)
    master0, opt_state0 = opt0.init(model0)
    straight = run(model0, opt0, master0, opt_state0, 3)

    model, opt = _model(), Zero1Optimizer(adamw(LR), WORLD, ring=ring)
    master, opt_state = opt.init(model)
    first = run(model, opt, master, opt_state, 1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, TrainCheckpointState(model.state_dict(), (master, opt_state.state_dict()),
                                     extra=opt.checkpoint_extra()))

    model2, opt2 = _model(seed=1), Zero1Optimizer(adamw(LR), WORLD, ring=ring)
    blank, blank_state = opt2.init(model2)
    ckpt = TrainCheckpointState(model2.state_dict(), (blank, blank_state.state_dict()),
                                extra=opt2.checkpoint_extra())
    assert mgr.restore(ckpt)
    model2.load_state_dict(ckpt.params)
    master2, opt_state2 = opt2.restore(ckpt)
    resumed = first + run(model2, opt2, master2, opt_state2, 2)
    assert torch.equal(torch.stack(straight), torch.stack(resumed))
    assert torch.equal(master0, master2)
    assert all(torch.equal(a, b) for a, b in zip(model0.state_dict().values(), model2.state_dict().values()))
    assert opt_state2.state[master2]["exp_avg"].shape == master2.shape
    # the other layout refuses this checkpoint, both at the load and at the
    # optimizer
    other = Zero1Optimizer(adamw(LR), WORLD, ring=not ring)
    with pytest.raises(ValueError, match="layout mismatch"):
        other.restore(ckpt)
    declared = TrainCheckpointState(model2.state_dict(), (blank, blank_state.state_dict()),
                                    extra=other.checkpoint_extra())
    with pytest.raises(ValueError, match="checkpoint layout mismatch on extra"):
        mgr.restore(declared)


# --------------------------------------------------------------------------- #
# the layout guard, against JAX's
# --------------------------------------------------------------------------- #

#: (the resuming state's extra, whether it holds optimizer state, the
#: checkpoint's extra)
GUARD_CASES = [
    ({"zero1_layout": PLAIN}, True, {"zero1_layout": RING}),   # mismatched tag
    ({"zero1_layout": RING}, True, {"zero1_layout": RING}),    # the same tag
    ({}, True, {"zero1_layout": RING}),                        # tagged into an untagged resume
    ({}, False, {"zero1_layout": RING}),                       # a params-only load
    ({"zero1_layout": RING}, True, {}),                        # an untagged checkpoint
    ({"zero1_layout": RING}, False, {"other": 1}),
    ({}, True, {}),
]


def _guard_outcome(state, snapshot):
    try:
        state.apply_snapshot(snapshot)
        return ("ok", state.step, dict(state.extra))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("resuming, holds_opt, saved", GUARD_CASES)
def test_layout_guard_outcomes_match_jax(resuming, holds_opt, saved):
    from adapcc_tpu.checkpoint import LAYOUT_GUARD_KEYS as JAX_KEYS
    from adapcc_tpu.checkpoint import TrainCheckpointState as JaxState

    assert LAYOUT_GUARD_KEYS == JAX_KEYS
    snap = {"epoch": 2, "step": 7, "best_metric": 0.5, "params": {"w": torch.ones(3)},
            "opt_state": {"m": torch.zeros(3)}, "extra": saved}
    port = TrainCheckpointState({"w": torch.zeros(3)}, {"m": torch.ones(3)} if holds_opt else None,
                                extra=dict(resuming))
    ref = JaxState({"w": np.zeros(3)}, {"m": np.ones(3)} if holds_opt else None, extra=dict(resuming))
    got = _guard_outcome(port, snap)
    assert got == _guard_outcome(ref, {**snap, "params": {"w": np.ones(3)}, "opt_state": {"m": np.zeros(3)}})
    # the file round trip takes the same funnel
    blob = TrainCheckpointState(snap["params"], snap["opt_state"], 2, 7, 0.5, saved).to_bytes()
    port = TrainCheckpointState({"w": torch.zeros(3)}, {"m": torch.ones(3)} if holds_opt else None,
                                extra=dict(resuming))
    try:
        port.load_bytes(blob)
        again = ("ok", port.step, dict(port.extra))
        assert torch.equal(port.params["w"], torch.ones(3))
    except ValueError as e:
        again = ("ValueError", str(e))
    assert again == got


@pytest.mark.parametrize("extra", [None, {}, {"zero1_layout": RING}, {"zero1_layout": PLAIN},
                                   {"zero1_layout": {**PLAIN, "world": 2}}])
@pytest.mark.parametrize("ring", [False, True])
def test_zero1_validate_checkpoint_extra_matches_jax(extra, ring):
    import jax
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JaxZero1Optimizer

    def outcome(opt):
        try:
            opt.validate_checkpoint_extra(extra)
            return "ok"
        except ValueError as e:
            return str(e)

    port = Zero1Optimizer(adamw(LR), WORLD, ring=ring)
    ref = JaxZero1Optimizer(optax.sgd(0.1), Mesh(jax.devices()[:WORLD], ("ranks",)), ring=ring)
    assert outcome(port) == outcome(ref)


# --------------------------------------------------------------------------- #
# files, retention and devices
# --------------------------------------------------------------------------- #


def test_checkpoint_manager_keeps_the_newest_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    assert not mgr.restore(TrainCheckpointState({"w": torch.zeros(1)}))
    for step in (1, 2, 5, 3):
        mgr.save(step, TrainCheckpointState({"w": torch.full((2,), float(step))}, step=step))
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5
    state = TrainCheckpointState({"w": torch.zeros(2)})
    assert mgr.restore(state) and state.step == 5 and torch.equal(state.params["w"], torch.full((2,), 5.0))
    assert mgr.restore(state, step=3) and state.step == 3
    assert not mgr.restore(state, step=1)  # retired
    assert sorted(os.listdir(tmp_path)) == ["3", "5"]
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path), max_to_keep=0)


def test_save_checkpoint_is_atomic_and_keeps_the_best(tmp_path):
    path = str(tmp_path / "run" / "ckpt")
    state = TrainCheckpointState({"w": torch.arange(4.0)}, epoch=3, best_metric=0.25)
    save_checkpoint(state, path, is_best=True)
    save_checkpoint(state, path)
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpt", "model_best.ckpt"]  # no tmp file left
    for name in ("ckpt", "model_best.ckpt"):
        loaded = TrainCheckpointState({"w": torch.zeros(4)})
        assert load_checkpoint(loaded, str(tmp_path / "run" / name))
        assert (loaded.epoch, loaded.best_metric) == (3, 0.25) and torch.equal(loaded.params["w"], torch.arange(4.0))
    assert not load_checkpoint(loaded, str(tmp_path / "missing"))


def test_load_places_tensors_on_the_resuming_state_and_never_guesses(tmp_path):
    """Each tensor goes where the resuming state holds it (the optimizer's
    step, as torch keeps it, stays where the template's is); a state without
    a tensor needs ``device=``."""
    model = _model()
    opt = adamw(LR)(model.parameters())
    lm_loss(model(torch.from_numpy(_tokens(1))), torch.from_numpy(_tokens(1))).backward()
    opt.step()
    blob = TrainCheckpointState(model.state_dict(), opt.state_dict()).to_bytes()
    like = TrainCheckpointState(model.state_dict(), opt.state_dict())
    like.load_bytes(blob)
    assert like.opt_state["state"][0]["step"].device == opt.state_dict()["state"][0]["step"].device
    empty = TrainCheckpointState(None)
    with pytest.raises(ValueError, match="device="):
        empty.load_bytes(blob)
    empty.load_bytes(blob, device=torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(empty.params.values(), model.state_dict().values()))
