"""The port's ZeRO-1 ring step held against the JAX package's.

Both sides start from the same weights (a seeded port model, handed to JAX
as a flax tree, as in ``test_torch_ddp.py``) and run two AdamW(3e-4) steps of
the tiny GPT-2 at world 4 on the same numpy tokens: JAX's
``zero1_train_step`` with ``Zero1Optimizer(ring=True)``, its ring kernels
under the Pallas TPU interpreter on the virtual 4-device mesh, and the
port's single-controller ``zero1_train_step`` on the CPU.

- The initial flat master is equal element for element: same leaf order,
  same ``[in, out]`` kernels, same tile-aligned shards, same ring ownership
  (row ``r`` = chunk ``(r + 1) % world``).
- Per-rank losses agree to 1e-6 plus ``assert_allclose``'s default rtol of
  1e-7, as in ``test_torch_ddp.py`` (float32, summation order only; the
  second step's losses differ by up to 1.4e-6, three float32 ulps at 5.5).
  The final master and parameters agree to the Adam-amplified bound that
  ``test_torch_ddp.py`` states: 0.1·lr, and 2·lr per step for the key bias,
  whose true gradient is zero.  The Adam moments agree to 1e-7 (first) and
  1e-9 (second), four and seventy times the largest gap seen.
"""

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.ddp.trainer import adamw
from adapcc_tpu_torch.models.convert import flax_to_state_dict, zero1_state_from_jax
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.parallel.fsdp import (
    Zero1Optimizer,
    _flatten,
    _flatten_meta,
    _unflatten,
    zero1_train_step,
)
from test_torch_ddp import LOSS_ATOL, LR, STEPS, TINY, _assert_params_close, _flax_params, _tokens

WORLD = 4


def _model(state_dict=None):
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=None if state_dict else 0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _jax_zero1(params, tokens):
    """JAX ZeRO-1 on the Pallas ring: the initial master, the layout tag,
    per-step ``[world]`` losses, and the final (master, opt state, params)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from adapcc_tpu.models.gpt2 import lm_loss as jax_lm_loss
    from adapcc_tpu.parallel.fsdp import Zero1Optimizer as JaxZero1Optimizer
    from adapcc_tpu.parallel.fsdp import zero1_train_step as jax_zero1_train_step

    model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32, attention="xla"))
    mesh = Mesh(jax.devices()[:WORLD], ("ranks",))
    opt = JaxZero1Optimizer(optax.adamw(LR), mesh, ring=True, ring_interpret=True)
    master, opt_state = opt.init(params)
    init_master = np.asarray(master)
    step = jax_zero1_train_step(lambda p, b: jax_lm_loss(model.apply(p, b), b), opt, mesh)
    params = jax.device_put(params, NamedSharding(mesh, P()))
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    losses = []
    for _ in range(STEPS):
        params, master, opt_state, loss = step(params, master, opt_state, batch)
        losses.append(np.asarray(loss))
    final = jax.device_get((master, opt_state, params))
    return init_master, opt.layout_metadata(), np.stack(losses, axis=1), final


@pytest.fixture(scope="module")
def runs():
    """The JAX and the port runs from the same weights and tokens."""
    params = _flax_params()
    tokens = _tokens(WORLD)
    jax_run = _jax_zero1(params, tokens)

    model = _model(flax_to_state_dict(params))
    opt = Zero1Optimizer(adamw(LR), WORLD, ring=True)
    master, opt_state = opt.init(model)
    init_master = master.clone()
    step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
    losses = []
    for _ in range(STEPS):
        model, master, opt_state, loss = step(model, master, opt_state, torch.from_numpy(tokens))
        losses.append(loss.numpy())
    port_run = (init_master, opt, np.stack(losses, axis=1), (master, opt_state, model))
    return jax_run, port_run


def _master_params(master, model):
    """The parameters a ``[world, N/world]`` ring master stands for (rows
    rolled back into chunk order), by parameter name."""
    meta = _flatten_meta(model, WORLD, 8 * 128)
    scratch = _model()
    _unflatten(torch.roll(master, 1, dims=0).reshape(-1), meta, scratch)
    return {k: v.detach().numpy() for k, v in scratch.state_dict().items()}


def test_init_master_and_layout_match_jax(runs):
    (j_master, j_layout, _, _), (p_master, opt, _, _) = runs
    assert p_master.shape == j_master.shape == (WORLD, 17408)
    assert np.array_equal(p_master.numpy(), j_master)
    assert opt.layout_metadata() == j_layout


def test_two_ring_steps_match_jax(runs):
    (_, _, j_losses, (j_master, j_opt_state, j_params)), (_, _, p_losses, (p_master, p_opt, model)) = runs
    np.testing.assert_allclose(p_losses, j_losses, atol=LOSS_ATOL)
    assert np.all(p_losses[:, -1] < p_losses[:, 0])
    # the parameters the model holds, and those the master stands for
    params_j = {k: v.numpy() for k, v in flax_to_state_dict(j_params).items()}
    _assert_params_close({k: v.detach().numpy() for k, v in model.state_dict().items()},
                         {k: torch.from_numpy(v) for k, v in params_j.items()})
    master_j, adam_j = zero1_state_from_jax(j_master, j_opt_state)
    _assert_params_close(_master_params(p_master, model),
                         {k: torch.from_numpy(v) for k, v in _master_params(master_j, model).items()})
    # the Adam state of every rank's row, carried across by the converter
    adam_p = p_opt.state[p_opt.param_groups[0]["params"][0]]
    assert float(adam_p["step"]) == float(adam_j["step"]) == STEPS
    np.testing.assert_allclose(adam_p["exp_avg"].numpy(), adam_j["exp_avg"].numpy(), atol=1e-7)
    np.testing.assert_allclose(adam_p["exp_avg_sq"].numpy(), adam_j["exp_avg_sq"].numpy(), atol=1e-9)


def test_flat_layout_is_the_jax_tree_order():
    """Leaf order and shapes of the flat vector against the JAX package's
    ``_flatten_meta`` of the flax tree; flatten and unflatten round-trip."""
    from adapcc_tpu.parallel.fsdp import _flatten_meta as jax_flatten_meta

    model = _model()
    meta = _flatten_meta(model, WORLD, 8 * 128)
    j_meta = jax_flatten_meta(_flax_params(), WORLD, 8 * 128)
    assert [leaf.shape for leaf in meta.leaves] == list(j_meta.shapes)
    assert (meta.total, meta.padded) == (j_meta.total, j_meta.padded)
    flat = _flatten(dict(model.named_parameters()), meta)
    other = _model(flax_to_state_dict(_flax_params(seed=1)))
    _unflatten(flat, meta, other)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), other.state_dict().values()))


def test_zero1_rejects_what_waits():
    # the non-ring path, overlap="bucket" and restore run now
    # (tests/test_torch_overlap.py, tests/test_torch_checkpoint.py); shard
    # replicas live on the trainer and the replica store, as in JAX, and
    # the optimizer takes no such argument
    # (tests/test_torch_zero1_elastic.py)
    with pytest.raises(TypeError, match="shard_replicas"):
        Zero1Optimizer(adamw(LR), WORLD, shard_replicas=1)
    # a tuner-chosen ring chunk runs now (tests/test_torch_tuner.py); without
    # init there is no cell yet
    assert Zero1Optimizer(adamw(LR), WORLD, ring=True, tuner=object()).tuning_key() is None
    # the wire codec runs now; a name the registry lacks raises
    assert Zero1Optimizer(adamw(LR), WORLD, wire_dtype="int8").wire_dtype == "int8"
    with pytest.raises(ValueError, match="unknown wire codec"):
        Zero1Optimizer(adamw(LR), WORLD, wire_dtype="int4")
    opt = Zero1Optimizer(adamw(LR), WORLD, ring=True)
    step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
    with pytest.raises(ValueError, match="does not divide"):
        step(_model(), None, None, torch.zeros(3, TINY["max_seq"], dtype=torch.long))
    # the step runs in the flat layout init made, and only after it
    with pytest.raises(RuntimeError, match="init"):
        step(_model(), None, None, torch.zeros(WORLD, TINY["max_seq"], dtype=torch.long))


def test_wire_dtype_env_compresses_zero1_like_jax(monkeypatch):
    """``ADAPCC_WIRE_DTYPE=int8`` wins over ``Zero1Optimizer``'s default in
    both packages: every rank's contribution takes its int8 wire value
    before the reduce-scatter, and the port's two steps equal the JAX
    package's (the port once trained in float32 under it)."""
    monkeypatch.setenv("ADAPCC_WIRE_DTYPE", "int8")
    params = _flax_params()
    tokens = _tokens(WORLD)
    _, _, j_losses, (j_master, j_opt_state, j_params) = _jax_zero1(params, tokens)

    model = _model(flax_to_state_dict(params))
    opt = Zero1Optimizer(adamw(LR), WORLD, ring=True)
    master, opt_state = opt.init(model)
    step = zero1_train_step(lambda m, b: lm_loss(m(b), b), opt)
    losses = []
    for _ in range(STEPS):
        model, master, opt_state, loss = step(model, master, opt_state, torch.from_numpy(tokens))
        losses.append(loss.numpy())
    np.testing.assert_allclose(np.stack(losses, axis=1), j_losses, atol=LOSS_ATOL)
    params_j = {k: v.numpy() for k, v in flax_to_state_dict(j_params).items()}
    _assert_params_close({k: v.detach().numpy() for k, v in model.state_dict().items()},
                         {k: torch.from_numpy(v) for k, v in params_j.items()})
    master_j, _ = zero1_state_from_jax(j_master, j_opt_state)
    _assert_params_close(_master_params(master, model),
                         {k: torch.from_numpy(v) for k, v in _master_params(master_j, model).items()})
    assert opt.wire_dtype == "int8"
