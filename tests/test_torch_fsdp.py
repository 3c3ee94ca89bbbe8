"""The port's per-rank FSDP held against the JAX package's GSPMD FSDP.

- ``fsdp_shardings`` chooses, leaf by leaf, the spec JAX's ``_leaf_spec``
  chooses on the flax tree (GPT-2 and VGG, worlds 2 and 4);
- three ``fsdp_train_step`` steps at world 2 over gloo (rank 0 here, rank 1
  in a spawned worker) against JAX's GSPMD step on a 2-device mesh from the
  same weights (the port's seeded model, handed to JAX as a flax tree),
  under Adam and under SGD with momentum: the losses (the world's mean
  against JAX's one loss of the global batch) within ``LOSS_RTOL``, the
  parameters within the optimizer's ``atol``;
- each rank keeps 1/world of every sharded leaf and the optimizer state of
  exactly its slices.

Tolerances: float32 in both, summation order only.  Adam normalizes each
gradient element, so an element whose gradient nearly cancels can move by a
few percent of lr: parameters within a tenth of lr a step.  Adam's update
does not see the gradient's scale; SGD's is proportional to it, so the SGD
case holds the reduce-scatter's and the all-reduce's averaging: at
``SGD_LR`` a gradient off by the world's factor moves the parameters and the
later losses far past ``SGD_PARAM_ATOL`` and ``LOSS_RTOL``.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.ddp.trainer import adam, sgd
from adapcc_tpu_torch.models.convert import flax_paths, flax_to_state_dict, to_flax_variables
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.models.vgg import VGG11
from adapcc_tpu_torch.parallel.fsdp_rank import _leaf_spec, fsdp_shardings

LR = 1e-4
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 0.1 * LR * STEPS
SGD_LR = 0.1
SGD_PARAM_ATOL = 1e-5
TINY_GPT2 = dict(vocab_size=64, max_seq=16, n_layer=1, n_head=2, d_model=32)
MIN_ELEMS = 256


def _model(name):
    if name == "gpt2":
        return GPT2(GPT2Config(**TINY_GPT2, dtype=torch.float32), device="cpu", seed=0)
    return VGG11(num_classes=10, classifier_width=16, dtype=torch.float32, image_size=32, device="cpu")


def _batch(name, rows=4):
    rng = np.random.default_rng(9)
    if name == "gpt2":
        return rng.integers(0, TINY_GPT2["vocab_size"], size=(rows, TINY_GPT2["max_seq"]))
    return (rng.normal(size=(rows, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, size=(rows,)))


def _torch_loss(name):
    if name == "gpt2":
        return lambda m, b: lm_loss(m(b), b)
    return lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1].long())


def _jax_model_and_loss(name):
    import jax.numpy as jnp
    import optax

    if name == "gpt2":
        from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
        from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
        from adapcc_tpu.models.gpt2 import lm_loss as jax_lm_loss

        jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2, dtype=jnp.float32))
        return lambda p, b: jax_lm_loss(jm.apply(p, b), b)
    from adapcc_tpu.models.vgg import VGG11 as JaxVGG11

    jm = JaxVGG11(num_classes=10, classifier_width=16, dtype=jnp.float32)
    return lambda p, b: optax.softmax_cross_entropy_with_integer_labels(jm.apply(p, b[0]), b[1]).mean()


@pytest.mark.parametrize("name", ["gpt2", "vgg"])
@pytest.mark.parametrize("world", [2, 4])
def test_leaf_specs_match_jax(name, world):
    import jax
    from jax.sharding import Mesh

    from adapcc_tpu.parallel.fsdp import _leaf_spec as jax_leaf_spec
    from adapcc_tpu.parallel.fsdp import fsdp_shardings as jax_fsdp_shardings

    model = _model(name)
    variables = to_flax_variables(model)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ranks",))
    want = {"/".join(str(k.key) for k in path): tuple(sh.spec)
            for path, sh in jax.tree_util.tree_flatten_with_path(
                jax_fsdp_shardings(variables, mesh, min_shard_elems=MIN_ELEMS))[0]}
    paths = flax_paths(model)
    got = {"/".join(("params", *paths[n][0])): spec
           for n, spec in fsdp_shardings(model, world, min_shard_elems=MIN_ELEMS).items()}
    assert got == want
    assert any(got.values()) and not all(got.values())
    for shape in [(), (3,), (512, 3), (6, 512), (3, 3, 16, 64), (7, 9)]:
        assert _leaf_spec(shape, world, MIN_ELEMS) == tuple(jax_leaf_spec(shape, world, MIN_ELEMS, "ranks"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: the optimizer cases: (the port's factory, optax's, the state key of
#: the first moment, the parameters' atol)
OPTIMIZERS = {
    "adam": (adam(LR), lambda optax: optax.adam(LR), "exp_avg", PARAM_ATOL),
    "sgd": (sgd(SGD_LR, momentum=0.9), lambda optax: optax.sgd(SGD_LR, momentum=0.9), "momentum_buffer",
            SGD_PARAM_ATOL),
}


def _fsdp_rank(rank, init_method, name, opt, state_dict):
    """One gloo rank: STEPS FSDP steps of ``opt`` on this rank's half;
    returns the losses, the gathered final parameters and the bytes this
    rank holds."""
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
    from adapcc_tpu_torch.parallel import fsdp_train_step, shard_fsdp

    torch.set_num_threads(1)
    world = build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    try:
        model = _model(name)
        model.load_state_dict(state_dict)
        full = {n: p.numel() for n, p in model.named_parameters()}
        params = shard_fsdp(model, world, min_shard_elems=MIN_ELEMS)
        tx = OPTIMIZERS[opt][0]
        opt_state = tx(params.parameters())
        step = fsdp_train_step(_torch_loss(name), tx, world)
        batch = _batch(name)
        half = slice(rank * 2, (rank + 1) * 2)
        shard = torch.from_numpy(batch[half]) if name == "gpt2" else tuple(torch.from_numpy(a[half]) for a in batch)
        losses = []
        for _ in range(STEPS):
            params, opt_state, loss = step(params, opt_state, shard)
            losses.append(loss.item())
        held = {n: (s.numel(), full[n], params.dims[n] is not None) for n, s in params.shards.items()}
        moments = {n: opt_state.state[s][OPTIMIZERS[opt][2]].numel() for n, s in params.shards.items()}
        model = params.gather()
        return losses, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}, held, moments
    finally:
        destroy_world()


def _jax_fsdp(name, opt, variables):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.parallel.fsdp import fsdp_train_step as jax_fsdp_train_step
    from adapcc_tpu.parallel.fsdp import shard_fsdp as jax_shard_fsdp

    mesh = Mesh(np.array(jax.devices()[:2]), ("ranks",))
    tx = OPTIMIZERS[opt][1](optax)
    params = jax_shard_fsdp(variables, mesh, min_shard_elems=MIN_ELEMS)
    opt_state = tx.init(params)
    step = jax_fsdp_train_step(_jax_model_and_loss(name), tx, mesh, min_shard_elems=MIN_ELEMS, donate=False)
    batch = _batch(name)
    batch = jnp.asarray(batch) if name == "gpt2" else tuple(jnp.asarray(a) for a in batch)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return losses, flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.device_get(params)))


def _check_world2_against_jax(name, opt):
    model = _model(name)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(_fsdp_rank, (1, init_method, name, opt, sd))
        ref_losses, ref_params = _jax_fsdp(name, opt, to_flax_variables(model))
        per_rank = [_fsdp_rank(0, init_method, name, opt, sd), pending.get(timeout=120)]
    for rank, (losses, params, held, moments) in enumerate(per_rank):
        np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL, err_msg=f"rank {rank}")
        assert sorted(params) == sorted(ref_params)
        for k, want in ref_params.items():
            np.testing.assert_allclose(params[k], want.numpy(), atol=OPTIMIZERS[opt][3], err_msg=f"rank {rank} {k}")
        # a sharded leaf's slice holds 1/world of it, and so do its moments
        sharded = {n: (kept, full) for n, (kept, full, is_sharded) in held.items() if is_sharded}
        assert sharded and all(kept * 2 == full for kept, full in sharded.values())
        assert all(moments[n] == held[n][0] for n in held)
        assert sum(k for k, _ in sharded.values()) * 2 == sum(f for _, f in sharded.values())


@pytest.mark.parametrize("name", ["gpt2", "vgg"])
def test_fsdp_train_step_world2_matches_jax_gspmd(name):
    _check_world2_against_jax(name, "adam")


@pytest.mark.parametrize("name", ["gpt2", "vgg"])
def test_fsdp_train_step_world2_sgd_matches_jax_gspmd(name):
    """SGD's update is proportional to the gradient: the averaging's scale."""
    _check_world2_against_jax(name, "sgd")


def test_fsdp_tp_waits_for_its_slice():
    from adapcc_tpu_torch.parallel import fsdp_tp_shardings, fsdp_tp_train_step

    for fn in (fsdp_tp_shardings, fsdp_tp_train_step):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            fn(None, None, None)
