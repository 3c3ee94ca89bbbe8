"""BatchNorm's state in the port held against the JAX package: SyncBN at
world 2 over gloo (rank 0 here, rank 1 in a spawned worker) against JAX's
``shard_map`` over 2 CPU devices with ``axis_name`` set, and
``DDPTrainer`` (its ``model_state``) against JAX's trainer with its
``model_state``.

Tolerances: float32, summation order only: logits and running statistics
within ``F32_RTOL`` of the tensor's largest magnitude, gradients and
trained weights within ``GRAD_RTOL`` (plus ``GRAD_FLOOR`` of the model's
largest gradient), as in ``tests/test_torch_vision_models.py``.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.models import resnet as torch_resnet
from adapcc_tpu_torch.models.convert import flax_paths, flax_to_state_dict, to_flax_layout, to_flax_variables

F32_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-5


def _images(b=4, size=16, seed=0):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


def _labels(b=4, classes=10, seed=1):
    return np.random.default_rng(seed).integers(0, classes, size=(b,))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol:.1e} x {scale:.3e}"


def _init(tmodel):
    return to_flax_variables(tmodel)


def _load(tmodel, variables):
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return tmodel


def _xent(logits, labels):
    return torch.nn.functional.cross_entropy(logits, torch.as_tensor(labels))


def _grads_by_flax_path(tmodel):
    paths = flax_paths(tmodel)
    out = {}
    for name, p in tmodel.named_parameters():
        path, transposed = paths[name]
        out["/".join(path)] = (to_flax_layout(p.grad) if transposed else p.grad).detach().numpy()
    return out


def _assert_grads(got, jgrads, what=""):
    assert sorted(got) == sorted(jgrads)
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in jgrads.values())
    for k, g in jgrads.items():
        err = np.abs(got[k].reshape(g.shape).astype(np.float64) - g).max()
        bound = GRAD_RTOL * np.abs(g).max() + floor
        assert err <= bound, f"{what}grad {k}: max |diff| {err:.3e} > {bound:.3e}"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: a two-stage ResNet (one BasicBlock a stage, the second a strided
#: projection): every kind of BatchNorm site of ResNet-18 at a quarter of
#: its JAX compile time
SYNC_KW = dict(stage_sizes=(1, 1), num_classes=10, width=8, small_inputs=True, norm="batch")


def _syncbn_rank(rank, init_method, variables, x, y):
    """One gloo rank: logits, loss, gradients (averaged over the world) and
    the running statistics after a train-mode forward on this rank's half."""
    import torch.distributed as dist

    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    try:
        tm = _load(torch_resnet.ResNet(dtype=torch.float32, device="cpu", group=dist.group.WORLD, **SYNC_KW),
                   variables).train()
        half = slice(rank * len(x) // 2, (rank + 1) * len(x) // 2)
        logits = tm(torch.from_numpy(x[half]))
        loss = _xent(logits, y[half])
        loss.backward()
        for p in tm.parameters():
            dist.all_reduce(p.grad)
            p.grad /= 2
        return (logits.detach().numpy(), loss.item(), _grads_by_flax_path(tm),
                {k: b.numpy() for k, b in tm.named_buffers()})
    finally:
        destroy_world()


def _syncbn_child(*args):
    torch.set_num_threads(1)
    return _syncbn_rank(*args)


def _jax_syncbn(variables, x, y):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from adapcc_tpu.models.resnet import ResNet

    jm = ResNet(dtype=jnp.float32, axis_name="ranks", **SYNC_KW)
    mesh = Mesh(np.array(jax.devices()[:2]), ("ranks",))

    def per_shard(params, stats, xs, ys):
        def loss(p):
            logits, upd = jm.apply({"params": p, "batch_stats": stats}, xs, train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits, ys).mean(), (logits, upd)

        (val, (logits, upd)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        grads = jax.lax.pmean(grads, "ranks")
        return logits, val[None], grads, upd["batch_stats"]

    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=(P(), P(), P("ranks"), P("ranks")),
                       out_specs=(P("ranks"), P("ranks"), P(), P()), check_vma=False))
    logits, losses, grads, stats = fn(variables["params"], variables["batch_stats"], jnp.asarray(x),
                                      jnp.asarray(y))
    flat = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    stats = flax_to_state_dict({"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
    return np.asarray(logits), np.asarray(losses), flat, {k: v.numpy() for k, v in stats.items()}


def test_syncbn_world2_matches_jax_pmean():
    """SyncBN: each rank normalizes its half with the statistics of the
    whole batch (an AVG all-reduce of the mean and the mean of squares),
    the backward sums the statistics' cotangents over the ranks (the
    transpose of ``pmean``), and the running statistics agree on both ranks
    and with JAX's."""
    x, y = _images(b=8, size=16), _labels(b=8)
    v = _init(torch_resnet.ResNet(dtype=torch.float32, device="cpu", **SYNC_KW))
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(_syncbn_child, (1, init_method, v, x, y))
        ref = _jax_syncbn(v, x, y)
        per_rank = [_syncbn_rank(0, init_method, v, x, y), pending.get(timeout=120)]
    logits_j, losses_j, grads_j, stats_j = ref
    for rank, (logits, loss, grads, stats) in enumerate(per_rank):
        _close(logits, logits_j[rank * 4:(rank + 1) * 4], F32_RTOL, f"rank {rank} logits")
        assert abs(loss - losses_j[rank]) <= 1e-5
        _assert_grads(grads, grads_j, f"rank {rank} ")
        for k, s in stats_j.items():
            _close(stats[k], s, F32_RTOL, f"rank {rank} running stat {k}")


def test_ddp_stateful_loss_step_matches_jax():
    """``DDPTrainer`` on a BatchNorm ResNet: two SGD steps at world 1
    against JAX's trainer with ``stateful_loss=True`` and its
    ``model_state``; the state's ``model_state`` is the model's buffers,
    bound without a flag."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from adapcc_tpu.ddp import DDPTrainer as JaxDDPTrainer
    from adapcc_tpu.models.resnet import ResNet
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
    from adapcc_tpu_torch.ddp.trainer import DDPTrainer, sgd
    from adapcc_tpu_torch.strategy.ir import Strategy

    x, y = _images(size=16), _labels()
    kw = SYNC_KW
    tm = torch_resnet.ResNet(dtype=torch.float32, device="cpu", **kw)
    v = _init(tm)
    jm = ResNet(dtype=jnp.float32, **kw)

    def jax_loss(p, ms, b):
        logits, upd = jm.apply({"params": p, "batch_stats": ms}, b[0], train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, b[1]).mean(), upd["batch_stats"]

    mesh = Mesh(np.array(jax.devices()[:1]), ("ranks",))
    jt = JaxDDPTrainer(jax_loss, optax.sgd(0.1, momentum=0.9), mesh, JaxStrategy.ring(1), stateful_loss=True)
    js = jt.init_state(v["params"], model_state=v["batch_stats"])
    for _ in range(2):
        js, _ = jt.step(js, (jnp.asarray(x), jnp.asarray(y)))
    want = flax_to_state_dict({"params": jax.device_get(js.params), "batch_stats": jax.device_get(js.model_state)})

    world = build_world_mesh(1, device="cpu")
    try:
        loss = lambda m, b: _xent(m(b[0]), b[1])  # noqa: E731
        trainer = DDPTrainer(loss, sgd(0.1, momentum=0.9), world, Strategy.ring(1))
        state = trainer.init_state(tm)
        assert state.model_state["stem_norm.mean"] is tm.stem_norm.mean
        for _ in range(2):
            state, _ = trainer.step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    finally:
        destroy_world()
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        _close(got[k].numpy(), np.asarray(w), GRAD_RTOL, k)
