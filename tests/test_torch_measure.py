"""The port's measurement harnesses and input pipeline held against the JAX
package's: the gradient-noise-scale norms and estimator, the trainer's GNS
at world 2 (gloo: rank 0 here, rank 1 in a spawned worker) against JAX's
2-device mesh, the throughput meter, the training meters and log scraper,
and the prefetching batch pipeline.

Tolerances: the squared norms are float32 sums in another order, within
``NORM_RTOL``; the estimator's arithmetic is float64 on both sides, exact
up to ``1e-12``.  The world-2 trainer runs 3 Adam steps of an MLP from the
same weights: its per-step norms within ``NORM_RTOL`` (Adam magnifies a
float32 rounding only where a gradient element nearly cancels).
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.data import batch_indices, device_batches, prefetch_to_device
from adapcc_tpu_torch.measure import (
    GNSEstimator,
    ThroughputMeter,
    ddp_grad_sq_norms,
    gns_from_norms,
    stacked_grad_sq_norms,
    tree_sq_norm,
)
from adapcc_tpu_torch.utils import AverageMeter, ProgressMeter, parse_training_log

NORM_RTOL = 1e-5
GNS_STEPS = 3


def _arrays(seed=0, shapes=((3, 4), (5,), (2, 2, 2))):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_tree_sq_norm_matches_jax():
    import jax.numpy as jnp

    from adapcc_tpu.measure.gns import tree_sq_norm as jax_tree_sq_norm

    arrays = _arrays()
    want = float(jax_tree_sq_norm([jnp.asarray(a) for a in arrays]))
    got = float(tree_sq_norm([torch.from_numpy(a) for a in arrays]))
    assert abs(got - want) <= NORM_RTOL * want


def test_stacked_norms_match_jax_pmean_under_shard_map():
    """``stacked_grad_sq_norms`` on ``[world, ...]`` gradients equals JAX's
    ``ddp_grad_sq_norms`` inside ``shard_map`` over 4 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from adapcc_tpu.measure.gns import ddp_grad_sq_norms as jax_norms

    world = 4
    stacked = [a for a in _arrays(1, ((world, 3, 4), (world, 7)))]
    mesh = Mesh(np.array(jax.devices()[:world]), ("ranks",))

    def per_shard(a, b):
        local = [a[0], b[0]]
        mean = [jax.lax.pmean(x, "ranks") for x in local]
        small, big = jax_norms(local, mean, "ranks")
        return jnp.stack([small, big])

    want = np.asarray(jax.shard_map(per_shard, mesh=mesh, in_specs=(P("ranks"), P("ranks")), out_specs=P(),
                                    check_vma=False)(*[jnp.asarray(s) for s in stacked]))
    small, big = stacked_grad_sq_norms([torch.from_numpy(s) for s in stacked])
    np.testing.assert_allclose([float(small), float(big)], want, rtol=NORM_RTOL)


@pytest.mark.parametrize("b_small,b_big,ema", [(4, 8, 0.9), (2, 16, 0.5)])
def test_gns_estimator_sequence_matches_jax(b_small, b_big, ema):
    from adapcc_tpu.measure.gns import GNSEstimator as JaxGNS
    from adapcc_tpu.measure.gns import gns_from_norms as jax_gns_from_norms

    rng = np.random.default_rng(3)
    pairs = [(float(s), float(s) * float(f)) for s, f in zip(rng.uniform(1, 2, 8), rng.uniform(0.2, 0.9, 8))]
    port, ref = GNSEstimator(b_small, b_big, ema), JaxGNS(b_small, b_big, ema)
    for small, big in pairs:
        assert gns_from_norms(small, big, b_small, b_big) == pytest.approx(
            jax_gns_from_norms(small, big, b_small, b_big), rel=1e-12)
        got, want = port.update(small, big), ref.update(small, big)
        assert (got is None) == (want is None)
        if want is not None:
            assert got == pytest.approx(want, rel=1e-12)
    with pytest.raises(ValueError, match="need b_big > b_small"):
        gns_from_norms(1.0, 1.0, 4, 4)


def test_measure_gns_refused_on_a_world_of_one():
    from adapcc_tpu_torch.comm.mesh import World
    from adapcc_tpu_torch.ddp.trainer import DDPTrainer, adam
    from adapcc_tpu_torch.strategy.ir import Strategy

    with pytest.raises(ValueError, match="measure_gns needs a multi-device mesh: the estimator contrasts "
                                         r"per-rank \(small-batch\) vs allreduced \(big-batch\) gradients"):
        DDPTrainer(lambda m, b: m(b).sum(), adam(1e-3), World(0, 1, torch.device("cpu")), Strategy.ring(1),
                   measure_gns=True)


# --- DDPTrainer(measure_gns=True) at world 2 ------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gns_data():
    rng = np.random.default_rng(5)
    return rng.normal(size=(8, 6)).astype(np.float32), rng.integers(0, 4, size=(8,))


def _gns_rank(rank, init_method, state_dict):
    """One gloo rank: GNS_STEPS Adam steps of the MLP on this rank's half;
    returns each step's (E|G_b|², |G_B|²) and the estimator's (|G|², S)."""
    import torch.nn.functional as F

    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
    from adapcc_tpu_torch.ddp.trainer import DDPTrainer, adam
    from adapcc_tpu_torch.models.mlp import MLP
    from adapcc_tpu_torch.strategy.ir import Strategy

    torch.set_num_threads(1)
    world = build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    try:
        model = MLP(6, (8, 4), device="cpu", seed=None)
        model.load_state_dict(state_dict)
        trainer = DDPTrainer(lambda m, b: F.cross_entropy(m(b[0]), b[1].long()), adam(1e-2), world,
                             Strategy.ring(2), measure_gns=True)
        state = trainer.init_state(model)
        x, y = _gns_data()
        shard = (torch.from_numpy(x[rank * 4:(rank + 1) * 4]), torch.from_numpy(y[rank * 4:(rank + 1) * 4]))
        for _ in range(GNS_STEPS):
            state, _ = trainer.step(state, shard)
        pending = [p.tolist() for p in trainer._gns_pending]
        est = trainer.gns
        return pending, (est._g2, est._s, est.b_small, est.b_big)
    finally:
        destroy_world()


def _jax_gns(variables):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from adapcc_tpu.ddp import DDPTrainer as JaxDDPTrainer
    from adapcc_tpu.ddp import TrainState as JaxTrainState
    from adapcc_tpu.models.mlp import MLP as JaxMLP
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    model = JaxMLP(features=(8, 4))
    mesh = Mesh(np.array(jax.devices()[:2]), ("ranks",))

    def loss_fn(p, b):
        return optax.softmax_cross_entropy_with_integer_labels(model.apply(p, b[0]), b[1]).mean()

    trainer = JaxDDPTrainer(loss_fn, optax.adam(1e-2), mesh, JaxStrategy.ring(2), measure_gns=True)
    state = jax.device_put(JaxTrainState.create(variables, trainer.tx), NamedSharding(mesh, P()))
    x, y = _gns_data()
    batch = jax.device_put((jnp.asarray(x), jnp.asarray(y)), NamedSharding(mesh, P("ranks")))
    for _ in range(GNS_STEPS):
        state, _ = trainer.step(state, batch)
    pending = [np.asarray(p).tolist() for p in trainer._gns_pending]
    est = trainer.gns
    return pending, (est._g2, est._s, est.b_small, est.b_big)


def test_ddp_measure_gns_world2_matches_jax():
    from adapcc_tpu_torch.models.convert import to_flax_variables
    from adapcc_tpu_torch.models.mlp import MLP

    model = MLP(6, (8, 4), device="cpu", seed=0)
    sd = model.state_dict()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(_gns_rank, (1, init_method, sd))
        ref_pending, ref_est = _jax_gns(to_flax_variables(model))
        per_rank = [_gns_rank(0, init_method, sd), pending.get(timeout=120)]
    assert len(ref_pending) == GNS_STEPS
    for got_pending, got_est in per_rank:
        np.testing.assert_allclose(got_pending, ref_pending, rtol=NORM_RTOL)
        assert got_est[2:] == ref_est[2:]
        np.testing.assert_allclose(got_est[:2], ref_est[:2], rtol=1e-4)


# --- throughput, meters, log scraper ------------------------------------------------------


def test_throughput_meter_summary_and_csv_match_jax(tmp_path):
    from adapcc_tpu.measure.throughput import ThroughputMeter as JaxMeter

    times = [0.5, 0.1, 0.2, 0.3, 0.25]
    port, ref = ThroughputMeter(32, warmup_steps=1), JaxMeter(32, warmup_steps=1)
    port.step_times, ref.step_times = list(times), list(times)
    assert port.summary() == ref.summary()
    port.write_csv(tmp_path / "t.csv")
    ref.write_csv(tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert ThroughputMeter(8).summary() == JaxMeter(8).summary()
    # run(): one time a step, the step's outputs waited for
    meter = ThroughputMeter(4, warmup_steps=0)
    out = meter.run(lambda i: torch.ones(3) * i, 3)
    assert out["steps"] == 3.0 and len(meter.step_times) == 3


def test_meters_and_log_scraper_match_jax(tmp_path, capsys):
    from adapcc_tpu.utils import AverageMeter as JaxAvg
    from adapcc_tpu.utils import ProgressMeter as JaxProgress
    from adapcc_tpu.utils import parse_training_log as jax_parse

    a, b = AverageMeter("loss", ":.4f"), JaxAvg("loss", ":.4f")
    for v, n in ((1.5, 2), (0.25, 3)):
        a.update(v, n)
        b.update(v, n)
    assert str(a) == str(b) and a.avg == b.avg
    assert ProgressMeter(50, [a], prefix="epoch 0 ").display(7) == JaxProgress(50, [b], prefix="epoch 0 ").display(7)
    log = tmp_path / "train.log"
    log.write_text("step 3 loss 1.25\nnoise\nstep: 4  loss: 2e-3 extra\nepoch 1 loss 9\n")
    assert parse_training_log(str(log)) == jax_parse(str(log))
    assert parse_training_log(str(log), pattern=r"epoch (\d+) loss (\d+)") == [(1, 9.0)]


# --- the input pipeline -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_batch_indices_match_jax(seed):
    from adapcc_tpu.data import batch_indices as jax_batch_indices

    for drop_last in (True, False):
        got = [b.tolist() for b in batch_indices(23, 5, seed, drop_last)]
        want = [b.tolist() for b in jax_batch_indices(23, 5, seed, drop_last)]
        assert got == want


def test_device_batches_order_matches_jax_and_shards_by_rank():
    from adapcc_tpu.data import device_batches as jax_device_batches

    from adapcc_tpu_torch.comm.mesh import World

    packed = np.arange(60, dtype=np.int32).reshape(20, 3)
    want = [np.asarray(b) for b in jax_device_batches(packed, 4, seed=3)]
    got = [b.numpy() for b in device_batches(packed, 4, seed=3, device="cpu")]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # per rank: rank r's rows of each global batch, JAX's P("ranks") layout
    shards = [[b.numpy() for b in device_batches(packed, 4, world=World(r, 2, torch.device("cpu")), seed=3)]
              for r in range(2)]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(np.concatenate([shards[0][i], shards[1][i]]), w)
    with pytest.raises(ValueError, match="not divisible"):
        device_batches(packed, 3, world=World(0, 2, torch.device("cpu")))


def test_prefetch_surfaces_a_producer_error_and_keeps_tuples():
    def items():
        yield (np.zeros(2, np.float32), np.ones(1, np.int64))
        raise KeyError("producer broke")

    it = prefetch_to_device(items(), size=1, device="cpu")
    x, y = next(it)
    assert isinstance(x, torch.Tensor) and x.shape == (2,) and y.dtype == torch.int64
    with pytest.raises(RuntimeError, match="prefetch producer failed") as info:
        next(it)
    assert isinstance(info.value.__cause__, KeyError)
    with pytest.raises(ValueError, match="prefetch size must be >= 1"):
        next(prefetch_to_device(iter([]), size=0, device="cpu"))


def test_ddp_grad_sq_norms_world1_is_the_local_norm():
    g = [torch.from_numpy(a) for a in _arrays(2)]
    small, big = ddp_grad_sq_norms(g, g)
    assert float(small) == float(big) == float(tree_sq_norm(g))


def test_launch_env_contract(monkeypatch):
    from adapcc_tpu_torch import launch

    monkeypatch.delenv("ADAPCC_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("ADAPCC_PLATFORM", "cpu")
    assert launch.apply_platform_env() == "cpu"
    assert launch.maybe_initialize_distributed() is False
    monkeypatch.setenv("ADAPCC_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="ADAPCC_PLATFORM"):
        launch.apply_platform_env()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        launch.build_launch_plan()
