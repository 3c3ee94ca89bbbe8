"""The port's DDPTrainer held against the JAX package's.

Both trainers start from the same weights (a seeded port model, handed to
JAX as a flax tree) and
run two AdamW(3e-4) steps on the same numpy tokens:

- world 1 in this process (gloo), flash attention;
- world 2 over gloo (rank 0 here, rank 1 in a spawned worker), xla attention, once with the
  full world and once with ``active_mask=[True, False]`` (rank 1's gradient
  is dropped and the average runs over the one active rank).

Per-rank losses agree to 1e-6 (float32, summation order only).  Parameters
agree to 3e-5, a tenth of one step's learning rate: Adam normalizes every
gradient element, so where an element's two gradients nearly cancel, a 1e-6
relative difference in the gradients moves its update by a few percent of
lr.  The key bias is the exception: softmax is shift-invariant along each
row, so its true gradient is zero and both frameworks feed Adam only rounding
noise, which Adam scales up to steps of ±lr; it is held to 2·lr per step.
The workers import only torch: this module imports JAX inside the functions
that build the reference.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import engine
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.ddp.hook import GradSyncHook
from adapcc_tpu_torch.ddp.trainer import DDPTrainer, TrainState, adamw
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss
from adapcc_tpu_torch.primitives import ReduceOp
from adapcc_tpu_torch.strategy.ir import Strategy

TINY = dict(vocab_size=256, max_seq=32, n_layer=1, n_head=2, d_model=64)
PER_RANK_BATCH = 2
STEPS = 2
LR = 3e-4
LOSS_ATOL = 1e-6
PARAM_ATOL = 0.1 * LR
KEY_BIAS_ATOL = 2 * LR * STEPS


def _tokens(world, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY["vocab_size"], size=(world * PER_RANK_BATCH, TINY["max_seq"]))


def _flax_params(seed=0):
    """The flax tree of a seeded port model (the inverse of
    ``flax_to_state_dict``; a flax init would cost a JAX compile)."""
    tree = {}
    for key, t in GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=seed).state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        arr = t.numpy()
        if leaf == "bias":
            node["bias"] = arr
        elif path[-1] in ("wte", "wpe"):
            node["embedding"] = arr
        elif path[-1].startswith("ln"):
            node["scale"] = arr
        else:
            node["kernel"] = arr.T
    return {"params": tree}


def _jax_runs(params, tokens, world, attention, masks=(None,)):
    """Per mask: per-step ``[world]`` losses and the final params of the JAX
    trainer.  With masks, one dynamic-mask trainer (one compiled step) runs
    them all; an all-True mask is the full world, the same arithmetic as the
    static step (psum / world)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.ddp import DDPTrainer as JaxDDPTrainer
    from adapcc_tpu.ddp import TrainState as JaxTrainState
    from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from adapcc_tpu.models.gpt2 import lm_loss as jax_lm_loss
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32, attention=attention, flash_block=32))
    mesh = Mesh(jax.devices()[:world], ("ranks",))
    dynamic = any(m is not None for m in masks)
    trainer = JaxDDPTrainer(
        lambda p, b: jax_lm_loss(model.apply(p, b), b), optax.adamw(LR), mesh,
        JaxStrategy.ring(world), dynamic_mask=dynamic,
    )
    # state and batch placed as the step's outputs are, so the second step
    # reuses the first step's compiled program
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    runs = []
    for mask in masks:
        state = jax.device_put(JaxTrainState.create(params, trainer.tx), NamedSharding(mesh, P()))
        kw = {"active_mask": jnp.asarray([True] * world if mask is None else mask)} if dynamic else {}
        losses = []
        for _ in range(STEPS):
            state, loss = trainer.step(state, batch, **kw)
            losses.append(np.asarray(loss))
        runs.append((np.stack(losses, axis=1), flax_to_state_dict(jax.device_get(state.params))))
    return runs


def _torch_run(state_dict, shard, world_mesh, attention, mask=None):
    """Per-step losses of this rank and its final state dict."""
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention=attention, flash_block=32),
                 device="cpu", seed=None)
    model.load_state_dict(state_dict)
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world_mesh,
                         Strategy.ring(world_mesh.world_size), dynamic_mask=mask is not None)
    state = TrainState.create(model, trainer.tx)
    batch = torch.from_numpy(shard)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.step(state, batch, active_mask=None if mask is None else torch.tensor(mask))
        losses.append(loss.item())
    return np.array(losses), {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_params_close(got, want):
    assert got.keys() == want.keys()
    d = TINY["d_model"]
    for name in want:
        g, w = got[name], want[name].numpy()
        if name.endswith("attn.qkv.bias"):  # [q | k | v] biases
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d], atol=KEY_BIAS_ATOL, err_msg=name)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, err_msg=name)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world2_rank(rank, init_method, state_dict, tokens, masks):
    """One gloo rank of the world-2 runs: a result per mask (None = static)."""
    world = build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    try:
        shard = tokens[rank * PER_RANK_BATCH:(rank + 1) * PER_RANK_BATCH]
        return [_torch_run(state_dict, shard, world, "xla", mask) for mask in masks]
    finally:
        destroy_world()


def _world2_child(*args):
    torch.set_num_threads(1)
    return _world2_rank(*args)


@pytest.fixture(scope="module")
def flax_params():
    params = _flax_params()
    sd = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=0).state_dict()
    assert all(torch.equal(flax_to_state_dict(params)[k], v) for k, v in sd.items())
    return params


@pytest.fixture
def world1():
    world = build_world_mesh(1, device="cpu")
    yield world
    destroy_world()


def test_ddp_world1_flash_matches_jax(flax_params, world1):
    tokens = _tokens(1)
    [(losses_j, params_j)] = _jax_runs(flax_params, tokens, 1, "flash")
    losses_t, params_t = _torch_run(flax_to_state_dict(flax_params), tokens, world1, "flash")
    np.testing.assert_allclose(losses_t, losses_j[0], atol=LOSS_ATOL)
    _assert_params_close(params_t, params_j)


def test_ddp_world2_gloo_matches_jax_with_and_without_mask(flax_params):
    tokens = _tokens(2)
    masks = [None, [True, False]]
    sd = flax_to_state_dict(flax_params)
    ctx = multiprocessing.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    # rank 1 in a spawned worker, rank 0 in this process (torch is already
    # imported here); the JAX references build while the worker starts
    with ctx.Pool(1) as pool:
        pending = pool.apply_async(_world2_child, (1, init_method, sd, tokens, masks))
        refs = _jax_runs(flax_params, tokens, 2, "xla", masks)
        per_rank = [_world2_rank(0, init_method, sd, tokens, masks), pending.get(timeout=120)]
    for i, (mask, (losses_j, params_j)) in enumerate(zip(masks, refs)):
        for rank in range(2):
            losses_t, params_t = per_rank[rank][i]
            np.testing.assert_allclose(losses_t, losses_j[rank], atol=LOSS_ATOL, err_msg=f"rank {rank} mask {mask}")
            _assert_params_close(params_t, params_j)


def test_masked_psum_averages_over_active_ranks(world1):
    x = torch.tensor([2.0, 4.0])
    assert torch.equal(engine.masked_psum_shard(x.clone(), [True], ReduceOp.AVG), x)
    # an inactive rank contributes the identity: zero for SUM, -inf for MAX
    assert torch.equal(engine.masked_psum_shard(x.clone(), [False], ReduceOp.SUM), torch.zeros(2))
    assert torch.all(engine.masked_psum_shard(x.clone(), [False], ReduceOp.MAX) == float("-inf"))
    with pytest.raises(ValueError, match="active mask"):
        engine.masked_psum_shard(x, [True, True])


def test_hook_resolves_psum_and_rejects_what_waits():
    one_host = Strategy.ring(2, ips={0: "a", 1: "a"})
    two_hosts = Strategy.ring(2, ips={0: "a", 1: "b"})
    assert GradSyncHook(one_host)._resolved_mode() == "psum"
    assert GradSyncHook(two_hosts)._resolved_mode() == "schedule"
    assert GradSyncHook(one_host, use_xla_fastpath=False)._resolved_mode() == "schedule"
    assert torch.equal(GradSyncHook(one_host).negotiate(0), torch.ones(2, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="schedule"):
        GradSyncHook(two_hosts).sync([torch.zeros(1)], None)
    with pytest.raises(NotImplementedError, match="quantized-wire"):
        GradSyncHook(one_host, compress="bf16")
    with pytest.raises(NotImplementedError, match="later slice"):
        Strategy(Strategy.ring(2).trees, 2, wire_dtype="int8")


def test_strategy_copy_matches_jax():
    """The port's copy of Strategy.ring and of the hook's data-plane choice
    against the reference's."""
    from adapcc_tpu.ddp.hook import GradSyncHook as JaxGradSyncHook
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy

    for ips in ({r: "a" for r in range(4)}, {0: "a", 1: "a", 2: "b", 3: "b"}, None):
        port, ref = Strategy.ring(4, num_trans=2, ips=ips), JaxStrategy.ring(4, num_trans=2, ips=ips)
        for t, r in zip(port.trees, ref.trees):
            assert (t.root, t.children, t.parent, t.ips) == (r.root, r.children, r.parent, r.ips)
        for fast in (True, False):
            assert (GradSyncHook(port, use_xla_fastpath=fast)._resolved_mode()
                    == JaxGradSyncHook(ref, use_xla_fastpath=fast)._resolved_mode())


def test_trainer_rejects_what_waits(world1):
    s = Strategy.ring(1)
    for kw, match in [({"accum_steps": 2}, "accumulation"), ({"zero1": True}, "ZeRO-1"),
                      ({"bsp": False}, "relay"), ({"measure_gns": True}, "noise"),
                      ({"tune": True}, "tuner")]:
        with pytest.raises(NotImplementedError, match=match):
            DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, **kw)
    trainer = DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s)
    with pytest.raises(ValueError, match="dynamic_mask"):
        trainer.step(None, None, active_mask=torch.ones(1, dtype=torch.bool))


def test_adamw_has_optax_defaults():
    opt = adamw(3e-4)([torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_scan_steps_matches_sequential_steps(world1):
    cfg = GPT2Config(**TINY, dtype=torch.float32)
    shard = torch.from_numpy(_tokens(1))

    def run(scan):
        model = GPT2(cfg, device="cpu", seed=1)
        trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world1, Strategy.ring(1))
        state = TrainState.create(model, trainer.tx)
        if scan:
            _, losses = trainer.scan_steps(state, shard, STEPS)
        else:
            losses = torch.stack([trainer.step(state, shard)[1] for _ in range(STEPS)])
        return losses, model.state_dict()

    (la, sa), (lb, sb) = run(True), run(False)
    assert torch.equal(la, lb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
