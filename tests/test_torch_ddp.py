"""The port's DDPTrainer held against the JAX package's.

Both trainers start from the same weights (a seeded port model, handed to
JAX as a flax tree) and
run two AdamW(3e-4) steps on the same numpy tokens:

- world 1 in this process (gloo), flash attention;
- world 2 over gloo (rank 0 here, rank 1 in a spawned worker), xla attention, once with the
  full world and once with ``active_mask=[True, False]`` (rank 1's gradient
  is dropped and the average runs over the one active rank); on the psum
  plane, and on the bucketed schedule plane (``sync_mode="schedule"``, two
  merged chain trees, rank 1 a relay in the masked run).

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
from adapcc_tpu_torch.utils.observability import MetricsRegistry

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


def _jax_runs(params, tokens, world, attention, masks=(None,), sync_mode="auto", num_trans=1):
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
        JaxStrategy.ring(world, num_trans), dynamic_mask=dynamic, sync_mode=sync_mode,
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


def _torch_run(state_dict, shard, world_mesh, attention, mask=None, sync_mode="auto", num_trans=1):
    """Per-step losses of this rank and its final state dict."""
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention=attention, flash_block=32),
                 device="cpu", seed=None)
    model.load_state_dict(state_dict)
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world_mesh,
                         Strategy.ring(world_mesh.world_size, num_trans), dynamic_mask=mask is not None,
                         sync_mode=sync_mode)
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


def _world2_rank(rank, init_method, state_dict, tokens, masks, sync_mode="auto", num_trans=1):
    """One gloo rank of the world-2 runs: a result per mask (None = static)."""
    world = build_world_mesh(2, rank=rank, device="cpu", init_method=init_method)
    try:
        shard = tokens[rank * PER_RANK_BATCH:(rank + 1) * PER_RANK_BATCH]
        return [_torch_run(state_dict, shard, world, "xla", mask, sync_mode, num_trans) for mask in masks]
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


def test_ddp_world2_schedule_plane_matches_jax_with_and_without_relay(flax_params):
    """``sync_mode="schedule"`` with ``dynamic_mask=True`` over two merged
    chain trees: the gradients bucketed in the flax leaf order and layout,
    each bucket through the tree rounds; the full world, then rank 1 a
    relay (it forwards, contributes nothing, and receives the average)."""
    tokens = _tokens(2, seed=11)
    masks = [[True, True], [True, False]]
    sd = flax_to_state_dict(flax_params)
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    args = (sd, tokens, masks, "schedule", 2)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(_world2_child, (1, init_method, *args))
        refs = _jax_runs(flax_params, tokens, 2, "xla", masks, sync_mode="schedule", num_trans=2)
        per_rank = [_world2_rank(0, init_method, *args), pending.get(timeout=120)]
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
    # the schedule plane runs now (tests/test_torch_schedule.py), and so do
    # its observability sinks (tests/test_torch_tuner.py)
    registry = MetricsRegistry()
    assert GradSyncHook(two_hosts, metrics=registry)._metrics is registry
    # the wire codecs run now: a registered name is taken, a typo raises
    assert GradSyncHook(one_host, compress="bf16").effective_compress() == "bf16"
    assert Strategy(Strategy.ring(2).trees, 2, wire_dtype="int8").wire_dtype == "int8"
    with pytest.raises(ValueError, match="unknown wire codec"):
        GradSyncHook(one_host, compress="int4")
    with pytest.raises(ValueError, match="unknown wire codec"):
        Strategy(Strategy.ring(2).trees, 2, wire_dtype="fp8")
    # overlap="bucket" runs now (tests/test_torch_overlap.py)


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
    # accumulation runs now (tests/test_torch_overlap.py), and so does
    # ZeRO-1 without the ring (tests/test_torch_zero1_elastic.py); the ring
    # form waits for the per-process ring, and shard replicas need zero1
    # (JAX's words)
    assert DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, zero1=True).zero1
    with pytest.raises(NotImplementedError, match="per-process ring"):
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, zero1=True, zero1_ring=True)
    # the gradient-noise scale runs now (tests/test_torch_measure.py) and, as
    # JAX's, refuses a world of one
    with pytest.raises(ValueError, match="measure_gns needs a multi-device mesh"):
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, measure_gns=True)
    with pytest.raises(ValueError, match="shard_replicas > 0 requires zero1=True"):
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, shard_replicas=1)
    # the async relay runs now (tests/test_torch_elastic.py); it takes a
    # mask every step, and refuses a static one in JAX's words
    assert DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, bsp=False)._dynamic_mask
    with pytest.raises(ValueError, match="relay"):
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, bsp=False, dynamic_mask=False)
    # the step tuner runs now (tests/test_torch_tuner.py): tune=True builds a
    # choosing tuner for the world; tune_every must be positive
    tuned = DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, tune=True)
    assert tuned.tuner is not None and tuned.tuner.explicit_mode == "choose" and tuned.tuner.world == 1
    with pytest.raises(ValueError, match="tune_every"):
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, tune=True, tune_every=0)
    trainer = DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s)
    with pytest.raises(ValueError, match="dynamic_mask"):
        trainer.step(None, None, active_mask=torch.ones(1, dtype=torch.bool))
    # error feedback runs now, with a codec, in BSP mode, step by step
    with pytest.raises(ValueError, match="'off' wire codec"):
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, error_feedback=True)
    with pytest.raises(ValueError, match="BSP"):
        DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, grad_compress="int8", error_feedback=True, bsp=False)
    ef = DDPTrainer(lambda m, b: m(b), adamw(LR), world1, s, grad_compress="int8", error_feedback=True)
    with pytest.raises(ValueError, match="residual"):
        ef.scan_steps(None, None, 2)


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


# --------------------------------------------------------------------------- #
# the wire codecs on the gradient sync
# --------------------------------------------------------------------------- #


def _residual_tree(params, seed=3):
    """A seeded float32 error-feedback bank in the JAX trainer's layout: the
    flax tree with a leading world dim of 1."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (rng.normal(size=(1, *np.shape(v))) * 1e-4).astype(np.float32)
                for k, v in tree.items()}

    return walk(params)


#: a gradient element on a rounding tie may take adjacent int8 codes in the
#: two frameworks, whose gradients differ in the last bits; Adam can turn
#: that one-code difference into a difference of up to about lr in the
#: element.  Each step therefore starts both trainers from the JAX trainer's
#: state (params, Adam moments, residual), so such a difference cannot
#: cascade, and a few elements a step may differ by up to 2·lr (0 seen in
#: the params, 2 in the residual)
FLIP_BUDGET = 8
FLIP_ATOL = 2 * LR


def _assert_close_but_flips(got, want, atol, what):
    """Every element within ``atol`` (``KEY_BIAS_ATOL`` for the key bias), but
    at most ``FLIP_BUDGET`` within ``FLIP_ATOL``; returns how many."""
    d = TINY["d_model"]
    flips = 0
    for name in want:
        diff = np.abs(np.asarray(got[name], np.float32) - np.asarray(want[name], np.float32))
        allowed = np.full(diff.shape, atol, np.float32)
        if name.endswith("attn.qkv.bias"):
            allowed[d:2 * d] = KEY_BIAS_ATOL
        assert (diff <= np.maximum(allowed, FLIP_ATOL)).all(), f"{what} {name}: max diff {diff.max()}"
        flips += int((diff > allowed).sum())
    assert flips <= FLIP_BUDGET, f"{what}: {flips} elements beyond tolerance"
    return flips


def _jax_ddp_steps(params, tokens, residual=None, **trainer_kw):
    """World-1 JAX DDPTrainer with ``trainer_kw``: per step, the loss and the
    state after it (params, optax state, residual tree or None), as numpy."""
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

    model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32, attention="xla"))
    mesh = Mesh(jax.devices()[:1], ("ranks",))
    trainer = JaxDDPTrainer(lambda p, b: jax_lm_loss(model.apply(p, b), b), optax.adamw(LR), mesh,
                            JaxStrategy.ring(1), **trainer_kw)
    if residual is not None:
        trainer._residual = jax.device_put(jax.tree_util.tree_map(jnp.asarray, residual),
                                           NamedSharding(mesh, P("ranks")))
    batch = jax.device_put(jnp.asarray(tokens, jnp.int32), NamedSharding(mesh, P("ranks")))
    state = jax.device_put(JaxTrainState.create(params, trainer.tx), NamedSharding(mesh, P()))
    steps = []
    for _ in range(STEPS):
        state, loss = trainer.step(state, batch)
        res = None if trainer._residual is None else jax.device_get(trainer._residual)
        steps.append((float(np.asarray(loss)[0]), jax.device_get(state.params), jax.device_get(state.opt_state), res))
    return steps


def _torch_ddp_step(params, opt_state, residual, tokens, world, **trainer_kw):
    """One port DDPTrainer step from a JAX trainer's state (flax params, the
    optax adamw state or None for a fresh one, the residual tree or None):
    the loss, the params after it and the residual list."""
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention="xla"), device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    trainer = DDPTrainer(lambda m, b: lm_loss(m(b), b), adamw(LR), world, Strategy.ring(1), **trainer_kw)
    if residual is not None:
        from adapcc_tpu_torch.models.convert import residual_from_jax

        trainer._residual = residual_from_jax(residual, model, rank=0)
    state = TrainState.create(model, trainer.tx)
    if opt_state is not None:
        adam = opt_state[0]
        mu, nu = flax_to_state_dict(adam.mu), flax_to_state_dict(adam.nu)
        for name, p in model.named_parameters():
            state.optimizer.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[name],
                                        "exp_avg_sq": nu[name]}
    _, loss = trainer.step(state, torch.from_numpy(tokens))
    params_after = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return loss.item(), params_after, getattr(trainer, "_residual", None)


def _compressed_steps_match_jax(params, tokens, world, residual=None, **trainer_kw):
    """Each step of the port, from the JAX trainer's state before it, against
    the JAX step: losses, params and the residual bank.  The int8 blocks
    follow the JAX leaves' layout (``Dense`` kernels ``[in, out]``): in the
    port's ``[out, in]`` layout every block would hold other elements."""
    steps = _jax_ddp_steps(params, tokens, residual, **trainer_kw)
    before = (params, None, residual)
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=None)
    for loss_j, params_j, opt_j, res_j in steps:
        loss_t, params_t, res_t = _torch_ddp_step(*before, tokens, world, **trainer_kw)
        assert abs(loss_t - loss_j) <= LOSS_ATOL
        want = {k: v.numpy() for k, v in flax_to_state_dict(params_j).items()}
        _assert_close_but_flips(params_t, want, PARAM_ATOL, "params")
        if res_j is not None:
            from adapcc_tpu_torch.models.convert import residual_from_jax

            names = [n for n, _ in model.named_parameters()]
            res_want = dict(zip(names, (r.numpy() for r in residual_from_jax(res_j, model, rank=0))))
            # a residual is at most half a code step, so 254 times a leaf's
            # largest residual stands for its largest gradient: the banks
            # agree to 1e-6 of that (1.1e-6 seen), but where a code differs,
            # by one step (two of the leaf's largest half steps)
            flips = 0
            for name, r in zip(names, res_t):
                half_step = np.abs(res_want[name]).max()
                diff = np.abs(r.numpy() - res_want[name])
                assert (diff <= 2 * half_step * (1 + 1e-6)).all(), name
                flips += int((diff > 2e-6 * 254 * half_step).sum())
            assert flips <= FLIP_BUDGET, f"residual: {flips} elements a code step off"
        before = (params_j, opt_j, res_j)
    return steps


def test_ddp_int8_error_feedback_matches_jax(flax_params, world1):
    """``grad_compress="int8"`` with error feedback, from a seeded residual
    bank carried across by ``residual_from_jax``."""
    _compressed_steps_match_jax(flax_params, _tokens(1), world1, _residual_tree(flax_params),
                                grad_compress="int8", error_feedback=True)


def test_wire_dtype_env_compresses_the_hook_like_jax(flax_params, world1, monkeypatch):
    """``ADAPCC_WIRE_DTYPE=int8`` wins over the hook's ``compress="off"`` in
    both packages: the port's DDP steps equal the JAX package's int8 steps
    (the port once trained in float32 under it)."""
    monkeypatch.setenv("ADAPCC_WIRE_DTYPE", "int8")
    _compressed_steps_match_jax(flax_params, _tokens(1), world1)
    assert GradSyncHook(Strategy.ring(1)).effective_compress() == "int8"
