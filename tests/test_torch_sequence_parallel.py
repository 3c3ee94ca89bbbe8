"""The port's sequence-parallel plane held against the JAX package's.

The same numpy-seeded inputs go through ``adapcc_tpu.parallel`` (under
``shard_map`` on the conftest's CPU mesh, jitted, flash in interpret mode
as JAX's own tests run it) and ``adapcc_tpu_torch.parallel`` (on CPU
tensors, so the flash blocks run the kernels' plain versions), float32
throughout.  Tolerances are JAX's tests' own:

- ring attention, dense and flash blocks, causal and not, worlds 2 and 4
  (stacked): outputs within 2e-5 and q/k/v gradients within 5e-4
  (tests/test_ring_flash.py:72, :92) of JAX's oracle
  (``reference_attention``, which JAX's ring equals), the causal flash
  ring's output at world 4 also of JAX's flash ring; each flash block's
  backward sees a non-zero ``lse`` cotangent, and a ring launches each
  kernel ``world`` times (ranks whose block has the same kind share one);
- Ulysses, dense and flash, causal and not, worlds 2 and 4: outputs within
  1e-5 (tests/test_ulysses.py:24) and gradients within 1e-4 (its grads
  test) of JAX's oracle, and JAX's ``H % world`` refusal word for word;
- the sequence-parallel GPT-2 (2 layers, 4 heads, d_model 32, T = 32 over
  2 and 4 ranks) for ring and Ulysses, dense and flash attention, dense
  and chunked loss: loss within 1e-5 and gradients within 2e-4
  (tests/test_gpt2_sp.py:38-42) of JAX's ``gpt2_sp_loss_and_grad``, run
  for ring with the dense loss and Ulysses with the chunked one (JAX's are
  one function, and every port configuration meets each); JAX's refusals
  word for word; DP × SP on a (data 2, sp 2) mesh: 3 steps of
  ``gpt2_sp_train_step`` with the port's ``adamw`` against JAX's with
  ``optax.adamw``, losses within 1e-5 at every step and the parameters
  within Adam's ``2·lr`` a step (a parameter whose true gradient is ~0,
  as the key biases', moves by up to ``lr`` on noise);
- the per-rank form at world 4 over gloo (rank 0 here, ranks 1-3 in one
  spawn): ring (flash, causal; dense, not), Ulysses (flash) and the GPT-2's
  DP × SP loss and gradients against the stacked form and JAX within the
  same bounds; the tensor-parallel primitives (``row_parallel_dense``,
  ``chunked_softmax_xent_shard``) against the stacked form, which
  tests/test_torch_tensor_parallel.py holds against JAX, within its
  tolerances.

Workers import only torch: this module imports JAX inside functions.
"""

import dataclasses
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.ddp.trainer import adamw
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
from adapcc_tpu_torch.ops import flash_attention as fa
from adapcc_tpu_torch.ops.chunked_ce import chunked_softmax_xent_shard
from adapcc_tpu_torch.parallel.axis import Axis, Mesh
from adapcc_tpu_torch.parallel.gpt2_sp import gpt2_sp_loss_and_grad, gpt2_sp_train_step, local_tokens
from adapcc_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_shard
from adapcc_tpu_torch.parallel.tensor import column_parallel_dense, row_parallel_dense
from adapcc_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_shard

RING_OUT_ATOL, RING_GRAD_ATOL = 2e-5, 5e-4
ULYSSES_OUT_ATOL, ULYSSES_GRAD_ATOL = 1e-5, 1e-4
SP_LOSS_ATOL, SP_GRAD_ATOL = 1e-5, 2e-4
#: tests/test_chunked_ce.py's vocabulary-parallel tolerances (loss, gradients)
XENT_RTOL, XENT_GRAD_ATOL = 1e-6, 2e-6
TP_ATOL = 1e-5

#: attention inputs: [B, T, H, D], scaled as tests/test_ring_flash.py's
ATT_SHAPE = (1, 16, 4, 8)
BLOCK = 4
BASE = dict(vocab_size=64, max_seq=32, n_layer=2, n_head=4, d_model=32)
SP_TOKENS = (2, 32)
FLASH_BLOCK = 8
LOSS_BLOCK = 32
#: JAX's sequence-parallel configurations run: (sp_impl, attention, loss);
#: its flash blocks meet the port's in the ring attention tests (a flash
#: GPT-2 costs seconds of interpreter compile on one core)
JAX_SP_COVER = (("ring", "xla", "dense"), ("ulysses", "xla", "chunked"))
DPSP = {"data": 2, "sp": 2}
DPSP_TOKENS = (4, 32)
DPSP_STEPS, DPSP_LR = 3, 1e-3
RANK_WORLD = 4
#: the tensor-parallel per-rank cases: x [N, Din], w1 [Din, Dh], w2 [Dh, Dout]
TP_DIMS = (6, 8, 16, 12)
XENT_DIMS = (12, 16, 64, 16)  # N, D, V, block


def _attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=ATT_SHAPE).astype(np.float32) * 0.5 for _ in range(3))
    g = rng.normal(size=ATT_SHAPE).astype(np.float32)
    return q, k, v, g


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _port_attention(fn, world, arrays, **kw):
    q, k, v, g = arrays
    tq, tk, tv = _leaves(q, k, v)
    out = fn(world, tq, tk, tv, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.fixture(scope="module")
def jax_attention(mesh4):
    """JAX's oracle (output and the q/k/v cotangents of ``g``) causal and
    not, and its flash ring at world 4, causal."""
    import jax

    from adapcc_tpu.parallel import ring_attention as jring
    from adapcc_tpu.parallel.ring_attention import reference_attention as jref

    q, k, v, g = _attention_inputs()

    def oracles(q, k, v):
        both = []
        for causal in (True, False):
            o, vjp = jax.vjp(lambda q, k, v: jref(q, k, v, causal=causal), q, k, v)
            both.append((o, vjp(g)))
        return both

    out = {}
    for causal, (o, grads) in zip((True, False), jax.jit(oracles)(q, k, v)):
        out["oracle", causal] = (np.asarray(o), [np.asarray(x) for x in grads])
    out["ring", True] = np.asarray(jring(mesh4, q, k, v, causal=True, block_impl="flash",
                                         block_q=BLOCK, block_k=BLOCK))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_impl", ["dense", "flash"])
def test_ring_attention_matches_jax(jax_attention, monkeypatch, world, causal, block_impl):
    dlse, calls = [], {"fwd": 0}
    forward, backward = fa._FlashAttention.forward, fa._FlashAttention.backward

    def spy_forward(ctx, *args):
        calls["fwd"] += 1
        return forward(ctx, *args)

    def spy_backward(ctx, do, g_lse):
        dlse.append(0.0 if g_lse is None else g_lse.abs().max().item())
        return backward(ctx, do, g_lse)

    monkeypatch.setattr(fa._FlashAttention, "forward", staticmethod(spy_forward))
    monkeypatch.setattr(fa._FlashAttention, "backward", staticmethod(spy_backward))
    out, grads = _port_attention(ring_attention, world, _attention_inputs(), causal=causal,
                                 block_impl=block_impl, block_q=BLOCK, block_k=BLOCK)
    want, want_grads = jax_attention["oracle", causal]
    np.testing.assert_allclose(out, want, atol=RING_OUT_ATOL)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, b, atol=RING_GRAD_ATOL, err_msg=f"d{name}")
    if block_impl == "flash":
        if (world, causal) == (4, True):
            np.testing.assert_allclose(out, jax_attention["ring", True], atol=RING_OUT_ATOL)
        # one launch a step, each of them with an lse cotangent
        assert calls["fwd"] == world and len(dlse) == world
        assert min(dlse) > 0, dlse
    else:
        assert calls["fwd"] == 0 and not dlse


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_impl", ["dense", "flash"])
def test_ulysses_matches_jax(jax_attention, world, causal, block_impl):
    out, grads = _port_attention(ulysses_attention, world, _attention_inputs(), causal=causal,
                                 block_impl=block_impl)
    want, want_grads = jax_attention["oracle", causal]
    np.testing.assert_allclose(out, want, atol=ULYSSES_OUT_ATOL)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, b, atol=ULYSSES_GRAD_ATOL, err_msg=f"d{name}")


def test_ulysses_and_ring_refusals_are_jax_words(mesh4):
    from adapcc_tpu.parallel import ring_attention as jring
    from adapcc_tpu.parallel import ulysses_attention as julysses

    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 8, 3, 4)).astype(np.float32)  # 3 heads over 4 ranks
    with pytest.raises(ValueError) as je:
        julysses(mesh4, q, q, q)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError) as pe:
        ulysses_attention(4, t, t, t)
    assert str(pe.value) == str(je.value)
    q = rng.normal(size=(1, 16, 4, 4)).astype(np.float32)
    with pytest.raises(ValueError) as je:
        jring(mesh4, q, q, q, block_impl="nope")
    t = torch.from_numpy(q)
    with pytest.raises(ValueError) as pe:
        ring_attention(4, t, t, t, block_impl="nope")
    assert str(pe.value) == str(je.value)


# --------------------------------------------------------------------------- #
# the sequence-parallel GPT-2
# --------------------------------------------------------------------------- #


def _flax_params(tokens):
    """A flax GPT-2 tree of the tiny configuration, seeded numpy values
    (nonzero biases and LayerNorm parameters), without a flax init."""
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig

    tree = jax.eval_shape(JGPT2(JConfig(**BASE, dtype=jnp.float32)).init, jax.random.PRNGKey(0),
                          jnp.asarray(tokens[:1], jnp.int32))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        noise = (rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
        return noise + 1 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, tree)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], size=shape)


def _port_model(params, axis=None, **cfg):
    model = GPT2(GPT2Config(**BASE, dtype=torch.float32, sp_axis=axis, flash_block=FLASH_BLOCK, **cfg),
                 device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    return model


@pytest.fixture(scope="module")
def jax_sp(mesh4):
    """JAX's ``gpt2_sp_loss_and_grad`` on ``JAX_SP_COVER``, as ``(loss,
    grads by the port's parameter names)``."""
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.parallel import gpt2_sp_loss_and_grad as jloss_and_grad

    tokens = _tokens(SP_TOKENS, 0)
    params = _flax_params(tokens)
    results = []
    for impl, attention, loss in JAX_SP_COVER:
        model = JGPT2(JConfig(**BASE, dtype=jnp.float32, sp_axis="ranks", sp_impl=impl, attention=attention,
                              flash_block=FLASH_BLOCK))
        value, grads = jloss_and_grad(model, mesh4, loss=loss, loss_block=LOSS_BLOCK)(
            params, jnp.asarray(tokens, jnp.int32))
        results.append((float(value), flax_to_state_dict(jax.device_get(grads))))
    return params, tokens, results


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("loss", ["dense", "chunked"])
def test_sp_gpt2_loss_and_grads_match_jax(jax_sp, world, sp_impl, attention, loss):
    params, tokens, results = jax_sp
    mesh = Mesh.stacked_mesh({"ranks": world})
    model = _port_model(params, mesh["ranks"], sp_impl=sp_impl, attention=attention)
    value, grads = gpt2_sp_loss_and_grad(model, mesh, loss=loss, loss_block=LOSS_BLOCK)(torch.from_numpy(tokens))
    for want, want_grads in results:
        np.testing.assert_allclose(value.item(), want, atol=SP_LOSS_ATOL)
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=SP_GRAD_ATOL, err_msg=name)


def test_sp_refusals_are_jax_words(mesh4):
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.parallel import gpt2_sp_loss_and_grad as jloss_and_grad

    mesh = Mesh.stacked_mesh({"ranks": RANK_WORLD})
    tokens = _tokens(SP_TOKENS, 0)
    jtokens = jnp.asarray(tokens, jnp.int32)
    params = _flax_params(tokens)

    def pair(jax_call, port_call):
        with pytest.raises(ValueError) as je:
            jax_call()
        with pytest.raises(ValueError) as pe:
            port_call()
        assert str(pe.value) == str(je.value)

    def jmodel(**kw):
        return JGPT2(JConfig(**BASE, dtype=jnp.float32, **kw))

    pair(lambda: jloss_and_grad(jmodel(sp_axis="other"), mesh4),
         lambda: gpt2_sp_loss_and_grad(_port_model(params, Axis("other", RANK_WORLD)), mesh))
    pair(lambda: jloss_and_grad(jmodel(sp_axis="ranks"), mesh4, data_axis="nope"),
         lambda: gpt2_sp_loss_and_grad(_port_model(params, mesh["ranks"]), mesh, data_axis="nope"))
    pair(lambda: jloss_and_grad(jmodel(sp_axis="ranks"), mesh4, loss="sparse"),
         lambda: gpt2_sp_loss_and_grad(_port_model(params, mesh["ranks"]), mesh, loss="sparse"))
    pair(lambda: jax.eval_shape(jloss_and_grad(jmodel(sp_axis="ranks", dropout=0.1), mesh4), params, jtokens),
         lambda: gpt2_sp_loss_and_grad(_port_model(params, mesh["ranks"], dropout=0.1), mesh)(
             torch.from_numpy(tokens)))
    pair(lambda: jax.eval_shape(jloss_and_grad(jmodel(sp_axis="ranks", sp_impl="tree"), mesh4), params, jtokens),
         lambda: gpt2_sp_loss_and_grad(_port_model(params, mesh["ranks"], sp_impl="tree"), mesh)(
             torch.from_numpy(tokens)))


def test_dp_x_sp_train_steps_match_jax_with_optax_adamw():
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.parallel import gpt2_sp_train_step as jtrain_step

    tokens = _tokens(DPSP_TOKENS, 7)
    params = _flax_params(tokens)
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), tuple(DPSP))
    tx = optax.adamw(DPSP_LR)
    jstep = jtrain_step(JGPT2(JConfig(**BASE, dtype=jnp.float32, sp_axis="sp")), tx, jmesh,
                        axis_name="sp", data_axis="data")
    # the state placed on the mesh first, as the step returns it: otherwise
    # the second step compiles again
    jparams, jstate, jtokens = jax.device_put((params, tx.init(params), jnp.asarray(tokens, jnp.int32)),
                                              NamedSharding(jmesh, P()))
    jlosses = []
    for _ in range(DPSP_STEPS):
        jparams, jstate, loss = jstep(jparams, jstate, jtokens)
        jlosses.append(float(loss))

    mesh = Mesh.stacked_mesh(DPSP)
    model = _port_model(params, mesh["sp"])
    step = gpt2_sp_train_step(model, adamw(DPSP_LR), mesh, axis_name="sp", data_axis="data")
    opt_state, losses = None, []
    for _ in range(DPSP_STEPS):
        model, opt_state, loss = step(model, opt_state, torch.from_numpy(tokens))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, atol=SP_LOSS_ATOL)
    assert losses[-1] < losses[0]
    want = flax_to_state_dict(jax.device_get(jparams))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2 * DPSP_LR * DPSP_STEPS,
                                   err_msg=name)


# --------------------------------------------------------------------------- #
# the per-rank form over gloo
# --------------------------------------------------------------------------- #


def _tp_inputs():
    rng = np.random.default_rng(11)
    N, Din, Dh, Dout = TP_DIMS
    x, w1, w2 = (rng.normal(size=s).astype(np.float32) * 0.3 for s in ((N, Din), (Din, Dh), (Dh, Dout)))
    n, d, V, _ = XENT_DIMS
    xe = rng.normal(size=(n, d)).astype(np.float32)
    we = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    ye = rng.integers(0, V, size=(n,))
    return x, w1, w2, xe, we, ye


#: the per-rank attention cases: (kind, global form, keyword arguments)
RANK_ATTENTION = {
    "ring flash": ("ring", dict(causal=True, block_impl="flash", block_q=BLOCK, block_k=BLOCK)),
    "ring dense": ("ring", dict(causal=False, block_impl="dense", block_q=BLOCK, block_k=BLOCK)),
    "ulysses flash": ("ulysses", dict(causal=True, block_impl="flash")),
}


def _rank_results(rank, init_method, params, tokens):
    """This rank's shard of every per-rank case; ``params`` the DP × SP
    case's flax tree (numpy)."""
    from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world

    build_world_mesh(RANK_WORLD, rank=rank, device="cpu", init_method=init_method)
    try:
        mesh = Mesh.per_rank({"ranks": RANK_WORLD})
        dpsp = Mesh.per_rank(DPSP)
        axis = mesh["ranks"]
        q, k, v, g = _attention_inputs()
        Tl = ATT_SHAPE[1] // RANK_WORLD
        mine = slice(rank * Tl, (rank + 1) * Tl)
        out = {}
        for name, (kind, kw) in RANK_ATTENTION.items():
            fn = ring_attention_shard if kind == "ring" else ulysses_attention_shard
            tq, tk, tv = _leaves(q[:, mine], k[:, mine], v[:, mine])
            o = fn(tq, tk, tv, axis, **kw)
            (o * torch.from_numpy(g[:, mine])).sum().backward()
            out[name] = (o.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)])
        model = _port_model(params, dpsp["sp"], attention="flash")
        value, grads = gpt2_sp_loss_and_grad(model, dpsp, axis_name="sp", data_axis="data")(
            local_tokens(torch.from_numpy(tokens), dpsp, "sp", "data"))
        out["gpt2"] = (value.item(), {n: t.numpy().copy() for n, t in grads.items()})
        out["tp"] = _tp_rank(axis, rank)
        return out
    finally:
        destroy_world()


def _tp_rank(axis, rank):
    """Rank ``rank``'s column → row pair output and gradients, and its
    vocabulary-parallel loss with ``dx`` and its ``dw`` shard."""
    x, w1, w2, xe, we, ye = _tp_inputs()
    h = TP_DIMS[2] // RANK_WORLD
    tx, tw1, tw2 = _leaves(x, w1[:, rank * h:(rank + 1) * h], w2[rank * h:(rank + 1) * h])
    y = row_parallel_dense(column_parallel_dense(tx, tw1), tw2, axis)
    y.square().sum().backward()
    V = XENT_DIMS[2] // RANK_WORLD
    txe, twe = _leaves(xe, we[rank * V:(rank + 1) * V])
    loss = chunked_softmax_xent_shard(txe, twe, torch.from_numpy(ye), axis, block=XENT_DIMS[3],
                                      compute_dtype=torch.float32)
    loss.backward()
    return (y.detach().numpy(), [t.grad.numpy() for t in (tx, tw1, tw2)],
            loss.item(), txe.grad.numpy(), twe.grad.numpy())


def _rank_child(rank, init_method, params, tokens):
    torch.set_num_threads(1)
    return _rank_results(rank, init_method, params, tokens)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stacked_tp():
    """The stacked form of ``_tp_rank``'s cases (which
    tests/test_torch_tensor_parallel.py holds against JAX's), and the
    unsharded pair's output."""
    x, w1, w2, xe, we, ye = _tp_inputs()
    w = RANK_WORLD
    axis = Axis("ranks", w)
    tx, tw1, tw2 = _leaves(x, np.stack(np.split(w1, w, axis=1)), np.stack(np.split(w2, w, axis=0)))
    y = row_parallel_dense(column_parallel_dense(tx, tw1), tw2, axis)
    y.square().sum().backward()
    txe, twe = _leaves(xe, we.reshape(w, -1, we.shape[1]))
    loss = chunked_softmax_xent_shard(txe, twe, torch.from_numpy(ye), axis, block=XENT_DIMS[3],
                                      compute_dtype=torch.float32)
    loss.backward()
    stacked = (y.detach().numpy(), [tx.grad.numpy(), np.concatenate(list(tw1.grad.numpy()), axis=1),
                                    np.concatenate(list(tw2.grad.numpy()), axis=0)],
               loss.item(), txe.grad.numpy(), twe.grad.numpy().reshape(we.shape))
    return stacked, (x @ w1) @ w2


def test_per_rank_form_over_gloo_matches_stacked_and_jax(jax_attention, jax_sp):
    params, tokens, results = jax_sp
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(RANK_WORLD - 1) as pool:
        pending = [pool.apply_async(_rank_child, (r, init_method, params, tokens)) for r in range(1, RANK_WORLD)]
        # while the workers start: the stacked references
        stacked_tp = _stacked_tp()
        mesh = Mesh.stacked_mesh(DPSP)
        sp_value, sp_grads = gpt2_sp_loss_and_grad(_port_model(params, mesh["sp"], attention="flash"), mesh,
                                                   axis_name="sp", data_axis="data")(torch.from_numpy(tokens))
        per_rank = [_rank_results(0, init_method, params, tokens)] + [p.get(timeout=120) for p in pending]

    q, k, v, g = _attention_inputs()
    for name, (kind, kw) in RANK_ATTENTION.items():
        if kind == "ring":
            fn, atol, grad_atol = ring_attention, RING_OUT_ATOL, RING_GRAD_ATOL
        else:
            fn, atol, grad_atol = ulysses_attention, ULYSSES_OUT_ATOL, ULYSSES_GRAD_ATOL
            kw = {n: a for n, a in kw.items() if not n.startswith("block_")}
        out = np.concatenate([r[name][0] for r in per_rank], axis=1)
        grads = [np.concatenate([r[name][1][i] for r in per_rank], axis=1) for i in range(3)]
        s_out, s_grads = _port_attention(fn, RANK_WORLD, (q, k, v, g), **kw)
        o_want, g_want = jax_attention["oracle", kw["causal"]]
        for ref_out, ref_grads in ((s_out, s_grads), (o_want, g_want)):
            np.testing.assert_allclose(out, ref_out, atol=atol, err_msg=name)
            for a, b in zip(grads, ref_grads):
                np.testing.assert_allclose(a, b, atol=grad_atol, err_msg=name)

    # DP x SP: every rank holds the stacked form's loss and gradient, and
    # JAX's (its gpt2_sp_loss_and_grad, the unsharded ones)
    wants = [(sp_value.item(), {n: t.numpy() for n, t in sp_grads.items()})]
    wants += [(v, {n: t.numpy() for n, t in g.items()}) for v, g in results]
    for value, grads in (r["gpt2"] for r in per_rank):
        for want, want_grads in wants:
            np.testing.assert_allclose(value, want, atol=SP_LOSS_ATOL)
            for name, gr in grads.items():
                np.testing.assert_allclose(gr, want_grads[name], atol=SP_GRAD_ATOL, err_msg=name)

    # tensor parallel: the pair's output on every rank, its weights'
    # gradients reassembled from the shards; the vocabulary-parallel loss and dx on
    # every rank, dw from the shards
    (s_y, s_pair_grads, s_loss, s_dx, s_dw), dense_y = stacked_tp
    h = TP_DIMS[2] // RANK_WORLD
    tp = [r["tp"] for r in per_rank]
    # x is replicated: each rank's gradient is its own term's, summed over
    # the axis as the sequence-parallel model's parameters are
    pair_grads = [sum(t[1][0] for t in tp), np.concatenate([t[1][1] for t in tp], axis=1),
                  np.concatenate([t[1][2] for t in tp], axis=0)]
    assert pair_grads[1].shape[1] == h * RANK_WORLD
    for y, *_ in tp:
        np.testing.assert_allclose(y, s_y, atol=TP_ATOL)
        np.testing.assert_allclose(y, dense_y, atol=TP_ATOL)
    for a, b in zip(pair_grads, s_pair_grads):
        np.testing.assert_allclose(a, b, atol=TP_ATOL)
    dw = np.concatenate([t[4] for t in tp])
    for _, _, loss, dx, _ in tp:
        np.testing.assert_allclose(loss, s_loss, rtol=XENT_RTOL)
        np.testing.assert_allclose(dx, s_dx, atol=XENT_GRAD_ATOL)
    np.testing.assert_allclose(dw, s_dw, atol=XENT_GRAD_ATOL)
