"""The port's tensor-parallel primitives and vocabulary-parallel loss held
against the JAX package's.

- ``column_parallel_dense`` → ``row_parallel_dense`` (stacked, worlds 2, 4
  and 8, with biases) against the unsharded dense chain and JAX's pair
  under ``shard_map`` on the conftest's CPU mesh, within 1e-5 (float32,
  summation order); its gradients equal the dense chain's.
- ``tree_shardings`` on the GPT-2's parameters picks the leaves and the
  dimensions JAX's ``tree_shardings`` picks with ``gpt2_tp_rules`` (a
  flax kernel's spec read on the transposed ``Linear.weight``), on a
  ``(data, model)`` mesh and a vocabulary the model axis does not divide
  (the embedding falls back to replicated in both); ``shard_tree``'s
  stacked slices are the shards JAX places on each device, bit for bit.
- ``chunked_softmax_xent_shard`` (stacked, 8 ranks) against JAX's under
  ``shard_map`` with its gradients taken in the shard body, as
  tests/test_chunked_ce.py does, on its two cases (a vocabulary shard that
  is a multiple of the block, and one that pads): loss within rtol 1e-6,
  ``dx`` on every rank and the reassembled ``dw`` within 2e-6 (its
  tolerances).

The per-rank forms run over gloo in tests/test_torch_sequence_parallel.py's
spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from adapcc_tpu.ops.chunked_ce import chunked_softmax_xent_shard as jax_xent_shard
from adapcc_tpu.parallel import column_parallel_dense as jax_column
from adapcc_tpu.parallel import gpt2_tp_rules as jax_rules
from adapcc_tpu.parallel import row_parallel_dense as jax_row
from adapcc_tpu.parallel import tree_shardings as jax_tree_shardings
from adapcc_tpu_torch.models.convert import flax_paths
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
from adapcc_tpu_torch.ops.chunked_ce import chunked_softmax_xent_shard
from adapcc_tpu_torch.parallel.axis import Axis, Mesh
from adapcc_tpu_torch.parallel.tensor import (
    column_parallel_dense, gpt2_tp_rules, row_parallel_dense, shard_tree, tree_shardings,
)

TP_ATOL = 1e-5
XENT_RTOL, XENT_GRAD_ATOL = 1e-6, 2e-6
#: x [N, Din] → [N, Dh] (column) → [N, Dout] (row)
N, DIN, DH, DOUT = 6, 8, 16, 12
#: a vocabulary the model axis (4) does not divide
TP_MODEL = dict(vocab_size=66, max_seq=16, n_layer=2, n_head=4, d_model=32)
TP_MESH = {"data": 2, "model": 4}
XENT_WORLD = 8
#: (N, D, V, block): V_local 8 (two blocks), and V_local 6 (one padded block)
XENT_CASES = [(16, 8, 64, 4), (12, 8, 48, 4)]


def _pair_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x, w1, w2 = (rng.normal(size=s).astype(np.float32) * 0.3 for s in ((N, DIN), (DIN, DH), (DH, DOUT)))
    b1, b2 = (rng.normal(size=(n,)).astype(np.float32) * 0.1 for n in (DH, DOUT))
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("world", [2, 4, 8])
def test_column_row_pair_matches_dense_and_jax(world):
    x, w1, b1, w2, b2 = _pair_inputs()
    jmesh = JMesh(jax.devices()[:world], ("model",))

    def pair(x, w1, b1, w2, b2):
        return jax_row(jax_column(x, w1, b1), w2, "model", b2)

    jy = shard_map(pair, mesh=jmesh, in_specs=(P(), P(None, "model"), P("model"), P("model", None), P()),
                   out_specs=P(), check_vma=False)(x, w1, b1, w2, b2)

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w1, b1, w2, b2)]
    tx, tw1, tb1, tw2, tb2 = leaves
    axis = Axis("model", world)
    y = row_parallel_dense(
        column_parallel_dense(tx, tw1.view(DIN, world, -1).transpose(0, 1), tb1.view(world, -1)),
        tw2.view(world, -1, DOUT), axis, tb2)
    dense = (tx @ tw1 + tb1) @ tw2 + tb2
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=TP_ATOL)
    np.testing.assert_allclose(y.detach().numpy(), dense.detach().numpy(), atol=TP_ATOL)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(N, DOUT)).astype(np.float32))
    grads = torch.autograd.grad(y, leaves, g)
    want = torch.autograd.grad(dense, leaves, g)
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TP_ATOL, err_msg=name)


def test_column_output_stays_sharded_on_a_batch_of_rows():
    """Stacked shards broadcast over leading batch dimensions: a ``[B, T,
    Din]`` input gives ``[world, B, T, Dh/world]``."""
    x, w1, b1, w2, b2 = _pair_inputs()
    world = 4
    xb = torch.from_numpy(np.stack([x, -x]))  # [2, N, Din]
    h = column_parallel_dense(xb, torch.from_numpy(w1).view(DIN, world, -1).transpose(0, 1),
                              torch.from_numpy(b1).view(world, -1))
    assert h.shape == (world, 2, N, DH // world)
    y = row_parallel_dense(h, torch.from_numpy(w2).view(world, -1, DOUT), Axis("model", world),
                           torch.from_numpy(b2))
    dense = (xb @ torch.from_numpy(w1) + torch.from_numpy(b1)) @ torch.from_numpy(w2) + torch.from_numpy(b2)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), atol=TP_ATOL)


@pytest.fixture(scope="module")
def gpt2_tree():
    """The port's tiny GPT-2 and the flax tree of its parameters (values
    carried across by name)."""
    model = GPT2(GPT2Config(**TP_MODEL, dtype=torch.float32), device="cpu", seed=3)
    tree: dict = {}
    params = dict(model.named_parameters())
    for name, (path, transposed) in flax_paths(model).items():
        value = params[name].detach().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(value.T if transposed else value)
    return model, {"params": tree}


def test_tree_shardings_pick_jax_leaves_and_dims(gpt2_tree):
    model, tree = gpt2_tree
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), tuple(TP_MESH))
    jspecs = jax_tree_shardings(tree, jmesh, jax_rules("model"))
    specs = tree_shardings(model, Mesh.stacked_mesh(TP_MESH), gpt2_tp_rules("model"))
    paths = flax_paths(model)
    sharded = []
    for name, spec in specs.items():
        path, transposed = paths[name]
        jspec = jspecs["params"]
        for key in path:
            jspec = jspec[key]
        want = tuple(jspec.spec)
        assert spec == (tuple(reversed(want)) if transposed else want), name
        if spec:
            sharded.append(name)
    assert any("qkv" in n for n in sharded) and any(".fc." in n for n in sharded)
    assert specs["wte.weight"] == ()  # 66 rows over 4: replicated, as in JAX


def test_shard_tree_slices_are_jax_device_shards(gpt2_tree):
    model, tree = gpt2_tree
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), tuple(TP_MESH))
    jspecs = jax_tree_shardings(tree, jmesh, jax_rules("model"))
    stacks = shard_tree(model, Mesh.stacked_mesh(TP_MESH), gpt2_tp_rules("model"))
    paths = flax_paths(model)
    coords = {d: c for c, d in np.ndenumerate(jmesh.devices)}
    for name, stack in stacks.items():
        path, transposed = paths[name]
        leaf, spec = tree["params"], jspecs["params"]
        for key in path:
            leaf, spec = leaf[key], spec[key]
        placed = jax.device_put(leaf, spec)
        assert stack.shape[:2] == (2, 4), name
        for shard in placed.addressable_shards:
            got = stack[coords[shard.device]].numpy()
            want = np.asarray(shard.data)
            np.testing.assert_array_equal(got.T if transposed else got, want, err_msg=name)


@pytest.mark.parametrize("n, d, vocab, block", XENT_CASES)
def test_vocab_parallel_loss_matches_jax(n, d, vocab, block):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(vocab, d)) * 0.3).astype(np.float32)
    y = rng.integers(0, vocab, size=(n,))
    jmesh = JMesh(jax.devices()[:XENT_WORLD], ("ranks",))

    def per_shard(x, w_shard):
        loss, (dx, dw) = jax.value_and_grad(
            lambda x, w: jax_xent_shard(x, w, jnp.asarray(y, jnp.int32), "ranks", block, jnp.float32),
            argnums=(0, 1))(x, w_shard)
        return loss[None], dx[None], dw

    jloss, jdx, jdw = jax.jit(shard_map(per_shard, mesh=jmesh, in_specs=(P(), P("ranks")),
                                        out_specs=(P("ranks"), P("ranks"), P("ranks")), check_vma=False))(x, w)

    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w.reshape(XENT_WORLD, vocab // XENT_WORLD, d), requires_grad=True)
    loss = chunked_softmax_xent_shard(tx, tw, torch.from_numpy(y), Axis("ranks", XENT_WORLD), block, torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), np.asarray(jloss), rtol=XENT_RTOL)
    for r in range(XENT_WORLD):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx[r]), atol=XENT_GRAD_ATOL)
    np.testing.assert_allclose(tw.grad.numpy().reshape(vocab, d), np.asarray(jdw), atol=XENT_GRAD_ATOL)
