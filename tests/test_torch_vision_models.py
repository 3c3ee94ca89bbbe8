"""The port's image models (MLP, VGG, ResNet, ViT) held against the JAX
package's flax modules.

Each case builds the port's model from a seed, hands its weights to the
flax module as a flax tree (``to_flax_variables``, checked against
``flax_to_state_dict``; a flax init would cost JAX seconds) and feeds both
the same numpy-seeded ``[B, H, W, C]`` images (even sizes, so a stride-2
``SAME`` conv pads (0, 1)).  The ImageNet stem runs at 64x64, so the last
stage is 2x2: at 1x1 a GroupNorm of two channels normalizes two numbers,
and its variance is rounding noise on either side.

Tolerances: float32 models differ only in summation order (and, in the
norms, in how the mean of squares is reduced): logits within ``F32_RTOL``
of the largest logit; gradients within ``GRAD_RTOL`` of the largest
gradient of their leaf, plus ``GRAD_FLOOR`` of the model's largest
gradient (a key bias's true gradient is zero: softmax is shift-invariant,
so both sides hold rounding noise there).  Through train-mode norms each
block's backward subtracts means of nearly equal terms, which magnifies
rounding with depth: ResNet-50's gradients are not compared, its logits
and running statistics are.  bfloat16 models round at the same points on
both sides, but each side may round a float32 value to a neighbouring bf16
value, and that propagates: logits within ``BF16_TOL`` of their largest
magnitude.  SyncBN and the stateful trainer are
in ``tests/test_torch_syncbn.py``.
"""

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.models import mlp as torch_mlp
from adapcc_tpu_torch.models import resnet as torch_resnet
from adapcc_tpu_torch.models import vgg as torch_vgg
from adapcc_tpu_torch.models import vit as torch_vit
from adapcc_tpu_torch.models.convert import flax_paths, flax_to_state_dict, to_flax_variables

F32_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-5
BF16_TOL = 4e-2


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
    """The flax variables of a seeded port model (their round trip exact)."""
    variables = to_flax_variables(tmodel)
    back = flax_to_state_dict(variables)
    assert all(torch.equal(back[k].float(), v.float()) for k, v in tmodel.state_dict().items())
    return variables


def _load(tmodel, variables):
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return tmodel


def _apply(jm, **kw):
    import jax

    return jax.jit(lambda v, x: jm.apply(v, x, **kw))


def _flax_leaf_paths(params):
    import jax

    return sorted("/".join(str(k.key) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0])


def _grads_by_flax_path(tmodel):
    """The torch gradients in the flax leaves' layouts, keyed by flax path."""
    from adapcc_tpu_torch.models.convert import to_flax_layout

    paths = flax_paths(tmodel)
    out = {}
    for name, p in tmodel.named_parameters():
        path, transposed = paths[name]
        out["/".join(path)] = (to_flax_layout(p.grad) if transposed else p.grad).detach().numpy()
    return out


def _xent(logits, labels):
    return torch.nn.functional.cross_entropy(logits, torch.as_tensor(labels))


def _jax_loss_and_grads(apply, variables, x, y):
    import jax
    import jax.numpy as jnp
    import optax

    def loss(p):
        return optax.softmax_cross_entropy_with_integer_labels(apply({"params": p}, jnp.asarray(x)),
                                                                jnp.asarray(y)).mean()

    val, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    flat = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(val), flat


def _assert_grads(got, jgrads, what=""):
    assert sorted(got) == sorted(jgrads)
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in jgrads.values())
    for k, g in jgrads.items():
        err = np.abs(got[k].reshape(g.shape).astype(np.float64) - g).max()
        bound = GRAD_RTOL * np.abs(g).max() + floor
        assert err <= bound, f"{what}grad {k}: max |diff| {err:.3e} > {bound:.3e}"


def test_mlp_logits_and_grads_match_jax():
    from adapcc_tpu.models.mlp import MLP

    x, y = _images(size=4).reshape(4, -1), _labels()
    jm = MLP(features=(32, 16, 10))
    tm = torch_mlp.MLP(x.shape[1], (32, 16, 10), device="cpu")
    v = _init(tm)
    _close(tm(torch.from_numpy(x)).detach().numpy(), _apply(jm)(v, x), F32_RTOL, "mlp logits")
    loss_j, grads_j = _jax_loss_and_grads(jm.apply, v, x, y)
    loss_t = _xent(tm(torch.from_numpy(x)), y)
    loss_t.backward()
    assert abs(loss_t.item() - loss_j) <= 1e-6
    _assert_grads(_grads_by_flax_path(tm), grads_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg11_logits_match_jax(dtype):
    """VGG flattens NHWC: ``fc1`` needs no permutation when converted."""
    import jax.numpy as jnp

    from adapcc_tpu.models.vgg import VGG11

    x = _images(size=32)
    jm = VGG11(num_classes=10, classifier_width=16, dtype=getattr(jnp, dtype))
    tm = torch_vgg.VGG11(num_classes=10, classifier_width=16, dtype=getattr(torch, dtype), image_size=32,
                         device="cpu")
    v = _init(tm)
    tol = F32_RTOL if dtype == "float32" else BF16_TOL
    _close(tm(torch.from_numpy(x)).float().detach().numpy(), np.asarray(_apply(jm)(v, x), np.float32), tol, "vgg")


WIDTH = {18: 8, 50: 16}
RESNET_CASES = [
    # (depth, norm, small_inputs, image size)
    (18, "group", True, 16),
    (18, "batch", True, 16),
    (18, "group", False, 64),
    (18, "batch", False, 64),
    (50, "group", False, 64),
    (50, "batch", True, 16),
]


def _flax_paths_of(tree):
    import jax

    return {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("depth,norm,small,size", RESNET_CASES)
def test_resnet_logits_and_grads_match_jax(depth, norm, small, size):
    """Eval-mode logits (BatchNorm on its running statistics); in train
    mode (batch statistics) the loss, the running statistics after the
    forward and, for ResNet-18, the gradients of a cross-entropy."""
    import jax
    import jax.numpy as jnp
    import optax

    from adapcc_tpu.models import resnet as jax_resnet

    x, y = _images(size=size), _labels()
    kw = dict(num_classes=10, width=8, small_inputs=small, norm=norm)
    jm = getattr(jax_resnet, f"ResNet{depth}")(dtype=jnp.float32, **kw)
    tm = getattr(torch_resnet, f"ResNet{depth}")(dtype=torch.float32, device="cpu", **kw)
    with torch.no_grad():  # running statistics away from (0, 1), so eval mode uses them
        for name, b in tm.named_buffers():
            b.copy_(torch.rand(b.shape, generator=torch.Generator().manual_seed(len(name))) + 0.5)
    v = _init(tm)
    tm.eval()
    _close(tm(torch.from_numpy(x)).detach().numpy(), _apply(jm)(v, x), F32_RTOL, "eval logits")

    def loss(p):
        if norm == "batch":
            logits, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        else:
            logits, upd = jm.apply({"params": p}, jnp.asarray(x), train=True), {}
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean(), upd

    tm.train()
    loss_t = _xent(tm(torch.from_numpy(x)), y)
    if depth == 18:
        (loss_j, upd), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        loss_t.backward()
        _assert_grads(_grads_by_flax_path(tm), _flax_paths_of(grads))
    else:
        loss_j, upd = jax.jit(loss)(v["params"])
    assert abs(loss_t.item() - float(loss_j)) <= F32_RTOL * max(1.0, abs(float(loss_j)))
    if norm == "batch":
        stats = flax_to_state_dict({"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                                         upd["batch_stats"])})
        buffers = dict(tm.named_buffers())
        assert sorted(stats) == sorted(buffers)
        for k, s in stats.items():
            _close(buffers[k].numpy(), s.numpy(), F32_RTOL, f"running stat {k}")


def test_resnet_bf16_logits_match_jax():
    import jax.numpy as jnp

    from adapcc_tpu.models.resnet import ResNet18

    x = _images(size=16)
    kw = dict(num_classes=10, width=8, small_inputs=True, norm="group")
    jm = ResNet18(dtype=jnp.bfloat16, **kw)
    tm = torch_resnet.ResNet18(dtype=torch.bfloat16, device="cpu", **kw).eval()
    v = _init(tm)
    _close(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(_apply(jm)(v, x)), BF16_TOL, "bf16 resnet logits")


def test_same_padding_is_flax_s():
    assert torch_resnet.same_pads(16, 3, 2) == (0, 1)
    assert torch_resnet.same_pads(16, 3, 1) == (1, 1)
    assert torch_resnet.same_pads(15, 3, 2) == (1, 1)
    assert torch_resnet.same_pads(16, 1, 2) == (0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_logits_and_grads_match_jax(dtype):
    import jax.numpy as jnp

    from adapcc_tpu.models.vit import ViT, ViTConfig

    x, y = _images(size=32), _labels()
    jm = ViT(ViTConfig(**{**ViTConfig.tiny().__dict__, "dtype": getattr(jnp, dtype)}))
    tcfg = torch_vit.ViTConfig(**{**torch_vit.ViTConfig.tiny().__dict__, "dtype": getattr(torch, dtype)})
    tm = torch_vit.ViT(tcfg, device="cpu")
    v = _init(tm)
    tol = F32_RTOL if dtype == "float32" else BF16_TOL
    _close(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(_apply(jm)(v, x), np.float32), tol, "vit logits")
    if dtype == "float32":
        loss_j, grads_j = _jax_loss_and_grads(jm.apply, v, x, y)
        loss_t = _xent(tm(torch.from_numpy(x)), y)
        loss_t.backward()
        assert abs(loss_t.item() - loss_j) <= 1e-5
        _assert_grads(_grads_by_flax_path(tm), grads_j)
