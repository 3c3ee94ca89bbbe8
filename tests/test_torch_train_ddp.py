"""``train_ddp``'s presets in the port, per model and data-parallel mode.

Every ``--model`` preset has the JAX package's shapes (its parameter tree,
leaf for leaf, against ``jax.eval_shape`` of the flax module
``make_workload`` builds, with the same constructor arguments), and trains
at world 1 under ``ddp``, ``zero1`` and ``fsdp`` from the same seeded
weights on the same batch: at world 1 the three modes compute one function,
so their logged losses agree within ``MODE_RTOL`` (float32 sums in another
order where the trainer flattens or shards).
"""

import numpy as np
import pytest

from adapcc_tpu_torch.comm.mesh import destroy_world
from adapcc_tpu_torch.models.convert import flax_paths
from adapcc_tpu_torch.workloads import train_ddp

MODE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _leave_no_world():
    """A workload joins a process group (a world of one here) and keeps it,
    as JAX's keeps its mesh; leave none behind for the next test in this
    process."""
    yield
    destroy_world()


def _jax_model(name):
    import jax.numpy as jnp

    if name == "mlp":
        from adapcc_tpu.models import MLP

        return MLP(features=(64, 64, 10)), (1, 32)
    if name == "vgg":
        from adapcc_tpu.models.vgg import VGG16

        return VGG16(num_classes=10, classifier_width=512), (1, 32, 32, 3)
    if name in ("resnet18", "resnet50"):
        from adapcc_tpu.models.resnet import ResNet18, ResNet50

        ctor = ResNet18 if name == "resnet18" else ResNet50
        return ctor(num_classes=10, small_inputs=True, dtype=jnp.float32), (1, 32, 32, 3)
    if name == "vit":
        from adapcc_tpu.models.vit import ViT, ViTConfig

        cfg = ViTConfig(image_size=64, patch_size=8, num_classes=100, d_model=192, n_layer=6, n_head=3)
        return ViT(cfg), (1, 64, 64, 3)
    from adapcc_tpu.models.gpt2 import GPT2, GPT2Config

    return GPT2(GPT2Config(vocab_size=8192, max_seq=256, n_layer=4, n_head=4, d_model=256)), (1, 256)


def _dense_general_as_linear(key, shape):
    """flax MHA's ``DenseGeneral`` leaves as the port's ``Linear`` leaves:
    kernels ``[d, h, hd]`` → ``[d, h·hd]`` and ``[h, hd, d]`` → ``[h·hd,
    d]``, biases ``[h, hd]`` → ``[h·hd]``."""
    if "/attn/" not in key or len(shape) < 2:
        return shape
    if key.endswith("out/kernel"):
        return (shape[0] * shape[1], shape[2])
    if key.endswith("kernel"):
        return (shape[0], shape[1] * shape[2])
    return (shape[0] * shape[1],)


@pytest.mark.parametrize("name", train_ddp.MODELS)
def test_preset_shapes_match_jax(name):
    import jax
    import jax.numpy as jnp

    from adapcc_tpu_torch.models.convert import flax_shape

    jm, shape = _jax_model(name)
    dummy = jax.ShapeDtypeStruct(shape, jnp.int32 if name == "gpt2" else jnp.float32)
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), dummy)["params"]
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    _, model, _ = train_ddp.make_workload(name, 4, "cpu")
    paths = flax_paths(model)
    got = {}
    for n, p in model.named_parameters():
        path, transposed = paths[n]
        got["/".join(path)] = flax_shape(tuple(p.shape)) if transposed else tuple(p.shape)
    if name == "vit":
        want = {k: _dense_general_as_linear(k, v) for k, v in want.items()}
    assert got == want


@pytest.mark.parametrize("name", train_ddp.MODELS)
def test_preset_trains_alike_under_ddp_zero1_and_fsdp(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the bootstrap writes its topology files here
    runs = {}
    for mode in ("ddp", "zero1", "fsdp"):
        runs[mode] = train_ddp.main(["--device", "cpu", "--model", name, "--dp-mode", mode, "--steps", "2",
                                     "--batch", "4", "--min-shard-elems", "4096"])

    assert len(runs["ddp"]) == 2 and np.isfinite(runs["ddp"]).all()
    for mode in ("zero1", "fsdp"):
        np.testing.assert_allclose(runs[mode], runs["ddp"], rtol=MODE_RTOL, err_msg=mode)
