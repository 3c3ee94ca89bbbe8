"""The port's GPT-2 held against the JAX package's, from converted weights.

A tiny float32 GPT-2 (vocab 512, T=64, 2 layers, 2 heads, d_model 64) gets
a flax parameter tree (flax's structure, seeded numpy values), converted with
``adapcc_tpu_torch.models.convert``, and both models run the same numpy
tokens.  Logits agree to 1e-5 and the loss to 1e-6: float32 on both sides,
so only summation order (and flax's one-pass LayerNorm variance) differ.
The flash configuration runs the JAX kernels in interpret mode and the
port's plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from adapcc_tpu.models.gpt2 import lm_loss as jax_lm_loss
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, lm_loss

LOGITS_ATOL = 1e-5
LOSS_ATOL = 1e-6
TINY = dict(vocab_size=512, max_seq=64, n_layer=2, n_head=2, d_model=64)


@pytest.fixture(scope="module")
def flax_params_and_tokens():
    tokens = np.random.default_rng(3).integers(0, TINY["vocab_size"], size=(2, TINY["max_seq"]))
    model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32))
    # flax's own tree (names, shapes) with seeded numpy values: nonzero
    # biases and LayerNorm parameters exercise every converted leaf, and
    # eval_shape costs no compile
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(tokens[:1], jnp.int32))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        noise = (rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
        return noise + 1 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, tree), tokens


def test_converted_state_dict_covers_the_model(flax_params_and_tokens):
    params, _ = flax_params_and_tokens
    sd = flax_to_state_dict(params)
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32), device="cpu", seed=None)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # Dense [in, out] kernels become transposed Linear weights
    np.testing.assert_array_equal(
        sd["h0.attn.qkv.weight"].numpy(), params["params"]["h0"]["attn"]["qkv"]["kernel"].T
    )


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_logits_and_loss_match_jax(flax_params_and_tokens, attention):
    params, tokens = flax_params_and_tokens
    jax_model = JaxGPT2(JaxGPT2Config(**TINY, dtype=jnp.float32, attention=attention, flash_block=32))
    jax_tokens = jnp.asarray(tokens, jnp.int32)
    logits_j = jax.jit(jax_model.apply)(params, jax_tokens)
    loss_j = jax_lm_loss(logits_j, jax_tokens)

    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, attention=attention, flash_block=32),
                 device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        t_tokens = torch.from_numpy(tokens)
        logits_t = model(t_tokens)
        loss_t = lm_loss(logits_t, t_tokens)

    assert logits_t.dtype == torch.float32 and logits_t.shape == (2, TINY["max_seq"], TINY["vocab_size"])
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=LOGITS_ATOL)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=LOSS_ATOL)


def test_bf16_config_keeps_the_reference_dtypes():
    """Linear layers and attention compute in bf16, LayerNorm in float32,
    logits come out float32 (the flax dtype points)."""
    cfg = GPT2Config(**TINY, dtype=torch.bfloat16)
    model = GPT2(cfg, device="cpu", seed=0).to(torch.bfloat16)
    seen = {}
    model.h0.attn.register_forward_hook(lambda m, i, o: seen.update(attn_in=i[0].dtype, attn_out=o.dtype))
    logits = model(torch.zeros(1, 8, dtype=torch.long))
    assert seen == {"attn_in": torch.float32, "attn_out": torch.bfloat16}
    assert logits.dtype == torch.float32
    assert model.h0.ln1.eps == 1e-6


def test_seeded_init_is_reproducible():
    cfg = GPT2Config(**TINY, dtype=torch.float32)
    a = GPT2(cfg, device="cpu", seed=5).state_dict()
    b = GPT2(cfg, device="cpu", seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["h0.ln1.weight"] == 1) and torch.all(a["h1.fc.bias"] == 0)
    # residual projections use the scaled GPT-2 std 0.02/sqrt(2·n_layer)
    assert abs(a["h0.proj.weight"].std().item() - 0.01) < 1e-3
