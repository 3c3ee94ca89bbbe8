"""The port's memory-lean GPT-2 knobs held against the JAX package's.

A tiny GPT-2 (vocab 256, T=32, 2 layers, 2 heads, d_model 64) from a flax
tree of seeded numpy values, converted with ``models/convert.py``:

- each remat policy (``"full"``, ``"dots"``, ``"dots_no_batch"``) gives the
  model without remat's logits and gradients bit for bit, and JAX's remat
  model's within the GPT-2 parity tolerance of ``tests/test_torch_gpt2.py``
  (logits 1e-5, loss 1e-6) and, for the gradients, the chunked loss's
  gradient tolerance of ``tests/test_chunked_ce.py`` (3e-6); an unknown
  policy raises JAX's ``ValueError``;
- dropout: deterministic (and ``eval()``) equals dropout 0 exactly, the
  same generator gives the same output and gradients (with and without
  remat, whose recomputation draws the same masks), each site keeps about
  ``1 - p`` of its elements, and ``attention="flash"`` takes the
  materialized attention at ``dropout > 0``, as JAX routes it;
- ``lm_loss_chunked`` against JAX's: float32 to ``tests/test_chunked_ce.py``'s
  tolerances (values rtol 2e-6, gradients atol 3e-6), the bfloat16 head
  within its 2 % of the value, on a vocabulary that is a multiple of the
  block and one that is not.
"""

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.models import gpt2 as port_gpt2
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config, _dropout, lm_loss, lm_loss_chunked
from adapcc_tpu_torch.ops.chunked_ce import chunked_softmax_xent

TINY = dict(vocab_size=256, max_seq=32, n_layer=2, n_head=2, d_model=64)
LOGITS_ATOL = 1e-5
LOSS_ATOL = 1e-6
GRAD_ATOL = 3e-6
CHUNK_RTOL = 2e-6
BF16_REL = 0.02
POLICIES = ("full", "dots", "dots_no_batch")


@pytest.fixture(scope="module")
def params_and_tokens():
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig

    tokens = np.random.default_rng(3).integers(0, TINY["vocab_size"], size=(2, TINY["max_seq"]))
    tree = jax.eval_shape(JGPT2(JConfig(**TINY, dtype=jnp.float32)).init, jax.random.PRNGKey(0),
                          jnp.asarray(tokens[:1], jnp.int32))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        noise = (rng.normal(size=leaf.shape) * 0.05).astype(np.float32)
        return noise + 1 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, tree), tokens


def _port(params, **cfg):
    model = GPT2(GPT2Config(**TINY, dtype=torch.float32, **cfg), device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(params))
    return model


def _logits_and_grads(model, tokens, **forward_kw):
    t = torch.from_numpy(tokens)
    model.zero_grad(set_to_none=True)
    logits = model(t, **forward_kw)
    lm_loss(logits, t).backward()
    return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _jax_logits_loss_grads(params, tokens, **cfg):
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.models.gpt2 import lm_loss as jloss

    model = JGPT2(JConfig(**TINY, dtype=jnp.float32, **cfg))
    toks = jnp.asarray(tokens, jnp.int32)

    def loss_and_logits(p):
        logits = model.apply(p, toks)
        return jloss(logits, toks), logits

    (loss, logits), grads = jax.value_and_grad(loss_and_logits, has_aux=True)(params)
    return np.asarray(logits), float(loss), flax_to_state_dict(jax.device_get(grads))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_is_the_plain_model_and_jax_remat(params_and_tokens, policy):
    params, tokens = params_and_tokens
    plain_logits, plain_grads = _logits_and_grads(_port(params), tokens)
    logits, grads = _logits_and_grads(_port(params, remat=True, remat_policy=policy), tokens)
    assert torch.equal(logits, plain_logits)
    assert all(torch.equal(grads[n], plain_grads[n]) for n in grads)
    j_logits, j_loss, j_grads = _jax_logits_loss_grads(params, tokens, remat=True, remat_policy=policy)
    np.testing.assert_allclose(logits.numpy(), j_logits, atol=LOGITS_ATOL)
    np.testing.assert_allclose(lm_loss(logits, torch.from_numpy(tokens)).item(), j_loss, atol=LOSS_ATOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(), atol=GRAD_ATOL, err_msg=name)


def test_unknown_remat_policy_raises_as_jax(params_and_tokens):
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig

    params, tokens = params_and_tokens
    with pytest.raises(ValueError) as pe:
        GPT2Config(**TINY, remat=True, remat_policy="some")
    with pytest.raises(ValueError) as je:
        JGPT2(JConfig(**TINY, dtype=jnp.float32, remat=True, remat_policy="some")).apply(
            params, jnp.asarray(tokens, jnp.int32))
    assert str(pe.value) == str(je.value)
    # a policy is only read with remat on, in both packages
    assert GPT2Config(**TINY, remat_policy="some").remat is False


def test_dropout_is_deterministic_where_asked_and_replays_under_one_generator(params_and_tokens):
    params, tokens = params_and_tokens
    plain_logits, plain_grads = _logits_and_grads(_port(params), tokens)
    drop = _port(params, dropout=0.1)
    for kw in ({"deterministic": True}, {}):
        if not kw:
            drop.eval()
        logits, grads = _logits_and_grads(drop, tokens, **kw)
        assert torch.equal(logits, plain_logits) and all(torch.equal(grads[n], plain_grads[n]) for n in grads)
    drop.train()
    runs = {}
    for name, model, seed in (("a", drop, 1), ("b", drop, 1), ("c", drop, 2),
                              ("remat", _port(params, dropout=0.1, remat=True, remat_policy="dots"), 1)):
        runs[name] = _logits_and_grads(model, tokens, generator=torch.Generator().manual_seed(seed))
    for other in ("b", "remat"):
        assert torch.equal(runs[other][0], runs["a"][0])
        assert all(torch.equal(runs[other][1][n], runs["a"][1][n]) for n in plain_grads), other
    assert not torch.equal(runs["c"][0], runs["a"][0])
    assert not torch.equal(runs["a"][0], plain_logits)
    # the model's own generator stands in for an explicit one
    drop.dropout_generator = torch.Generator().manual_seed(1)
    assert torch.equal(_logits_and_grads(drop, tokens)[0], runs["a"][0])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_one_minus_p_and_scales_like_flax(p):
    x = torch.ones(200_000)
    y = _dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert _dropout(x, 0.0, torch.Generator()) is x and torch.equal(_dropout(x, 1.0, torch.Generator()),
                                                                       torch.zeros_like(x))


def test_flash_runs_only_without_dropout(params_and_tokens, monkeypatch):
    params, tokens = params_and_tokens
    calls = []
    real = port_gpt2.flash_attention
    monkeypatch.setattr(port_gpt2, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    flash = _port(params, attention="flash", flash_block=32)
    flash(torch.from_numpy(tokens))
    assert len(calls) == TINY["n_layer"]
    _port(params, attention="flash", flash_block=32, dropout=0.1)(torch.from_numpy(tokens),
                                                                  generator=torch.Generator().manual_seed(0))
    assert len(calls) == TINY["n_layer"]


@pytest.mark.parametrize("block", [64, 96], ids=["multiple", "ragged"])
def test_lm_loss_chunked_matches_jax_float32(params_and_tokens, block):
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.models.gpt2 import GPT2 as JGPT2
    from adapcc_tpu.models.gpt2 import GPT2Config as JConfig
    from adapcc_tpu.models.gpt2 import lm_loss_chunked as jchunked

    params, tokens = params_and_tokens
    model = _port(params)
    t = torch.from_numpy(tokens)
    loss = lm_loss_chunked(model, t, block=block)
    loss.backward()
    dense = lm_loss(_port(params)(t), t)
    jmodel = JGPT2(JConfig(**TINY, dtype=jnp.float32))
    j_loss, j_grads = jax.value_and_grad(lambda p: jchunked(jmodel, p, jnp.asarray(tokens, jnp.int32),
                                                            block=block))(params)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=CHUNK_RTOL)
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=CHUNK_RTOL)
    j_grads = flax_to_state_dict(jax.device_get(j_grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(), atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("block", [64, 96], ids=["multiple", "ragged"])
def test_chunked_xent_bf16_head_matches_jax(block):
    import jax.numpy as jnp

    from adapcc_tpu.ops.chunked_ce import chunked_softmax_xent as jxent

    rng = np.random.default_rng(1)
    x = rng.normal(size=(24, 16)).astype(np.float32)
    w = (rng.normal(size=(TINY["vocab_size"], 16)) * 0.3).astype(np.float32)
    y = rng.integers(0, TINY["vocab_size"], size=(24,))
    got = chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y), block, torch.bfloat16)
    want = float(jxent(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y, jnp.int32), block, jnp.bfloat16))
    assert abs(got.item() - want) / want < BF16_REL
    dense = chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
                                 TINY["vocab_size"], torch.float32)
    assert abs(got.item() - dense.item()) / dense.item() < BF16_REL
