"""The port's KV-cache decode, samplers and ``generate`` held against the
JAX package's.

A tiny float32 GPT-2 (vocab 64, max_seq 16, 2 layers, 4 heads, d_model 32)
gets a flax parameter tree (flax's structure, seeded numpy values),
converted with ``adapcc_tpu_torch.models.convert``.  Teacher-forced decode
logits agree with JAX's (jitted) to ``LOGITS_ATOL``, and the cached decode
with the port's own full forward to the same bound; the filters' masks and
greedy picks are JAX's bit for bit, and greedy ``generate`` streams (EOS
handling and overflow included) are JAX's token for token.  Sampled
streams are held within the port: torch's generators are not threefry.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapcc_tpu.models import gpt2_generate as jgen
from adapcc_tpu.models.gpt2 import GPT2 as JaxGPT2
from adapcc_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from adapcc_tpu_torch.checkpoint import TrainCheckpointState, save_checkpoint
from adapcc_tpu_torch.models import gpt2_generate as tgen
from adapcc_tpu_torch.models.convert import flax_to_state_dict
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config

LOGITS_ATOL = 1e-5
TINY = dict(vocab_size=64, max_seq=16, n_layer=2, n_head=4, d_model=32)


def flax_tree(cfg: dict, seed: int):
    """A flax GPT-2 tree (flax's names and shapes, from ``eval_shape``) with
    seeded numpy values, and its JAX model."""
    model = JaxGPT2(JaxGPT2Config(**cfg, dtype=jnp.float32))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = (rng.normal(size=leaf.shape) * 0.2).astype(np.float32)
        return noise + 1 if path[-1].key == "scale" else noise

    return model, jax.tree_util.tree_map_with_path(fill, tree)


def port_model(cfg: dict, tree) -> GPT2:
    model = GPT2(GPT2Config(**cfg, dtype=torch.float32), device="cpu", seed=None)
    model.load_state_dict(flax_to_state_dict(tree))
    return model.eval()


@pytest.fixture(scope="module")
def pair():
    jmodel, tree = flax_tree(TINY, 0)
    return jmodel, tree["params"], port_model(TINY, tree)


def test_decode_logits_match_jax_teacher_forced(pair):
    jmodel, params, model = pair
    B, T = 2, TINY["max_seq"]
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], size=(B, T))
    cache = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((B, 1), jnp.int32), decode=True,
                        pos=jnp.zeros((), jnp.int32))["cache"]
    step = jax.jit(lambda c, tok, t: jmodel.apply({"params": params, "cache": c}, tok, decode=True, pos=t,
                                                  mutable=["cache"]))
    tcache = model.init_cache(B)
    for t in range(T):
        lj, mutated = step(cache, jnp.asarray(tokens[:, t : t + 1], jnp.int32), jnp.int32(t))
        cache = mutated["cache"]
        lt, tcache = model(torch.from_numpy(tokens[:, t : t + 1]), decode=True, pos=t, cache=tcache)
        assert lt.shape == (B, 1, TINY["vocab_size"]) and lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGITS_ATOL, err_msg=f"step {t}")
    assert tcache.index == T


def test_cached_decode_matches_full_forward(pair):
    _, _, model = pair
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, TINY["vocab_size"], size=(1, 12)))
    with torch.no_grad():
        full = model(tokens)
        cache = model.init_cache(1)
        for t in range(tokens.shape[1]):
            step, cache = model(tokens[:, t : t + 1], decode=True, pos=t, cache=cache)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(), atol=LOGITS_ATOL)
    # greedy generate reproduces greedy decoding by full forwards
    out = tgen.generate(model, tokens[:, :3], 3, 6, temperature=0.0)
    seq = tokens[0, :3].tolist()
    with torch.no_grad():
        for _ in range(6):
            seq.append(int(model(torch.tensor([seq]))[0, -1].argmax()))
    assert out[0].tolist() == seq


def test_decode_raises_like_jax(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="one token at a time"):
        model(torch.zeros((1, 2), dtype=torch.long), decode=True, pos=0)
    with pytest.raises(ValueError, match="needs pos"):
        model(torch.zeros((1, 1), dtype=torch.long), decode=True)


def _mask_equal(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isneginf(port.numpy()), np.isneginf(ref))
    np.testing.assert_array_equal(port.numpy(), ref)  # kept logits untouched, -inf elsewhere


def test_filters_and_greedy_match_jax_bitwise():
    """The masks and kept logits equal JAX's.  Nucleus filtering compares a
    softmax's running sum with ``p``; the two frameworks sum in other
    orders, so at ``p = 1`` a random row's tail is cut wherever rounding
    carries its prefix past 1, at other places in each: ``p = 1`` is held on
    JAX's own hand-made rows, where no rounding reaches the bound."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(6, 64)) * 3).astype(np.float32)
    logits[1, :8] = 2.5  # ties at the boundary
    lt, lj = torch.from_numpy(logits), jnp.asarray(logits)
    for k in (1, 5, 8, 64, 80):
        _mask_equal(tgen.filter_top_k(lt, k), jgen.filter_top_k(lj, k))
    for p in (0.0, 0.1, 0.5, 0.9, 0.999):
        _mask_equal(tgen.filter_top_p(lt, p), jgen.filter_top_p(lj, p))
    one_hot = np.array([[100.0, 0.0, 0.0, 0.0], [3.0, 2.0, 1.0, 0.0]], np.float32)
    for p in (0.1, 0.8, 0.9, 1.0):
        _mask_equal(tgen.filter_top_p(torch.from_numpy(one_hot), p), jgen.filter_top_p(jnp.asarray(one_hot), p))
    greedy = tgen.sample_token(lt, None, temperature=0.0, top_k=2, top_p=0.5)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgen.sample_token(jax.random.PRNGKey(0), lj, 0.0)))


def test_sampling_draws_every_call_and_pins_argmax():
    logits = torch.tensor([[0.0, 10.0, 0.0]])
    draws = {int(tgen.sample_token(logits, torch.Generator().manual_seed(i), temperature=1.0, top_k=1)) for i in range(5)}
    assert draws == {1}  # top_k=1 pins the argmax even when sampling
    varied = {int(tgen.sample_token(torch.tensor([[0.5, 2.0, 1.0]]), torch.Generator().manual_seed(i), temperature=2.0))
              for i in range(16)}
    assert len(varied) > 1


def test_greedy_generate_matches_jax(pair):
    jmodel, params, model = pair
    prompt = np.array([[5, 17, 3], [9, 2, 40]])
    ref = jgen.generate(jmodel, params, jnp.asarray(prompt, jnp.int32), 3, 8, temperature=0.0)
    out = tgen.generate(model, prompt, 3, 8, temperature=0.0)
    assert out.shape == (2, 11) and out.dtype == torch.long
    assert out.tolist() == np.asarray(ref).tolist()


def test_eos_latch_and_eos_in_prompt_match_jax(pair):
    jmodel, params, model = pair
    prompt = np.array([[5, 17, 3]])
    base = tgen.generate(model, prompt, 3, 8, temperature=0.0)[0]
    eos = int(base[3])  # the first greedily generated token
    ref = jgen.generate(jmodel, params, jnp.asarray(prompt, jnp.int32), 3, 8, temperature=0.0, eos_id=eos)
    out = tgen.generate(model, prompt, 3, 8, temperature=0.0, eos_id=eos)
    assert out.tolist() == np.asarray(ref).tolist()
    assert (out[0, 3:] == eos).all()
    # an EOS inside the forced prompt does not latch
    in_prompt = np.array([[eos, 1]])
    ref = jgen.generate(jmodel, params, jnp.asarray(in_prompt, jnp.int32), 2, 6, temperature=0.0, eos_id=eos)
    out = tgen.generate(model, in_prompt, 2, 6, temperature=0.0, eos_id=eos)
    assert out.tolist() == np.asarray(ref).tolist()
    assert out[0].tolist() != [eos] * 8


def test_generate_rejects_overflow(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="max_seq"):
        tgen.generate(model, torch.zeros((1, 16), dtype=torch.long), 16, 20)


def test_sampled_generate_is_seeded_and_draws_every_step(pair):
    """One ``[B, vocab]`` draw a position, prompt positions too (JAX splits
    its key on every step), from the generator given."""
    _, _, model = pair
    prompt = [[1, 2, 3], [3, 4, 5]]
    kw = dict(temperature=1.0, top_k=10)
    a = tgen.generate(model, prompt, 3, 5, generator=torch.Generator().manual_seed(7), **kw)
    b = tgen.generate(model, prompt, 3, 5, generator=torch.Generator().manual_seed(7), **kw)
    c = tgen.generate(model, prompt, 3, 5, generator=torch.Generator().manual_seed(8), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(7)
    tgen.generate(model, prompt, 3, 5, generator=gen, **kw)
    ref = torch.Generator().manual_seed(7)
    for _ in range(3 + 5 - 1):
        torch.rand((2, TINY["vocab_size"]), generator=ref)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=ref))


def test_byte_tokenizer_roundtrip():
    tok = tgen.ByteTokenizer()
    ids = tok.encode("héllo")
    assert ids[0] == tok.bos_id and tok.decode(ids) == "héllo" == tok.decode(ids + [tok.eos_id])


def test_interact_one_shot_from_a_port_checkpoint(tmp_path, capsys, monkeypatch):
    # no local BPE files either way: the byte tokenizer, without the import
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert isinstance(tgen.load_tokenizer(), tgen.ByteTokenizer)
    shape = ["--vocab", "258", "--seq", "16", "--layers", "1", "--heads", "2", "--dmodel", "32"]
    model = GPT2(GPT2Config(vocab_size=258, max_seq=16, n_layer=1, n_head=2, d_model=32, dtype=torch.float32),
                 device="cpu", seed=5)
    ckpt = str(tmp_path / "gpt2.ckpt")
    save_checkpoint(TrainCheckpointState(params=model.state_dict(), epoch=3), ckpt)
    tgen.interact(["--ckpt", ckpt, "--prompt", "hi", "--max-new-tokens", "4", "--temperature", "0",
                   "--device", "cpu", *shape])
    out = capsys.readouterr().out
    assert "loaded checkpoint (epoch 3)" in out
    with pytest.raises(SystemExit, match="incompatible"):
        tgen.interact(["--ckpt", ckpt, "--prompt", "hi", "--max-new-tokens", "4", "--device", "cpu",
                       "--vocab", "258", "--seq", "16", "--layers", "2", "--heads", "2", "--dmodel", "32"])
    with pytest.raises(SystemExit, match="not found or incompatible"):
        tgen.interact(["--ckpt", str(tmp_path / "nope.ckpt"), "--prompt", "x", "--device", "cpu", *shape,
                       "--max-new-tokens", "4"])
