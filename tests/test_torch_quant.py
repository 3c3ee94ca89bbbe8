"""The port's wire codecs (``adapcc_tpu_torch.quant``) held against the JAX
package's ``adapcc_tpu.quant``.

Codes and scales are compared bit for bit (int8 codes, float32 scales as
raw bits): both sides divide in IEEE float32 and round half to even.  The
unfused quant ring is compared with the JAX ppermute ring on the 4-device
CPU mesh: bf16 bit for bit (a cast and an add), int8 within 4 float32 ulps,
the reference's own bound between its data planes (XLA on the CPU may
contract a hop's decode-multiply and add into one FMA; the port rounds
twice), and every rank identical on both.  Inputs come from numpy with a
seed.  JAX is imported inside the functions that build references.
"""

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.quant import (
    DEFAULT_BLOCK_SIZE,
    WIRE_DTYPE_ENV,
    WireCodec,
    codec_names,
    dequantize_int8,
    error_feedback_step,
    get_codec,
    int8_error_bound,
    int8_roundtrip,
    quantize_int8,
    register_codec,
    resolve_wire_dtype,
    ring_error_bound,
    wire_ring_allreduce_stacked,
)

#: int8 against the JAX ring: the reference's contraction headroom
ULPS = 4


def _payload(n: int, block: int, seed: int = 0) -> np.ndarray:
    """Seeded normals with a zero block first, a block of exact .5 ties
    (block max 127, so the scale is 1 and every ``x / scale`` is a tie) and
    a ragged tail when ``n`` is not whole blocks."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 3).astype(np.float32)
    x[:block] = 0.0
    ties = rng.integers(-126, 126, size=block).astype(np.float32) + 0.5
    ties[0] = 127.0
    x[block:2 * block] = ties
    return x


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _assert_ulp_close(a: np.ndarray, b: np.ndarray, ulps: int = ULPS) -> None:
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    assert (np.abs(a - b) <= tol).all(), f"beyond {ulps} ulps: max diff {np.abs(a - b).max()}"


@pytest.mark.parametrize("block", [128, 256, 1024])
def test_quantize_int8_is_jax_bit_for_bit(block):
    import jax.numpy as jnp

    from adapcc_tpu.quant import dequantize_int8 as jax_dequantize
    from adapcc_tpu.quant import get_codec as jax_get_codec
    from adapcc_tpu.quant import quantize_int8 as jax_quantize

    x = _payload(7 * block + 77, block)
    q, s = quantize_int8(torch.from_numpy(x), block)
    jq, js = jax_quantize(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and q.shape == (8, block)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(_bits(s.numpy()), _bits(js))
    assert s[0] == 1.0 and not q[0].any()  # the zero block: scale 1, codes 0
    # the ties rounded half to even: codes are even where x / scale is a tie
    assert s[1] == 1.0 and not (q[1, 1:].numpy() % 2).any()
    deq = dequantize_int8(q, s, x.size).numpy()
    assert np.array_equal(_bits(deq), _bits(jax_dequantize(jq, js, x.size)))
    for name in ("off", "bf16", "int8"):
        got = get_codec(name).apply(torch.from_numpy(x), block)
        want = jax_get_codec(name).apply(jnp.asarray(x), block)
        assert np.array_equal(_bits(got.float().numpy()), _bits(np.asarray(want, np.float32))), name


def test_int8_error_bound_and_roundtrip_match_jax():
    import jax.numpy as jnp

    from adapcc_tpu.quant import int8_error_bound as jax_bound
    from adapcc_tpu.quant import int8_roundtrip as jax_roundtrip

    x = _payload(3000, DEFAULT_BLOCK_SIZE, seed=1)
    for stochastic in (False, True):
        assert np.array_equal(int8_error_bound(x, stochastic=stochastic), jax_bound(x, stochastic=stochastic))
    rt = int8_roundtrip(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(rt), _bits(jax_roundtrip(jnp.asarray(x))))
    assert (np.abs(rt - x) <= int8_error_bound(x)).all()
    # stochastic rounding: one code of floor or ceil of x / scale, from the
    # caller's generator, within a full step
    q, s = quantize_int8(torch.from_numpy(x), stochastic=True, generator=torch.Generator().manual_seed(0))
    sto = dequantize_int8(q, s, x.size).numpy()
    assert (np.abs(sto - x) <= int8_error_bound(x, stochastic=True) * (1 + 1e-6)).all()
    with pytest.raises(ValueError, match="Generator"):
        quantize_int8(torch.from_numpy(x), stochastic=True)


def test_error_feedback_step_keeps_the_mass_and_matches_jax():
    import jax.numpy as jnp

    from adapcc_tpu.quant import error_feedback_step as jax_ef
    from adapcc_tpu.quant import get_codec as jax_get_codec

    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(40, 33)).astype(np.float32), "b": rng.normal(size=300).astype(np.float32)}
    residual = {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32) for k, v in grads.items()}
    apply = get_codec("int8").apply
    wire, new_res = error_feedback_step({k: torch.from_numpy(v) for k, v in grads.items()},
                                        {k: torch.from_numpy(v) for k, v in residual.items()}, apply)
    j_wire, j_res = jax_ef({k: jnp.asarray(v) for k, v in grads.items()},
                           {k: jnp.asarray(v) for k, v in residual.items()}, jax_get_codec("int8").apply)
    for k in grads:
        # the invariant, exactly: wire + new residual == grads + residual
        assert np.array_equal((wire[k] + new_res[k]).numpy(), grads[k] + residual[k])
        assert np.array_equal(_bits(wire[k].numpy()), _bits(j_wire[k]))
        assert np.array_equal(_bits(new_res[k].numpy()), _bits(j_res[k]))
    # lists and single tensors are trees too
    w_list, r_list = error_feedback_step([torch.ones(3)], [torch.zeros(3)], apply)
    assert isinstance(w_list, list) and torch.equal(w_list[0] + r_list[0], torch.ones(3))


def test_resolve_wire_dtype_precedence_and_loud_typos(monkeypatch):
    from adapcc_tpu.quant import resolve_wire_dtype as jax_resolve

    monkeypatch.delenv(WIRE_DTYPE_ENV, raising=False)
    for arg, want in ((None, "off"), ("bf16", "bf16"), ("int8", "int8")):
        assert resolve_wire_dtype(arg) == jax_resolve(arg) == want
    monkeypatch.setenv(WIRE_DTYPE_ENV, "int8")  # the env wins over the argument
    assert resolve_wire_dtype("bf16") == jax_resolve("bf16") == "int8"
    monkeypatch.setenv(WIRE_DTYPE_ENV, "  ")  # blank is unset
    assert resolve_wire_dtype("bf16") == jax_resolve("bf16") == "bf16"
    monkeypatch.setenv(WIRE_DTYPE_ENV, "int4")
    with pytest.raises(ValueError, match=WIRE_DTYPE_ENV):
        resolve_wire_dtype("off")
    with pytest.raises(ValueError, match=WIRE_DTYPE_ENV):
        jax_resolve("off")
    monkeypatch.delenv(WIRE_DTYPE_ENV)
    with pytest.raises(ValueError, match="unknown wire codec 'fp8'"):
        resolve_wire_dtype("fp8")


def test_registry_matches_jax():
    from adapcc_tpu.quant import codec_names as jax_names
    from adapcc_tpu.quant import get_codec as jax_get_codec

    assert codec_names() == jax_names() == ("off", "bf16", "int8")
    for name in codec_names():
        for block in (128, 256, 1024):
            assert (get_codec(name).wire_bytes_per_element(block, 4.0)
                    == jax_get_codec(name).wire_bytes_per_element(block, 4.0))
    with pytest.raises(ValueError, match="already registered"):
        register_codec(WireCodec("int8", None, None, None, None))
    with pytest.raises(ValueError, match=r"registered codecs: off\|bf16\|int8"):
        get_codec("int4")


def _jax_quant_ring(xs: np.ndarray, wire: str, block: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.quant import wire_ring_allreduce_shard

    world = xs.shape[0]
    mesh = Mesh(jax.devices()[:world], ("ranks",))
    fn = jax.jit(jax.shard_map(
        lambda x: wire_ring_allreduce_shard(x[0], world, "ranks", wire, block)[None],
        mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"), check_vma=False))
    return np.asarray(fn(jnp.asarray(xs)))


@pytest.mark.parametrize("wire,block,n", [("int8", 256, 5000), ("int8", 128, 4 * 1024), ("bf16", 256, 3001)])
def test_quant_ring_matches_jax(wire, block, n):
    """The unfused quant ring, stacked, against the JAX ppermute ring: its
    own block-padded chunk layout (ragged payloads), the owner's adoption,
    forwarded bits."""
    from adapcc_tpu.quant import ring_error_bound as jax_ring_error_bound

    xs = (np.random.default_rng(3).normal(size=(4, n)) * 20).astype(np.float32)
    got = wire_ring_allreduce_stacked(torch.from_numpy(xs), wire, block).numpy()
    want = _jax_quant_ring(xs, wire, block)
    if wire == "bf16":
        assert np.array_equal(_bits(got), _bits(want))
    else:
        _assert_ulp_close(got, want)
        assert np.array_equal(ring_error_bound(xs, block_size=block), jax_ring_error_bound(xs, block_size=block))
        assert (np.abs(got[0] - xs.sum(0)) <= ring_error_bound(xs, block_size=block)).all()
    for out in (got, want):
        for r in range(1, 4):
            assert np.array_equal(out[r], out[0])


def test_quant_ring_world_one_and_shapes():
    x = torch.randn(1, 3, 5)
    assert wire_ring_allreduce_stacked(x) is x
    xs = torch.randn(2, 3, 5, dtype=torch.bfloat16)
    out = wire_ring_allreduce_stacked(xs, "int8", 128)
    assert out.shape == xs.shape and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown wire codec"):
        wire_ring_allreduce_stacked(xs, "fp8")
