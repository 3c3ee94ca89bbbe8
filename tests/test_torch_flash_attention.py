"""The port's flash attention held against the JAX package's.

The same numpy inputs go through ``adapcc_tpu.ops.flash_attention`` (its
Pallas kernels in interpret mode on the CPU, as tests/test_flash_attention.py
runs them) and ``adapcc_tpu_torch.ops.flash_attention`` (on CPU tensors, the
kernels' plain torch versions).  Tolerances are the JAX tests' own: 2e-5 on
the forward and lse, 5e-5 on the gradients, float32 throughout — the two
differ only in summation order.

The CUDA kernels run only on the card, where chip_smoke.py holds each against
its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapcc_tpu.ops import flash_attention as jax_flash
from adapcc_tpu.ops import flash_attention_with_lse as jax_flash_lse
from adapcc_tpu_torch.ops import flash_attention as fa

B, T, H, D = 2, 64, 2, 16
BLOCK = 32
FWD_ATOL = 2e-5
GRAD_ATOL = 5e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, T, H, D)).astype(np.float32) * 0.5 for _ in range(4))
    dlse = rng.normal(size=(B, H, T)).astype(np.float32)
    return q, k, v, do, dlse


def _torch_leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_jax(causal):
    q, k, v, do, _ = _inputs()

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)
        return jnp.vdot(out, do), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)

    tq, tk, tv = _torch_leaves(q, k, v)
    out_t = fa.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK, block_k=BLOCK)
    (out_t * torch.from_numpy(do)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=FWD_ATOL)
    for name, t, j in zip("qkv", (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_with_lse_and_its_cotangent_match_jax(causal):
    """``lse`` and a ``dlse`` cotangent (folded in as ``delta − dlse``)."""
    q, k, v, do, dlse = _inputs(seed=1)

    def jax_loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)
        return jnp.vdot(out, do) + jnp.vdot(lse, dlse), (out, lse)

    (_, (out_j, lse_j)), grads_j = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True
    ))(q, k, v)

    tq, tk, tv = _torch_leaves(q, k, v)
    out_t, lse_t = fa.flash_attention_with_lse(tq, tk, tv, causal=causal, block_q=BLOCK, block_k=BLOCK)
    assert lse_t.shape == (B, H, T)
    ((out_t * torch.from_numpy(do)).sum() + (lse_t * torch.from_numpy(dlse)).sum()).backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=FWD_ATOL)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j), atol=FWD_ATOL)
    for name, t, j in zip("qkv", (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_ATOL, err_msg=f"d{name}")


def test_custom_scale_matches_jax():
    q, k, v, _, _ = _inputs(seed=2)
    out_j = jax_flash(q, k, v, causal=True, scale=0.5, block_q=BLOCK, block_k=BLOCK)
    out_t = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, scale=0.5,
                               block_q=BLOCK, block_k=BLOCK)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=FWD_ATOL)


def test_argument_checks_match_jax():
    q = torch.zeros(B, 48, H, D)
    with pytest.raises(ValueError, match="divide into blocks"):
        fa.flash_attention(q, q, q, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="shapes differ"):
        fa.flash_attention(q, q[:, :16], q)
    # JAX rejects block 12 (Mosaic's 8-row tiling rule); the port has no
    # such constraint and keeps only the divisibility contract
    out = fa.flash_attention(q, q, q, block_q=12, block_k=12)
    assert out.shape == q.shape


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [40, 128])
def test_dq_at_head_dims_split_into_boxes_matches_jax(d, causal):
    """dq at head dims the bf16 dq kernel reads as 64-column TMA boxes with
    columns past D (40: one ragged box) and as two boxes (128): ``flash_dq``
    (its plain version, on CPU tensors) against the JAX package's VJP."""
    b, t, h = 1, 32, 2
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.normal(size=(b, t, h, d)).astype(np.float32) * 0.5 for _ in range(4))
    _, vjp = jax.vjp(lambda q: jax_flash(q, k, v, causal=causal, block_q=16, block_k=16), q)
    (dq_j,) = vjp(do)

    def bhtd(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(b * h, t, d).contiguous()

    tq, tk, tv, tdo = map(bhtd, (q, k, v, do))
    scale = d ** -0.5
    o, lse = fa.flash_fwd(tq, tk, tv, scale, causal)
    delta = (tdo * o).sum(-1)
    dq_t = fa.flash_dq(tq, tk, tv, tdo, lse, delta, scale, causal)
    np.testing.assert_allclose(dq_t.reshape(b, h, t, d).transpose(1, 2).numpy(), np.asarray(dq_j),
                               atol=GRAD_ATOL)


def test_kernel_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count nothing."""
    before = [w.launches for w in fa.KERNELS]
    q = torch.randn(2, 32, 16)
    o, lse = fa.flash_fwd(q, q, q, 0.25, True)
    fa.flash_dq(q, q, q, q, lse, lse, 0.25, True)
    fa.flash_dkv(q, q, q, q, lse, lse, 0.25, True)
    assert [w.launches for w in fa.KERNELS] == before



def _sweep_variants():
    from adapcc_tpu_torch.ops import flash_sweep

    return flash_sweep.VARIANTS


@pytest.mark.parametrize("name", sorted(_sweep_variants()))
def test_flash_sweep_variant_applies_to_the_source(name):
    """Each design variant ``ops/flash_sweep.py`` builds on the card is a set
    of literal substitutions on ``csrc/flash_attention.cu``: every one must
    find its text in the committed source and change it, or the variant
    would not build the design it names."""
    from adapcc_tpu_torch.ops import _build

    source = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    for old, new in _sweep_variants()[name]:
        assert old in source and new != old


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make, reason", [
    (lambda: _bf16(4, 200, 64), None),
    (lambda: _bf16(4, 200, 40), None),  # an 80-byte row pitch
    (lambda: _bf16(4, 1, 64), None),  # a length-1 axis's stride is free
    (lambda: torch.zeros(4, 200, 8), None),  # float32: a 32-byte pitch
    (lambda: _bf16(4 * 200 * 64 + 1)[1:].view(4, 200, 64), "16-byte aligned base"),
    (lambda: _bf16(4, 200, 12), "row pitch"),  # 24 bytes
    (lambda: _bf16(4, 16, 200, 64)[:, 0], "contiguous"),  # a row of a [B, H, T, D] batch
    (lambda: _bf16(4, 64, 200).transpose(1, 2), "contiguous"),
], ids=["bf16", "bf16-d40", "t1", "float32-d8", "misaligned", "pitch-24", "strided-rows", "transposed"])
def test_tma_layout_error(make, reason):
    """The layout the bf16 forward, dq and dk/dv kernels read through TMA maps,
    as a pure function of shape, strides, dtype and address: on a CUDA
    tensor the wrappers raise its message before any launch."""
    t = make()
    error = fa.tma_layout_error(t.shape, t.stride(), t.dtype, t.data_ptr())
    if reason is None:
        assert error is None
    else:
        assert reason in error
