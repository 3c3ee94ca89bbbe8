"""Blockwise (flash) causal attention: CUDA kernels for Hopper.

The port of :mod:`adapcc_tpu.ops.flash_attention`.  Attention is computed
with the online-softmax recurrence, never materializing ``[T, T]`` in device
memory, and the backward pass rebuilds ``p_ij = exp(s_ij − lse_i)`` from the
saved logsumexp::

    s_ij   = q_i k_j^T · scale
    m'     = max(m, rowmax(s_ij)),  p_ij = exp(s_ij − m')
    l      = l·exp(m − m') + rowsum(p_ij)
    acc    = acc·exp(m − m') + p_ij v_j
    o_i    = acc / l ;  lse_i = m + log l

    Δ_i    = rowsum(do_i ∘ o_i) − dlse_i
    ds_ij  = p_ij · (do_i v_j^T − Δ_i) · scale
    dq_i   = Σ_j ds_ij k_j ;  dk_j = Σ_i ds_ij q_i ;  dv_j = Σ_i p_ij do_i

Three kernels (``csrc/flash_attention.cu``) replace the three Pallas
kernels: :func:`flash_fwd` (``_fwd_kernel``), :func:`flash_dq`
(``_dq_kernel``) and :func:`flash_dkv` (``_dkv_kernel``).  Each wrapper takes
its kernel for CUDA tensors and its plain torch version (``_fwd_plain``,
``_dq_plain``, ``_dkv_plain``: the same formulas, in float32) for CPU
tensors, and counts its kernel launches in ``<wrapper>.launches``.

The Pallas lane padding of the per-row statistics and its 8-alignment rule
for block sizes are Mosaic constraints and have no counterpart here; the
CUDA kernels pick their own tiles, and ``block_q``/``block_k`` keep the
reference's contract that ``T`` divides into them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 128


# --------------------------------------------------------------------------- #
# plain torch versions: the kernels' formulas, in float32
# --------------------------------------------------------------------------- #


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool) -> torch.Tensor:
    """``s = q k^T · scale`` in float32 over ``[BH, T, D]``, masked to -1e30
    above the diagonal under ``causal``."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        T = q.shape[1]
        above = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, _NEG_INF)
    return s


def _fwd_plain(q, k, v, scale: float, causal: bool):
    """``(o, lse)`` of :func:`flash_fwd`."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
    o = torch.matmul(torch.exp(s - lse), v.float())
    return o.to(q.dtype), lse.squeeze(-1)


def _ds(q, k, v, do, lse, delta, scale: float, causal: bool):
    """``(p, ds)`` rebuilt from the residuals, as both backward kernels do."""
    p = torch.exp(_scores(q, k, scale, causal) - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta.unsqueeze(-1)) * scale


def _dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    """``dq`` of :func:`flash_dq`."""
    _, ds = _ds(q, k, v, do, lse, delta, scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    """``(dk, dv)`` of :func:`flash_dkv`."""
    p, ds = _ds(q, k, v, do, lse, delta, scale, causal)
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #


def tma_layout_error(shape, strides, dtype: torch.dtype, address: int) -> Optional[str]:
    """Why a ``[BH, T, D]`` operand cannot be read through a TMA tensor map
    (the bf16 forward, dq and dk/dv kernels build one per operand from its
    base pointer and shape), or ``None``: the kernels take a contiguous
    layout, a 16-byte aligned base, and a row pitch (``D`` elements) that is
    a multiple of 16 bytes.  The float32 dq and dk/dv copy rows in 16-byte
    ``cp.async`` chunks, which need the same."""
    _, T, D = shape
    if any(n > 1 and s != want for n, s, want in zip(shape, strides, (T * D, D, 1))):
        return f"flash kernels need a contiguous [BH, T, D] layout, got strides {tuple(strides)}"
    if address % 16:
        return f"flash kernels need a 16-byte aligned base, got address {address:#x}"
    pitch = D * dtype.itemsize
    if pitch % 16:
        return f"flash kernels need a row pitch that is a multiple of 16 bytes, got {pitch}"
    return None


def _check_kernel_inputs(*tensors: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take."""
    ref = tensors[0]
    if ref.device.type != "cuda":
        raise ValueError(f"flash kernels run on CUDA or CPU tensors, got {ref.device}")
    if ref.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {ref.dtype}")
    _, _, D = ref.shape
    if D % 8 or D > _MAX_HEAD_DIM:
        raise ValueError(
            f"flash kernels need head_dim a multiple of 8 and at most "
            f"{_MAX_HEAD_DIM}, got {D}"
        )
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(
                f"flash kernel operands differ: {t.device} {t.dtype} "
                f"{tuple(t.shape)} vs {ref.device} {ref.dtype} {tuple(ref.shape)}"
            )
        error = tma_layout_error(t.shape, t.stride(), t.dtype, t.data_ptr())
        if error is not None:
            raise ValueError(error)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures: tensor pointers, (bh, seq, dim), scale, (causal, is_bf16), stream
_SIGNATURES = {
    "adapcc_flash_fwd": [_P] * 5 + [_I] * 3 + [_F] + [_I] * 2 + [_P],
    "adapcc_flash_dq": [_P] * 7 + [_I] * 3 + [_F] + [_I] * 2 + [_P],
    "adapcc_flash_dkv": [_P] * 8 + [_I] * 3 + [_F] + [_I] * 2 + [_P],
    "adapcc_flash_smem_bytes": [_I, _I],  # (0 forward | 1 dk/dv | 2 dq, head dim)
}


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/flash_attention.cu``, built at first use, with its signatures."""
    from adapcc_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _kernel_call(entry: str, *args) -> None:
    """Launch ``<entry>`` on the current stream; tensors pass as pointers."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(_library(), entry)(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} at launch")


def flash_fwd(q, k, v, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(o [BH,T,D], lse [BH,T] float32)`` from ``[BH, T, D]`` q/k/v."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, scale, causal)
    _check_kernel_inputs(q, k, v)
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernel_call(
            "adapcc_flash_fwd", q, k, v, o, lse, BH, T, D, float(scale),
            int(causal), int(q.dtype == torch.bfloat16),
        )
    flash_fwd.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, scale: float, causal: bool) -> torch.Tensor:
    """K3: ``dq`` from the residuals and ``delta = rowsum(do∘o) − dlse``."""
    if q.device.type == "cpu":
        return _dq_plain(q, k, v, do, lse, delta, scale, causal)
    _check_kernel_inputs(q, k, v, do)
    _check_stats(q, lse, delta)
    BH, T, D = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernel_call(
            "adapcc_flash_dq", q, k, v, do, lse, delta, dq, BH, T, D,
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
        )
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """K4: ``(dk, dv)`` from the residuals and ``delta``."""
    if q.device.type == "cpu":
        return _dkv_plain(q, k, v, do, lse, delta, scale, causal)
    _check_kernel_inputs(q, k, v, do)
    _check_stats(q, lse, delta)
    BH, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _kernel_call(
            "adapcc_flash_dkv", q, k, v, do, lse, delta, dk, dv, BH, T, D,
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
        )
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0

#: the kernel wrappers, in the order of the TPU kernels they replace
KERNELS = (flash_fwd, flash_dq, flash_dkv)


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    for s in stats:
        if s.dtype != torch.float32 or s.shape != q.shape[:2] or not s.is_contiguous():
            raise ValueError(
                f"lse/delta must be contiguous float32 {tuple(q.shape[:2])}, "
                f"got {s.dtype} {tuple(s.shape)}"
            )
        if s.device != q.device:
            raise ValueError(f"lse/delta on {s.device}, q on {q.device}")


# --------------------------------------------------------------------------- #
# autograd and the public [B, T, H, D] API
# --------------------------------------------------------------------------- #


class _FlashAttention(torch.autograd.Function):
    """Flash attention over ``[BH, T, D]`` returning ``(o, lse)``; both
    outputs are differentiable (an ``lse`` cotangent folds into the
    backward kernels as ``delta − dlse``, as in ``_flash_bwd_core``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def _check_blocks(T: int, block_q: int, block_k: int) -> None:
    bq, bk = min(block_q, T), min(block_k, T)
    if T % bq or T % bk:
        raise ValueError(f"seq len {T} must divide into blocks ({bq}, {bk})")


def _bthd_call(q, k, v, causal, scale, block_q, block_k):
    """Validate, default the scale, and run the autograd function on
    ``[B·H, T, D]`` copies; returns its ``(o, lse)`` and ``(B, T, H, D)``."""
    B, T, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    _check_blocks(T, block_q, block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    def to_bhtd(x):
        return x.transpose(1, 2).reshape(B * H, T, D).contiguous()

    o, lse = _FlashAttention.apply(to_bhtd(q), to_bhtd(k), to_bhtd(v), float(scale), bool(causal))
    return o, lse, (B, T, H, D)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Blockwise attention over ``[B, T, H, D]`` tensors (model layout).

    ``scale`` defaults to ``1/sqrt(D)``.  ``T`` must divide by the block
    sizes (clamped to ``T``), as in the reference.
    """
    o, _, (B, T, H, D) = _bthd_call(q, k, v, causal, scale, block_q, block_k)
    return o.reshape(B, H, T, D).transpose(1, 2)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise attention returning ``(out [B,T,H,D], lse [B,H,T])``.

    ``lse[b,h,t] = logsumexp_j(scale·q_t·k_j)`` under the causal mask — the
    statistic a blockwise consumer merges partial attention with.  Both
    outputs are differentiable.
    """
    o, lse, (B, T, H, D) = _bthd_call(q, k, v, causal, scale, block_q, block_k)
    return o.reshape(B, H, T, D).transpose(1, 2), lse.reshape(B, H, T)
