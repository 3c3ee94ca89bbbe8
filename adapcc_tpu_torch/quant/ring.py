"""Wire-codec ring allreduce: the unfused quantized ring, stacked form.

The port of :mod:`adapcc_tpu.quant.ring`.  The JAX function runs per rank
inside ``shard_map`` with ``ppermute`` hops; here every rank's row of a
stacked ``[world, ...]`` tensor walks the ring at once, in plain torch (the
JAX package's is plain XLA too).  It is the engine's reroute arm
(``quant_ring[<codec>]``) beside the fused ring kernels:

- **reduce-scatter**, ``world - 1`` hops: each rank encodes the chunk in
  flight, ships the wire arrays one ring step, and the receiver decodes and
  adds into its float32 partial, which is encoded again when it moves on;
- **all-gather**, ``world - 1`` hops: each reduced chunk is encoded once by
  its owner, which adopts its own decoded chunk, and the encoded blocks are
  forwarded verbatim, so every rank ends with the same bits.

The chunk layout is its own: ``world`` chunks, each padded to whole codec
blocks (not to whole ring tiles), so one chunk's scales never cover another
chunk's elements.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE, get_codec


def wire_ring_allreduce_stacked(
    stacked: torch.Tensor,
    wire_dtype: str = "int8",
    block_size: int = DEFAULT_BLOCK_SIZE,
) -> torch.Tensor:
    """SUM-allreduce of every row of ``[world, ...]`` with the wire codec
    applied per hop; the stacked result in the input's shape and dtype.
    ``world == 1`` is the identity (no wire, no codec error)."""
    codec = get_codec(wire_dtype)
    world = stacked.shape[0]
    if world == 1:
        return stacked
    flat = stacked.reshape(world, -1).to(torch.float32)
    n = flat.shape[1]
    chunk = -(-n // world)
    chunk = -(-chunk // block_size) * block_size
    acc = F.pad(flat, (0, world * chunk - n)).reshape(world, world, chunk)
    ranks = torch.arange(world, device=stacked.device)

    def encode(vals: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``[world, chunk]`` rows → wire arrays with a leading rank dim
        (blocks never straddle rows: ``chunk`` is whole blocks)."""
        return tuple(w.reshape(world, -1, *w.shape[1:]) for w in codec.encode(vals.reshape(-1), block_size))

    def decode(wire: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        flat_wire = tuple(w.reshape(-1, *w.shape[2:]) for w in wire)
        return codec.decode(flat_wire, world * chunk, block_size).reshape(world, chunk)

    def hop(wire: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        return tuple(w.roll(1, dims=0) for w in wire)  # rank r receives from r - 1

    # reduce-scatter: decode-accumulate-encode at every hop
    for s in range(world - 1):
        recvd = hop(encode(acc[ranks, (ranks - s) % world]))
        recv_idx = (ranks - s - 1) % world
        acc[ranks, recv_idx] = acc[ranks, recv_idx] + decode(recvd)

    # all-gather: encode once, forward the encoded blocks verbatim; the owner
    # adopts its own decoded chunk, so every rank holds the same values
    own_idx = (ranks + 1) % world
    wire = encode(acc[ranks, own_idx])
    out = torch.zeros_like(acc)
    out[ranks, own_idx] = decode(wire)
    for s in range(world - 1):
        wire = hop(wire)
        # the chunk arriving at hop s is the owned chunk of rank r - 1 - s
        out[ranks, (ranks - s) % world] = decode(wire)
    return out.reshape(world, -1)[:, :n].reshape(stacked.shape).to(stacked.dtype)


def ring_error_bound(xs: Any, world: Optional[int] = None, block_size: int = DEFAULT_BLOCK_SIZE) -> np.ndarray:
    """Elementwise ``|quantized ring - float32 sum|`` bound for the int8 ring
    (numpy, ``xs`` is ``[world, n]``): each element's partial is encoded at
    most ``world`` times, each costing at most half a step of the largest
    partial its block holds, bounded by the block max of ``sum_r |x_r|``."""
    xs = np.asarray(xs, dtype=np.float32)
    if world is None:
        world = xs.shape[0]
    n = xs[0].reshape(-1).shape[0]
    mass = np.abs(xs).reshape(world, -1).sum(axis=0)
    chunk = -(-n // world)
    chunk = -(-chunk // block_size) * block_size
    padded = np.pad(mass, (0, world * chunk - n)).reshape(-1, block_size)
    per_block = np.max(padded, axis=1) / 127.0
    bound = 0.5 * world * np.repeat(per_block, block_size)[:n]
    return bound + 1e-6  # absolute slack for float32 accumulation noise
