"""The port's psum plane held against the JAX engine's: AVG of an integer
payload, full world and masked, at world 2 over gloo.

JAX's ``_fused_reduce`` divides an integer psum by ``denom`` with ``/``,
which promotes to float32; the port returns the same float32 values, as a
new tensor, through ``engine.allreduce`` and ``engine.masked_psum_shard``.
A floating payload is still reduced and divided in place.  Rank 0 runs in
the pytest process and rank 1 in one spawned worker; the JAX references
(``shard_map`` over the 2-device CPU mesh) build while the worker starts.
The worker imports only torch: this module imports JAX inside the function
that builds the reference.
"""

import multiprocessing
import socket

import numpy as np
import torch

from adapcc_tpu_torch.comm import engine
from adapcc_tpu_torch.comm.mesh import build_world_mesh, destroy_world
from adapcc_tpu_torch.primitives import ReduceOp

WORLD = 2
#: row r is rank r's int32 payload
PAYLOAD = np.array([[3, 4], [5, 6]], dtype=np.int32)
#: None: the full-world allreduce; a mask: masked_psum_shard
MASKS = (None, [True, True], [True, False])


def _jax_avgs():
    """Per mask, the ``[world, 2]`` AVG every rank holds in the JAX engine."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from adapcc_tpu.comm.engine import _fused_reduce, masked_psum_shard
    from adapcc_tpu.primitives import ReduceOp as JaxReduceOp

    mesh = Mesh(jax.devices()[:WORLD], ("ranks",))
    outs = []
    for mask in MASKS:
        def per_shard(x, mask=mask):
            if mask is None:
                return _fused_reduce(x, "ranks", JaxReduceOp.AVG, WORLD)
            return masked_psum_shard(x, jnp.asarray(mask), "ranks", JaxReduceOp.AVG)

        fn = jax.jit(jax.shard_map(per_shard, mesh=mesh, in_specs=P("ranks"), out_specs=P("ranks"),
                                   check_vma=False))
        outs.append(np.asarray(fn(jnp.asarray(PAYLOAD))))
    return outs


def _avg(x, mask):
    if mask is None:
        return engine.allreduce(x, ReduceOp.AVG)
    return engine.masked_psum_shard(x, mask, ReduceOp.AVG)


def _rank(rank, init_method):
    """One gloo rank: per mask, this rank's integer AVG (with its dtype and
    whether the payload kept its integers), then whether a float32 AVG came
    back as the tensor it was given."""
    build_world_mesh(WORLD, rank=rank, device="cpu", init_method=init_method)
    try:
        results = []
        for mask in MASKS:
            x = torch.from_numpy(PAYLOAD[rank].copy())
            out = _avg(x, mask)
            results.append((out.numpy(), str(out.dtype), x.dtype == torch.int32))
        floats = []
        for mask in MASKS:
            y = torch.from_numpy(PAYLOAD[rank].astype(np.float32))
            out = _avg(y, mask)
            floats.append((out is y, out.numpy()))
        return results, floats
    finally:
        destroy_world()


def _child(rank, init_method):
    torch.set_num_threads(1)
    return _rank(rank, init_method)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_integer_avg_returns_jax_float32_and_float_avg_stays_in_place():
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = pool.apply_async(_child, (1, init_method))
        refs = _jax_avgs()
        per_rank = [_rank(0, init_method), pending.get(timeout=120)]
    assert np.array_equal(refs[0], [[4.0, 5.0], [4.0, 5.0]])
    assert np.array_equal(refs[2], [[3.0, 4.0], [3.0, 4.0]])
    for i, mask in enumerate(MASKS):
        assert refs[i].dtype == np.float32, mask
        for rank in range(WORLD):
            got, dtype, kept_int = per_rank[rank][0][i]
            assert dtype == "torch.float32" and kept_int, (mask, rank)
            assert np.array_equal(got, refs[i][rank]), (mask, rank)
            same, value = per_rank[rank][1][i]
            assert same, (mask, rank)  # a float payload is divided in place
            assert np.array_equal(value, refs[i][rank]), (mask, rank)
