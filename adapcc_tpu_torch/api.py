"""Public AdapCC façade: the same surface as the reference's adapcc.py.

The port of :mod:`adapcc_tpu.api`.  The reference exposes a classmethod
façade over one ``CudaCommu`` (adapcc.py:6-77): ``init`` runs the
detect/profile bootstrap chosen by ``entry_point``, ``setup`` creates a
transmission context, the collective methods forward to the communicator,
and ``reconstruct_topology`` tears everything down and re-adapts.  This is
the same façade over the port's
:class:`~adapcc_tpu_torch.communicator.Communicator`.

Entry-point contract (adapcc.py:30-41): ``DETECT`` (6) runs detect → profile
→ synthesize; ``PROFILE`` (7) assumes a logical graph exists and runs profile
→ synthesize; ``-1`` skips the bootstrap (use a pre-written strategy file).

Run the reference's smoke benchmark with ``python -m adapcc_tpu_torch.api``
(on the card) or ``python -m adapcc_tpu_torch.api --device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Any, Optional, Sequence

import torch

from adapcc_tpu_torch.comm.mesh import DeviceLike, World
from adapcc_tpu_torch.communicator import Communicator
from adapcc_tpu_torch.config import CommArgs
from adapcc_tpu_torch.primitives import ALLREDUCE, DETECT, PROFILE, SKIP_BOOTSTRAP, ReduceOp


class AdapCC:
    """Classmethod façade; state mirrors the reference's class attributes."""

    communicator: Optional[Communicator] = None
    local_rank: Optional[int] = None
    world_rank: Optional[int] = None
    world_size: Optional[int] = None
    profile_freq: Optional[int] = None

    @classmethod
    def init(
        cls,
        args: Any,
        local_rank: int = 0,
        world_rank: int = 0,
        world_size: Optional[int] = None,
        device: DeviceLike = None,
        world: Optional[World] = None,
        num_slices: int = 1,
    ) -> None:
        """Create the communicator and run the adaptive bootstrap.

        ``local_rank``/``world_rank`` are accepted for signature parity with
        the reference (adapcc.py:16) and only label this process; the world
        is ``world_size`` ranks stacked on ``device``, or ``world``'s process
        group.  ``num_slices > 1`` makes the stacked world two-level, as the
        JAX package's ``("dcn", "ici")`` mesh does (``policy="hier"`` then
        synthesizes its composed plan)."""
        comm_args = args if isinstance(args, CommArgs) else CommArgs.from_namespace(args)
        cls.communicator = Communicator(comm_args, world_size=world_size, device=device, world=world,
                                        num_slices=num_slices)
        cls.local_rank = local_rank
        cls.world_rank = world_rank
        cls.world_size = cls.communicator.world_size
        cls.profile_freq = comm_args.profile_freq

        entry = comm_args.entry_point
        if entry == DETECT:
            cls.communicator.init_threads(DETECT)
            cls.communicator.exit_threads(DETECT)
            cls.communicator.init_threads(PROFILE)
            cls.communicator.exit_threads(PROFILE)
        elif entry == PROFILE:
            cls.communicator.init_threads(PROFILE)
            cls.communicator.exit_threads(PROFILE)
        elif entry == SKIP_BOOTSTRAP:
            pass
        else:
            raise ValueError(f"no supported entry point for init: {entry}")

    @classmethod
    def setup(cls, prim: int) -> None:
        cls.communicator.init_threads(prim)

    @classmethod
    def allreduce(
        cls,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
    ) -> torch.Tensor:
        return cls.communicator.all_reduce(tensor, size, chunk_bytes, active_gpus, op=op)

    @classmethod
    def reduce(
        cls,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
        op: ReduceOp = ReduceOp.SUM,
    ) -> torch.Tensor:
        return cls.communicator.reduce(tensor, size, chunk_bytes, active_gpus, op=op)

    @classmethod
    def boardcast(
        cls,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        return cls.communicator.boardcast(tensor, size, chunk_bytes, active_gpus)

    @classmethod
    def alltoall(
        cls,
        tensor: torch.Tensor,
        size: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        active_gpus: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        return cls.communicator.alltoall(tensor, size, chunk_bytes, active_gpus)

    @classmethod
    def reconstruct_topology(cls, args: Any, prim: int) -> None:
        """Clear contexts, re-run the adaptive bootstrap, rebuild the context
        (adapcc.py:63-67): the periodic re-adaptation ``profile_freq``
        drives in training loops."""
        comm = cls.communicator
        cls.clear(prim)
        cls.init(
            args,
            cls.local_rank,
            cls.world_rank,
            cls.world_size,
            device=comm.device if comm else None,
            world=comm.world if comm else None,
            num_slices=comm.num_slices if comm else 1,
        )
        cls.setup(prim)

    @classmethod
    def set_profile_freq(cls, freq: int) -> None:
        cls.profile_freq = freq

    @classmethod
    def clear(cls, prim: int) -> None:
        cls.communicator.exit_threads(prim)
        cls.communicator.clear()


def smoke_benchmark(world: int = 4, device: DeviceLike = None) -> None:
    """The reference's ``__main__`` smoke benchmark (adapcc.py:81-117): the
    full adaptive bootstrap, then 16-float allreduces of ``ones*i`` over
    ``world`` ranks (every rank prints ``i*world``), plus a subset (relay)
    allreduce.  Deterministic; ``log/primitive`` holds the golden copy."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="adapcc_smoke_") as workdir:
        args = CommArgs(
            strategy_file=f"{workdir}/strategy.xml",
            logical_graph=f"{workdir}/logical_graph.xml",
            topology_dir=workdir,
            entry_point=DETECT,
            parallel_degree=2,
        )
        AdapCC.init(args, world_size=world, device=device)
        dev = AdapCC.communicator.device
        AdapCC.setup(ALLREDUCE)

        for i in (1, 2, 3):
            x = torch.stack([torch.ones(16, device=dev) * i for _ in range(world)])
            out = AdapCC.allreduce(x, size=16, chunk_bytes=8).cpu()
            for r in range(world):
                vals = out[r].to(torch.int64).tolist()
                print(f"rank {r} allreduce(ones*{i}) -> {vals}")

        # subset collective: the last rank is a relay; active ranks still sum
        x = torch.stack([torch.ones(16, device=dev) * (r + 1) for r in range(world)])
        active = list(range(world - 1))
        out = AdapCC.allreduce(x, active_gpus=active).cpu()
        print(f"partial allreduce over active {active} -> {int(out[0][0])}")

        AdapCC.clear(ALLREDUCE)
    print("smoke benchmark complete")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="AdapCC façade smoke benchmark")
    parser.add_argument("--device", default=None, help="torch device (default: this process's CUDA card)")
    smoke_benchmark(device=parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
