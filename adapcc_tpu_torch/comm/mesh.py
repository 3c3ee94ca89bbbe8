"""The collective world: one process per device under ``torch.distributed``.

The port of :func:`adapcc_tpu.comm.mesh.build_world_mesh` and of the
launcher's environment contract (``launch/launcher.py::apply_platform_env``).
The JAX package runs one controller over a mesh of devices; the port runs the
reference AdapCC's way, one process per GPU (``cudaSetDevice(localRank)``,
csrc/run.cu:49), joined into a process group: NCCL on the card, gloo on the
CPU.  A world of one process needs no launcher.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None, local_rank: int = 0) -> torch.device:
    """The device an entry point runs on: the caller's, else this process's
    CUDA card.  Never falls back to the CPU: without CUDA it raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", local_rank % torch.cuda.device_count())


@dataclass(frozen=True)
class World:
    """This process's place in the collective world."""

    rank: int
    world_size: int
    device: torch.device


def build_world_mesh(
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: DeviceLike = None,
    init_method: Optional[str] = None,
) -> World:
    """Join (or create) the process group and return this process's
    :class:`World`.

    Arguments override the launcher environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` sets
    them); with neither, the world is this one process, whose group keeps
    its store in memory: no port to pick, so none another process can take
    between the pick and the listen.  Reuses an already initialized group of
    the same size.
    """
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    dev = resolve_device(device, int(env.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise ValueError(
                f"process group already initialized as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, asked for rank {rank} of {world_size}"
            )
        return World(rank, world_size, dev)
    store = None
    if init_method is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = "env://"
        elif world_size == 1:
            store = dist.HashStore()
        else:
            raise ValueError(
                f"a world of {world_size} processes needs init_method or "
                "MASTER_ADDR/MASTER_PORT"
            )
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        store=store,
        world_size=world_size,
        rank=rank,
    )
    return World(rank, world_size, dev)


def device_ip(process_index: int = 0) -> str:
    """Host label of a rank, used where the reference uses the node ip
    (tree edge classification, strategy XML): the owning process, as the
    JAX package labels a device (``adapcc_tpu.comm.mesh.device_ip``)."""
    return f"process-{process_index}"


def world_processes(world_size: int, world: Optional[World] = None) -> List[int]:
    """Rank → owning process.  One process holding every rank's row (the
    single-controller form) owns them all; a process group of one process a
    rank maps rank ``r`` to process ``r``."""
    if world is None or world.world_size == 1:
        return [0] * world_size
    if world.world_size != world_size:
        raise ValueError(
            f"a world of {world_size} ranks over a process group of {world.world_size} processes: "
            "either one process holds every rank or each process holds one"
        )
    return list(range(world_size))


def world_ip_table(world_size: int, world: Optional[World] = None) -> List[str]:
    """Rank → "ip" list of the collective world (the analog of
    ``topology/ip_table.txt``): what ``mesh_ip_table`` gives a flat JAX mesh
    of the same processes, so the synthesizer groups hosts alike."""
    return [device_ip(p) for p in world_processes(world_size, world)]


def mesh_ip_table(world_size: int, num_slices: int = 1, world: Optional[World] = None) -> List[str]:
    """Rank → "ip" list as the JAX package's ``mesh_ip_table`` gives it: on
    a two-level world (``num_slices > 1``) the slice row, ``slice-<k>``
    (the synthesizer's hosts must be the slices the two-level plane runs),
    otherwise :func:`world_ip_table`.  A ragged split raises."""
    if num_slices > 1:
        from adapcc_tpu_torch.comm.two_level import build_two_level_mesh

        ici = build_two_level_mesh(num_slices, world_size=world_size).ici_size
        return [f"slice-{r // ici}" for r in range(world_size)]
    return world_ip_table(world_size, world)


def destroy_world() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
