"""Joining a launched world: the port of :mod:`adapcc_tpu.launch`'s
environment contract (``launch/launcher.py:207-227``).

A launcher starts one process a rank with ``ADAPCC_NUM_PROCESSES``,
``ADAPCC_PROCESS_ID`` and the coordinator's ``host:port`` in
``ADAPCC_COORDINATOR_ADDRESS`` (the port's name for JAX's
``JAX_COORDINATOR_ADDRESS``); :func:`maybe_initialize_distributed` joins the
process group through :func:`~adapcc_tpu_torch.comm.mesh.build_world_mesh`.
``ADAPCC_PLATFORM`` (``cuda`` or ``cpu``; JAX's ``JAX_PLATFORMS`` pin) names
the device the launched workers run on.

The rest of the JAX package's ``launch`` (the ssh/scp launch plan, host
ordering, the artifact dispatcher, the connectivity check) waits for its
slice and raises :func:`~adapcc_tpu_torch.primitives.not_ported`.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from adapcc_tpu_torch.primitives import not_ported

COORDINATOR_ENV = "ADAPCC_COORDINATOR_ADDRESS"
NUM_PROCESSES_ENV = "ADAPCC_NUM_PROCESSES"
PROCESS_ID_ENV = "ADAPCC_PROCESS_ID"
PLATFORM_ENV = "ADAPCC_PLATFORM"
_PLATFORMS = ("cuda", "cpu")


def apply_platform_env() -> Optional[str]:
    """The device the launcher pinned (``ADAPCC_PLATFORM``), or None when it
    pinned none; a value other than ``cuda`` or ``cpu`` raises."""
    plat = os.environ.get(PLATFORM_ENV, "").strip()
    if not plat:
        return None
    if plat not in _PLATFORMS:
        raise ValueError(f"{PLATFORM_ENV}={plat!r}: expected one of {_PLATFORMS}")
    return plat


def maybe_initialize_distributed() -> bool:
    """Join the multi-process world the launcher's environment describes.

    Applies the platform pin, then reads ``ADAPCC_COORDINATOR_ADDRESS`` +
    ``ADAPCC_NUM_PROCESSES`` / ``ADAPCC_PROCESS_ID`` and joins the process
    group (NCCL on the card, gloo on the CPU) with the coordinator as its
    rendezvous; returns False (after the platform pin) when launched as one
    process.  Call before first device use."""
    plat = apply_platform_env()
    addr = os.environ.get(COORDINATOR_ENV)
    num = os.environ.get(NUM_PROCESSES_ENV)
    if not addr or not num or int(num) <= 1:
        return False
    from adapcc_tpu_torch.comm.mesh import build_world_mesh

    build_world_mesh(int(num), rank=int(os.environ.get(PROCESS_ID_ENV, "0")), device=plat,
                     init_method=f"tcp://{addr}")
    return True


_LAUNCH_SLICE = "the launch slice (ROADMAP item 6: ssh/scp fan-out, one process a host)"


def _waits(what: str):
    def stub(*args: Any, **kwargs: Any):
        raise not_ported(what, _LAUNCH_SLICE)

    stub.__name__ = what
    return stub


Dispatcher = _waits("Dispatcher")
HostSpec = _waits("HostSpec")
build_launch_plan = _waits("build_launch_plan")
main = _waits("main")
order_hosts = _waits("order_hosts")
parse_ips = _waits("parse_ips")
write_ip_table = _waits("write_ip_table")

__all__ = [
    "Dispatcher",
    "HostSpec",
    "apply_platform_env",
    "build_launch_plan",
    "main",
    "maybe_initialize_distributed",
    "order_hosts",
    "parse_ips",
    "write_ip_table",
]
