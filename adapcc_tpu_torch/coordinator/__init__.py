"""Coordinator plane: relay negotiation + fault detection.

The port of :mod:`adapcc_tpu.coordinator`.  The decision logic
(:mod:`~adapcc_tpu_torch.coordinator.logic`) is transport-free and needs no
more than numpy; the gRPC transport (:mod:`~adapcc_tpu_torch.coordinator.
service`, wire-compatible with the reference's ``coordinator.proto``) is
loaded on first use of one of its names, so that importing the package, the
logic or :mod:`adapcc_tpu_torch.measure` works on a machine without
``grpcio``.
"""

from adapcc_tpu_torch.coordinator.logic import CoordinatorLogic, CoordinatorShutdown

_SERVICE_NAMES = (
    "CoordinatorServer",
    "CoordinatorUnavailable",
    "Controller",
    "HeartbeatClient",
    "Hooker",
    "rpc_timeout_s",
)

__all__ = ["CoordinatorLogic", "CoordinatorShutdown", *_SERVICE_NAMES]


def __getattr__(name: str):
    if name in _SERVICE_NAMES:
        from adapcc_tpu_torch.coordinator import service

        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
