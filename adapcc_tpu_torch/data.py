"""Input pipeline: host-side batching + async device prefetch.

The port of :mod:`adapcc_tpu.data`.  The reference feeds its workloads with
torch ``DataLoader`` iterators; the JAX package builds the overlap itself,
and so does the port: a background thread moves the next host batch to the
device while the current step computes.

On the card each batch is staged in pinned host memory and copied with
``non_blocking=True`` on a side stream; the producer records an event after
the copy, and the consumer makes its current stream wait on that event and
marks the tensor as used there (``record_stream``) before yielding it, so
the copy is ordered before every use and the allocator does not reuse the
memory while the consumer's stream may still read it.  On the CPU a batch is
a tensor copy of the host array.

``device_batches`` is the one-call path the workloads use: shuffled full
batches of a packed array in the JAX package's order (:func:`batch_indices`,
numpy's ``default_rng(seed).permutation``), with a bounded prefetch queue.
With a :class:`~adapcc_tpu_torch.comm.mesh.World` each process takes its
rank's contiguous slice of every global batch, the rows JAX's
``NamedSharding(mesh, P(axis))`` puts on that rank's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from adapcc_tpu_torch.comm.mesh import DeviceLike, World, resolve_device

_END = object()


class _PrefetchError:
    """Private in-band wrapper for a producer failure — unambiguous even
    when the iterator legitimately yields tuples."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def prefetch_to_device(it: Iterator[Any], size: int = 2, device: DeviceLike = None) -> Iterator[Any]:
    """Yield the batches of ``it`` (numpy arrays or tensors, alone or in
    tuples, lists and dicts) as tensors on ``device`` (the card when None;
    raises without one), ``size`` batches in flight.  A producer exception
    re-raises at the consumer's next pull, chained as its cause."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(device=dev) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()  # consumer gone: unblock + stop the producer

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(x: Any) -> torch.Tensor:
        t = torch.as_tensor(x)
        if not cuda:
            return t.clone() if isinstance(x, torch.Tensor) else t.to(dev, copy=True)
        return t.pin_memory().to(dev, non_blocking=True)

    def produce() -> None:
        try:
            for batch in it:
                if stop.is_set():
                    return
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        moved = _tree_map(to_device, batch)
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                    item = (moved, ready)
                else:
                    item = (_tree_map(to_device, batch), None)
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            _put(_PrefetchError(e))
            return
        _put(_END)

    t = threading.Thread(target=produce, daemon=True, name="adapcc-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _PrefetchError):
                raise RuntimeError("prefetch producer failed") from item.exc
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                for leaf in _leaves(batch):
                    leaf.record_stream(stream)
            yield batch
    finally:
        # an abandoned iterator (break / exception in the consumer) must not
        # leave the producer blocked holding device batches alive
        stop.set()


def batch_indices(n: int, batch: int, seed: Optional[int], drop_last: bool = True) -> Iterator[np.ndarray]:
    """Index blocks for one epoch: shuffled when ``seed`` is given (JAX's
    order for the same seed)."""
    idx = np.random.default_rng(seed).permutation(n) if seed is not None else np.arange(n)
    end = n - batch + 1 if drop_last else n
    for i in range(0, end, batch):
        yield idx[i:i + batch]


def device_batches(
    packed: np.ndarray,
    batch: int,
    world: Optional[World] = None,
    seed: Optional[int] = 0,
    prefetch: int = 2,
    device: DeviceLike = None,
) -> Iterator[torch.Tensor]:
    """Shuffled ``[batch, ...]`` batches of a packed host array on
    ``device`` (default: ``world.device``, else the card).  With a
    ``world``, each global batch must divide by its size and this process
    gets its rank's ``batch / world`` rows.  One pass = one epoch; reseed for
    the next."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if world is not None and batch % world.world_size:
        raise ValueError(f"batch {batch} not divisible by the world ({world.world_size})")
    if device is None and world is not None:
        device = world.device
    if world is None:
        lo, hi = 0, batch
    else:
        per = batch // world.world_size
        lo, hi = world.rank * per, (world.rank + 1) * per

    def host_batches() -> Iterator[np.ndarray]:
        for idx in batch_indices(len(packed), batch, seed):
            yield packed[idx[lo:hi]]

    return prefetch_to_device(host_batches(), size=prefetch, device=device)
