"""Slot-paged KV cache, laid out over the tensor-parallel world by heads
(the port of :mod:`adapcc_tpu.serve.kv_cache`).

One decode slot holds ``2 · n_layer · max_seq · d_model`` cache entries,
and the continuous batcher keeps ``slots`` of them alive at once.  Per
layer, K and V are each

    ``[world, slots, max_seq, n_head/world, head_dim]``

on one device, row ``r`` of the leading dimension rank ``r``'s heads: the
head split the decode step (:mod:`adapcc_tpu_torch.serve.model`) computes
attention over.  The pages are written in place.

Slot lifecycle:

- **admission** claims a free slot and zeroes its pages, the state a fresh
  ``generate`` cache starts from;
- **evict-on-EOS** frees the slot at once (the rest of a finished stream is
  EOS by the latch, so no model step is owed) and the next admission reuses
  it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from adapcc_tpu_torch.comm.mesh import DeviceLike, resolve_device
from adapcc_tpu_torch.comm.ring import _dtype_name
from adapcc_tpu_torch.models.gpt2 import GPT2Config


class SlotKVCache:
    """Per-layer (K, V) slot pages of a stacked world on ``device`` (the
    card when None)."""

    def __init__(self, cfg: GPT2Config, world: int, slots: int, device: DeviceLike = None, metrics=None) -> None:
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if cfg.n_head % world:
            raise ValueError(f"n_head={cfg.n_head} must divide over the TP world {world} (head-sharded cache pages)")
        self.cfg = cfg
        self.world = int(world)
        self.slots = int(slots)
        self.heads_local = cfg.n_head // world
        self.head_dim = cfg.d_model // cfg.n_head
        self.device = resolve_device(device)
        shape = (self.world, self.slots, cfg.max_seq, self.heads_local, self.head_dim)
        #: per layer: (k_pages, v_pages), each [world, slots, max_seq, Hl, hd]
        self.layers: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(shape, dtype=cfg.dtype, device=self.device))
            for _ in range(cfg.n_layer)
        ]
        #: optional MetricsRegistry: the slot-lifecycle ledger (occupancy,
        #: eviction and reuse counters, the page-bytes reservoir)
        self.metrics = metrics
        self._occupied: set = set()
        self._ever_used: set = set()

    def _note_occupancy(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("kv_cache.occupied_slots", len(self._occupied))
            self.metrics.gauge("kv_cache.occupancy", len(self._occupied) / self.slots)

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")

    # -- lifecycle -------------------------------------------------------------

    def clear_slot(self, slot: int) -> None:
        """Zero one slot's pages across all layers (the fresh-cache state
        ``generate`` starts from) and count the admission."""
        self._check_slot(slot)
        for k, v in self.layers:
            k[:, slot].zero_()
            v[:, slot].zero_()
        if self.metrics is not None:
            self.metrics.incr("kv_cache.admissions")
            if slot in self._ever_used:
                self.metrics.incr("kv_cache.slot_reuse")
        self._ever_used.add(slot)
        self._occupied.add(slot)
        self._note_occupancy()

    def release_slot(self, slot: int, used_tokens: Optional[int] = None, evicted: bool = False) -> None:
        """Free one slot at completion: the eviction counter and the
        page-bytes sample (``used_tokens`` × the per-token KV footprint, the
        bytes the request wrote, not the ``max_seq`` reservation)."""
        self._check_slot(slot)
        self._occupied.discard(slot)
        self._note_occupancy()
        if self.metrics is None:
            return
        self.metrics.incr("kv_cache.released")
        if evicted:
            self.metrics.incr("kv_cache.evictions")
        if used_tokens is not None:
            self.metrics.observe("kv_cache.page_bytes", used_tokens * self.bytes_per_token)

    @property
    def bytes_per_token(self) -> int:
        """KV footprint of ONE cached token across all layers and ranks (K
        and V): the unit of the page-bytes histogram and of KV-transfer
        pricing."""
        itemsize = torch.empty((), dtype=self.cfg.dtype).element_size()
        return 2 * self.cfg.n_layer * self.cfg.d_model * itemsize

    def stats(self) -> dict:
        """The slot-lifecycle ledger read back from the registry (zeros
        without one)."""
        out = {
            "occupied_slots": len(self._occupied),
            "occupancy": len(self._occupied) / self.slots,
            "admissions": 0, "slot_reuse": 0, "evictions": 0, "released": 0,
        }
        if self.metrics is None:
            return out
        snap = self.metrics.snapshot()
        for key in ("admissions", "slot_reuse", "evictions", "released"):
            out[key] = int(snap["counters"].get(f"kv_cache.{key}", 0))
        pages = snap["timings"].get("kv_cache.page_bytes")
        if pages:
            out["page_bytes"] = {"count": pages["count"], "p50": pages["p50_s"], "p99": pages["p99_s"],
                                 "max": pages["max_s"]}
        return out

    # -- layout ----------------------------------------------------------------

    @property
    def nbytes_per_rank(self) -> int:
        """One rank's cache footprint: it scales as ``1/world``."""
        k, _ = self.layers[0]
        per_layer = 2 * k.numel() * k.element_size() // self.world
        return per_layer * self.cfg.n_layer

    def layout(self) -> dict:
        """Artifact row describing the paging geometry."""
        return {
            "layers": self.cfg.n_layer,
            "world": self.world,
            "slots": self.slots,
            "max_seq": self.cfg.max_seq,
            "heads_local": self.heads_local,
            "head_dim": self.head_dim,
            "dtype": _dtype_name(self.cfg.dtype),
            "nbytes_per_rank": self.nbytes_per_rank,
        }

    def __repr__(self) -> str:
        return (
            f"SlotKVCache(layers={self.cfg.n_layer}, world={self.world}, slots={self.slots}, "
            f"max_seq={self.cfg.max_seq}, heads_local={self.heads_local}, head_dim={self.head_dim})"
        )
