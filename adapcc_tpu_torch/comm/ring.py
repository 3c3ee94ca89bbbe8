"""Ring collectives: the hand-written ring data plane, single-controller form.

The port of the unfused half of :mod:`adapcc_tpu.comm.pallas_ring`.  A ring
collective walks ``world`` chunks around a unidirectional ring of ranks:

- **reduce-scatter**, ``world − 1`` steps: at step ``s`` rank ``r`` sends
  chunk ``r − s`` to its right neighbour and adds the chunk ``r − s − 1``
  that lands from its left one to its own copy.  Chunk ``c`` starts at rank
  ``c`` and gains one rank's term per hop, so after the walk rank ``r`` holds
  the full sum of chunk ``(r + 1) % world``;
- **all-gather**, ``world − 1`` steps of the same walk, adopting what lands.

The JAX engine's ring entry points are single-controller: they take a
stacked ``[world, ...]`` array and return the stacked result.  The port
keeps that form.  Every rank's rows live on one card and one kernel launch
walks the ring for all of them; each rank sees its neighbours only through
a table of device pointers (to their input, output, wire buffer and flag
words), which is what a CUDA IPC registration gives in the per-process
form.  Four kernels in ``csrc/ring.cu`` replace the four Pallas kernels,
all on one walk that stages nothing: each hop's result is written once,
into a buffer of the rank that computed it, where its right neighbour
reads it, and a chunk's last tile may be ragged:

- :func:`ring_k1a` (``_ring_kernel``): the whole chunk in one tile, the
  planner's ``vmem`` path (payloads up to ``chunk_bytes``);
- :func:`ring_k1b` (``_stream_ring_kernel``): each chunk streamed in
  ``[stage_rows, 128]`` tiles, the ``hbm-stream`` path;
- :func:`ring_k5a` (``_fused_ring_kernel``) and :func:`ring_k5b`
  (``_fused_stream_ring_kernel``): the same two walks on a float32 payload
  with a wire codec (``int8``: codes and a float32 scale per block of
  ``block_size`` elements; ``bf16``).  Only wire bytes cross from rank to
  rank: reduce-scatter hops encode the moving partial into the sender's
  wire buffer and the receiver decodes and adds in float32; the all-gather
  encodes each reduced chunk once at its owner, which adopts the decoded
  values, and forwards the bits verbatim, so every rank ends with the same
  bits.  A reduce-scatter alone returns each rank's owned chunk only.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version (:func:`_ring_plain`, :func:`_fused_ring_plain`: the same walk, hop
by hop, in torch) for a CPU tensor, and counts its launches in
``<wrapper>.launches``.  A launch does not wait for its kernel and
allocates nothing but its output (K5: and its wire buffers): a spin that
ran out is reported into a per-stream ring of pinned host records and
raised by :func:`check_errors`, which the next launch calls for the
launches that have finished and a caller calls at its own synchronisation
point for the rest.

The planner's tile padding (``_tile_elems``: 8×128 fp32, 16×128 bf16) is a
Mosaic rule, but it also fixes the chunk layout, and with it the ZeRO-1
shard layout and the order in which each element is summed, so the port
keeps it: results equal the JAX kernels' bit for bit.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import sys
from dataclasses import dataclass
from typing import Any, Deque, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.quant.codec import DEFAULT_BLOCK_SIZE, dequantize_int8, quantize_int8

_LANES = 128

#: env override for the ring staging granularity (chunk-size sweeps); wins
#: over both the caller's value and the strategy's chunk_bytes
RING_CHUNK_ENV = "ADAPCC_RING_CHUNK_BYTES"

#: env gate of the fused wire-codec kernels: ``auto`` fuses wherever the
#: plan allows, ``off`` pins the unfused quant ring, ``on`` demands the fused
#: kernels and raises where they cannot run (a typo raises too)
FUSED_WIRE_ENV = "ADAPCC_FUSED_WIRE"
FUSED_WIRE_MODES = ("auto", "on", "off")

#: wire dtypes the fused kernels speak, with their wire itemsize
_FUSED_WIRE_ITEMSIZE = {"bf16": 2, "int8": 1}
#: their ids in csrc/ring.cu (kWireInt8, kWireBf16)
_WIRE_CODES = {"int8": 1, "bf16": 2}
#: rows of a fused kernel's warp batch (csrc/ring.cu kBatchElems / 128):
#: its chunks and stage tiles are whole batches
_FUSED_ROWS = 8

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the kernels' limits (csrc/ring.cu kMaxWorld, kMaxBlocks, kFlagWords)
_MAX_WORLD = 32
_MAX_BLOCKS = 1024
_FLAG_WORDS = 8
#: int32 words of one report (csrc/ring.cu kRep*): a 64-bit tag (the epoch
#: of the call whose spin ran out), kind, rank, step, tile, block
_REPORT_WORDS = 8
#: reports per stream, reused in turn
_REPORT_SLOTS = 64
#: a spin that waits longer than this fails the call instead of hanging it
DEFAULT_TIMEOUT_S = 10.0


def _tile_elems(dtype: torch.dtype) -> int:
    sublanes = {4: 8, 2: 16, 1: 32}.get(dtype.itemsize, 8)
    return _LANES * sublanes


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def resolve_chunk_bytes(chunk_bytes: Optional[int] = None) -> int:
    """The staging granularity in force: the ``ADAPCC_RING_CHUNK_BYTES``
    sweep override wins, then the caller's value, then the default.  A
    malformed override raises: a typo silently falling back to the default
    would invalidate a chunk-size sweep."""
    env = os.environ.get(RING_CHUNK_ENV)
    if env is not None and env.strip():
        try:
            value = int(env)
        except ValueError:
            raise ValueError(f"{RING_CHUNK_ENV}={env!r}: expected a positive byte count") from None
        if value <= 0:
            raise ValueError(f"{RING_CHUNK_ENV}={env!r}: expected a positive byte count")
        return value
    if chunk_bytes is not None:
        if chunk_bytes <= 0:
            raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
        return int(chunk_bytes)
    return DEFAULT_CHUNK_BYTES


def resolve_fused_wire() -> str:
    """The fused-wire gate in force (``auto`` | ``on`` | ``off``)."""
    env = os.environ.get(FUSED_WIRE_ENV)
    if env is None or not env.strip():
        return "auto"
    mode = env.strip().lower()
    if mode not in FUSED_WIRE_MODES:
        raise ValueError(f"{FUSED_WIRE_ENV}={env!r}: expected one of {'|'.join(FUSED_WIRE_MODES)}")
    return mode


def fused_wire_unsupported_reason(dtype: torch.dtype, wire_dtype: str,
                                  block_size: Optional[int] = None) -> Optional[str]:
    """Why the fused codec kernels cannot run this configuration, or None.
    The codec is defined on float32 payloads, and the kernels' codec blocks
    nest in every staging tile as whole 128-element rows whose count divides
    the float32 tile's 8: ``block_size`` is one of 128, 256, 512, 1024."""
    if wire_dtype == "off":
        return "wire_dtype=off has no codec to fuse (the plain kernels ship the payload)"
    if wire_dtype not in _FUSED_WIRE_ITEMSIZE:
        return (f"wire_dtype={wire_dtype!r} has no fused kernel "
                f"(fused codecs: {'|'.join(sorted(_FUSED_WIRE_ITEMSIZE))})")
    if dtype != torch.float32:
        return (f"fused wire codecs are defined on float32 payloads, got {_dtype_name(dtype)} "
                "(quant/codec.py block semantics)")
    if wire_dtype == "int8":
        block_size = DEFAULT_BLOCK_SIZE if block_size is None else block_size
        rows = block_size // _LANES
        if block_size % _LANES or rows < 1 or 8 % rows:
            return (f"int8 block_size={block_size} cannot tile the staging: need a multiple of "
                    f"{_LANES} whose {_LANES}-element row count divides the float32 tile's 8 rows "
                    "(one of 128|256|512|1024)")
    return None


def fused_ring_dispatch_reason(dtype: torch.dtype, wire_dtype: str,
                               block_size: Optional[int] = None) -> Optional[str]:
    """Why a dispatch cannot take the fused wire path (the env gate, or a
    payload dtype or block size the codec kernels cannot take), or None when
    it can.  Under ``ADAPCC_FUSED_WIRE=on`` any reason raises instead of
    rerouting.  The card is no reason: a CUDA tensor on a card the kernels
    were not built for raises at launch, as K1's does."""
    mode = resolve_fused_wire()
    if mode == "off":
        reason: Optional[str] = f"{FUSED_WIRE_ENV}=off pins the unfused path"
    else:
        reason = fused_wire_unsupported_reason(dtype, wire_dtype, block_size)
    if reason is not None and mode == "on":
        raise ValueError(f"{FUSED_WIRE_ENV}=on but the fused wire path cannot run: {reason}")
    return reason


_REROUTE_NOTED: set = set()


def note_quant_reroute(wire_dtype: str, reason: str) -> None:
    """Say once per process and reason, on stderr, that a codec dispatch left
    the fused ring kernels for the unfused quant ring: whoever reads the
    throughput must know which data plane produced it."""
    key = (wire_dtype, reason)
    if key in _REROUTE_NOTED:
        return
    _REROUTE_NOTED.add(key)
    print(f"adapcc: wire_dtype={wire_dtype} ring collective rerouted off the fused ring kernels "
          f"onto the unfused quant ring (impl=quant_ring): {reason}", file=sys.stderr)


def _scale_rows(n_blocks: int) -> int:
    """Rows of the JAX kernels' float32 scale tile for ``n_blocks`` scales:
    whole 128-lane rows, padded to the float32 tile's 8 (the plan's record)."""
    rows = -(-n_blocks // _LANES)
    return -(-rows // 8) * 8


def _wire_geometry(stage_rows: int, wire_dtype: str, block_size: int) -> Tuple[int, int]:
    """``(wire_stage_bytes, scale_slot_bytes)`` of one ``[stage_rows, 128]``
    float32 staging tile under a fused codec, as the JAX planner records
    them."""
    wire_stage = stage_rows * _LANES * _FUSED_WIRE_ITEMSIZE[wire_dtype]
    if wire_dtype != "int8":
        return wire_stage, 0
    n_blocks = stage_rows * _LANES // block_size
    return wire_stage, _scale_rows(n_blocks) * _LANES * 4


def _fused_slot_bytes(elems: int, wire_dtype: str, block_size: int) -> int:
    """Wire bytes of ``elems`` float32 elements under a fused codec, as
    ``csrc/ring.cu`` lays them out (``fused_chunk_bytes``): the codes, then
    (int8) one float32 scale per block, rounded up to 16 bytes.  A chunk's
    is one chunk of a K5 wire buffer; a staging tile's is the plan's
    ``slot_bytes``."""
    size = elems * _FUSED_WIRE_ITEMSIZE[wire_dtype]
    if wire_dtype == "int8":
        size += elems // block_size * 4
    return -(-size // 16) * 16


@dataclass(frozen=True)
class RingSchedule:
    """The executed ring schedule: which path ran, at what staging
    granularity (the JAX planner's record, field for field)."""

    path: str              #: "vmem" (K1a) | "hbm-stream" (K1b)
    world: int
    steps: int             #: ring steps (RS + AG walks)
    chunk_bytes: int       #: requested staging budget (resolved)
    stage_bytes: int       #: executed tile bytes (near-budget, minimal padding)
    n_tiles: int           #: tiles per ring step on the hbm-stream path
    payload_bytes: int     #: caller bytes before padding
    padded_bytes: int      #: world × tile-padded chunk bytes
    dtype: str = "float32"
    #: wire codec fused into the kernels ("off": the plain kernels)
    wire_dtype: str = "off"
    #: int8 quantization block (elements per float32 scale); 0 without blocks
    block_size: int = 0
    #: bytes of one staged wire tile (0 on the plain kernels)
    wire_stage_bytes: int = 0
    #: bytes of the JAX kernels' float32 scale tile (int8 plans only)
    scale_slot_bytes: int = 0

    @property
    def slot_bytes(self) -> int:
        """Wire bytes of one staging tile of the CUDA kernels: none for the
        plain kernels; under a codec the tile's codes and (int8) one float32
        scale per block, rounded up to 16 bytes (:func:`_fused_slot_bytes`).
        Neither family stages anything: each hop's result is written once,
        where the next rank reads it."""
        if self.wire_dtype == "off":
            return 0
        return _fused_slot_bytes(self.stage_bytes // 4, self.wire_dtype, self.block_size)

    def to_row(self) -> dict:
        """The JAX record's row, field for field.  ``wire_stage_bytes`` and
        ``scale_slot_bytes`` are the TPU planner's staging geometry (a scale
        tile padded to 8 rows of 128), kept for parity; the CUDA kernels'
        wire tile is :attr:`slot_bytes`."""
        return {
            "ring_path": self.path,
            "chunk_bytes": self.chunk_bytes,
            "stage_bytes": self.stage_bytes,
            "n_tiles": self.n_tiles,
            "steps": self.steps,
            "world": self.world,
            "payload_bytes": self.payload_bytes,
            "padded_bytes": self.padded_bytes,
            "wire_dtype": self.wire_dtype,
            "wire_stage_bytes": self.wire_stage_bytes,
            "scale_slot_bytes": self.scale_slot_bytes,
        }


def _stage_rows_for(chunk_rows: int, sublanes: int, budget_bytes: int, row_bytes: int) -> int:
    """Near-budget whole-tile staging size with minimal padding: the chunk
    is covered by ``n = ceil(k / target)`` tiles of ``s = ceil(k / n)``
    native tiles each, so the zero padding is under one staging tile per
    chunk, and is the budget itself when the budget divides the chunk."""
    k = chunk_rows // sublanes  # chunk is tile-aligned by construction
    target = max(1, budget_bytes // (row_bytes * sublanes))
    n = -(-k // target)
    return -(-k // n) * sublanes


def plan_ring_schedule(
    nelems: int,
    dtype: torch.dtype,
    world: int,
    chunk_bytes: Optional[int] = None,
    rs: bool = True,
    ag: bool = True,
    wire_dtype: str = "off",
    block_size: Optional[int] = None,
) -> RingSchedule:
    """Path selection and executed tile size for a ring collective over
    ``nelems`` elements of ``dtype`` (one rank's payload across the ``world``
    chunks): ``vmem`` when the whole padded payload fits one ``chunk_bytes``
    budget, ``hbm-stream`` above it.

    ``wire_dtype`` other than ``"off"`` plans the fused codec kernels: on
    int8 the staging budget also covers each row's share of the float32
    scales, and the plan records the wire geometry.  The chunk layout is the
    payload dtype's on every codec, so ZeRO-1 shards do not depend on it."""
    if wire_dtype != "off":
        block_size = DEFAULT_BLOCK_SIZE if block_size is None else block_size
        reason = fused_wire_unsupported_reason(dtype, wire_dtype, block_size)
        if reason is not None:
            raise ValueError(f"cannot plan a fused wire ring: {reason}")
    fused = wire_dtype != "off"
    blk = int(block_size) if fused and wire_dtype == "int8" else 0
    itemsize = dtype.itemsize
    tile = _tile_elems(dtype)
    sublanes = tile // _LANES
    chunk = -(-max(1, int(nelems)) // max(1, world))  # ceil elems per rank
    chunk = -(-chunk // tile) * tile                  # whole dtype tiles
    padded_bytes = world * chunk * itemsize
    budget = resolve_chunk_bytes(chunk_bytes)
    steps = (world - 1 if rs else 0) + (world - 1 if ag else 0)
    common = dict(world=world, steps=steps, chunk_bytes=budget,
                  payload_bytes=int(nelems) * itemsize, dtype=_dtype_name(dtype),
                  wire_dtype=wire_dtype, block_size=blk)
    chunk_rows = chunk // _LANES
    if world == 1 or padded_bytes <= budget:
        wire_stage, scale_slot = _wire_geometry(chunk_rows, wire_dtype, blk) if fused else (0, 0)
        return RingSchedule(path="vmem", stage_bytes=chunk * itemsize, n_tiles=1,
                            padded_bytes=padded_bytes, wire_stage_bytes=wire_stage,
                            scale_slot_bytes=scale_slot, **common)
    # on int8 a staged row also carries its share of the block scales
    # (rounded up, so block 1024's half byte a row still counts)
    row_bytes = _LANES * itemsize + (-(-(_LANES * 4) // blk) if blk else 0)
    stage_rows = _stage_rows_for(chunk_rows, sublanes, budget, row_bytes)
    n_tiles = -(-chunk_rows // stage_rows)
    wire_stage, scale_slot = _wire_geometry(stage_rows, wire_dtype, blk) if fused else (0, 0)
    return RingSchedule(
        path="hbm-stream", stage_bytes=stage_rows * _LANES * itemsize, n_tiles=n_tiles,
        # each chunk zero-padded to whole staging tiles (sliced back out)
        padded_bytes=world * n_tiles * stage_rows * _LANES * itemsize,
        wire_stage_bytes=wire_stage, scale_slot_bytes=scale_slot, **common,
    )


# --------------------------------------------------------------------------- #
# the plain version: the same walk, hop by hop
# --------------------------------------------------------------------------- #


def _ring_plain(stacked: torch.Tensor, rs: bool, ag: bool) -> torch.Tensor:
    """The ring walk over ``[world, world, S, 128]`` (rank, chunk, rows,
    lanes), step by step with the kernels' per-hop arithmetic: the work
    buffer every rank holds at the end (its input, where nothing landed).
    An all-gather alone may take ``[world, S, 128]``, rank ``r``'s own chunk
    ``r``: the only chunk of the input that walk reads.

    At each step every rank ships the chunk it sends and the chunk it
    receives from its left neighbour is added to its own copy
    (``local + landed`` in the payload dtype, as ``work[recv_idx] +
    comm[slot]`` in the Pallas kernels) or, in the all-gather, adopted.
    """
    world = stacked.shape[0]
    ranks = torch.arange(world, device=stacked.device)
    if stacked.dim() == 3:
        if rs or not ag:
            raise ValueError("only an all-gather alone takes [world, rows, 128]")
        work = stacked.new_zeros((world, *stacked.shape))
        work[ranks, ranks] = stacked
    else:
        work = stacked.clone()
    n_rs = world - 1 if rs else 0
    n_ag = world - 1 if ag else 0
    # after RS each rank owns the reduced chunk r + 1; a pure AG starts at r
    own = 1 if rs else 0
    for step in range(n_rs + n_ag):
        in_rs = step < n_rs
        send_idx = (ranks - step) % world if in_rs else (ranks + own - (step - n_rs)) % world
        recv_idx = (send_idx - 1) % world
        landed = work[ranks, send_idx].roll(1, dims=0)  # rank r receives from r − 1
        work[ranks, recv_idx] = work[ranks, recv_idx] + landed if in_rs else landed
    return work


def _encode(vals: torch.Tensor, wire_dtype: str, block_size: int) -> Tuple[torch.Tensor, ...]:
    """Wire arrays of ``[world, S, 128]`` float32 chunks: bf16 values, or
    int8 codes and ``[world, blocks]`` scales (blocks nest in each chunk)."""
    if wire_dtype == "bf16":
        return (vals.to(torch.bfloat16),)
    q, scales = quantize_int8(vals.reshape(-1), block_size)
    return q.reshape(vals.shape), scales.reshape(vals.shape[0], -1)


def _decode(wire: Tuple[torch.Tensor, ...], wire_dtype: str, block_size: int) -> torch.Tensor:
    """Inverse of :func:`_encode`: ``[world, S, 128]`` float32."""
    if wire_dtype == "bf16":
        return wire[0].to(torch.float32)
    q, scales = wire
    return dequantize_int8(q.reshape(-1, block_size), scales.reshape(-1)).reshape(q.shape)


def _fused_ring_plain(stacked: torch.Tensor, rs: bool, ag: bool, wire_dtype: str,
                      block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    """The fused ring walk over ``[world, world, S, 128]`` float32 (an
    all-gather alone may take ``[world, S, 128]``, each rank's own chunk),
    step by step with the fused kernels' per-hop arithmetic; returns every
    rank's work buffer.

    - Reduce-scatter hops encode the chunk in flight; the receiver adds the
      decoded values to its float32 copy (``local + q·s``: a multiply, then
      an add, each rounded).
    - The first all-gather hop encodes each reduced chunk once, and its
      owner adopts the decoded values; later hops forward the bits that
      landed at the hop before.
    - A reduce-scatter alone keeps the owned chunk as the float32 sum, and
      an all-gather alone encodes each rank's own chunk once.
    """
    world = stacked.shape[0]
    ranks = torch.arange(world, device=stacked.device)
    if stacked.dim() == 3:
        if rs or not ag:
            raise ValueError("only an all-gather alone takes [world, rows, 128]")
        work = stacked.new_zeros((world, *stacked.shape))
        work[ranks, ranks] = stacked
    else:
        work = stacked.clone()
    n_rs = world - 1 if rs else 0
    n_ag = world - 1 if ag else 0
    own = 1 if rs else 0
    store: Optional[Tuple[torch.Tensor, ...]] = None  # landed AG wire, [rank, chunk, ...]
    for step in range(n_rs + n_ag):
        in_rs = step < n_rs
        send_idx = (ranks - step) % world if in_rs else (ranks + own - (step - n_rs)) % world
        recv_idx = (send_idx - 1) % world
        if in_rs or step == n_rs:
            wire = _encode(work[ranks, send_idx], wire_dtype, block_size)
            if not in_rs:  # the owner adopts its decoded chunk
                work[ranks, send_idx] = _decode(wire, wire_dtype, block_size)
        else:
            wire = tuple(w[ranks, send_idx] for w in store)
        landed = tuple(w.roll(1, dims=0) for w in wire)  # rank r receives from r − 1
        decoded = _decode(landed, wire_dtype, block_size)
        if in_rs:
            work[ranks, recv_idx] = work[ranks, recv_idx] + decoded
            continue
        work[ranks, recv_idx] = decoded
        if store is None:
            store = tuple(w.new_empty((world, *w.shape)) for w in landed)
        for kept, w in zip(store, landed):
            kept[ranks, recv_idx] = w
    return work


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

_P, _I, _LL, _ULL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
#: C signatures.  K1: x, out, flags, fail, report, world, chunk_elems,
#: [stage_elems,] rs, ag, x_own, is_bf16, epoch, timeout_ns, fault_rank,
#: device, done event, stream.  K5: x, out, wire, flags, fail, report, world,
#: chunk_elems, [stage_elems,] rs, ag, x_own, wire code, block_size,
#: chunk_wire_bytes, epoch, timeout_ns, fault_rank, device, done event, stream.
_TAIL = [_ULL, _ULL, _I, _I, _P, _P]
_SIGNATURES = {
    "adapcc_ring_k1a": [_P] * 5 + [_I, _LL] + [_I] * 4 + _TAIL,
    "adapcc_ring_k1b": [_P] * 5 + [_I, _LL, _LL] + [_I] * 4 + _TAIL,
    "adapcc_ring_k5a": [_P] * 6 + [_I, _LL] + [_I] * 5 + [_LL] + _TAIL,
    "adapcc_ring_k5b": [_P] * 6 + [_I, _LL, _LL] + [_I] * 5 + [_LL] + _TAIL,
}
#: what a rank waited for when its spin ran out (csrc/ring.cu kWait*)
_WAITS = {1: "the entry barrier", 2: "data from its left neighbour"}


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/ring.cu``, built at first use, with its signatures."""
    from adapcc_tpu_torch.ops import _build

    lib = _build.load("ring")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.adapcc_ring_error_string.argtypes = [ctypes.c_int]
    lib.adapcc_ring_error_string.restype = ctypes.c_char_p
    return lib


class _StreamState:
    """What the ring launches on one (device, stream) keep across calls.

    - The flag words.  Every call takes a fresh epoch above every value an
      earlier call wrote and compares flags against ``epoch + k``, so no
      reset pass runs between calls.
    - The failure word on the card: a kernel whose spin runs out raises it
      to its call's epoch, which the call's other blocks watch.
    - A ring of ``_REPORT_SLOTS`` reports in pinned host memory, each with an
      event that the launch records behind its kernel.  The failing kernel writes where it
      waited, tagged with its epoch, straight into its call's report, so a
      report is reused without being cleared and no copy or fill runs a call.

    Calls on one stream are ordered; a second stream gets state of its own.
    """

    def __init__(self, device: torch.device) -> None:
        self.flags: Optional[torch.Tensor] = None
        self.next_epoch = 1
        self.fail = torch.zeros(1, dtype=torch.int64, device=device)
        self.reports = torch.zeros((_REPORT_SLOTS, _REPORT_WORDS), dtype=torch.int32, pin_memory=True)
        self.reports_np = self.reports.numpy()  # the same memory, read without a tensor per report
        self.done = [torch.cuda.Event() for _ in range(_REPORT_SLOTS)]
        for event in self.done:  # created on the device; the launches record them from C
            event.record(torch.cuda.current_stream(device))
        #: reports whose launch check_errors has not read yet
        self.unread = [False] * _REPORT_SLOTS
        self.calls = 0

    def take(self, device: torch.device, world: int, total_iters: int) -> Tuple[torch.Tensor, int, int]:
        """``(flags, epoch, report slot)`` of the next call on this stream."""
        need = world * _MAX_BLOCKS * _FLAG_WORDS
        if self.flags is None or self.flags.numel() < need:
            self.flags = torch.zeros(need, dtype=torch.int64, device=device)
        epoch = self.next_epoch
        self.next_epoch = epoch + total_iters + 2
        slot = self.calls % _REPORT_SLOTS
        self.calls += 1
        while self.unread[slot]:  # the slot's last launch is still unread
            _read_oldest(wait=True)
        return self.flags, epoch, slot


_STREAMS: Dict[Tuple[int, int], _StreamState] = {}


#: card indices a launch has already checked with _check_card
_CHECKED_CARDS: set = set()


def _check_card(device: torch.device) -> None:
    """Raise unless ``device`` is a card the ring kernels are built for
    (sm_90a): a tensor that is not on the CPU runs its kernel or nothing."""
    if device.type != "cuda":
        raise ValueError(f"ring kernels run on CUDA or CPU tensors, got {device}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"the ring kernels are built for sm_90a; {device} is sm_{cap[0]}{cap[1]}")


def _check_kernel_inputs(chunks: torch.Tensor, stage_rows: int, rs: bool, ag: bool, fused: bool) -> None:
    """Raise on what the ring kernels do not take (a fused kernel's codec and
    dtype were checked by :func:`_codec`)."""
    dev = chunks.device
    if dev.type != "cuda" or dev.index not in _CHECKED_CARDS:
        _check_card(dev)
        _CHECKED_CARDS.add(dev.index)
    if not fused and chunks.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"ring kernels take float32 or bfloat16, got {chunks.dtype}")
    own = chunks.dim() == 3 and ag and not rs  # an all-gather alone: own chunks only
    if chunks.shape[-1] != _LANES or not (own or chunks.dim() == 4 and chunks.shape[0] == chunks.shape[1]):
        raise ValueError(f"ring kernels take [world, world, rows, {_LANES}] (or [world, rows, {_LANES}] "
                         f"for an all-gather alone), got {tuple(chunks.shape)}")
    world, rows = chunks.shape[0], chunks.shape[-2]
    if not 2 <= world <= _MAX_WORLD:
        raise ValueError(f"ring kernels take a world of 2 to {_MAX_WORLD}, got {world}")
    # every kernel bounds each stripe by the chunk's real length, so a last
    # tile may be ragged; K5's warps code whole 8-row tiles (1024 elements:
    # whole codec units of every block size)
    if not 0 < stage_rows <= rows:
        raise ValueError(f"chunk rows {rows} do not stream in stage tiles of {stage_rows} rows")
    if fused and (rows % _FUSED_ROWS or stage_rows % _FUSED_ROWS):
        raise ValueError(f"the fused kernels take chunks and stage tiles of whole {_FUSED_ROWS}-row tiles "
                         f"(whole codec units), got {rows} and {stage_rows} rows")
    if not chunks.is_contiguous() or chunks.data_ptr() % 16:
        raise ValueError("ring kernels need a contiguous, 16-byte aligned tensor")


class _Pending(NamedTuple):
    """A launch whose report check_errors has not read yet."""

    done: Any                 #: torch.cuda.Event recorded behind the launch
    state: _StreamState
    slot: int
    epoch: int
    entry: str
    timeout_s: float


_PENDING: Deque[_Pending] = collections.deque()


def _read_oldest(wait: bool) -> bool:
    """Read the oldest unread launch's report and raise if its spin ran
    out; ``False`` (nothing read) if ``wait`` is false and it has not
    finished."""
    pending = _PENDING[0]
    if wait:
        pending.done.synchronize()
    elif not pending.done.query():
        return False
    _PENDING.popleft()
    lo, hi, kind, rank, step, tile, block = pending.state.reports_np[pending.slot, :7].tolist()
    pending.state.unread[pending.slot] = False
    if kind and (lo & 0xFFFFFFFF) | (hi & 0xFFFFFFFF) << 32 == pending.epoch:
        raise RuntimeError(
            f"{pending.entry}: ring protocol wedged: rank {rank} (block {block}) waited more "
            f"than {pending.timeout_s} s for {_WAITS.get(kind, kind)} at step {step}, tile {tile}"
        )
    return True


def check_errors(wait: bool = True) -> None:
    """Raise ``RuntimeError`` for the first earlier launch whose spin ran
    out, naming its rank, block, step and tile.  ``wait=False`` reads only
    the launches that have finished and never blocks; ``wait=True`` waits
    for every launch made so far."""
    while _PENDING and _read_oldest(wait):
        pass


def _launch(entry: str, chunks: torch.Tensor, rs: bool, ag: bool, stage_rows: int,
            timeout_s: float, fault_rank: int, codec: Optional[Tuple[str, int]] = None) -> torch.Tensor:
    """Launch ``<entry>`` on the current stream; raises if the launch is
    refused, or for an earlier launch that has finished with a spin run out.
    A spin that runs out is reported in pinned host memory, for
    :func:`check_errors`: nothing here waits for the card.
    ``codec`` (``(wire_dtype, block_size)``) launches a fused kernel, with a
    wire buffer of ``world`` chunks a rank (codes, then int8 scales) from
    the caching allocator; its walk has a prologue phase before the ring's
    steps, and a reduce-scatter alone returns each rank's owned chunk only
    (``[world, rows, 128]``, row ``r`` chunk ``(r + 1) % world``)."""
    check_errors(wait=False)
    _check_kernel_inputs(chunks, stage_rows, rs, ag, codec is not None)
    world, rows = chunks.shape[0], chunks.shape[-2]
    n_tiles = -(-rows // stage_rows)
    steps = (world - 1) * (int(rs) + int(ag))
    geometry = [rows * _LANES] + ([stage_rows * _LANES] if entry.endswith("b") else [])
    dev = chunks.device
    if codec is None:
        out = torch.empty((world, world, rows, _LANES), dtype=chunks.dtype, device=dev)
        buffers: list = []
        tail = [int(chunks.dtype == torch.bfloat16)]
        phases = steps
    else:
        out = torch.empty((world, rows, _LANES) if rs and not ag else (world, world, rows, _LANES),
                          dtype=chunks.dtype, device=dev)
        wire_dtype, block_size = codec
        chunk_wire_bytes = _fused_slot_bytes(rows * _LANES, wire_dtype, block_size)
        wire = torch.empty(world * world * chunk_wire_bytes, dtype=torch.uint8, device=dev)
        buffers = [wire.data_ptr()]
        tail = [_WIRE_CODES[wire_dtype], block_size, chunk_wire_bytes]
        phases = 1 + steps
    # the handle of the device's current stream, without a Stream object (the
    # launch runs on it, on that device, and records the done event there)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    key = (dev.index, stream)
    state = _STREAMS.get(key) or _STREAMS.setdefault(key, _StreamState(dev))
    flags, epoch, slot = state.take(dev, world, phases * n_tiles)
    done = state.done[slot]
    rc = getattr(_library(), entry)(
        chunks.data_ptr(), out.data_ptr(), *buffers, flags.data_ptr(), state.fail.data_ptr(),
        state.reports.data_ptr() + slot * _REPORT_WORDS * 4,
        world, *geometry, int(rs), int(ag), int(chunks.dim() == 3), *tail,
        epoch, int(timeout_s * 1e9), fault_rank, dev.index, done.cuda_event, stream,
    )
    if rc != 0:
        msg = _library().adapcc_ring_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} at launch ({msg})")
    state.unread[slot] = True
    _PENDING.append(_Pending(done, state, slot, epoch, entry, timeout_s))
    return out


_PHASES = {(True, False): "rs", (False, True): "ag", (True, True): "rs+ag"}


def _count(wrapper, rs: bool, ag: bool) -> None:
    wrapper.launches += 1
    wrapper.phases[_PHASES[bool(rs), bool(ag)]] += 1


def ring_k1a(chunks: torch.Tensor, rs: bool, ag: bool, *,
             timeout_s: float = DEFAULT_TIMEOUT_S, fault_rank: int = -1) -> torch.Tensor:
    """K1a: the ring walk over ``[world, world, S, 128]`` (an all-gather
    alone: ``[world, S, 128]``, each rank's own chunk) with each chunk in one
    tile (the ``vmem`` path); returns every rank's ``[world, world, S, 128]``
    work buffer.

    ``fault_rank`` makes that rank stop after the entry barrier, so its
    neighbours' spins run out after ``timeout_s`` (a wedged protocol must
    fail, not hang); -1 runs the walk.
    """
    if chunks.device.type == "cpu":
        return _ring_plain(chunks, rs, ag)
    out = _launch("adapcc_ring_k1a", chunks, rs, ag, chunks.shape[-2], timeout_s, fault_rank)
    _count(ring_k1a, rs, ag)
    return out


def ring_k1b(chunks: torch.Tensor, rs: bool, ag: bool, stage_rows: int, *,
             timeout_s: float = DEFAULT_TIMEOUT_S, fault_rank: int = -1) -> torch.Tensor:
    """K1b: the same walk with each chunk streamed in ``[stage_rows, 128]``
    tiles (the ``hbm-stream`` path); the last tile of a chunk may be
    ragged."""
    if chunks.device.type == "cpu":
        return _ring_plain(chunks, rs, ag)
    out = _launch("adapcc_ring_k1b", chunks, rs, ag, stage_rows, timeout_s, fault_rank)
    _count(ring_k1b, rs, ag)
    return out


def _codec(dtype: torch.dtype, wire_dtype: str, block_size: Optional[int]) -> Tuple[str, int]:
    """The fused kernels' ``(wire_dtype, block_size)`` for a ``dtype``
    payload (a bf16 wire has no blocks: 0); raises where they cannot run,
    so nothing runs float32 under a codec's name."""
    block_size = (DEFAULT_BLOCK_SIZE if block_size is None else int(block_size)) if wire_dtype == "int8" else 0
    reason = fused_wire_unsupported_reason(dtype, wire_dtype, block_size)
    if reason is not None:
        raise ValueError(f"wire_dtype={wire_dtype!r} cannot run on the fused ring: {reason}")
    return wire_dtype, block_size


def _fused_plain_result(chunks: torch.Tensor, rs: bool, ag: bool, codec: Tuple[str, int]) -> torch.Tensor:
    """What a fused kernel returns, from its plain version: every rank's
    work buffer, or for a reduce-scatter alone each rank's owned chunk."""
    work = _fused_ring_plain(chunks, rs, ag, *codec)
    if ag:
        return work
    ranks = torch.arange(chunks.shape[0])
    return work[ranks, (ranks + 1) % chunks.shape[0]]


def ring_k5a(chunks: torch.Tensor, rs: bool, ag: bool, wire_dtype: str, block_size: Optional[int] = None, *,
             timeout_s: float = DEFAULT_TIMEOUT_S, fault_rank: int = -1) -> torch.Tensor:
    """K5a: K1a's walk (each chunk one stage) on a float32 payload with the
    ``wire_dtype`` codec (``int8`` at ``block_size``, or ``bf16``) on the
    wire; the same shapes and ``fault_rank`` as :func:`ring_k1a`, except
    that a reduce-scatter alone returns ``[world, S, 128]``: row ``r`` is
    the chunk ``(r + 1) % world`` that rank ``r`` owns, the walk's only
    float32 result (it never writes a partial)."""
    codec = _codec(chunks.dtype, wire_dtype, block_size)
    if chunks.device.type == "cpu":
        return _fused_plain_result(chunks, rs, ag, codec)
    out = _launch("adapcc_ring_k5a", chunks, rs, ag, chunks.shape[-2], timeout_s, fault_rank, codec)
    _count(ring_k5a, rs, ag)
    return out


def ring_k5b(chunks: torch.Tensor, rs: bool, ag: bool, stage_rows: int, wire_dtype: str,
             block_size: Optional[int] = None, *, timeout_s: float = DEFAULT_TIMEOUT_S,
             fault_rank: int = -1) -> torch.Tensor:
    """K5b: the fused walk with each chunk streamed in ``[stage_rows, 128]``
    tiles; the last tile of a chunk may be ragged (chunk and tile rows are
    whole 8-row tiles).  Shapes as :func:`ring_k5a`."""
    codec = _codec(chunks.dtype, wire_dtype, block_size)
    if chunks.device.type == "cpu":
        return _fused_plain_result(chunks, rs, ag, codec)
    out = _launch("adapcc_ring_k5b", chunks, rs, ag, stage_rows, timeout_s, fault_rank, codec)
    _count(ring_k5b, rs, ag)
    return out


for _w in (ring_k1a, ring_k1b, ring_k5a, ring_k5b):
    _w.launches = 0
    #: launches by phase: "rs", "ag" or "rs+ag"
    _w.phases = collections.Counter()

#: the kernel wrappers, in the order of the TPU kernels they replace
KERNELS = (ring_k1a, ring_k1b, ring_k5a, ring_k5b)


# --------------------------------------------------------------------------- #
# dispatch and the stacked (single-controller) collectives
# --------------------------------------------------------------------------- #


def _pad_chunks(flat: torch.Tensor, world: int) -> Tuple[torch.Tensor, int]:
    """``[ranks, n]`` → ``[ranks, world, chunk/128, 128]`` chunk-major, each
    rank's payload padded to ``world`` whole dtype tiles (a view when no
    padding is needed)."""
    tile = _tile_elems(flat.dtype)
    ranks, n = flat.shape
    chunk = -(-n // world)
    chunk = -(-chunk // tile) * tile
    if world * chunk != n:
        flat = F.pad(flat, (0, world * chunk - n))
    return flat.reshape(ranks, world, chunk // _LANES, _LANES), chunk


def _run_ring_chunks(chunks: torch.Tensor, *, rs: bool, ag: bool, chunk_bytes: Optional[int] = None,
                     wire_dtype: str = "off", block_size: Optional[int] = None) -> torch.Tensor:
    """Run the ring on ``[world, world, S, 128]`` (an all-gather alone:
    ``[world, S, 128]``, each rank's own chunk), dispatching to K1a or K1b
    per the planned schedule (K5a or K5b when ``wire_dtype`` names a codec);
    returns ``[world, world, S, 128]`` (a fused reduce-scatter alone: each
    rank's owned chunk, ``[world, S, 128]``).  The stream kernels take the
    chunks as they are: a chunk's last tile may be ragged.  A codec the
    fused kernels cannot run raises: nothing runs float32 under a codec's
    name."""
    chunks = chunks.contiguous()
    world = chunks.shape[0]
    nelems = chunks[0].numel() * (world if chunks.dim() == 3 else 1)
    codec = _codec(chunks.dtype, wire_dtype, block_size) if wire_dtype != "off" else ()
    plan = plan_ring_schedule(nelems, chunks.dtype, world, chunk_bytes, rs=rs, ag=ag, wire_dtype=wire_dtype,
                              block_size=(codec[1] or None) if codec else None)
    if plan.path == "vmem":
        return ring_k5a(chunks, rs, ag, *codec) if codec else ring_k1a(chunks, rs, ag)
    stage_rows = plan.stage_bytes // (_LANES * chunks.dtype.itemsize)
    return ring_k5b(chunks, rs, ag, stage_rows, *codec) if codec else ring_k1b(chunks, rs, ag, stage_rows)


def ring_allreduce_stacked(stacked: torch.Tensor, chunk_bytes: Optional[int] = None,
                           wire_dtype: str = "off", block_size: Optional[int] = None) -> torch.Tensor:
    """Sum-allreduce of every rank's row of ``[world, ...]``: ring
    reduce-scatter then ring all-gather, one kernel launch
    (``ring_allreduce_shard`` for all ranks); ``wire_dtype`` runs the fused
    codec kernels."""
    world = stacked.shape[0]
    if world == 1:
        return stacked
    flat = stacked.reshape(world, -1)
    chunks, _ = _pad_chunks(flat, world)
    out = _run_ring_chunks(chunks, rs=True, ag=True, chunk_bytes=chunk_bytes,
                           wire_dtype=wire_dtype, block_size=block_size)
    return out.reshape(world, -1)[:, : flat.shape[1]].reshape(stacked.shape)


def ring_reduce_scatter_stacked(stacked: torch.Tensor, chunk_bytes: Optional[int] = None,
                                wire_dtype: str = "off", block_size: Optional[int] = None) -> torch.Tensor:
    """Ring reduce-scatter of ``[world, ...]``: row ``r`` of the ``[world,
    chunk]`` result is what rank ``r`` holds, the reduced chunk ``(r + 1) %
    world`` of its flattened, tile-padded payload (``ring_reduce_scatter_shard``).
    Under a codec the owned chunk is the float32 sum of decoded hops, and the
    fused kernels return only the owned chunks: no copy gathers them."""
    world = stacked.shape[0]
    if world == 1:
        return stacked.reshape(1, -1)
    chunks, chunk = _pad_chunks(stacked.reshape(world, -1), world)
    out = _run_ring_chunks(chunks, rs=True, ag=False, chunk_bytes=chunk_bytes,
                           wire_dtype=wire_dtype, block_size=block_size)
    if wire_dtype != "off":
        return out.reshape(world, chunk)
    out = out.reshape(world, world, chunk)
    return torch.stack([out[r, (r + 1) % world] for r in range(world)])


def ring_all_gather_stacked(stacked: torch.Tensor, chunk_bytes: Optional[int] = None,
                            wire_dtype: str = "off", block_size: Optional[int] = None) -> torch.Tensor:
    """Ring all-gather of ``[world, chunk]`` (row ``r`` = rank ``r``'s
    tile-aligned payload): row ``r`` of the ``[world, world, chunk]`` result
    is the gathered stack as rank ``r`` holds it (``ring_all_gather_shard``).
    Under a codec each rank's chunk is encoded once and every rank, its
    owner too, holds the decoded bits."""
    world = stacked.shape[0]
    flat = stacked.reshape(world, -1)
    n = flat.shape[1]
    if world == 1:
        return flat.reshape(1, 1, n)
    tile = _tile_elems(stacked.dtype)
    if n % tile:
        raise ValueError(f"all-gather payload must be tile-aligned ({tile} elems), got {n}")
    # rank r's payload is its own chunk r, the one chunk of the input the
    # walk reads; the walk fills the others
    out = _run_ring_chunks(flat.reshape(world, n // _LANES, _LANES), rs=False, ag=True,
                           chunk_bytes=chunk_bytes, wire_dtype=wire_dtype, block_size=block_size)
    return out.reshape(world, world, n)
