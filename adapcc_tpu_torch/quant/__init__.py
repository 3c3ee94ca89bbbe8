"""Wire codecs: block-wise quantized collectives and error feedback (the
port of :mod:`adapcc_tpu.quant`)."""

from adapcc_tpu_torch.quant.codec import (
    DEFAULT_BLOCK_SIZE,
    WIRE_DTYPE_ENV,
    WireCodec,
    codec_names,
    dequantize_int8,
    error_feedback_step,
    get_codec,
    int8_error_bound,
    int8_roundtrip,
    quantize_int8,
    register_codec,
    resolve_wire_dtype,
    timed_roundtrip,
)
from adapcc_tpu_torch.quant.ring import ring_error_bound, wire_ring_allreduce_stacked

__all__ = [
    "DEFAULT_BLOCK_SIZE",
    "WIRE_DTYPE_ENV",
    "WireCodec",
    "codec_names",
    "dequantize_int8",
    "error_feedback_step",
    "get_codec",
    "int8_error_bound",
    "int8_roundtrip",
    "quantize_int8",
    "register_codec",
    "resolve_wire_dtype",
    "ring_error_bound",
    "timed_roundtrip",
    "wire_ring_allreduce_stacked",
]
