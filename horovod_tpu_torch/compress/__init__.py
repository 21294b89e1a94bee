"""Wire codecs of the port: the registry of ``horovod_tpu/compress``.

The port's own copy of ``horovod_tpu/compress/__init__.py``'s codec
registry (``CompressionCodec``, ``QUANTIZED_CODECS``, ``CAST_CODECS``,
``codec_from_name``, ``codec_name``, ``codec_levels``, and the knobs'
``default_block_size`` and ``default_codec``):

  none         passthrough
  fp16 / bf16  wire-dtype cast
  int8         block-wise 8-bit affine quantization
  uint4        block-wise 4-bit affine quantization, two nibbles a byte

``quantize.py`` is the numpy block quantizer of the eager host planes and
``fused.py`` its single-pass passes over the native ``qencode`` and
``qdecode``; ``ops.py`` holds the torch block quantizer and the quantized
all-reduce that ``parallel/grad_sync.py`` and the device plane run.
"""
from __future__ import annotations

import enum


class CompressionCodec(enum.IntEnum):
    """Wire codec ids (the reference's control-plane numbering)."""
    NONE = 0
    FP16 = 1
    BF16 = 2
    INT8 = 3
    UINT4 = 4


#: Codecs that quantize (block scale + zero point) rather than cast.
QUANTIZED_CODECS = (CompressionCodec.INT8, CompressionCodec.UINT4)

#: Codecs that cast the wire dtype without quantizing.
CAST_CODECS = (CompressionCodec.FP16, CompressionCodec.BF16)

_BY_NAME = {
    "none": CompressionCodec.NONE,
    "fp16": CompressionCodec.FP16,
    "bf16": CompressionCodec.BF16,
    "int8": CompressionCodec.INT8,
    "uint4": CompressionCodec.UINT4,
}


def codec_from_name(name) -> CompressionCodec:
    """Resolve a codec from a user-facing spelling: a name string, a
    CompressionCodec, None, or an object exposing ``wire_codec``."""
    if name is None:
        return CompressionCodec.NONE
    if isinstance(name, CompressionCodec):
        return name
    wire = getattr(name, "wire_codec", None)
    if wire is not None:
        return codec_from_name(wire)
    try:
        return _BY_NAME[str(name).strip().lower()]
    except KeyError:
        raise ValueError(
            f"Unknown compression codec {name!r}; expected one of "
            f"{sorted(_BY_NAME)}") from None


def codec_name(codec: CompressionCodec) -> str:
    return CompressionCodec(codec).name.lower()


def codec_levels(codec: CompressionCodec) -> int:
    """Quantization levels (256 for int8 wire bytes, 16 for uint4)."""
    if codec == CompressionCodec.UINT4:
        return 16
    if codec == CompressionCodec.INT8:
        return 256
    raise ValueError(f"codec {codec!r} is not a quantized codec")


def default_block_size() -> int:
    from ..common import config
    return int(config.COMPRESSION_BLOCK_SIZE.get())


def default_codec() -> CompressionCodec:
    from ..common import config
    return codec_from_name(config.COMPRESSION.get())


from .quantize import (QuantizedBlocks, chunk_bounds, dequantize,  # noqa: E402
                       from_bytes, num_blocks, payload_nbytes, quantize,
                       roundtrip_error_bound, serialized_nbytes,
                       staged_nbytes, to_bytes)

__all__ = [
    "CompressionCodec", "QUANTIZED_CODECS", "CAST_CODECS",
    "codec_from_name", "codec_name", "codec_levels",
    "default_block_size", "default_codec",
    "QuantizedBlocks", "quantize", "dequantize", "to_bytes", "from_bytes",
    "num_blocks", "payload_nbytes", "serialized_nbytes", "staged_nbytes",
    "chunk_bounds", "roundtrip_error_bound",
]
