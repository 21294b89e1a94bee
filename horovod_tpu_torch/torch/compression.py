"""Gradient compression for the torch binding (the contract of
``horovod_tpu/torch/compression.py``, upstream horovod/torch/
compression.py): ``compress(tensor) -> (compressed, ctx)`` casts a
floating tensor to the wire dtype before the allreduce, ``decompress``
casts it back.  ``fp16`` and ``bf16`` are torch casts, on the tensor's
device.  ``int8`` and ``uint4`` pass the tensor through unchanged and tag
the allreduce with their ``wire_codec``: the planes quantize per fusion
buffer (per-block scale and zero point, fp32 accumulation), so the
quantized bytes are what cross the wire.
"""
from __future__ import annotations

import torch


class Compressor:
    @staticmethod
    def compress(tensor: torch.Tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Pass-through (reference: compression.py NoneCompressor)."""

    @staticmethod
    def compress(tensor: torch.Tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Cast floating tensors to ``wire`` for the wire and back after."""

    wire = torch.float16

    @classmethod
    def compress(cls, tensor: torch.Tensor):
        if tensor.dtype.is_floating_point:
            return tensor.type(cls.wire), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        if ctx is not None:
            return tensor.type(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """fp16 on the wire (reference: compression.py:46-63)."""

    wire = torch.float16


class BF16Compressor(_CastCompressor):
    """bf16 on the wire: fp32's exponent range, so no loss scaling."""

    wire = torch.bfloat16


class Int8Compressor(Compressor):
    """Block-wise int8 wire quantization, done by the planes per fusion
    buffer (block size: HOROVOD_COMPRESSION_BLOCK_SIZE); not composable
    with op=Adasum."""

    wire_codec = "int8"

    @staticmethod
    def compress(tensor: torch.Tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        return tensor


class Uint4Compressor(Int8Compressor):
    """The 4-bit variant: about 1/8 of the fp32 wire bytes."""

    wire_codec = "uint4"


class Compression:
    """Optional gradient compression algorithm used during allreduce."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    uint4 = Uint4Compressor

    @staticmethod
    def resolve(spec):
        """Accept a Compressor class or a codec name string
        ("none"/"fp16"/"bf16"/"int8"/"uint4")."""
        if spec is None:
            return Compression.none
        if isinstance(spec, str):
            try:
                return getattr(Compression, spec.strip().lower())
            except AttributeError:
                raise ValueError(
                    f"Unknown compression {spec!r}; expected one of "
                    "none/fp16/bf16/int8/uint4") from None
        return spec
