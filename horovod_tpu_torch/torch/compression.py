"""Gradient compression for the torch binding (the contract of
``horovod_tpu/torch/compression.py``, upstream horovod/torch/
compression.py): ``compress(tensor) -> (compressed, ctx)`` casts a
floating tensor to the wire dtype before the allreduce, ``decompress``
casts it back.  ``fp16`` and ``bf16`` are torch casts, on the tensor's
device.  The quantized wires ``int8`` and ``uint4`` are the eager codecs,
ROADMAP queue A item 9(a)'s rest: they raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

_REST_9A = "ROADMAP queue A item 9(a), the rest"


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
    """The block-quantized int8 wire (the reference's runtime codec)."""

    wire_codec = "int8"

    @classmethod
    def compress(cls, tensor: torch.Tensor):
        raise NotImplementedError(
            f"Compression.{cls.wire_codec} (the eager codecs) is {_REST_9A}")

    @classmethod
    def decompress(cls, tensor: torch.Tensor, ctx):
        cls.compress(tensor)


class Uint4Compressor(Int8Compressor):
    """The 4-bit variant."""

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
