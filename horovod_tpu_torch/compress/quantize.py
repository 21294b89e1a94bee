"""Block-wise affine quantization for the eager planes' wire (numpy).

The port's copy of ``horovod_tpu/compress/quantize.py``, line for line, so
that the TCP and shm planes put the reference's bytes on the wire.  A
flat fp buffer is split into fixed-size blocks; each block is quantized
on its own with an affine map

    q = round((x - zero_point) / scale),   scale = (max - min) / (L - 1)

where ``L`` is the number of levels (256 for the int8 codec, 16 for
uint4).  Per-block scaling bounds the element-wise reconstruction error by
``scale / 2``, so one outlier only degrades its own block.

This is numpy, not torch: the socket and mmap planes hold host memory,
and numpy's rounding and casts are the reference's.  The device plane and
``parallel/grad_sync.py`` use the torch twin in ``compress/ops.py``, which
has the same scale rule.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import CompressionCodec, codec_levels

# Per-block wire overhead: one fp32 scale + one fp32 zero point.
_BLOCK_META_BYTES = 8


def num_blocks(n: int, block_size: int) -> int:
    return -(-n // block_size) if n else 0


def payload_nbytes(n: int, codec: CompressionCodec) -> int:
    """Quantized-value bytes for ``n`` elements (uint4 packs two per byte)."""
    if codec == CompressionCodec.UINT4:
        return (n + 1) // 2
    return n


def serialized_nbytes(n: int, codec: CompressionCodec,
                      block_size: int) -> int:
    """Total wire bytes: scales || zero_points || payload."""
    return num_blocks(n, block_size) * _BLOCK_META_BYTES \
        + payload_nbytes(n, codec)


@dataclasses.dataclass
class QuantizedBlocks:
    """One quantized flat buffer: per-block scale/zero-point + packed
    values.  ``n`` is the ORIGINAL element count (payload may carry a pad
    nibble for odd-length uint4 buffers)."""
    codec: CompressionCodec
    n: int
    block_size: int
    scales: np.ndarray        # fp32 [nb]
    zero_points: np.ndarray   # fp32 [nb]
    payload: np.ndarray       # uint8 [payload_nbytes(n, codec)]

    def nbytes(self) -> int:
        return self.scales.nbytes + self.zero_points.nbytes \
            + self.payload.nbytes


def quantize(flat, codec: CompressionCodec,
             block_size: int) -> QuantizedBlocks:
    """Quantize a flat floating buffer blockwise.  Always computes in
    fp32 (the accumulation dtype contract shared with the planes)."""
    x = np.asarray(flat, dtype=np.float32).reshape(-1)
    n = x.size
    levels = codec_levels(codec)
    nb = num_blocks(n, block_size)
    if nb == 0:
        return QuantizedBlocks(codec, 0, block_size,
                               np.zeros(0, np.float32),
                               np.zeros(0, np.float32),
                               np.zeros(0, np.uint8))
    pad = nb * block_size - n
    if pad:
        # Pad with the last element so the tail block's min/max (and
        # therefore its scale) is not polluted by synthetic zeros.
        x = np.concatenate([x, np.full(pad, x[-1], np.float32)])
    blocks = x.reshape(nb, block_size)
    lo = blocks.min(axis=1)
    hi = blocks.max(axis=1)
    scales = (hi - lo) / np.float32(levels - 1)
    scales = np.where(scales > 0, scales, np.float32(1.0)).astype(np.float32)
    q = np.rint((blocks - lo[:, None]) / scales[:, None])
    q = np.clip(q, 0, levels - 1).astype(np.uint8).reshape(-1)[:n]
    if codec == CompressionCodec.UINT4:
        if n % 2:
            q = np.concatenate([q, np.zeros(1, np.uint8)])
        payload = (q[0::2] << 4) | q[1::2]
    else:
        payload = q
    return QuantizedBlocks(codec, n, block_size, scales,
                           lo.astype(np.float32), payload)


def dequantize(qb: QuantizedBlocks, dtype=np.float32) -> np.ndarray:
    """Reconstruct the flat buffer: x̂ = q·scale + zero_point (fp32 math,
    cast to ``dtype`` at the end)."""
    n = qb.n
    if n == 0:
        return np.zeros(0, dtype=dtype)
    if qb.codec == CompressionCodec.UINT4:
        q = np.empty(qb.payload.size * 2, np.uint8)
        q[0::2] = qb.payload >> 4
        q[1::2] = qb.payload & 0x0F
        q = q[:n]
    else:
        q = qb.payload
    scales = np.repeat(qb.scales, qb.block_size)[:n]
    zps = np.repeat(qb.zero_points, qb.block_size)[:n]
    out = q.astype(np.float32) * scales + zps
    return out.astype(dtype, copy=False)


def to_bytes(qb: QuantizedBlocks) -> bytes:
    """Wire encoding: scales || zero_points || payload.  Sizes are fully
    derivable from (n, codec, block_size), which every rank knows from the
    negotiated Response — no header needed."""
    return qb.scales.tobytes() + qb.zero_points.tobytes() \
        + qb.payload.tobytes()


def from_bytes(raw, n: int, codec: CompressionCodec,
               block_size: int) -> QuantizedBlocks:
    buf = np.frombuffer(raw, dtype=np.uint8)
    nb = num_blocks(n, block_size)
    meta = nb * 4
    scales = buf[:meta].view(np.float32)
    zps = buf[meta:2 * meta].view(np.float32)
    payload = buf[2 * meta:2 * meta + payload_nbytes(n, codec)]
    return QuantizedBlocks(codec, n, block_size, scales, zps, payload)


def roundtrip_error_bound(flat, codec: CompressionCodec,
                          block_size: int) -> np.ndarray:
    """Per-element worst-case |x - dequantize(quantize(x))|: half a
    quantization step of the element's block."""
    x = np.asarray(flat, dtype=np.float32).reshape(-1)
    n = x.size
    nb = num_blocks(n, block_size)
    if nb == 0:
        return np.zeros(0, np.float32)
    pad = nb * block_size - n
    if pad:
        x = np.concatenate([x, np.full(pad, x[-1], np.float32)])
    blocks = x.reshape(nb, block_size)
    step = (blocks.max(1) - blocks.min(1)) / np.float32(
        codec_levels(codec) - 1)
    return (np.repeat(step, block_size)[:n] / 2).astype(np.float32)


def chunk_bounds(n: int, size: int) -> np.ndarray:
    """Even element-chunk boundaries for the owner-reduce exchange: chunk
    r = [bounds[r], bounds[r+1]), the first ``rem`` chunks one element
    longer (the same split rule as the ring planes)."""
    base, rem = divmod(n, size)
    sizes = [base + (1 if i < rem else 0) for i in range(size)]
    return np.cumsum([0] + sizes)


def staged_nbytes(n: int, size: int, codec: CompressionCodec,
                  block_size: int) -> tuple[list[int], int]:
    """(per-chunk serialized bytes, total) for a buffer of ``n`` elements
    split into ``size`` owner chunks — the shm plane's region accounting
    and the deterministic chunk offsets every plane shares."""
    bounds = chunk_bounds(n, size)
    per_chunk = [serialized_nbytes(int(bounds[r + 1] - bounds[r]),
                                   codec, block_size)
                 for r in range(size)]
    return per_chunk, sum(per_chunk)
