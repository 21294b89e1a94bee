"""Block quantization and the quantized all-reduce, as torch ops.

The counterpart of ``horovod_tpu/compress/jax_ops.py``, with its scale
rule: affine per block of ``block_size`` consecutive elements, scale
``(max - min) / (levels - 1)`` (1 for a constant block), zero point the
block's minimum, round half to even, uint4 packed two nibbles a byte.
Every step is a correctly rounded fp32 operation (each division by a
tensor), so the card and the CPU give the same bytes.

``quantized_allreduce`` is the exchange ``parallel/grad_sync.py`` runs
for the int8/uint4 codecs:

  1. pad the flat bucket to world x chunk (chunk block-aligned);
  2. quantize each destination chunk on its own (per-block scale + zp);
  3. all-to-all the quantized chunks: every rank receives all ranks'
     contributions to its own chunk;
  4. dequantize and sum in fp32, divide by the world for op=average;
  5. requantize the reduced chunk once and all-gather it;
  6. dequantize and strip the padding.

These are plain torch ops, as the reference's are plain ``jnp``.
"""
from __future__ import annotations

import torch

from ..parallel import collectives
from . import CompressionCodec, codec_levels


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """x / d, correctly rounded on every device: torch on CUDA turns a
    division by a Python number into a multiply by its reciprocal."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_rows(x: torch.Tensor, codec: CompressionCodec,
                  block_size: int):
    """Quantize each row of ``x`` [rows, m] blockwise (m % block_size == 0;
    callers pad).  Returns (payload uint8 [rows, pb], scales fp32
    [rows, nb], zero points fp32 [rows, nb])."""
    rows, m = x.shape
    levels = codec_levels(codec)
    nb = m // block_size
    blocks = x.float().reshape(rows, nb, block_size)
    lo = blocks.amin(dim=2)
    hi = blocks.amax(dim=2)
    scales = _div(hi - lo, levels - 1)
    scales = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.round((blocks - lo[..., None]) / scales[..., None])
    q = q.clamp(0, levels - 1).to(torch.uint8).reshape(rows, m)
    if codec == CompressionCodec.UINT4:
        # Two nibbles a byte, so that the exchange moves half the bytes.
        q = (q[:, 0::2] << 4) | q[:, 1::2]
    return q, scales, lo


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor,
                    zps: torch.Tensor, codec: CompressionCodec,
                    block_size: int) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` -> fp32 [rows, m]."""
    rows = q.shape[0]
    if codec == CompressionCodec.UINT4:
        q = torch.stack([q >> 4, q & 0x0F], dim=-1).reshape(rows, -1)
    nb = scales.shape[1]
    blocks = q.float().reshape(rows, nb, block_size)
    out = blocks * scales[..., None] + zps[..., None]
    return out.reshape(rows, nb * block_size)


def check_block_size(codec: CompressionCodec, block_size: int) -> None:
    if CompressionCodec(codec) == CompressionCodec.UINT4 and block_size % 2:
        raise ValueError("uint4 compression requires an even block size")


def quantized_allreduce(flat: torch.Tensor, group, op: str,
                        codec: CompressionCodec, block_size: int,
                        residual: torch.Tensor | None = None):
    """Block-quantized all-reduce of a flat floating buffer over
    ``group`` (one process group or one per mesh axis, as in
    ``collectives``).  With ``residual`` (error feedback) returns
    ``(reduced, new_residual)``: the residual is the compensated input
    minus what the wire carried of it.  Without, just ``reduced``.  The
    reduction accumulates in fp32; ``op == "average"`` divides before the
    requantization, so that it sees the averaged range."""
    codec = CompressionCodec(codec)
    check_block_size(codec, block_size)
    n = flat.shape[0]
    world = collectives.world_size(group)
    chunk = -(-n // world)
    chunk = -(-chunk // block_size) * block_size

    x = flat.float()
    if residual is not None:
        x = x + residual.float()
    compensated = x
    x = torch.nn.functional.pad(x, (0, chunk * world - n))
    x = x.reshape(world, chunk)

    q, s, zp = quantize_rows(x, codec, block_size)
    if residual is not None:
        sent = dequantize_rows(q, s, zp, codec, block_size)
        new_residual = compensated - sent.reshape(-1)[:n]

    # After the exchange row p holds rank p's contribution to this
    # rank's chunk.
    q, s, zp = (collectives.alltoall(t, group) for t in (q, s, zp))
    red = dequantize_rows(q, s, zp, codec, block_size).sum(dim=0)
    if op in ("average", "mean"):
        red = _div(red, world)

    qr, sr, zr = quantize_rows(red[None, :], codec, block_size)
    qg, sg, zg = (collectives.allgather(t, group) for t in (qr, sr, zr))
    full = dequantize_rows(qg, sg, zg, codec, block_size).reshape(-1)[:n]
    out = full.to(flat.dtype)
    if residual is not None:
        return out, new_residual
    return out
