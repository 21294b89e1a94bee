"""Single-pass codec passes for the host planes' quantized and cast legs.

The port's copy of ``horovod_tpu/compress/fused.py`` (``FusedKernels``:
``encode``, ``decode_into``, ``decode_add``, ``cast_add``) on numpy views
of the planes' host memory.  One pass per codec consumes an arriving wire
segment and updates the fp32 accumulator in place (``decode_add``), or
emits a ready-to-send contiguous wire image from the accumulator
(``encode``); every intermediate lands in persistent scratch keyed by the
caller's tag, so steady-state legs allocate nothing.

The passes run the native ``qencode``/``qdecode`` of ``native/kernels.cc``
(the reference's kernels, copied whole), which do the same IEEE fp32
operations in the same order as ``quantize.py``: the fused legs are
bitwise equal to the per-chunk chain.  **This differs from the reference
on purpose:** the reference takes its numpy chain whenever the native
library is missing; the port's loader raises instead (``native``), and
the numpy chain below runs only under ``HOROVOD_TPU_DISABLE_NATIVE=1``
(or a caller's non-fp32 input, as in the reference).
"""
from __future__ import annotations

import numpy as np
import torch

from . import CompressionCodec, codec_levels
from .quantize import num_blocks, payload_nbytes, serialized_nbytes


class FusedKernels:
    """Persistent-scratch fused dequant+accumulate / requantize kernels.

    One instance per plane (a TcpCollectives, a ShmBackend): scratch
    slots are keyed by caller-chosen tags.  Not thread-safe across
    concurrent calls on one instance — the owning plane serializes its
    own ops, like the channel scratch in runner/network.py.
    """

    __slots__ = ("_f32", "_u8")

    def __init__(self) -> None:
        self._f32: dict = {}
        self._u8: dict = {}

    # -- scratch pools (grown geometrically, never shrunk) ---------------
    def f32(self, key, n: int) -> np.ndarray:
        buf = self._f32.get(key)
        if buf is None or buf.size < n:
            cap = max(n, 0 if buf is None else 2 * buf.size)
            buf = np.empty(cap, np.float32)
            self._f32[key] = buf
        return buf[:n]

    def u8(self, key, n: int) -> np.ndarray:
        buf = self._u8.get(key)
        if buf is None or buf.size < n:
            cap = max(n, 0 if buf is None else 2 * buf.size)
            buf = np.empty(cap, np.uint8)
            self._u8[key] = buf
        return buf[:n]

    # -- fused requantize: fp32 accumulator -> contiguous wire image -----
    def encode(self, x: np.ndarray, codec: CompressionCodec,
               block_size: int, slot) -> np.ndarray:
        """Quantize ``x`` (flat fp32) blockwise straight into a persistent
        wire image ``scales || zero_points || payload`` (the exact
        from_bytes/to_bytes layout, byte-identical to
        ``to_bytes(quantize(x))``).  The returned uint8 array is valid
        until the next ``encode`` on the same ``slot`` — senders must
        flush before the slot is reused (the collectives' op-final flush
        already guarantees it).

        Dispatch: the native single-pass kernel (native/kernels.cc
        hvd_qencode, GIL released), or the numpy form below under
        HOROVOD_TPU_DISABLE_NATIVE=1.  Both are byte-identical to
        ``to_bytes(quantize(x))``."""
        n = int(x.size)
        levels = codec_levels(codec)
        nb = num_blocks(n, block_size)
        wire = self.u8((slot, "wire"),
                       serialized_nbytes(n, codec, block_size))
        if nb == 0:
            return wire
        if isinstance(x, np.ndarray) and x.dtype == np.float32 \
                and x.flags.c_contiguous:
            from .. import native
            if not native.disabled():
                native.qencode(torch.from_numpy(x), block_size, levels,
                               codec == CompressionCodec.UINT4,
                               torch.from_numpy(wire))
                return wire
        m = nb * block_size
        meta = nb * 4
        scales = wire[:meta].view(np.float32)
        zps = wire[meta:2 * meta].view(np.float32)
        payload = wire[2 * meta:]

        xb = self.f32((slot, "xb"), m)
        xb[:n] = x
        if m > n:
            # Pad with the last element (same rule as quantize.py) so the
            # tail block's scale is not polluted by synthetic zeros.
            xb[n:] = xb[n - 1]
        blocks = xb.reshape(nb, block_size)
        hi = self.f32((slot, "hi"), nb)
        np.max(blocks, axis=1, out=hi)
        np.min(blocks, axis=1, out=zps)
        np.subtract(hi, zps, out=scales)
        scales /= np.float32(levels - 1)
        # ~(scales > 0), not (scales <= 0): quantize.py's np.where rule
        # maps a NaN scale to 1.0 too.
        np.copyto(scales, np.float32(1.0), where=~(scales > 0))

        q32 = self.f32((slot, "q32"), m).reshape(nb, block_size)
        np.subtract(blocks, zps[:, None], out=q32)
        q32 /= scales[:, None]
        np.rint(q32, out=q32)
        np.clip(q32, 0, levels - 1, out=q32)
        qu = self.u8((slot, "q"), m)
        np.copyto(qu, q32.reshape(-1), casting="unsafe")
        if codec == CompressionCodec.UINT4:
            # Zero the pad lanes first so the final half-filled byte
            # matches the reference's zero pad nibble exactly.
            qu[n:] = 0
            packed = self.u8((slot, "pk"), m // 2)
            np.left_shift(qu[0::2], 4, out=packed)
            np.bitwise_or(packed, qu[1::2], out=packed)
            payload[:] = packed[:payload.size]
        else:
            payload[:] = qu[:n]
        return wire

    # -- fused dequantize into a caller-owned destination ----------------
    def _unpacked(self, raw, n: int, codec: CompressionCodec,
                  block_size: int, slot,
                  dest: "np.ndarray | None" = None) -> np.ndarray:
        """Fused dequantize of a wire image: unpack the levels into
        ``dest`` (or persistent scratch) and apply ``q·scale + zp`` in
        place by block-metadata broadcast — no np.repeat expansion, no
        fresh output array.  ``dest`` must be a contiguous fp32 view of
        exactly m = nb·block_size elements."""
        nb = num_blocks(n, block_size)
        m = nb * block_size
        meta = nb * 4
        arr = np.frombuffer(raw, np.uint8,
                            count=serialized_nbytes(n, codec, block_size))
        scales = arr[:meta].view(np.float32)
        zps = arr[meta:2 * meta].view(np.float32)
        pv = arr[2 * meta:2 * meta + payload_nbytes(n, codec)]
        q32 = self.f32((slot, "dq"), m) if dest is None else dest
        if codec == CompressionCodec.UINT4:
            qu = self.u8((slot, "un"), 2 * pv.size)
            np.right_shift(pv, 4, out=qu[0::2])
            np.bitwise_and(pv, 0x0F, out=qu[1::2])
            np.copyto(q32[:n], qu[:n], casting="unsafe")
        else:
            np.copyto(q32[:n], pv, casting="unsafe")
        if m > n:
            q32[n:] = 0          # pad lanes: decoded but never read
        blocks = q32.reshape(nb, block_size)
        np.multiply(blocks, scales[:, None], out=blocks)
        np.add(blocks, zps[:, None], out=blocks)
        return q32

    def _native_decode(self, raw, n: int, codec: CompressionCodec,
                       block_size: int, dst: np.ndarray,
                       accumulate: bool) -> bool:
        """The native single-pass decode (hvd_qdecode): dequantize — and
        with ``accumulate``, reduce — in ONE loop over the payload, GIL
        released.  Same IEEE ops as the numpy form (mul, add,
        accumulate-add; -ffp-contract=off), so bitwise identical.  False
        when the numpy form must run."""
        from .. import native
        if native.disabled() or not (dst.dtype == np.float32
                                     and dst.flags.c_contiguous):
            return False
        wire = np.frombuffer(raw, np.uint8,
                             count=serialized_nbytes(n, codec,
                                                     block_size))
        native.qdecode(torch.from_numpy(wire), n, block_size,
                       codec == CompressionCodec.UINT4,
                       torch.from_numpy(dst), accumulate)
        return True

    def decode_into(self, raw, n: int, codec: CompressionCodec,
                    block_size: int, out: np.ndarray, slot) -> None:
        """Dequantize a wire image straight into ``out`` (fp32 view,
        e.g. the caller's final output slice) — same per-element
        ``q * scale + zero_point`` fp32 math as quantize.dequantize.
        The native kernel; in the numpy form block-aligned chunks decode
        in place in ``out`` itself and ragged tails stage the last
        partial block in scratch."""
        if n == 0:
            return
        if self._native_decode(raw, n, codec, block_size, out, False):
            return
        m = num_blocks(n, block_size) * block_size
        if m == n and out.flags.c_contiguous:
            self._unpacked(raw, n, codec, block_size, slot, dest=out)
            return
        q32 = self._unpacked(raw, n, codec, block_size, slot)
        out[:] = q32[:n]

    def decode_add(self, raw, n: int, codec: CompressionCodec,
                   block_size: int, acc: np.ndarray, slot) -> None:
        """THE fused inner loop: consume an arriving quantized segment and
        accumulate it into the fp32 accumulator in place — one native
        dequant+reduce loop (hvd_qdecode accumulate=1), or one dequant
        pass in scratch + one in-place add in the numpy form; zero
        allocations either way."""
        if n == 0:
            return
        if self._native_decode(raw, n, codec, block_size, acc, True):
            return
        q32 = self._unpacked(raw, n, codec, block_size, slot)
        np.add(acc, q32[:n], out=acc)

    # -- fused cast-codec widen+accumulate -------------------------------
    def cast_add(self, raw, wire_dtype: torch.dtype, acc: np.ndarray,
                 slot) -> None:
        """Widen an arriving fp16/bf16 segment to fp32 and accumulate in
        place (the cast_allreduce gather-leg pass): one widening copy
        into scratch + one in-place add — bitwise identical to
        ``acc += segment.astype(np.float32)`` without the allocation.
        The wire dtype is torch's (numpy has no bf16); the widening is
        exact either way."""
        n = acc.size
        if n == 0:
            return
        wv = torch.frombuffer(raw, dtype=wire_dtype, count=n)
        s32 = self.f32((slot, "cw"), n)
        torch.from_numpy(s32).copy_(wv)
        np.add(acc, s32, out=acc)
