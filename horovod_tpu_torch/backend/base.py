"""Backend interface + priority dispatch.

The port's copy of ``horovod_tpu/backend/base.py`` (``dim0_row_bounds``,
``accum_dtype``, ``FusionBufferManager``, ``CollectiveBackend``,
``scale_buffer``, ``OperationManager``) on torch tensors: CPU tensors for
the TCP and shm planes, CUDA tensors for the device plane and a world of
one, whose fusion buffers live on the card; and the codec helpers every
plane reads a response's codec through (``quantized_codec``,
``codec_block_size``, ``wire_cast_dtype``).

Reference: horovod/common/ops/operation_manager.{cc,h}:27-66 and
collective_operations.h:38-288.  `OperationManager` walks backends in
registration priority order; the first whose `enabled()` returns True for a
given Response executes it.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from ..common.dtypes import to_torch
from ..common.message import Response, ResponseType
from ..common.status import Status
from ..common.tensor_queue import TensorTableEntry


def dim0_row_bounds(n_rows: int, size: int) -> list[int]:
    """Uneven dim-0 reducescatter split: rank r owns rows
    [bounds[r], bounds[r+1]); the first ``rem`` ranks get one extra row.
    MUST stay identical across the TCP and shm planes."""
    base, rem = divmod(n_rows, size)
    return [r * base + min(r, rem) for r in range(size + 1)]


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for reductions: 16-bit floats widen to fp32,
    everything else reduces in place (the numerics contract shared by the
    TCP and shm planes; reference: common/half.cc fp16 sum)."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return dtype


def is_device_response(response: Response) -> bool:
    """True when every rank submitted the response's tensors on a CUDA
    card (``Request.device`` >= 0; the controller refuses a mix of CPU
    and CUDA for one name).  The same on every rank, so the planes'
    ``enabled`` checks built on it stay rank-symmetric; a joined rank's
    slot holds 0 and so never turns a CPU response into a device one."""
    return bool(response.devices) and min(response.devices) >= 0


def add_(acc: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``acc += other`` elementwise, as numpy's ``np.add(out=acc)`` does:
    integers wrap, bool sums are logical or.  torch has no add for
    uint16, so that one goes through numpy views of the same memory
    (host tensors only: the socket and mmap planes)."""
    if acc.dtype == torch.uint16:
        _host_only(acc)
        a = acc.numpy()
        np.add(a, other.numpy(), out=a)
        return acc
    return acc.add_(other)


def _host_only(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"a tensor on {t.device} reached a host-memory "
                         f"plane; CUDA tensors are never staged through "
                         f"the host")


def byte_view(t: torch.Tensor) -> memoryview:
    """Flat byte view of a contiguous host tensor: the zero-copy payload
    or destination handed to sockets and mmap regions."""
    _host_only(t)
    return memoryview(_flat(t).view(torch.uint8).numpy())


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as 1-d with a unit stride.  torch calls a
    one-element tensor contiguous whatever its stride (a sparse tensor's
    transposed indices hold stride 2), and a byte view needs 1."""
    flat = t.reshape(-1)
    if flat.stride(0) != 1:
        flat = flat.clone(memory_format=torch.contiguous_format)
    return flat


class FusionBufferManager:
    """Persistent fusion staging buffers — the analogue of the reference's
    one-per-(device, framework) buffer (fusion_buffer_manager.cc): lazily
    allocated, grown geometrically, reused every cycle so steady-state
    fused responses pay zero allocations."""

    def __init__(self) -> None:
        self._buffers: dict[tuple[str, torch.dtype, torch.device],
                            torch.Tensor] = {}

    def get(self, tag: str, dtype: torch.dtype, n: int,
            device: torch.device = torch.device("cpu")) -> torch.Tensor:
        key = (tag, dtype, device)
        buf = self._buffers.get(key)
        if buf is None or buf.numel() < n:
            cap = max(n, 0 if buf is None else 2 * buf.numel())
            buf = torch.empty(cap, dtype=dtype, device=device)
            self._buffers[key] = buf
        return buf[:n]

    def owns(self, arr: torch.Tensor) -> bool:
        """True if ``arr`` is (a view of) a managed buffer — such results
        must be copied out before the next cycle clobbers them."""
        ptr = arr.untyped_storage().data_ptr()
        return any(ptr == b.untyped_storage().data_ptr()
                   for b in self._buffers.values())


class CollectiveBackend(ABC):
    """One data-plane implementation of the collective ops."""

    name = "abstract"
    # Attached by core.init so ops can emit sub-activity spans
    # (MEMCPY_IN_FUSION_BUFFER / <PLANE>_<OP> / MEMCPY_OUT_FUSION_BUFFER).
    timeline = None
    # Multi-stream dispatch contract (core._dispatch_cycle): True means
    # independent responses may execute concurrently on per-stream
    # instances of this backend, each over its own channel set.  Planes
    # with process-global protocol state (shm lockstep, the NCCL group's
    # program order on one device stream, the hierarchical sub-meshes)
    # stay False and always run on stream 0.
    stream_safe = False
    # Which dispatch stream this instance serves (annotates timeline
    # activities; per-stream instances are built by core.init).
    stream = 0
    # Algorithm used by the most recent collective on this instance.
    last_algo = "none"
    # Where a joined rank's zero stand-ins are made (the device plane's
    # card; the host for every other plane).
    device = torch.device("cpu")

    def _act_start(self, entries, activity: str) -> None:
        tl = self.timeline
        if tl is not None and tl.enabled:
            tl.activity_start_all(entries, activity, stream=self.stream)

    def _act_end(self, entries) -> None:
        tl = self.timeline
        if tl is not None and tl.enabled:
            tl.activity_end_all(entries)

    @property
    def fusion_buffers(self) -> FusionBufferManager:
        fb = getattr(self, "_fusion_buffers", None)
        if fb is None:
            fb = self._fusion_buffers = FusionBufferManager()
        return fb

    @abstractmethod
    def enabled(self, response: Response,
                entries: list[TensorTableEntry]) -> bool:
        ...

    def execute(self, response: Response,
                entries: list[TensorTableEntry]) -> Status:
        rt = response.response_type
        if rt in (ResponseType.ALLREDUCE, ResponseType.ADASUM):
            return self.allreduce(response, entries)
        if rt == ResponseType.ALLGATHER:
            return self.allgather(response, entries)
        if rt == ResponseType.BROADCAST:
            return self.broadcast(response, entries)
        if rt == ResponseType.ALLTOALL:
            return self.alltoall(response, entries)
        if rt == ResponseType.REDUCESCATTER:
            return self.reducescatter(response, entries)
        if rt == ResponseType.BARRIER:
            return self.barrier(response, entries)
        return Status.unknown_error(f"Unsupported response type {rt}")

    @abstractmethod
    def allreduce(self, response, entries) -> Status: ...

    @abstractmethod
    def allgather(self, response, entries) -> Status: ...

    @abstractmethod
    def broadcast(self, response, entries) -> Status: ...

    @abstractmethod
    def alltoall(self, response, entries) -> Status: ...

    def reducescatter(self, response, entries) -> Status:
        return Status.unknown_error("reducescatter not supported by "
                                    f"backend {self.name}")

    def barrier(self, response, entries) -> Status:
        return Status.ok()

    # ------------------------------------------------------------------
    # Fusion-buffer staging helpers (reference:
    # collective_operations.h:89-125 MemcpyInFusionBuffer / ScaleBuffer).
    # ------------------------------------------------------------------
    def pack_fusion_buffer(self, response: Response,
                           entries: list[TensorTableEntry]) -> torch.Tensor:
        """Concatenate flattened entry payloads into the backend's
        persistent staging buffer (single entries pass through without a
        copy — the data plane stages them itself).  Host buffers pack
        through the native kernel; a buffer on the card packs with one
        ``torch.cat`` into it there."""
        dtype = to_torch(response.tensor_type)
        device = next((e.tensor.device for e in entries
                       if e.tensor is not None), self.device)
        if len(entries) == 1:
            e = entries[0]
            if e.tensor is None:
                return torch.zeros(response.tensor_sizes[0], dtype=dtype,
                                   device=device)
            return e.tensor.to(dtype).contiguous().reshape(-1)
        parts: list[torch.Tensor | None] = [
            None if e.tensor is None      # joined-rank zero stand-in
            else e.tensor.to(dtype).contiguous().reshape(-1)
            for e in entries]
        sizes = list(response.tensor_sizes)
        self._act_start(entries, "MEMCPY_IN_FUSION_BUFFER")
        try:
            fused = self.fusion_buffers.get("pack", dtype, sum(sizes),
                                            device)
            if device.type == "cpu":
                from .. import native
                native.pack(parts, sizes, fused)
            else:
                torch.cat([torch.zeros(n, dtype=dtype, device=device)
                           if p is None else p
                           for p, n in zip(parts, sizes)], out=fused)
            return fused
        finally:
            self._act_end(entries)

    def unpack_fusion_buffer(self, buf: torch.Tensor, response: Response,
                             entries: list[TensorTableEntry]) -> None:
        """Slice the fused result back into per-entry outputs, restoring
        original shapes.  Results living in a persistent buffer are copied
        out (the next cycle reuses the buffer); fresh backend results are
        sliced zero-copy."""
        owned = self.fusion_buffers.owns(buf)
        if len(entries) > 1:
            self._act_start(entries, "MEMCPY_OUT_FUSION_BUFFER")
        try:
            offset = 0
            for i, e in enumerate(entries):
                n = response.tensor_sizes[i]
                chunk = buf[offset:offset + n]
                offset += n
                out = chunk.reshape(e.tensor.shape) \
                    if e.tensor is not None else chunk
                e.output = out.clone() if owned else out
        finally:
            if len(entries) > 1:
                self._act_end(entries)

    @staticmethod
    def resolve_alltoall_splits(entry: TensorTableEntry, dim0: int,
                                world_size: int) -> list[int] | Status:
        """Explicit splits, or an even division of dim 0; a Status error
        when neither applies (shared by the TCP and shm planes)."""
        if entry.splits:
            if len(entry.splits) != world_size:
                return Status.invalid_argument(
                    f"alltoall splits must have one entry per rank "
                    f"(got {len(entry.splits)} for world size "
                    f"{world_size})")
            splits = [int(s) for s in entry.splits]
            if any(s < 0 for s in splits):
                return Status.invalid_argument(
                    f"alltoall splits must be non-negative (got {splits})")
            if sum(splits) != dim0:
                return Status.invalid_argument(
                    f"alltoall splits must sum to the first dimension "
                    f"(sum {sum(splits)} != dim0 {dim0})")
            return splits
        if dim0 % world_size != 0:
            return Status.invalid_argument(
                "alltoall first dimension must be divisible by the "
                "world size when splits are not given")
        return [dim0 // world_size] * world_size

    @staticmethod
    def allgather_entry_dims(response: Response, n_entries: int,
                             world_size: int) -> list[list[int]]:
        """Per-entry per-rank first dims of a (possibly fused) allgather
        response: tensor_sizes holds one world_size block per entry."""
        sizes = list(response.tensor_sizes)
        assert len(sizes) == n_entries * world_size, \
            (len(sizes), n_entries, world_size)
        return [sizes[i * world_size:(i + 1) * world_size]
                for i in range(n_entries)]

    @staticmethod
    def _fused_allgather_layout(dims: list[list[int]], rests: list[int],
                                itemsize: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
        """(bytes[i][r], exclusive per-rank entry prefix[i][r]) for the
        rank-major/entry-major packed layout."""
        nbytes = np.asarray(dims, dtype=np.int64) * \
            (np.asarray(rests, dtype=np.int64)[:, None] * itemsize)
        return nbytes, np.cumsum(nbytes, axis=0) - nbytes

    @staticmethod
    def pack_fused_allgather(response: Response,
                             entries: list[TensorTableEntry],
                             dtype: torch.dtype, world_size: int):
        """Encode the fused-allgather wire layout shared by the TCP and
        shm planes: each rank's packed payload is the concatenation of
        its block of every entry (entry-major), as raw bytes.  Returns
        (locals_, dims, rests, per_rank_bytes, payload)."""
        dims = CollectiveBackend.allgather_entry_dims(
            response, len(entries), world_size)
        locals_ = [contiguous(e.tensor.to(dtype)) for e in entries]
        rests = [_rest(a.shape) for a in locals_]
        nbytes, _ = CollectiveBackend._fused_allgather_layout(
            dims, rests, dtype.itemsize)
        per_rank = nbytes.sum(axis=0).tolist()
        payload = torch.cat([a.reshape(-1).view(torch.uint8)
                             for a in locals_])
        return locals_, dims, rests, per_rank, payload

    @staticmethod
    def unpack_fused_allgather(full: torch.Tensor,
                               entries: list[TensorTableEntry],
                               locals_: list[torch.Tensor],
                               dims: list[list[int]],
                               rests: list[int],
                               dtype: torch.dtype,
                               per_rank: list[int]) -> None:
        """Slice a rank-major/entry-major packed byte exchange back into
        per-entry outputs in global rank order."""
        size = len(per_rank)
        rank_off = np.cumsum([0] + list(per_rank))
        nbytes, ent_off = CollectiveBackend._fused_allgather_layout(
            dims, rests, dtype.itemsize)
        for i, e in enumerate(entries):
            rest_shape = tuple(locals_[i].shape[1:])
            blocks = []
            for r in range(size):
                off = int(rank_off[r] + ent_off[i, r])
                blk = full[off:off + int(nbytes[i, r])].view(dtype) \
                    .reshape((dims[i][r],) + rest_shape)
                blocks.append(blk)
            e.output = torch.cat(blocks, dim=0)

    # ------------------------------------------------------------------
    # Wire-compression codec helpers, shared by the planes so every one
    # interprets Response.codec the same way.
    # ------------------------------------------------------------------
    @staticmethod
    def quantized_codec(response: Response):
        """The response's quantized codec (int8/uint4) when it applies —
        floating payloads only — else None."""
        from ..common.dtypes import is_floating
        from ..compress import QUANTIZED_CODECS, CompressionCodec
        codec = CompressionCodec(response.codec)
        if codec in QUANTIZED_CODECS and is_floating(response.tensor_type):
            return codec
        return None

    @staticmethod
    def codec_block_size(response: Response) -> int:
        """Negotiated quantization block size (the knob's default for a
        hand-built response that left it out)."""
        if response.codec_block_size > 0:
            return response.codec_block_size
        from ..compress import default_block_size
        return default_block_size()

    @staticmethod
    def wire_cast_dtype(response: Response) -> torch.dtype | None:
        """Wire dtype for the cast codecs (fp16/bf16) when the payload is
        a wider float, else None.  The planes reduce 16-bit wires with
        fp32 accumulation already (accum_dtype), so the cast alone is the
        legacy Compression.fp16's semantics."""
        from ..common.dtypes import element_size, is_floating
        from ..compress import CompressionCodec
        codec = CompressionCodec(response.codec)
        if not is_floating(response.tensor_type) or \
                element_size(response.tensor_type) <= 2:
            return None
        if codec == CompressionCodec.FP16:
            return torch.float16
        if codec == CompressionCodec.BF16:
            return torch.bfloat16
        return None

    @staticmethod
    def scale_buffer(buf: torch.Tensor, factor: float) -> torch.Tensor:
        """Multiply by ``factor`` with the reference's numpy arithmetic:
        16-bit floats in fp32 then rounded back, integers by the float64
        factor then truncated (torch would promote ``int * float`` to
        float32), other floats by the factor in their own dtype."""
        if factor == 1.0:
            return buf
        if accum_dtype(buf.dtype) != buf.dtype:
            return (buf.float() * factor).to(buf.dtype)
        if buf.dtype == torch.bool:
            return buf & bool(factor)
        if not buf.dtype.is_floating_point:
            return (buf.double() * factor).to(buf.dtype)
        return buf * factor


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` with numpy's rounding (numpy's ``astype``, as
    the reference's planes cast), on the host or the card.  torch casts
    float64 to float16 through float32, rounding twice, where numpy rounds
    once; rounding to float32 *to odd* first (an inexact result keeps its
    last bit set) makes the second rounding the single correct one.
    Every other float cast is torch's and equals numpy's and ml_dtypes'
    (bf16) already."""
    if t.dtype == dtype:
        return t
    if dtype == torch.float16 and t.dtype == torch.float64:
        f = t.to(torch.float32)
        back = f.double()
        inexact = (back != t) & torch.isfinite(back)
        away = back.abs() > t.abs()
        bits = f.view(torch.int32) - (inexact & away).to(torch.int32)
        t = (bits | inexact.to(torch.int32)).view(torch.float32)
    return t.to(dtype)


def contiguous(t: torch.Tensor) -> torch.Tensor:
    """``np.ascontiguousarray`` on a tensor: contiguous, and a 0-d tensor
    becomes 1-d, which is the shape the reference's planes return for a
    scalar they staged this way."""
    t = t.contiguous()
    if t.dim() == 0:
        return t.reshape(1)
    return t if t.numel() != 1 else _flat(t).reshape(t.shape)


def _rest(shape) -> int:
    """Elements per dim-0 row."""
    rest = 1
    for d in tuple(shape)[1:]:
        rest *= int(d)
    return rest


class OperationManager:
    """Priority dispatch over registered backends
    (reference: ops/operation_manager.cc)."""

    def __init__(self, backends: list[CollectiveBackend]) -> None:
        self._backends = backends

    @property
    def backends(self) -> list[CollectiveBackend]:
        return list(self._backends)

    def resolve(self, response: Response,
                entries: list[TensorTableEntry]) -> CollectiveBackend | None:
        """First enabled backend for this response, or None.  Every
        enabled() check is rank-symmetric by contract (world size, knob
        env, unanimous KV-store formation), so all ranks resolve the same
        plane."""
        for backend in self._backends:
            if backend.enabled(response, entries):
                return backend
        return None

    def execute_operation(self, response: Response,
                          entries: list[TensorTableEntry]) -> Status:
        if response.response_type == ResponseType.ERROR:
            return Status.precondition_error(response.error_message)
        if response.response_type == ResponseType.JOIN:
            return Status.ok()
        backend = self.resolve(response, entries)
        if backend is not None:
            return backend.execute(response, entries)
        return Status.unknown_error(
            f"No enabled backend for response type "
            f"{response.response_type.name}")
