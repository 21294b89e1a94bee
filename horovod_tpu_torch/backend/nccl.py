"""NCCL data plane for CUDA tensors in the eager core.

The port's counterpart of ``horovod_tpu/backend/xla.py``:
``NcclCommunicator`` takes the place of ``XlaCommunicator`` and
``NcclBackend`` that of ``XlaBackend``, first in the plane chain
(reference: operations.cc:143-252, NCCL before MPI before Gloo).  Where
the reference lays each rank's fused buffer into one row of a global JAX
array and lets XLA emit the collective, this plane hands the fused buffer
on the card to ``torch.distributed`` over the world's process group
(``parallel/multihost.py``); NCCL on the card, or gloo when the CPU tests
hand it a gloo group and CPU tensors.  The controller runs the same
ResponseList in the same order on every rank, so every rank issues the
same NCCL calls in the same order, the property that keeps NCCL free of
deadlock (SURVEY §5.8).

The numerics are the reference's: 16-bit floats accumulate in fp32 (the
fused buffer is widened once, all-reduced and cast back once), averaging
rides the response's postscale, and integers scale by the float64 factor
and truncate (``scale_buffer``).  NCCL has no 16-bit integer and its
``bool`` sum is a max; int16, uint16 and bool therefore reduce in int32
and come back as numpy's ``add`` gives them (16-bit integers wrap, a bool
sum is logical or).  The data-movement collectives move raw bytes, so
they take every dtype.

Where ``XlaBackend.enabled`` declines (ragged reduce-scatter, all-empty
gathers, 64-bit types) and lets the response fall to the TCP plane, this
plane keeps the case on the card, since falling through would stage a
CUDA tensor through the host.

The wire codecs run on the card too.  The cast codecs (fp16/bf16) are a
cast around the allreduce.  The quantized codecs (int8/uint4) follow
``XlaCommunicator.quantized_allreduce``: each rank quantizes its buffer
once (``compress/ops.py`` ``quantize_rows``, the last element padding the
last block), one all-gather moves every rank's payload, scales and zero
points, and every rank dequantizes and sums in fp32; there is no
requantization, so the error stays within one quantization of each
input.  Adasum is a stated difference: the XLA plane does not claim it
and the reference runs it on the host, but a CUDA tensor stays on its
card, so this plane runs ``ops/adasum.py``'s VHDD itself, in float64 on
the card, each pairwise exchange one ``batch_isend_irecv`` so both
partners send and receive at once.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..common.dtypes import to_torch
from ..common.message import Response, ResponseType
from ..common.status import Status
from ..common.tensor_queue import TensorTableEntry
from .base import (CollectiveBackend, _rest, cast, contiguous,
                   dim0_row_bounds, is_device_response)

# The dtype a reduction runs in on the wire, where it is not the tensor's.
_REDUCE_DTYPE = {torch.float16: torch.float32,
                 torch.bfloat16: torch.float32,
                 torch.int16: torch.int32,
                 torch.uint16: torch.int32,
                 torch.bool: torch.int32}


def _widen(buf: torch.Tensor) -> torch.Tensor:
    return buf.to(_REDUCE_DTYPE.get(buf.dtype, buf.dtype))


def _narrow(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return acc != 0
    return acc.to(dtype)


def adasum_combine(a: torch.Tensor, b: torch.Tensor,
                   dots: torch.Tensor) -> torch.Tensor:
    """``ops/adasum.py`` ``adasum_combine`` on tensors, without a host
    sync: ``dots`` holds (aa, bb, ab) on a's device, and a zero norm takes
    coefficient 1, so two zero norms give a + b."""
    aa, bb, ab = dots[0], dots[1], dots[2]
    one = torch.ones((), dtype=dots.dtype, device=dots.device)
    acoef = torch.where(aa == 0, one, 1.0 - ab / (2.0 * aa))
    bcoef = torch.where(bb == 0, one, 1.0 - ab / (2.0 * bb))
    return acoef * a + bcoef * b


def _bytes(rows: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's last dimension as raw bytes (the layout the
    data-movement collectives send, whatever the dtype)."""
    return rows.view(torch.uint8)


class NcclCommunicator:
    """The collectives of one process group on one device: in-place
    sums and broadcasts of flat buffers, and the ragged gathers, scatters
    and exchanges, padded where NCCL wants equal blocks."""

    def __init__(self, group=None, device: torch.device | str = "cuda"
                 ) -> None:
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)

    def _global(self, rank: int) -> int:
        return rank if self.group is None else \
            dist.get_global_rank(self.group, rank)

    def allreduce(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum ``buf`` over the ranks, in place."""
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def broadcast(self, buf: torch.Tensor, root: int) -> torch.Tensor:
        """Root's ``buf`` into every rank's ``buf``, in place."""
        dist.broadcast(buf, src=self._global(root), group=self.group)
        return buf

    def allgatherv(self, local: torch.Tensor,
                   counts: list[int]) -> torch.Tensor:
        """Concatenate every rank's flat ``local`` (``counts[r]``
        elements on rank r) in rank order.  Ragged blocks are padded to
        the largest so one all-gather moves them; the padding is dropped
        on the card."""
        widest = max(counts)
        if widest == 0:
            return local.new_empty(0)
        full = local.new_empty(self.size * widest)
        if counts[self.rank] < widest:
            padded = local.new_zeros(widest)
            padded[:local.numel()] = local
            local = padded
        dist.all_gather_into_tensor(full, local, group=self.group)
        if min(counts) == widest:
            return full
        return torch.cat([full[r * widest:r * widest + n]
                          for r, n in enumerate(counts)])

    def alltoallv(self, rows: torch.Tensor, splits: list[int]
                  ) -> tuple[torch.Tensor, list[int]]:
        """Send ``splits[j]`` rows of ``rows`` to rank j; return the rows
        received, in rank order, and how many came from each rank.  The
        received counts cross as one small exchange whose result the host
        reads: it sizes the output."""
        send = torch.tensor(splits, dtype=torch.int64, device=rows.device)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        received = [int(x) for x in recv.tolist()]
        out = rows.new_empty((sum(received),) + tuple(rows.shape[1:]))
        dist.all_to_all_single(out, rows, output_split_sizes=received,
                               input_split_sizes=list(splits),
                               group=self.group)
        return out, received

    def quantized_allreduce(self, buf: torch.Tensor, codec,
                            block_size: int) -> torch.Tensor:
        """Sum of every rank's flat ``buf`` through the quantized wire,
        fp32: quantize once, all-gather payload, scales and zero points
        in one exchange, dequantize every row and sum."""
        from ..compress import CompressionCodec, num_blocks
        from ..compress.ops import dequantize_rows, quantize_rows
        n = buf.numel()
        nb = num_blocks(n, block_size)
        if nb == 0:
            return buf.new_zeros(0, dtype=torch.float32)
        m = nb * block_size
        x = buf.reshape(-1).float()
        if m > n:
            # The last element pads the last block (compress/quantize.py's
            # rule), so its scale is that of the elements it holds.
            x = torch.cat([x, x[-1:].expand(m - n)])
        q, s, zp = quantize_rows(x[None, :], codec, block_size)
        pb = m // 2 if codec == CompressionCodec.UINT4 else m
        row = torch.cat([q.reshape(-1), s.reshape(-1).view(torch.uint8),
                         zp.reshape(-1).view(torch.uint8)])
        rows = row.new_empty(self.size * row.numel())
        dist.all_gather_into_tensor(rows, row, group=self.group)
        rows = rows.reshape(self.size, -1)
        meta = nb * 4
        q = rows[:, :pb]
        s = rows[:, pb:pb + meta].contiguous().view(torch.float32)
        zp = rows[:, pb + meta:].contiguous().view(torch.float32)
        deq = dequantize_rows(q, s, zp, codec, block_size)
        return deq.sum(dim=0)[:n]

    def _exchange(self, peer: int, send: torch.Tensor,
                  recv: torch.Tensor) -> None:
        """Send ``send`` to ``peer`` and receive ``recv`` from it at once
        (NCCL needs the pair's send and receive posted together); an
        empty side posts nothing, as its partner expects nothing."""
        ops = []
        if send.numel():
            ops.append(dist.P2POp(dist.isend, send, self._global(peer),
                                  group=self.group))
        if recv.numel():
            ops.append(dist.P2POp(dist.irecv, recv, self._global(peer),
                                  group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def adasum(self, buf: torch.Tensor) -> torch.Tensor:
        """Adasum of every rank's flat ``buf``, in float64 on the card and
        returned in ``buf``'s dtype: ``ops/adasum.py`` ``adasum_tcp``'s
        recursive vector-halving distance-doubling, its dot products
        summed over each level's aligned rank group by XOR recursive
        doubling, so both ranks of a pair combine with the same
        coefficients.  Needs a power-of-2 world."""
        from ..ops.adasum import is_pow2
        size, rank = self.size, self.rank
        if size == 1:
            return buf
        if not is_pow2(size):
            raise ValueError(
                f"Adasum requires a power-of-2 world size, got {size}")
        frag = buf.reshape(-1).to(torch.float64, copy=True)
        path: list[tuple[int, bool, int]] = []   # (partner, kept_first, n)
        distance, level = 1, 0
        while distance < size:
            partner = rank ^ distance
            n = frag.numel()
            mid = n // 2
            kept_first = rank < partner
            keep = frag[:mid] if kept_first else frag[mid:]
            give = frag[mid:] if kept_first else frag[:mid]
            other = torch.empty_like(keep)
            self._exchange(partner, give.contiguous(), other)
            a, b = (keep, other) if kept_first else (other, keep)
            dots = torch.stack([a @ a, b @ b, a @ b])
            for j in range(level + 1):
                peer_dots = torch.empty_like(dots)
                self._exchange(rank ^ (1 << j), dots, peer_dots)
                dots = dots + peer_dots
            frag = adasum_combine(a, b, dots)
            path.append((partner, kept_first, n))
            distance <<= 1
            level += 1
        # Reverse sweep: reassemble the full combined vector.
        for partner, kept_first, n in reversed(path):
            other = frag.new_empty(n - frag.numel())
            self._exchange(partner, frag, other)
            frag = torch.cat([frag, other] if kept_first else [other, frag])
        return cast(frag, buf.dtype)

    def reducescatter(self, rows: torch.Tensor,
                      bounds: list[int]) -> torch.Tensor:
        """Sum ``rows`` ([n, rest]) over the ranks and return rows
        ``bounds[rank]:bounds[rank + 1]`` of the sum.  Uneven splits are
        padded to the largest block so one reduce-scatter moves them."""
        counts = [bounds[r + 1] - bounds[r] for r in range(self.size)]
        widest, rest = max(counts), rows.shape[1]
        if widest * rest == 0:
            return rows.new_empty((counts[self.rank], rest))
        if min(counts) == widest:
            blocks = rows
        else:
            blocks = rows.new_zeros((self.size, widest, rest))
            for r, n in enumerate(counts):
                blocks[r, :n] = rows[bounds[r]:bounds[r + 1]]
        out = rows.new_empty(widest * rest)
        dist.reduce_scatter_tensor(out, blocks.reshape(-1),
                                   op=dist.ReduceOp.SUM, group=self.group)
        return out.reshape(widest, rest)[:counts[self.rank]]


class NcclBackend(CollectiveBackend):
    """The device plane: every collective of a response whose tensors
    lie on the ranks' cards, on the card, through ``NcclCommunicator``."""

    name = "nccl"

    _SUPPORTED = (ResponseType.ALLREDUCE, ResponseType.ADASUM,
                  ResponseType.BROADCAST, ResponseType.ALLGATHER,
                  ResponseType.ALLTOALL, ResponseType.REDUCESCATTER)

    def __init__(self, comm: NcclCommunicator) -> None:
        self.comm = comm
        self.world_size = comm.size
        self.device = comm.device

    def enabled(self, response: Response,
                entries: list[TensorTableEntry]) -> bool:
        """Every rank submitted the response's tensors on its card (the
        enqueue refused a tensor on any other card), for a collective
        this plane has.  Rank-symmetric: it reads only the response."""
        return response.response_type in self._SUPPORTED and \
            is_device_response(response)

    def allreduce(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        buf = self.pack_fusion_buffer(response, entries)
        buf = self.scale_buffer(buf, response.prescale_factor)
        dtype = buf.dtype
        wire_dt = self.wire_cast_dtype(response)
        codec = self.quantized_codec(response)
        if response.response_type == ResponseType.ADASUM or \
                codec is not None:
            self._act_start(entries, "NCCL_ADASUM" if codec is None
                            else "NCCL_QUANTIZED_ALLREDUCE")
            try:
                if codec is not None:
                    buf = self.comm.quantized_allreduce(
                        buf, codec, self.codec_block_size(response))
                else:
                    # Per tensor, as on the TCP plane; the cast codecs
                    # shrink the exchanged payload.
                    if wire_dt is not None:
                        buf = cast(buf, wire_dt)
                    offset, parts = 0, []
                    for n in response.tensor_sizes:
                        parts.append(self.comm.adasum(
                            buf[offset:offset + n]))
                        offset += n
                    buf = torch.cat(parts) if len(parts) > 1 else parts[0]
            finally:
                self._act_end(entries)
            buf = self.scale_buffer(cast(buf, dtype),
                                    response.postscale_factor)
            self.unpack_fusion_buffer(buf, response, entries)
            return Status.ok()
        if wire_dt is not None:
            buf = cast(buf, wire_dt)       # the cast codecs' wire
        acc = _widen(buf)
        if acc is buf and any(e.tensor is not None
                              and e.tensor.untyped_storage().data_ptr()
                              == buf.untyped_storage().data_ptr()
                              for e in entries):
            acc = buf.clone()          # the sum is in place: not the input
        self._act_start(entries, "NCCL_ALLREDUCE")
        try:
            self.comm.allreduce(acc)
        finally:
            self._act_end(entries)
        buf = self.scale_buffer(cast(_narrow(acc, buf.dtype), dtype),
                                response.postscale_factor)
        self.unpack_fusion_buffer(buf, response, entries)
        return Status.ok()

    def broadcast(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        dtype = to_torch(response.tensor_type)
        self._act_start(entries, "NCCL_BCAST")
        try:
            for i, e in enumerate(entries):
                if e.tensor is not None and \
                        self.comm.rank == response.root_rank:
                    buf = e.tensor.to(dtype).contiguous()
                elif e.tensor is not None:
                    buf = torch.empty(e.tensor.shape, dtype=dtype,
                                      device=e.tensor.device)
                else:
                    buf = torch.zeros(response.tensor_sizes[i], dtype=dtype,
                                      device=self.device)
                self.comm.broadcast(_bytes(buf.reshape(-1)),
                                    response.root_rank)
                e.output = buf
        finally:
            self._act_end(entries)
        return Status.ok()

    def allgather(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        dtype = to_torch(response.tensor_type)
        size = self.world_size
        self._act_start(entries, "NCCL_ALLGATHER")
        try:
            if len(entries) == 1:
                dims = self.allgather_entry_dims(response, 1, size)[0]
                local = contiguous(entries[0].tensor.to(dtype))
                row_bytes = _rest(local.shape) * dtype.itemsize
                full = self.comm.allgatherv(
                    _bytes(local.reshape(-1)), [d * row_bytes for d in dims])
                entries[0].output = full.view(dtype).reshape(
                    (sum(dims),) + tuple(local.shape[1:]))
                return Status.ok()
            # A fused response: every entry's bytes in one gather, in the
            # TCP plane's rank-major, entry-major layout.
            locals_, dims, rests, per_rank, payload = \
                self.pack_fused_allgather(response, entries, dtype, size)
            full = self.comm.allgatherv(payload, per_rank)
            self.unpack_fused_allgather(full, entries, locals_, dims, rests,
                                        dtype, per_rank)
            return Status.ok()
        finally:
            self._act_end(entries)

    def alltoall(self, response: Response,
                 entries: list[TensorTableEntry]) -> Status:
        dtype = to_torch(response.tensor_type)
        self._act_start(entries, "NCCL_ALLTOALL")
        try:
            for e in entries:
                local = contiguous(e.tensor.to(dtype))
                splits = self.resolve_alltoall_splits(e, local.shape[0],
                                                      self.world_size)
                if isinstance(splits, Status):
                    return splits
                rows = local.reshape(local.shape[0], _rest(local.shape))
                out, received = self.comm.alltoallv(_bytes(rows), splits)
                e.output = out.view(dtype).reshape(
                    (sum(received),) + tuple(local.shape[1:]))
                e.received_splits = received
            return Status.ok()
        finally:
            self._act_end(entries)

    def reducescatter(self, response: Response,
                      entries: list[TensorTableEntry]) -> Status:
        dtype = to_torch(response.tensor_type)
        self._act_start(entries, "NCCL_REDUCESCATTER")
        try:
            for e in entries:
                local = contiguous(e.tensor.to(dtype))
                shape = tuple(local.shape)
                bounds = dim0_row_bounds(shape[0], self.world_size)
                buf = self.scale_buffer(local.reshape(-1),
                                        response.prescale_factor)
                acc = _widen(buf).reshape(shape[0], _rest(shape))
                out = _narrow(self.comm.reducescatter(acc, bounds), dtype)
                out = self.scale_buffer(out.reshape(-1),
                                        response.postscale_factor)
                mine = bounds[self.comm.rank + 1] - bounds[self.comm.rank]
                e.output = out.reshape((mine,) + shape[1:])
            return Status.ok()
        finally:
            self._act_end(entries)
