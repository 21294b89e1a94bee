"""Hierarchical (two-level) host collectives over the local/cross layout.

The port's copy of ``horovod_tpu/backend/hierarchical.py``
(``HierarchicalTcpBackend``: the two-level reduction, the shm local legs,
the two-leg allgather and the per-leg counters) on CPU torch tensors.  The
schedule and its sums are the reference's, so the results are bitwise
equal.

The eager analogue of upstream NCCLHierarchicalAllreduce
(horovod/common/ops/nccl_operations.cc:187-398: reduce-scatter over the
intra-node communicator, cross-node allreduce of the owned shard,
allgather over the intra-node communicator) and MPIHierarchicalAllgather
(a node-local gather, then a cross-node exchange of whole node blocks).
Only 1/local_size of the payload crosses the slow axis.  Enabled by
``HOROVOD_HIERARCHICAL_ALLREDUCE``/``ALLGATHER``; it needs the launcher's
homogeneous host-major layout (rank == cross_rank * local_size +
local_rank) or a declared torus (``HOROVOD_TOPOLOGY=torus:RxC``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..common.dtypes import to_torch
from ..common.message import Response, ResponseType
from ..common.status import Status
from ..common.tensor_queue import TensorTableEntry
from .base import (CollectiveBackend, accum_dtype as _accum_dtype, add_,
                   contiguous, is_device_response)
from .tcp import TcpCollectives


def _even_sizes(n: int, parts: int) -> list[int]:
    base, rem = divmod(n, parts)
    return [base + (1 if j < rem else 0) for j in range(parts)]


class HierarchicalTcpBackend(CollectiveBackend):
    """Two-leg allreduce/allgather over (local, cross) TCP sub-meshes.

    Sits after the device plane and before the shm and flat TCP planes
    in the chain: it refines the host data plane when the knobs are on
    and never claims an op the knobs do not cover, nor a CUDA tensor.
    """

    name = "tcp-hierarchical"

    def __init__(self, local: TcpCollectives, cross: TcpCollectives, *,
                 allreduce_on: bool, allgather_on: bool,
                 shm_local=None) -> None:
        # The two-level ladder, the faster links first: host×slot is
        # (local, cross), a torus (row, col).  (The reference's ladder
        # also takes deeper fabrics; nothing builds one.)
        self.local, self.cross = local, cross
        # Optional same-host shm world over the LOCAL ranks: the
        # intra-host legs then ride mmap regions instead of TCP loopback.
        self.shm_local = shm_local
        self.allreduce_on = allreduce_on
        self.allgather_on = allgather_on
        # Per-leg op counts and analytic payload volumes: they show which
        # path a knob made run.
        self.leg_ops = dict.fromkeys(("local_rs", "local_ag", "cross_ar",
                                      "local_gather", "cross_gather"), 0)
        self.leg_bytes = dict(self.leg_ops)

    def enabled(self, response: Response,
                entries: list[TensorTableEntry]) -> bool:
        if is_device_response(response):
            return False
        rt = response.response_type
        if rt == ResponseType.ALLREDUCE:
            return self.allreduce_on
        if rt == ResponseType.ALLGATHER:
            return self.allgather_on
        return False

    def _use_shm_legs(self, wire_dtype: torch.dtype, nbytes: int) -> bool:
        # poison_seen, not bare `formed`: after any local rank poisons,
        # every local rank declines the shm legs for the next op together
        # (the unanimous-decline rule of ShmBackend.enabled).
        return (self.shm_local is not None
                and not self.shm_local.poison_seen()
                and nbytes <= self.shm_local.capacity
                # 16-bit wires keep the TCP legs: those stay in one fp32
                # accumulation across all three legs, which the
                # wire-dtype regions cannot hold.
                and _accum_dtype(wire_dtype) == wire_dtype)

    # -- allreduce: RS(local) -> AR(cross) -> AG(local) --------------------
    def allreduce(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        self.last_algo = "hierarchical"
        buf = self.pack_fusion_buffer(response, entries)
        buf = self.scale_buffer(buf, response.prescale_factor)
        wire_dtype = buf.dtype
        item = wire_dtype.itemsize
        if self._use_shm_legs(wire_dtype, buf.numel() * item):
            return self._allreduce_shm_local(response, entries, buf)
        # Accumulate ALL legs in the widened dtype, so a 16-bit buffer is
        # rounded once, as on the flat ring.
        buf = buf.to(_accum_dtype(wire_dtype)).contiguous()

        # Reduce-scatter within the host: this rank then owns shard
        # local.rank, its bounds a pure function of the payload size.
        sizes = _even_sizes(buf.numel(), self.local.size)
        bounds = np.cumsum([0] + sizes).tolist()
        self._act_start(entries, "LOCAL_REDUCESCATTER")
        try:
            shard = self.local.reduce_scatter(buf, bounds)
        finally:
            self._act_end(entries)
        self.leg_ops["local_rs"] += 1
        self.leg_bytes["local_rs"] += bounds[-1] * item

        # Allreduce the owned shard across hosts: only 1/local_size of the
        # payload crosses the slow axis.  An empty shard skips the
        # exchange but still counts the leg.
        if shard.numel():
            self._act_start(entries, "CROSS_ALLREDUCE")
            try:
                shard = self.cross.allreduce(contiguous(shard))
            finally:
                self._act_end(entries)
        self.leg_ops["cross_ar"] += 1
        self.leg_bytes["cross_ar"] += shard.numel() * item

        # Allgather the reduced shards back within the host.
        self._act_start(entries, "LOCAL_ALLGATHER")
        try:
            shard = self.local.allgatherv(shard.reshape(-1), sizes)
        finally:
            self._act_end(entries)
        self.leg_ops["local_ag"] += 1
        self.leg_bytes["local_ag"] += shard.numel() * item

        full = self.scale_buffer(shard, response.postscale_factor)
        self.unpack_fusion_buffer(full.to(wire_dtype), response, entries)
        return Status.ok()

    def _allreduce_shm_local(self, response: Response,
                             entries: list[TensorTableEntry],
                             buf: torch.Tensor) -> Status:
        """Local legs over the per-host shm world, cross leg over TCP, in
        ShmBackend's 3-barrier protocol with the cross allreduce of the
        owned chunk between the reduce and gather phases.  A failure
        between publishes poisons the world, so every local rank raises
        now and falls back to the TCP legs afterwards."""
        try:
            return self._shm_local_protocol(response, entries, buf)
        except BaseException:
            self.shm_local.poison()
            raise

    def _shm_local_protocol(self, response: Response,
                            entries: list[TensorTableEntry],
                            buf: torch.Tensor) -> Status:
        w = self.shm_local
        rank, size = w.rank, w.size
        dtype = buf.dtype
        itemsize = dtype.itemsize
        n = buf.numel()
        nbytes = n * itemsize
        t = w._t
        w._t += 1
        bounds = np.cumsum([0] + _even_sizes(n, size)).tolist()
        lo, hi = bounds[rank], bounds[rank + 1]

        def chunk(r: int, a: int, b: int) -> torch.Tensor:
            return w.data(r)[a * itemsize:b * itemsize].view(dtype)

        w.wait_all(3 * t)
        my_region = chunk(rank, 0, n)
        my_region.copy_(buf)
        w.publish(3 * t + 1)

        # Leg 1 (shm): reduce my chunk across the local ranks' regions.
        self._act_start(entries, "LOCAL_REDUCESCATTER")
        try:
            w.wait_all(3 * t + 1)
            mine = my_region[lo:hi]
            for r in range(size):
                if r != rank:
                    add_(mine, chunk(r, lo, hi))
        finally:
            self._act_end(entries)
        self.leg_ops["local_rs"] += 1
        self.leg_bytes["local_rs"] += nbytes

        # Leg 2 (TCP): allreduce the host-reduced chunk across hosts, back
        # into my chunk (peers read only their OWN chunk index before the
        # 3t+2 barrier).
        if hi > lo:
            self._act_start(entries, "CROSS_ALLREDUCE")
            try:
                my_region[lo:hi] = self.cross.allreduce(my_region[lo:hi])
            finally:
                self._act_end(entries)
        self.leg_ops["cross_ar"] += 1
        self.leg_bytes["cross_ar"] += (hi - lo) * itemsize
        w.publish(3 * t + 2)

        # Leg 3 (shm): gather the reduced chunks from their owners.
        self._act_start(entries, "LOCAL_ALLGATHER")
        try:
            w.wait_all(3 * t + 2)
            out = torch.empty(n, dtype=dtype)
            for r in range(size):
                rlo, rhi = bounds[r], bounds[r + 1]
                if rhi > rlo:
                    out[rlo:rhi] = chunk(r, rlo, rhi)
            w.publish(3 * t + 3)
        finally:
            self._act_end(entries)
        self.leg_ops["local_ag"] += 1
        self.leg_bytes["local_ag"] += nbytes

        out = self.scale_buffer(out, response.postscale_factor)
        self.unpack_fusion_buffer(out, response, entries)
        return Status.ok()

    # -- allgather: gather(local) -> gather node blocks (cross) ------------
    def allgather(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        """A node-local gather, then one exchange of whole node blocks;
        a fused response packs once, so every entry rides one local and
        one cross exchange.  The packed layout is the flat planes'
        (rank-major, entry-major within a rank); the global rank order
        is host-major, so concatenating host blocks reproduces it."""
        self.last_algo = "hierarchical"
        lsize = self.local.size
        csize = self.cross.size
        crank = self.cross.rank
        dtype = to_torch(response.tensor_type)
        locals_, dims, rests, per_rank, payload = \
            self.pack_fused_allgather(response, entries, dtype,
                                      lsize * csize)

        node_bytes = per_rank[crank * lsize:(crank + 1) * lsize]
        self._act_start(entries, "LOCAL_GATHER")
        try:
            node_block = self.local.allgatherv(payload, node_bytes)
        finally:
            self._act_end(entries)
        self.leg_ops["local_gather"] += 1
        self.leg_bytes["local_gather"] += node_block.numel()

        host_bytes = [sum(per_rank[h * lsize:(h + 1) * lsize])
                      for h in range(csize)]
        self._act_start(entries, "CROSS_GATHER")
        try:
            full = self.cross.allgatherv(node_block, host_bytes)
        finally:
            self._act_end(entries)
        self.leg_ops["cross_gather"] += 1
        self.leg_bytes["cross_gather"] += full.numel()

        self.unpack_fused_allgather(full, entries, locals_, dims, rests,
                                    dtype, per_rank)
        return Status.ok()

    # Never selected (enabled() is False for these response types).
    def broadcast(self, response, entries) -> Status:
        return Status.unknown_error(
            "hierarchical backend does not implement broadcast")

    def alltoall(self, response, entries) -> Status:
        return Status.unknown_error(
            "hierarchical backend does not implement alltoall")
