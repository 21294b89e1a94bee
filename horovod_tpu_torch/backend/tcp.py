"""TCP data plane — the Gloo-replacement CPU backend.

The port's copy of ``horovod_tpu/backend/tcp.py`` (``TcpCollectives`` with
the ring, tree, rhd and torus allreduce schedules that ``HOROVOD_ALGO=auto``
picks among, the cast and quantized codec legs, and ``TcpBackend`` with
its Adasum branch) on CPU torch tensors.  The schedules and their sum
order are the reference's, and the codec legs run the reference's numpy
arithmetic on numpy views of the tensors' memory (``compress/quantize.py``
and ``compress/fused.py``; torch casts only where numpy has no bf16), so
the results are bitwise equal.

Reference: horovod/common/ops/gloo_operations.{cc,h} (ring / halving-doubling
CPU collectives).  Bulk payloads ride a dedicated full-mesh socket set
(PeerMesh) so they never interleave with controller messages.  Sends are
enqueued on the mesh's persistent per-peer sender lanes straight from the
accumulator's memory, and receives land either directly in the destination
buffer or in reusable scratch, consumed in HOROVOD_SEGMENT_BYTES slices
(the same elementwise adds in the same order as one monolithic add).
``TcpBackend`` is stream-safe: ``core.init`` builds one per dispatch
stream, each over its own PeerMesh.

Algorithms:
- allreduce: ring reduce-scatter + ring allgather (bandwidth-optimal,
  2(N-1)/N · bytes per link) with fp32 accumulation for 16-bit dtypes;
  binomial tree, recursive halving-doubling and the two-phase torus for
  the cases ``_select_algo`` names;
- allgatherv: ring rotation of variable-size blocks;
- broadcast: binomial tree from the root (O(log N) latency);
- alltoall: pairwise exchange over the sender lanes (cycle-deadlock free).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..common import config
from ..common.dtypes import to_torch
from ..common.message import Response, ResponseType
from ..common.status import Status
from ..common.tensor_queue import TensorTableEntry
from ..runner.network import PeerMesh
from .base import (CollectiveBackend, _rest, accum_dtype as _accum_dtype,
                   add_, byte_view as _bv, cast, contiguous, dim0_row_bounds,
                   is_device_response)


def _nbv(arr: np.ndarray) -> memoryview:
    """Flat byte view of a C-contiguous numpy array (a codec wire image
    or an fp32 accumulator)."""
    return memoryview(arr.reshape(-1).view(np.uint8))


class TcpCollectives:
    """Raw collective algorithms over a PeerMesh (rank-symmetric calls)."""

    def __init__(self, mesh: PeerMesh,
                 ring_order: list[int] | None = None,
                 torus: tuple[int, int] | None = None,
                 algo: str | None = None,
                 tree_threshold: int | None = None,
                 fused: bool | None = None,
                 segment_bytes: int | None = None) -> None:
        self.mesh = mesh
        self.rank = mesh.rank
        self.size = mesh.size
        # Pipeline granularity for the segmented receive+accumulate (the
        # autotuner may retune it through ResponseList.tuned_segment_bytes;
        # the sums are the same at any value); 0 = monolithic receives.
        self.segment_bytes = config.SEGMENT_BYTES.get() \
            if segment_bytes is None else int(segment_bytes)
        # Topology-aware ring order (common/topology.py): a permutation
        # of ranks in ring-walk order; identity by default.
        if ring_order is not None:
            order = [int(r) for r in ring_order]
            assert sorted(order) == list(range(self.size)), order
            self._order = order
            self._pos = order.index(self.rank)
        else:
            self._order = list(range(self.size))
            self._pos = self.rank
        # Declared torus shape (rows, cols) with rank = row*cols + col.
        self._torus = None
        if torus is not None and torus[0] * torus[1] == self.size:
            self._torus = (int(torus[0]), int(torus[1]))
        self.algo = config.ALGO.get() if algo is None else str(algo)
        self.tree_threshold = config.TREE_THRESHOLD_BYTES.get() \
            if tree_threshold is None else int(tree_threshold)
        # Algorithm the last allreduce actually executed.
        self.last_algo = "ring"
        # Whether the last allreduce ran the native C++ ring.
        self.last_native = False
        # Single-pass codec passes (compress/fused.py) against the
        # per-chunk chain of compress/quantize.py (HOROVOD_FUSED_KERNELS);
        # bitwise equal either way.
        self.fused = config.FUSED_KERNELS.get() if fused is None \
            else bool(fused)
        from ..compress.fused import FusedKernels
        self._fk = FusedKernels()
        # Per-(peer, dtype) typed views over the channels' scratch
        # bytearrays (one cached view per channel instead of a fresh
        # wrapper per segment).
        self._seg_views: dict = {}
        # Segment-overlap efficiency (telemetry/): bytes whose accumulate
        # overlapped the wire (segmented path) vs bytes that arrived
        # monolithically.  No-op metrics when HOROVOD_METRICS=off.
        from ..telemetry import metrics as _tm_metrics
        _tm = _tm_metrics()
        self._m_seg_bytes = _tm.counter(
            "horovod_tcp_segmented_recv_bytes_total",
            "Ring-chunk bytes consumed through the segmented "
            "receive+accumulate (comm/compute overlapped)")
        self._m_mono_bytes = _tm.counter(
            "horovod_tcp_monolithic_recv_bytes_total",
            "Ring-chunk bytes consumed in one monolithic receive "
            "(chunk below segment size, or segmentation off)")
        # Per-leg fused-vs-reference latency histograms of the codec legs.
        self._tm_on = getattr(_tm, "enabled", False)
        self._m_leg = {
            (leg, fused): _tm.histogram(
                "horovod_tcp_codec_leg_ms",
                "Wall time of one codec-collective leg (gather = "
                "contributions in + fp32 accumulate, return = reduced "
                "chunks out), split by fused-kernel vs reference "
                "dispatch",
                labels={"leg": leg, "fused": "on" if fused else "off"})
            for leg in ("gather", "return") for fused in (True, False)}

    def _leg_start(self) -> float:
        return time.perf_counter() if self._tm_on else 0.0

    def _leg_end(self, leg: str, fused: bool, t0: float) -> None:
        if self._tm_on:
            self._m_leg[(leg, fused)].observe(
                (time.perf_counter() - t0) * 1e3)

    # -- helpers --------------------------------------------------------
    def _sendrecv(self, to_rank: int, payload: bytes,
                  from_rank: int) -> bytearray:
        """Concurrent send+recv, so pairwise exchanges cannot deadlock on
        filled socket buffers: the send streams on the peer's sender lane
        while this thread blocks in recv."""
        self.mesh.send_async(to_rank, payload)
        return self.mesh.recv(from_rank)

    def _recv_scratch(self, frm: int) -> memoryview:
        """Receive one framed message into the peer's reusable scratch;
        the view is valid until the next receive from `frm`."""
        nbytes = self.mesh.recv_begin(frm)
        view = self.mesh.scratch(frm, nbytes)
        if nbytes:
            self.mesh.recv_raw_into(frm, view)
        return view

    def _scratch_view(self, frm: int, view: memoryview,
                      dtype: torch.dtype) -> torch.Tensor:
        """Persistent typed tensor over the peer channel's scratch
        bytearray, invalidated when the channel grows its scratch (the
        underlying bytearray object changes identity)."""
        base = view.obj
        key = (frm, dtype)
        cached = self._seg_views.get(key)
        if cached is None or cached[0] is not base:
            arr = torch.frombuffer(base, dtype=dtype,
                                   count=len(base) // dtype.itemsize)
            self._seg_views[key] = (base, arr)
            return arr
        return cached[1]

    def _recv_accum(self, frm: int, acc_slice: torch.Tensor) -> None:
        """Receive one ring chunk from `frm`, adding it into `acc_slice`
        in segment_bytes slices.  Elementwise adds in ascending index
        order — bit-identical to one monolithic add."""
        nbytes = self.mesh.recv_begin(frm)
        itemsize = acc_slice.dtype.itemsize
        assert nbytes == acc_slice.numel() * itemsize, \
            (nbytes, acc_slice.numel() * itemsize)
        if nbytes == 0:
            return
        seg_elems = self.segment_bytes // itemsize
        total = acc_slice.numel()
        if seg_elems <= 0 or seg_elems >= total:
            view = self.mesh.scratch(frm, nbytes)
            self.mesh.recv_raw_into(frm, view)
            arr = self._scratch_view(frm, view, acc_slice.dtype)
            add_(acc_slice, arr[:total])
            self._m_mono_bytes.inc(nbytes)
            return
        self._m_seg_bytes.inc(nbytes)
        scratch = self.mesh.scratch(frm, seg_elems * itemsize)
        arr = self._scratch_view(frm, scratch, acc_slice.dtype)
        pos = 0
        while pos < total:
            k = min(seg_elems, total - pos)
            self.mesh.recv_raw_into(frm, scratch[:k * itemsize])
            add_(acc_slice[pos:pos + k], arr[:k])
            pos += k

    def _recv_into(self, frm: int, arr: torch.Tensor) -> None:
        """Receive one framed message from `frm` straight into `arr`
        (no staging copy; `arr` must be contiguous)."""
        nbytes = self.mesh.recv_begin(frm)
        assert nbytes == arr.numel() * arr.element_size(), \
            (nbytes, arr.numel() * arr.element_size())
        if nbytes:
            self.mesh.recv_raw_into(frm, _bv(arr))

    # -- algorithm selection --------------------------------------------
    def _select_algo(self, nbytes: int) -> str:
        """Pick the allreduce algorithm for an `nbytes` payload: a pure
        function of rank-symmetric inputs (the negotiated payload size
        and the launcher-uniform knobs), so every rank of a response
        picks the same one."""
        algo = self.algo
        if algo == "auto":
            if 0 < self.tree_threshold and nbytes <= self.tree_threshold \
                    and self.size > 2:
                algo = "tree"
            elif self._torus is not None:
                algo = "torus"
            else:
                algo = "ring"
        if algo == "rhd" and (self.size & (self.size - 1)) != 0:
            algo = "tree"      # halving/doubling needs a power-of-two world
        if algo == "torus" and self._torus is None:
            algo = "ring"
        if self.size <= 2 and algo in ("tree", "rhd", "torus"):
            # Two ranks: every schedule degenerates to the same single
            # exchange; keep the ring (native fast path, fewer frames).
            algo = "ring"
        return algo

    # -- allreduce ------------------------------------------------------
    def allreduce(self, buf: torch.Tensor) -> torch.Tensor:
        """Allreduce; returns the reduced buffer.  All variants reduce in
        the widened accumulation dtype end-to-end; fp32 results may
        differ from the ring in the last ulp where the accumulation ORDER
        differs (tree root adds in rank order, rhd adds pairwise) —
        integer dtypes are exact everywhere."""
        n, size = buf.numel(), self.size
        self.last_native = False
        if size == 1:
            return buf
        algo = self._select_algo(n * buf.element_size())
        self.last_algo = algo
        acc = buf.to(_accum_dtype(buf.dtype), copy=True).contiguous()
        if algo != "ring":
            if algo == "tree":
                acc = self._allreduce_tree(acc)
            elif algo == "rhd":
                acc = self._allreduce_rhd(acc)
            else:
                acc = self._allreduce_torus(acc)
            return acc.to(buf.dtype)
        pos = self._pos
        # Chunk i = [bounds[i], bounds[i+1]), owned by ring POSITION i.
        base, rem = divmod(n, size)
        sizes = [base + (1 if i < rem else 0) for i in range(size)]
        bounds = np.cumsum([0] + sizes).tolist()
        nxt = self._order[(pos + 1) % size]
        prv = self._order[(pos - 1) % size]

        # Native C++ ring (same schedule, GIL released).  It writes the
        # raw fds directly, so queued frames from a previous op's final
        # leg must drain first.  EXCLUDED under fault tolerance/chaos:
        # the C loop blocks on raw fds (it cannot honor the per-op
        # deadline, and the resilience socket timeouts put the fds in
        # non-blocking mode), and chaos send hooks never see its
        # traffic — the deadline-bounded Python ring is the resilient
        # path.
        from .. import native
        self.mesh.flush()
        native_ok = (self.mesh._resilience is None
                     and self.mesh._chaos is None)
        if native_ok and \
                native.ring_allreduce(self.mesh._socks[nxt].fileno(),
                                      self.mesh._socks[prv].fileno(),
                                      acc, pos, size):
            # Account the native ring's known volume so the mesh byte
            # counters stay truthful (2(N-1) chunk sends per rank).
            itemsize = acc.element_size()
            sent = sum(sizes[(pos - s) % size] +
                       sizes[(pos + 1 - s) % size]
                       for s in range(size - 1)) * itemsize
            rcvd = sum(sizes[(pos - s - 1) % size] +
                       sizes[(pos - s) % size]
                       for s in range(size - 1)) * itemsize
            with self.mesh._lock:
                self.mesh.bytes_sent += sent
                self.mesh.bytes_received += rcvd
            if self.mesh._tm_on:   # per-peer attribution for the raw-fd ring
                self.mesh._tm_count_sent(nxt, sent)
                self.mesh._tm_count_recv(prv, rcvd)
            self.last_native = True
            return acc.to(buf.dtype)

        # Reduce-scatter: after step s, this position owns-partial chunk
        # (pos - s) % size.  Sends go straight from the accumulator (never
        # re-mutated while queued: step s writes chunk (pos-s-1), which is
        # not sent until s+1).
        for step in range(size - 1):
            send_idx = (pos - step) % size
            recv_idx = (pos - step - 1) % size
            self.mesh.send_async(
                nxt, _bv(acc[bounds[send_idx]:bounds[send_idx + 1]]))
            self._recv_accum(prv, acc[bounds[recv_idx]:bounds[recv_idx + 1]])

        # Ring allgather of the fully reduced chunks, received straight
        # into their final position in the accumulator.
        for step in range(size - 1):
            send_idx = (pos + 1 - step) % size
            recv_idx = (pos - step) % size
            self.mesh.send_async(
                nxt, _bv(acc[bounds[send_idx]:bounds[send_idx + 1]]))
            self._recv_into(prv, acc[bounds[recv_idx]:bounds[recv_idx + 1]])

        # Queued frames must reach the kernel before the caller may mutate
        # the result.
        self.mesh.flush()
        return acc.to(buf.dtype)

    # -- binomial tree primitives (small-tensor allreduce) --------------
    def _tree_low(self) -> int:
        """My subtree stride in the rank-0-rooted binomial tree: lowbit
        of the rank, or the covering power of two at the root."""
        if self.rank == 0:
            low = 1
            while low < self.size:
                low <<= 1
            return low
        return self.rank & -self.rank

    def _tree_gather(self, payload, item: int) -> bytearray | None:
        """Binomial gather of one fixed-size `payload` per rank to rank
        0; the root ends holding all N contributions ordered BY RANK.
        Returns the slot buffer on rank 0, None elsewhere."""
        size, rank = self.size, self.rank
        low = self._tree_low()
        span = min(low, size - rank)        # my subtree = [rank, rank+span)
        block: bytearray | None = None
        if span > 1:
            block = bytearray(span * item)
            block[0:item] = payload
        m = 1
        while m < low:
            child = rank + m
            if child < size:
                cspan = min(m, size - child)
                view = memoryview(block)[m * item:(m + cspan) * item]
                nb = self.mesh.recv_begin(child)
                assert nb == cspan * item, (nb, cspan, item)
                self.mesh.recv_raw_into(child, view)
            m <<= 1
        if rank == 0:
            return block
        parent = rank - low
        self.mesh.send_async(
            parent, payload if block is None else memoryview(block))
        return None

    def _tree_bcast_into(self, view: memoryview) -> None:
        """Binomial broadcast of rank 0's `view` into every rank's view;
        flushes the lanes so the caller may mutate the buffer on return."""
        size, rank = self.size, self.rank
        low = self._tree_low()
        if rank != 0:
            parent = rank - low
            nb = self.mesh.recv_begin(parent)
            assert nb == len(view), (nb, len(view))
            self.mesh.recv_raw_into(parent, view)
        m = low >> 1
        while m:
            child = rank + m
            if child < size:
                self.mesh.send_async(child, view)
            m >>= 1
        self.mesh.flush()

    def _allreduce_tree(self, acc: torch.Tensor) -> torch.Tensor:
        """Binomial-tree allreduce for latency-bound payloads: the root
        accumulates all N contributions in RANK ORDER in the widened
        dtype and the result returns on the mirrored broadcast."""
        n = acc.numel()
        item = n * acc.element_size()
        block = self._tree_gather(_bv(acc), item)
        if block is not None:               # root: rank-order accumulate
            for j in range(1, self.size):
                arr = torch.frombuffer(block, dtype=acc.dtype, count=n,
                                       offset=j * item)
                add_(acc, arr)
        self._tree_bcast_into(_bv(acc))
        return acc

    # -- recursive halving-doubling (power-of-two worlds) ---------------
    def _allreduce_rhd(self, acc: torch.Tensor) -> torch.Tensor:
        """Recursive vector-halving/distance-doubling allreduce
        (Rabenseifner): log N exchange rounds each moving half the live
        window.  Power-of-two worlds only."""
        size, rank = self.size, self.rank
        lo, hi = 0, acc.numel()
        steps: list[tuple[int, int, int]] = []
        mask = 1
        while mask < size:
            partner = rank ^ mask
            mid = (lo + hi) // 2
            steps.append((lo, hi, mid))
            if rank & mask:
                self.mesh.send_async(partner, _bv(acc[lo:mid]))
                self._recv_accum(partner, acc[mid:hi])
                lo = mid
            else:
                self.mesh.send_async(partner, _bv(acc[mid:hi]))
                self._recv_accum(partner, acc[lo:mid])
                hi = mid
            mask <<= 1
        # Distance-doubling allgather: replay the halving in reverse.
        for plo, phi, mid in reversed(steps):
            mask >>= 1
            partner = rank ^ mask
            self.mesh.send_async(partner, _bv(acc[lo:hi]))
            if lo == mid:                   # I kept the upper half
                self._recv_into(partner, acc[plo:mid])
            else:
                self._recv_into(partner, acc[mid:phi])
            lo, hi = plo, phi
        self.mesh.flush()
        return acc

    # -- two-phase torus allreduce --------------------------------------
    def _group_ring_reduce_scatter(self, group: list[int], k: int,
                                   acc: torch.Tensor,
                                   bounds: list[int]) -> int:
        """Ring reduce-scatter among `group` (I am group[k]); returns the
        chunk index this member ends up owning fully reduced."""
        m = len(group)
        nxt, prv = group[(k + 1) % m], group[(k - 1) % m]
        for step in range(m - 1):
            si = (k - step) % m
            ri = (k - step - 1) % m
            self.mesh.send_async(nxt, _bv(acc[bounds[si]:bounds[si + 1]]))
            self._recv_accum(prv, acc[bounds[ri]:bounds[ri + 1]])
        return (k + 1) % m

    def _group_ring_allgather(self, group: list[int], k: int,
                              acc: torch.Tensor, bounds: list[int],
                              own: int) -> None:
        m = len(group)
        nxt, prv = group[(k + 1) % m], group[(k - 1) % m]
        for step in range(m - 1):
            si = (own - step) % m
            ri = (own - step - 1) % m
            self.mesh.send_async(nxt, _bv(acc[bounds[si]:bounds[si + 1]]))
            self._recv_into(prv, acc[bounds[ri]:bounds[ri + 1]])

    def _group_ring_allreduce(self, group: list[int], k: int,
                              seg: torch.Tensor) -> None:
        m = len(group)
        base, rem = divmod(seg.numel(), m)
        sizes = [base + (1 if i < rem else 0) for i in range(m)]
        bounds = np.cumsum([0] + sizes).tolist()
        own = self._group_ring_reduce_scatter(group, k, seg, bounds)
        self._group_ring_allgather(group, k, seg, bounds, own)

    def _allreduce_torus(self, acc: torch.Tensor) -> torch.Tensor:
        """Two-phase torus allreduce on a declared R×C grid: ring
        reduce-scatter along my ROW, ring allreduce of the owned chunk
        along my COLUMN, ring allgather back along the row."""
        rows, cols = self._torus
        row, col = divmod(self.rank, cols)
        row_group = [row * cols + j for j in range(cols)]
        col_group = [i * cols + col for i in range(rows)]
        base, rem = divmod(acc.numel(), cols)
        sizes = [base + (1 if j < rem else 0) for j in range(cols)]
        bounds = np.cumsum([0] + sizes).tolist()
        own = self._group_ring_reduce_scatter(row_group, col, acc, bounds)
        seg = acc[bounds[own]:bounds[own + 1]]
        if seg.numel() and rows > 1:
            self._group_ring_allreduce(col_group, row, seg)
        self._group_ring_allgather(row_group, col, acc, bounds, own)
        self.mesh.flush()
        return acc

    # -- cast-codec allreduce -------------------------------------------
    def cast_allreduce(self, buf: torch.Tensor,
                       wire_dtype: torch.dtype) -> torch.Tensor:
        """Allreduce with a narrow wire dtype (fp16/bf16) that halves the
        socket bytes: each rank ships its wire-cast chunks to their
        owners, owners accumulate in fp32 in rank order and round ONCE,
        and the reduced chunks return in the wire dtype.  Small payloads
        in worlds above two ranks take the binomial tree, bitwise equal
        to the owner-reduce."""
        if self.size == 1:
            return buf
        if self.size > 2 and self._select_algo(
                buf.numel() * wire_dtype.itemsize) == "tree":
            self.last_algo = "tree"
            return self._cast_allreduce_tree(buf, wire_dtype)
        self.last_algo = "ring"
        if self.fused:
            return self._cast_allreduce_fused(buf, wire_dtype)
        return self._cast_allreduce_reference(buf, wire_dtype)

    def _cast_return_leg(self, reduced: torch.Tensor, bounds,
                         n: int) -> torch.Tensor:
        """Send my reduced chunk to every peer and receive theirs
        straight into their output slices."""
        rank, size = self.rank, self.size
        out = torch.empty(n, dtype=reduced.dtype)
        out[bounds[rank]:bounds[rank + 1]] = reduced
        payload = _bv(reduced)
        for offset in range(1, size):
            to = (rank + offset) % size
            frm = (rank - offset) % size
            self.mesh.send_async(to, payload)
            self._recv_into(frm, out[bounds[frm]:bounds[frm + 1]])
        self.mesh.flush()
        return out

    def _cast_allreduce_fused(self, buf: torch.Tensor,
                              wire_dtype: torch.dtype) -> torch.Tensor:
        """Every destination chunk is posted on the sender lanes up
        front, then contributions are received in ascending rank order
        and folded into the fp32 accumulator as they land
        (``FusedKernels.cast_add``): the reference chain's rank-order
        sum, without its per-peer allocations."""
        from ..compress import chunk_bounds
        n, rank, size = buf.numel(), self.rank, self.size
        fk = self._fk
        x = cast(contiguous(buf), wire_dtype)
        bounds = chunk_bounds(n, size).tolist()
        my_len = bounds[rank + 1] - bounds[rank]
        t0 = self._leg_start()
        for offset in range(1, size):
            to = (rank + offset) % size
            self.mesh.send_async(to, _bv(x[bounds[to]:bounds[to + 1]]))
        acc = fk.f32(("cacc",), my_len)
        acc[:] = 0.0
        for j in range(size):                  # rank-order accumulate
            view = _bv(x[bounds[rank]:bounds[rank + 1]]) if j == rank \
                else self._recv_scratch(j)
            fk.cast_add(view, wire_dtype, acc, ("cin",))
        reduced = cast(torch.from_numpy(acc), wire_dtype)  # ONE rounding
        self._leg_end("gather", True, t0)
        t0 = self._leg_start()
        out = self._cast_return_leg(reduced, bounds, n)
        self._leg_end("return", True, t0)
        return cast(out, buf.dtype)

    def _cast_allreduce_reference(self, buf: torch.Tensor,
                                  wire_dtype: torch.dtype) -> torch.Tensor:
        """The per-chunk chain (HOROVOD_FUSED_KERNELS=0): each peer's
        contribution widened as it arrives into a list, summed in rank
        order at the end."""
        from ..compress import chunk_bounds
        n, rank, size = buf.numel(), self.rank, self.size
        x = cast(contiguous(buf), wire_dtype)
        bounds = chunk_bounds(n, size).tolist()
        my_len = bounds[rank + 1] - bounds[rank]
        t0 = self._leg_start()
        contrib32: list = [None] * size
        contrib32[rank] = x[bounds[rank]:bounds[rank + 1]].float()
        for offset in range(1, size):
            to = (rank + offset) % size
            frm = (rank - offset) % size
            self.mesh.send_async(to, _bv(x[bounds[to]:bounds[to + 1]]))
            view = self._recv_scratch(frm)
            contrib32[frm] = torch.frombuffer(
                view, dtype=wire_dtype, count=my_len).float() \
                if my_len else torch.zeros(0)
        acc = torch.zeros(my_len)
        for c in contrib32:                    # rank order
            acc += c
        reduced = cast(acc, wire_dtype)
        self._leg_end("gather", False, t0)
        t0 = self._leg_start()
        out = self._cast_return_leg(reduced, bounds, n)
        self._leg_end("return", False, t0)
        return cast(out, buf.dtype)

    # -- quantized allreduce --------------------------------------------
    def quantized_allreduce(self, buf: torch.Tensor, codec,
                            block_size: int) -> torch.Tensor:
        """Block-quantized allreduce, the owner-reduce exchange:

          1. quantize each destination chunk of my buffer on its own;
          2. send the quantized chunks (scales + zero points + payload)
             to their owners;
          3. dequantize + sum in fp32 in rank order, my own contribution
             dequantized too, so every rank reconstructs the same value;
          4. requantize the reduced chunk ONCE and send it to every rank.

        Wire bytes: 2(N-1)/N · the quantized size.  Small payloads in
        worlds above two ranks take the tree when the chunks are
        block-aligned (then its block stats equal the ring's) or the
        tree is pinned.  Fused and per-chunk chains are bitwise equal."""
        if self.size == 1:
            return buf
        aligned = buf.numel() % (self.size * block_size) == 0
        if self.size > 2 and (aligned or self.algo == "tree") and \
                self._select_algo(buf.numel() * 4) == "tree":
            self.last_algo = "tree"
            return self._quantized_allreduce_tree(buf, codec, block_size)
        self.last_algo = "ring"
        if self.fused:
            return self._quantized_allreduce_fused(buf, codec, block_size)
        return self._quantized_allreduce_reference(buf, codec, block_size)

    def _quantized_allreduce_fused(self, buf: torch.Tensor, codec,
                                   block_size: int) -> torch.Tensor:
        """Requantize straight into persistent wire images, each posted
        on its lane as soon as it is encoded; contributions are received
        in ascending rank order and folded into the fp32 accumulator as
        they land (``decode_add``); the return leg decodes straight into
        the output slices."""
        from ..compress import chunk_bounds
        n, rank, size = buf.numel(), self.rank, self.size
        fk = self._fk
        x = contiguous(buf.float()).numpy()
        bounds = chunk_bounds(n, size).tolist()
        my_len = bounds[rank + 1] - bounds[rank]
        t0 = self._leg_start()
        for offset in range(1, size):          # encode k+1 overlaps wire k
            to = (rank + offset) % size
            self.mesh.send_async(
                to, fk.encode(x[bounds[to]:bounds[to + 1]], codec,
                              block_size, ("enc", to)))
        my_wire = fk.encode(x[bounds[rank]:bounds[rank + 1]], codec,
                            block_size, ("enc", rank))
        acc = fk.f32(("qacc",), my_len)
        acc[:] = 0.0
        for j in range(size):                  # rank-order accumulate
            view = my_wire if j == rank else self._recv_scratch(j)
            fk.decode_add(view, my_len, codec, block_size, acc, ("qin",))
        reduced = fk.encode(acc, codec, block_size, ("red",))
        self._leg_end("gather", True, t0)

        t0 = self._leg_start()
        out = np.empty(n, np.float32)
        fk.decode_into(reduced, my_len, codec, block_size,
                       out[bounds[rank]:bounds[rank + 1]], ("qout",))
        for offset in range(1, size):
            to = (rank + offset) % size
            frm = (rank - offset) % size
            self.mesh.send_async(to, reduced)
            view = self._recv_scratch(frm)
            fk.decode_into(view, bounds[frm + 1] - bounds[frm], codec,
                           block_size, out[bounds[frm]:bounds[frm + 1]],
                           ("qout",))
        self.mesh.flush()
        self._leg_end("return", True, t0)
        return cast(torch.from_numpy(out), buf.dtype)

    def _quantized_allreduce_reference(self, buf: torch.Tensor, codec,
                                       block_size: int) -> torch.Tensor:
        """The per-chunk chain (HOROVOD_FUSED_KERNELS=0): quantize and
        to_bytes on the way out, from_bytes and dequantize and a deferred
        rank-order sum on the way in."""
        from ..compress import (chunk_bounds, dequantize, from_bytes,
                                quantize, to_bytes)
        n, rank, size = buf.numel(), self.rank, self.size
        x = contiguous(buf.float()).numpy()
        bounds = chunk_bounds(n, size).tolist()
        t0 = self._leg_start()
        my_chunks = [quantize(x[bounds[j]:bounds[j + 1]], codec, block_size)
                     for j in range(size)]
        my_len = bounds[rank + 1] - bounds[rank]
        contrib32: list = [None] * size
        contrib32[rank] = dequantize(my_chunks[rank])
        for offset in range(1, size):
            to = (rank + offset) % size
            frm = (rank - offset) % size
            self.mesh.send_async(to, to_bytes(my_chunks[to]))
            view = self._recv_scratch(frm)
            contrib32[frm] = dequantize(from_bytes(
                np.frombuffer(view, np.uint8), my_len, codec, block_size))
        acc = np.zeros(my_len, np.float32)
        for c in contrib32:
            acc += c
        reduced = quantize(acc, codec, block_size)
        self._leg_end("gather", False, t0)

        t0 = self._leg_start()
        out_parts: list = [None] * size
        out_parts[rank] = dequantize(reduced)
        payload = to_bytes(reduced)
        for offset in range(1, size):
            to = (rank + offset) % size
            frm = (rank - offset) % size
            self.mesh.send_async(to, payload)
            view = self._recv_scratch(frm)
            out_parts[frm] = dequantize(from_bytes(
                np.frombuffer(view, np.uint8),
                bounds[frm + 1] - bounds[frm], codec, block_size))
        self.mesh.flush()
        self._leg_end("return", False, t0)
        return cast(torch.from_numpy(np.concatenate(out_parts)), buf.dtype)

    # -- small-tensor codec legs on the binomial tree -------------------
    def _cast_allreduce_tree(self, buf: torch.Tensor,
                             wire_dtype: torch.dtype) -> torch.Tensor:
        """Whole-buffer wire-cast contributions gather to rank 0, the
        root widens and accumulates all N in rank order in fp32 and
        rounds ONCE, and the reduced image returns on the broadcast."""
        n, size = buf.numel(), self.size
        fk = self._fk
        x = cast(contiguous(buf), wire_dtype)
        item = n * wire_dtype.itemsize
        t0 = self._leg_start()
        block = self._tree_gather(_bv(x), item)
        if block is not None:               # root: rank-order accumulate
            acc = fk.f32(("tcacc",), n)
            acc[:] = 0.0
            mv = memoryview(block)
            for j in range(size):
                fk.cast_add(mv[j * item:(j + 1) * item], wire_dtype,
                            acc, ("tcin",))
            out = cast(torch.from_numpy(acc), wire_dtype)   # ONE rounding
        else:
            out = torch.empty(n, dtype=wire_dtype)
        self._leg_end("gather", self.fused, t0)
        t0 = self._leg_start()
        self._tree_bcast_into(_bv(out))
        self._leg_end("return", self.fused, t0)
        return cast(out, buf.dtype)

    def _quantized_allreduce_tree(self, buf: torch.Tensor, codec,
                                  block_size: int) -> torch.Tensor:
        """Whole-buffer encoded contributions gather to rank 0, the root
        dequantizes and accumulates all N in rank order in fp32 and
        requantizes ONCE, and every rank decodes the broadcast image."""
        n, size = buf.numel(), self.size
        fk = self._fk
        x = contiguous(buf.float()).numpy()
        t0 = self._leg_start()
        wire = fk.encode(x, codec, block_size, ("tqenc",))
        item = wire.nbytes                  # deterministic in (n, codec)
        block = self._tree_gather(_nbv(wire), item)
        if block is not None:               # root: rank-order accumulate
            acc = fk.f32(("tqacc",), n)
            acc[:] = 0.0
            mv = memoryview(block)
            for j in range(size):
                fk.decode_add(mv[j * item:(j + 1) * item], n, codec,
                              block_size, acc, ("tqin",))
            reduced = np.ascontiguousarray(
                fk.encode(acc, codec, block_size, ("tqred",)))
        else:
            reduced = np.empty(item, np.uint8)
        self._leg_end("gather", self.fused, t0)
        t0 = self._leg_start()
        self._tree_bcast_into(_nbv(reduced))
        out = np.empty(n, np.float32)
        fk.decode_into(reduced, n, codec, block_size, out, ("tqout",))
        self._leg_end("return", self.fused, t0)
        return cast(torch.from_numpy(out), buf.dtype)

    # -- reduce-scatter -------------------------------------------------
    def reduce_scatter(self, buf: torch.Tensor,
                       bounds: list[int]) -> torch.Tensor:
        """Ring reduce-scatter with caller-provided chunk bounds
        (bounds[r]..bounds[r+1] = rank r's output slice), shifted by one
        against the allreduce so rank r finishes owning chunk r."""
        rank, size = self.rank, self.size
        if size == 1:
            return buf
        acc = buf.to(_accum_dtype(buf.dtype), copy=True).contiguous()
        nxt, prv = (rank + 1) % size, (rank - 1) % size
        for step in range(size - 1):
            send_idx = (rank - step - 1) % size
            recv_idx = (rank - step - 2) % size
            self.mesh.send_async(
                nxt, _bv(acc[bounds[send_idx]:bounds[send_idx + 1]]))
            self._recv_accum(prv, acc[bounds[recv_idx]:bounds[recv_idx + 1]])
        self.mesh.flush()
        return acc[bounds[rank]:bounds[rank + 1]].to(buf.dtype)

    # -- allgatherv -----------------------------------------------------
    def allgatherv(self, local: torch.Tensor,
                   first_dims: list[int]) -> torch.Tensor:
        """Gather variable-first-dim blocks from every rank, rank order."""
        size, rank = self.size, self.rank
        if size == 1:
            return local
        local = contiguous(local)
        blocks: list[torch.Tensor | None] = [None] * size
        blocks[rank] = local
        rest_shape = tuple(local.shape[1:])
        nxt, prv = (rank + 1) % size, (rank - 1) % size
        for step in range(size - 1):
            send_idx = (rank - step) % size
            recv_idx = (rank - step - 1) % size
            self.mesh.send_async(nxt, _bv(blocks[send_idx]))
            block = torch.empty((first_dims[recv_idx],) + rest_shape,
                                dtype=local.dtype)
            self._recv_into(prv, block)
            blocks[recv_idx] = block
        self.mesh.flush()
        return torch.cat(blocks, dim=0)

    # -- broadcast ------------------------------------------------------
    def broadcast(self, buf: torch.Tensor | None, root: int,
                  nbytes: int, dtype: torch.dtype,
                  shape: tuple[int, ...]) -> torch.Tensor:
        """Binomial-tree broadcast: vrank v receives from v - lowbit(v)
        and forwards to v + m for descending powers m < lowbit(v), all
        relative to the root."""
        size, rank = self.size, self.rank
        if size == 1:
            assert buf is not None
            return buf
        vrank = (rank - root) % size
        if vrank == 0:
            data = contiguous(buf)
            low = 1
            while low < size:
                low <<= 1
        else:
            low = vrank & -vrank
            parent = ((vrank - low) + root) % size
            data = torch.empty(shape if shape else
                               (nbytes // max(dtype.itemsize, 1),),
                               dtype=dtype)
            self._recv_into(parent, data)
        payload = _bv(data)
        m = low >> 1
        while m:
            child = vrank + m
            if child < size:
                self.mesh.send_async((child + root) % size, payload)
            m >>= 1
        self.mesh.flush()
        return data

    # -- alltoall -------------------------------------------------------
    def alltoallv(self, local: torch.Tensor,
                  splits: list[int]) -> tuple[torch.Tensor, list[int]]:
        """Send splits[j] rows to rank j; return concatenated received rows
        and the per-rank received splits."""
        size, rank = self.size, self.rank
        local = contiguous(local)
        bounds = np.cumsum([0] + list(splits)).tolist()
        my_block = local[bounds[rank]:bounds[rank + 1]]
        received: list[torch.Tensor | None] = [None] * size
        received[rank] = my_block
        rest_shape = tuple(local.shape[1:])
        row_bytes = max(1, _rest(local.shape) * local.element_size())
        for offset in range(1, size):
            to_peer = (rank + offset) % size
            from_peer = (rank - offset) % size
            self.mesh.send_async(
                to_peer, _bv(local[bounds[to_peer]:bounds[to_peer + 1]]))
            nbytes = self.mesh.recv_begin(from_peer)
            block = torch.empty((nbytes // row_bytes,) + rest_shape,
                                dtype=local.dtype)
            assert nbytes == block.numel() * block.element_size()
            if nbytes:
                self.mesh.recv_raw_into(from_peer, _bv(block))
            received[from_peer] = block
        self.mesh.flush()
        received_splits = [int(b.shape[0]) for b in received]
        out = torch.cat(received, dim=0) \
            if any(s for s in received_splits) else my_block[:0]
        return out, received_splits

    def barrier(self) -> None:
        self.allreduce(torch.zeros(1, dtype=torch.uint8))


class TcpBackend(CollectiveBackend):
    """CollectiveBackend adapter over TcpCollectives."""

    name = "tcp"
    # Per-stream instances each own a dedicated PeerMesh channel set and
    # fusion buffers, so independent responses execute concurrently
    # without interleaving bytes on a shared socket.
    stream_safe = True

    def __init__(self, collectives: TcpCollectives) -> None:
        self.coll = collectives

    def enabled(self, response, entries) -> bool:
        # CUDA tensors are the device plane's: never staged through here.
        return self.coll.size > 1 and not is_device_response(response)

    def allreduce(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        buf = self.pack_fusion_buffer(response, entries)
        buf = self.scale_buffer(buf, response.prescale_factor)
        dtype = buf.dtype
        wire_dt = self.wire_cast_dtype(response)
        codec = self.quantized_codec(response)
        if response.response_type == ResponseType.ADASUM:
            from ..ops.adasum import adasum_tcp
            # Adasum is per tensor: a fused response runs VHDD per
            # segment, so no dot product mixes two tensors.  The cast
            # codecs shrink the payload; quantized codecs were refused
            # at negotiation.
            if wire_dt is not None:
                buf = cast(buf, wire_dt)
            self._act_start(entries, "TCP_ADASUM")
            try:
                offset, parts = 0, []
                for n in response.tensor_sizes:
                    parts.append(adasum_tcp(self.coll,
                                            buf[offset:offset + n]))
                    offset += n
                buf = torch.cat(parts) if len(parts) > 1 else parts[0]
            finally:
                self._act_end(entries)
            buf = cast(buf, dtype)
            self.last_algo = "adasum"
        elif codec is not None:
            self._act_start(entries, "TCP_QUANTIZED_ALLREDUCE")
            try:
                buf = self.coll.quantized_allreduce(
                    buf, codec, self.codec_block_size(response))
            finally:
                self._act_end(entries)
            self.last_algo = self.coll.last_algo
        elif wire_dt is not None:
            self._act_start(entries, "TCP_CAST_ALLREDUCE")
            try:
                buf = self.coll.cast_allreduce(buf, wire_dt)
            finally:
                self._act_end(entries)
            self.last_algo = self.coll.last_algo
        else:
            self._act_start(entries, "TCP_RING_ALLREDUCE")
            try:
                buf = self.coll.allreduce(buf)
            finally:
                self._act_end(entries)
            self.last_algo = self.coll.last_algo
        buf = self.scale_buffer(buf, response.postscale_factor)
        self.unpack_fusion_buffer(buf, response, entries)
        return Status.ok()

    def allgather(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        self.last_algo = "ring"
        self._act_start(entries, "TCP_ALLGATHERV")
        try:
            dtype = to_torch(response.tensor_type)
            size = self.coll.size
            if len(entries) == 1:
                dims = self.allgather_entry_dims(response, 1, size)
                local = contiguous(entries[0].tensor.to(dtype))
                entries[0].output = self.coll.allgatherv(local, dims[0])
                return Status.ok()
            # Fused response: ONE ring exchange for all entries.
            locals_, dims, rests, per_rank, payload = \
                self.pack_fused_allgather(response, entries, dtype, size)
            full = self.coll.allgatherv(payload, per_rank)
            self.unpack_fused_allgather(full, entries, locals_, dims,
                                        rests, dtype, per_rank)
            return Status.ok()
        finally:
            self._act_end(entries)

    def broadcast(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        dtype = to_torch(response.tensor_type)
        self.last_algo = "tree"            # binomial broadcast schedule
        self._act_start(entries, "TCP_BCAST")
        try:
            for e in entries:
                local = None if e.tensor is None else e.tensor.to(dtype)
                shape = tuple(local.shape) if local is not None else ()
                e.output = self.coll.broadcast(local, response.root_rank,
                                               response.tensor_sizes[0]
                                               * dtype.itemsize, dtype,
                                               shape)
            return Status.ok()
        finally:
            self._act_end(entries)

    def alltoall(self, response: Response,
                 entries: list[TensorTableEntry]) -> Status:
        self.last_algo = "pairwise"
        self._act_start(entries, "TCP_ALLTOALLV")
        try:
            for e in entries:
                local = e.tensor.to(to_torch(response.tensor_type))
                splits = self.resolve_alltoall_splits(e, local.shape[0],
                                                      self.coll.size)
                if isinstance(splits, Status):
                    return splits
                e.output, e.received_splits = self.coll.alltoallv(local,
                                                                  splits)
            return Status.ok()
        finally:
            self._act_end(entries)

    def reducescatter(self, response: Response,
                      entries: list[TensorTableEntry]) -> Status:
        # True ring reduce-scatter: chunk bounds follow the per-rank dim-0
        # split (uneven allowed), (N-1)/N bytes per link.
        self.last_algo = "ring"
        size = self.coll.size
        if len(entries) > 1:
            self._act_start(entries, "TCP_RING_ALLREDUCE")
            try:
                return self._reducescatter_fused(response, entries)
            finally:
                self._act_end(entries)
        self._act_start(entries, "TCP_RING_REDUCESCATTER")
        try:
            return self._reducescatter_single(response, entries, size)
        finally:
            self._act_end(entries)

    def _reducescatter_single(self, response: Response,
                              entries: list[TensorTableEntry],
                              size: int) -> Status:
        for e in entries:
            local = contiguous(e.tensor.to(to_torch(response.tensor_type)))
            shape = tuple(local.shape)
            rest = _rest(shape)
            rows = dim0_row_bounds(shape[0], size)
            bounds = [r * rest for r in rows]
            buf = self.scale_buffer(local.reshape(-1),
                                    response.prescale_factor)
            out = self.coll.reduce_scatter(buf.contiguous(), bounds)
            out = self.scale_buffer(out, response.postscale_factor)
            my_rows = rows[self.coll.rank + 1] - rows[self.coll.rank]
            e.output = out.reshape((my_rows,) + shape[1:])
        return Status.ok()

    def _reducescatter_fused(self, response: Response,
                             entries: list[TensorTableEntry]) -> Status:
        # Allreduce the fused buffer, slice per entry.
        buf = self.pack_fusion_buffer(response, entries)
        buf = self.scale_buffer(buf, response.prescale_factor)
        buf = self.coll.allreduce(buf)
        buf = self.scale_buffer(buf, response.postscale_factor)
        offset = 0
        for i, e in enumerate(entries):
            n = response.tensor_sizes[i]
            chunk = buf[offset:offset + n]
            offset += n
            shape = tuple(e.tensor.shape)
            full = chunk.reshape(shape)
            starts = dim0_row_bounds(shape[0], self.coll.size)
            sliced = full[starts[self.coll.rank]:
                          starts[self.coll.rank + 1]]
            e.output = sliced.clone() if self.fusion_buffers.owns(buf) \
                else sliced
        return Status.ok()

    def barrier(self, response, entries) -> Status:
        self.coll.barrier()
        return Status.ok()
