"""One rank of a device-plane world: ``python torch_device_plane_worker.py
<rank> <size> <rendezvous_port> <outdir>``.

The rank forms the world's process group through
``parallel.multihost.init_process_group`` over the port's rendezvous KV,
with gloo in place of NCCL, and drives ``NcclBackend`` on CPU tensors
with responses built as the controller builds them: allreduce (sum,
average, pre- and postscale, a fused response of five tensors),
allgather (ragged, fused, all empty), broadcast, alltoall with splits and
reduce-scatter (even, ragged, scaled), in every dtype of the wire.  The
plane's code is ``torch.distributed`` code, so only the group's backend
differs from the card's.  Then the rank drops the group, joins the eager
world (the TCP ring) and runs the same collectives on the same inputs
through ``hvd``, and probes the refusals: one name on the CPU on one rank
and on a card on another, and a card's request with no device plane.
Last, every rank is made to see the same one card: no plane forms.
Outputs go to ``plane_<rank>.pkl`` as (dtype, shape, bytes).  With a
fifth argument ``streams`` the rank runs ``run_streams`` alone and writes
``streams_<rank>.pkl``.
"""
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DTYPES = ("float16", "bfloat16", "float32", "float64", "int8", "uint8",
          "int32", "int64", "int16", "uint16", "bool")
FUSED_SHAPES = ((3,), (17,), (), (8, 8), (9,))
SCALES = {"sum": (1.0, 1.0), "scaled": (2.0, 0.25)}


def values(shape, dtype: str, rank: int, salt: int) -> torch.Tensor:
    """Rank ``rank``'s input of one case, made with numpy."""
    rng = np.random.default_rng(1000 * salt + rank)
    n = int(np.prod(shape, dtype=np.int64))
    if dtype == "bool":
        v = rng.random(n) < 0.3
    elif dtype in ("float16", "bfloat16", "float32", "float64"):
        v = rng.standard_normal(n) * 8.0
    else:
        # A quarter of the range: the prescale doubles the inputs, and a
        # double that does not fit its integer type converts to no
        # defined value.  Sums of four ranks still wrap.
        info = np.iinfo(dtype)
        v = rng.integers(max(info.min // 4, -2 ** 40),
                         min(info.max // 4, 2 ** 40), n, endpoint=True)
    t = torch.from_numpy(np.asarray(v))
    return t.to(getattr(torch, dtype)).reshape(shape)


def cases(size: int):
    """(name, op, dtype, per-rank shapes, extra) of every plane case; the
    test rebuilds the same list."""
    out = []
    for dt in DTYPES:
        for kind in ("sum", "avg", "scaled"):
            out.append((f"ar_{kind}_{dt}", "allreduce", dt, kind))
        out.append((f"ar_fused_{dt}", "allreduce_fused", dt, "sum"))
        out.append((f"ag_{dt}", "allgather", dt, None))
        out.append((f"ag_fused_{dt}", "allgather_fused", dt, None))
        out.append((f"ag_empty_{dt}", "allgather_empty", dt, None))
        out.append((f"bc_{dt}", "broadcast", dt, None))
        out.append((f"a2a_{dt}", "alltoall", dt, None))
        for kind in ("sum", "scaled"):
            out.append((f"rs_{kind}_{dt}", "reducescatter", dt, kind))
        out.append((f"rs_ragged_{dt}", "reducescatter_ragged", dt, "sum"))
    return out


def case_inputs(case, rank: int, size: int) -> list[torch.Tensor]:
    name, op, dt, _ = case
    salt = sum(map(ord, name))
    if op == "allreduce":
        return [values((37,), dt, rank, salt)]
    if op == "allreduce_fused":
        return [values(s, dt, rank, salt + i)
                for i, s in enumerate(FUSED_SHAPES)]
    if op == "allgather":
        return [values((rank + 1, 3), dt, rank, salt)]
    if op == "allgather_fused":
        return [values((rank + 1, 2), dt, rank, salt),
                values((2 * rank, 3), dt, rank, salt + 1)]
    if op == "allgather_empty":
        return [values((0, 3), dt, rank, salt)]
    if op == "broadcast":
        return [values((5, 2), dt, rank, salt)]
    if op == "alltoall":
        return [values((sum(splits(rank, size)), 2), dt, rank, salt)]
    if op == "reducescatter":
        return [values((2 * size, 3), dt, rank, salt)]
    return [values((2 * size + 1, 3), dt, rank, salt)]


def splits(rank: int, size: int) -> list[int]:
    return [(rank + d) % 3 for d in range(size)]


def factors(case, size: int) -> tuple[float, float]:
    kind = case[3]
    if kind == "avg":
        return 1.0, 1.0 / size
    return SCALES.get(kind, (1.0, 1.0))


def dump(t) -> tuple:
    t = t.detach().contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return (str(t.dtype).replace("torch.", ""), tuple(t.shape),
            raw.numpy().tobytes())


def run_plane(rank: int, size: int, records: dict) -> None:
    from horovod_tpu_torch.backend.nccl import NcclBackend, NcclCommunicator
    from horovod_tpu_torch.common.dtypes import DataType, from_any
    from horovod_tpu_torch.common.message import Response, ResponseType
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry

    plane = NcclBackend(NcclCommunicator(device="cpu"))
    records["plane/size"] = ("int", plane.world_size)
    for case in cases(size):
        name, op, dt, _ = case
        xs = case_inputs(case, rank, size)
        ttype = from_any(xs[0].dtype)
        pre, post = factors(case, size)
        entries = [TensorTableEntry(tensor_name=f"{name}.{i}", tensor=x)
                   for i, x in enumerate(xs)]
        kw = dict(tensor_names=[e.tensor_name for e in entries],
                  devices=list(range(size)), tensor_type=ttype)
        if op.startswith("allreduce"):
            resp = Response(response_type=ResponseType.ALLREDUCE,
                            tensor_sizes=[x.numel() for x in xs],
                            prescale_factor=pre, postscale_factor=post, **kw)
        elif op.startswith("allgather"):
            dims = [[case_inputs(case, r, size)[i].shape[0]
                     for r in range(size)] for i in range(len(xs))]
            resp = Response(response_type=ResponseType.ALLGATHER,
                            tensor_sizes=[d for ds in dims for d in ds],
                            **kw)
        elif op == "broadcast":
            resp = Response(response_type=ResponseType.BROADCAST,
                            tensor_sizes=[xs[0].numel()],
                            root_rank=size - 1, **kw)
        elif op == "alltoall":
            entries[0].splits = splits(rank, size)
            resp = Response(response_type=ResponseType.ALLTOALL, **kw)
        else:
            resp = Response(response_type=ResponseType.REDUCESCATTER,
                            tensor_sizes=[xs[0].numel()],
                            prescale_factor=pre, postscale_factor=post, **kw)
        assert plane.enabled(resp, entries), name
        status = plane.execute(resp, entries)
        status.raise_if_error()
        records[f"plane/{name}"] = tuple(dump(e.output) for e in entries)
        if op == "alltoall":
            records[f"plane/{name}/recv"] = ("splits",
                                             entries[0].received_splits)
        # The inputs are left as they were.
        assert all(dump(x) == dump(y) for x, y in
                   zip(xs, case_inputs(case, rank, size))), name
    # Routing: a response of CPU tensors (devices -1), or of a joined
    # rank in a CPU world, is not the device plane's; a barrier is not.
    cpu = Response(response_type=ResponseType.ALLREDUCE,
                   tensor_names=["r"], devices=[-1] * size,
                   tensor_type=DataType.FLOAT32, tensor_sizes=[1])
    joined = Response(response_type=ResponseType.ALLREDUCE,
                      tensor_names=["r"], devices=[-1] + [0] * (size - 1),
                      tensor_type=DataType.FLOAT32, tensor_sizes=[1])
    barrier = Response(response_type=ResponseType.BARRIER,
                       tensor_names=["b"], devices=[0] * size)
    records["plane/routing"] = ("routing", [
        plane.enabled(r, []) for r in (cpu, joined, barrier)])


def run_tcp(hvd, rank: int, size: int, records: dict) -> None:
    from horovod_tpu_torch import core
    records["tcp/planes"] = ("planes", [b.name for b in
                                        core.global_state().op_manager
                                        .backends])
    for case in cases(size):
        name, op, dt, kind = case
        xs = case_inputs(case, rank, size)
        pre, post = factors(case, size)
        sc = dict(prescale_factor=pre, postscale_factor=post)
        if op == "allreduce":
            outs = [hvd.allreduce(xs[0], name=name, op=hvd.Sum, **sc)]
        elif op == "allreduce_fused":
            outs = hvd.grouped_allreduce(xs, name=name, op=hvd.Sum)
        elif op.startswith("allgather"):
            hs = [hvd.allgather_async(x, name=f"{name}.{i}")
                  for i, x in enumerate(xs)]
            outs = [hvd.synchronize(h) for h in hs]
        elif op == "broadcast":
            outs = [hvd.broadcast(xs[0], root_rank=size - 1, name=name)]
        elif op == "alltoall":
            out, recv = hvd.alltoall(xs[0], splits=splits(rank, size),
                                     name=name)
            outs = [out]
            records[f"tcp/{name}/recv"] = ("splits", recv.tolist())
        else:
            outs = [hvd.reducescatter(xs[0], name=name, op=hvd.Sum, **sc)]
        records[f"tcp/{name}"] = tuple(dump(o) for o in outs)


def _outcome(fn) -> tuple:
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the error is the record
        return ("error", type(exc).__name__, str(exc))
    return ("ok",)


def run_refusals(hvd, rank: int, size: int, records: dict) -> None:
    from horovod_tpu_torch import core
    from horovod_tpu_torch.common.dtypes import DataType
    from horovod_tpu_torch.common.message import Request, RequestType
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry

    def crafted(name: str, device: int):
        """A request that says the tensor lies on card ``device`` (-1:
        the CPU); the tensor itself is a CPU stand-in."""
        e = TensorTableEntry(tensor_name=name, tensor=torch.ones(4),
                             device=device)
        r = Request(request_rank=rank, request_type=RequestType.ALLREDUCE,
                    tensor_type=DataType.FLOAT32, tensor_name=name,
                    device=device, tensor_shape=(4,))
        _, handle = core._enqueue([e], [r])
        return lambda: handle.wait(60).raise_if_error()

    records["refuse/mixed"] = _outcome(crafted("mixed",
                                               0 if rank == 0 else -1))
    records["refuse/cuda_no_plane"] = _outcome(crafted("no_plane", rank))
    records["refuse/check_mine"] = _outcome(
        lambda: core.check_device(torch.device("cuda", rank)))
    records["refuse/check_other"] = _outcome(
        lambda: core.check_device(torch.device("cuda", rank + 1)))
    records["refuse/after"] = dump(hvd.allreduce(
        torch.ones(3), name="after", op=hvd.Sum))


def run_one_card(hvd, rank: int, size: int, records: dict) -> None:
    """Every rank sees one card, the same one (a host with fewer cards
    than ranks), and NCCL: the plane does not form, CPU tensors ride the
    TCP ring, and with ``HOROVOD_NCCL_OPERATIONS=1`` every rank raises."""
    import torch.distributed as dist
    from horovod_tpu_torch import core
    from horovod_tpu_torch.parallel import multihost
    saved = (torch.cuda.is_available, torch.cuda.device_count,
             dist.is_nccl_available, multihost._card_identity)
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 1
    dist.is_nccl_available = lambda: True
    multihost._card_identity = lambda index: f"card{index}"
    try:
        os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = f"onecard{size}"
        hvd.init()
        try:
            st = core.global_state()
            records["onecard/planes"] = (
                "planes", [b.name for b in st.op_manager.backends])
            records["onecard/card"] = ("int", st.device_index)
            records["onecard/sum"] = dump(hvd.allreduce(
                torch.full((3,), float(rank)), name="onecard", op=hvd.Sum))
        finally:
            hvd.shutdown()
        os.environ.update(HOROVOD_RENDEZVOUS_EPOCH=f"onecard1{size}",
                          HOROVOD_NCCL_OPERATIONS="1")
        records["onecard/required"] = _outcome(hvd.init)
        hvd.shutdown()
    finally:
        (torch.cuda.is_available, torch.cuda.device_count,
         dist.is_nccl_available, multihost._card_identity) = saved
        os.environ.pop("HOROVOD_NCCL_OPERATIONS", None)


def run_streams(rank: int, size: int, port: int, records: dict) -> None:
    """``HOROVOD_NUM_STREAMS=2`` with the device plane in the chain: the
    process group over gloo, and ``NcclBackend`` put at the head of
    stream 0's chain by hand (``init`` forms it only on cards).  Rounds
    of device responses (requests that say the tensor is on this rank's
    card; the tensor is a CPU stand-in) and host allreduces go in at
    once; the device plane must run only on the background thread or
    stream 0's worker, the TCP plane on any stream."""
    import threading

    from horovod_tpu_torch import core
    from horovod_tpu_torch.backend.nccl import NcclBackend, NcclCommunicator
    from horovod_tpu_torch.common.dtypes import DataType
    from horovod_tpu_torch.common.message import Request, RequestType
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry
    from horovod_tpu_torch.parallel import multihost
    from horovod_tpu_torch.runner.network import RendezvousClient
    kv = RendezvousClient("127.0.0.1", port, 60.0)
    os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = f"streampg{size}"
    assert multihost.init_process_group(rank, size, kv=kv, backend="gloo",
                                        timeout=60.0)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      HOROVOD_RENDEZVOUS_EPOCH=f"streams{size}",
                      HOROVOD_SHM_OPERATIONS="0", HOROVOD_NUM_STREAMS="2",
                      HOROVOD_FUSION_THRESHOLD="0")
    import horovod_tpu_torch as hvd
    hvd.init()
    ran: dict[str, set] = {"device": set(), "host": set()}
    try:
        st = core.global_state()
        plane = NcclBackend(NcclCommunicator(device="cpu"))
        st.op_managers[0]._backends.insert(0, plane)

        def watch(backend, kind):
            execute = backend.execute

            def wrapped(response, entries):
                ran[kind].add(threading.current_thread().name)
                return execute(response, entries)
            backend.execute = wrapped

        watch(plane, "device")
        for mgr in st.op_managers:
            for b in mgr.backends:
                if b.name == "tcp":
                    watch(b, "host")
        for rnd in range(4):
            handles = []
            for i in range(6):
                name = f"dev{rnd}.{i}"
                e = TensorTableEntry(tensor_name=name,
                                     tensor=torch.full((5,), rank + i + 1.0),
                                     device=rank)
                r = Request(request_rank=rank,
                            request_type=RequestType.ALLREDUCE,
                            tensor_type=DataType.FLOAT32, tensor_name=name,
                            device=rank, tensor_shape=(5,))
                handles.append((i, True, core._enqueue([e], [r])[1]))
                handles.append((i, False, hvd.allreduce_async(
                    torch.full((7,), rank + i + 1.0), op=hvd.Sum,
                    name=f"host{rnd}.{i}")))
            for i, device, h in handles:
                want = sum(r + i + 1.0 for r in range(size))
                if device:
                    h.wait(60).raise_if_error()
                    out = h.entries[0].output
                else:
                    out = hvd.synchronize(h)
                assert out.eq(want).all(), (i, out)
        records["streams/threads"] = ("threads", sorted(ran["device"]),
                                      sorted(ran["host"]))
        records["streams/plane"] = ("plane", plane.stream_safe,
                                    st.active_streams)
    finally:
        hvd.shutdown()
        multihost.shutdown()


def main() -> int:
    rank, size, port = (int(a) for a in sys.argv[1:4])
    outdir = sys.argv[4]
    torch.set_num_threads(1)
    if sys.argv[5:] == ["streams"]:
        records: dict[str, tuple] = {}
        run_streams(rank, size, port, records)
        with open(os.path.join(outdir, f"streams_{rank}.pkl"), "wb") as f:
            pickle.dump(records, f)
        return 0
    from horovod_tpu_torch.parallel import multihost
    from horovod_tpu_torch.runner.network import RendezvousClient

    records: dict[str, tuple] = {}
    kv = RendezvousClient("127.0.0.1", port, 60.0)
    os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = f"plane{size}"
    assert multihost.init_process_group(rank, size, kv=kv, backend="gloo",
                                        timeout=60.0)
    run_plane(rank, size, records)
    torch.distributed.barrier()
    multihost.shutdown()

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      HOROVOD_RENDEZVOUS_EPOCH=f"tcp{size}",
                      HOROVOD_SHM_OPERATIONS="0", HOROVOD_ALGO="ring")
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        run_tcp(hvd, rank, size, records)
        run_refusals(hvd, rank, size, records)
    finally:
        hvd.shutdown()
    run_one_card(hvd, rank, size, records)
    with open(os.path.join(outdir, f"plane_{rank}.pkl"), "wb") as f:
        pickle.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
