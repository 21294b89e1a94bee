"""One rank of a device-plane codec world: ``python
torch_device_codec_worker.py <rank> <size> <rendezvous_port> <outdir>``.

The rank forms the world's process group through
``parallel.multihost.init_process_group`` with gloo in place of NCCL and
drives ``NcclBackend`` on CPU tensors with responses built as the
controller builds them: int8 and uint4 allreduces (sums at block-aligned
and ragged lengths, an average, a float64 input, a fused response of
three tensors), the fp16 and bf16 casts, and Adasum (float32 at several
lengths, float64, a fused response, the bf16 cast).  Then it drops the
group, joins the eager world on the TCP ring and runs the cast and Adasum
cases on the same inputs through ``hvd``.  Outputs go to
``codec_<rank>.pkl`` as (dtype, shape, bytes).
"""
import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from torch_device_plane_worker import dump  # noqa: E402

# name: (response type, codec, dtype, lengths, op)
CASES = {
    "q8_4096": ("allreduce", "int8", "float32", (4096,), "sum"),
    "q8_1001": ("allreduce", "int8", "float32", (1001,), "sum"),
    "q8_big": ("allreduce", "int8", "float32", (100003,), "sum"),
    "q8_avg": ("allreduce", "int8", "float32", (3000,), "average"),
    "q8_f64": ("allreduce", "int8", "float64", (777,), "sum"),
    "q8_fused": ("allreduce", "int8", "float32", (300, 7, 513), "sum"),
    "q4_4096": ("allreduce", "uint4", "float32", (4096,), "sum"),
    "q4_1001": ("allreduce", "uint4", "float32", (1001,), "sum"),
    "q4_big": ("allreduce", "uint4", "float32", (100003,), "sum"),
    "q4_avg": ("allreduce", "uint4", "float32", (3000,), "average"),
    "c16_f32": ("allreduce", "fp16", "float32", (1001,), "sum"),
    "c16_f64": ("allreduce", "fp16", "float64", (777,), "sum"),
    "cb16_f32": ("allreduce", "bf16", "float32", (4097,), "average"),
    "cb16_fused": ("allreduce", "bf16", "float32", (300, 7, 513), "sum"),
    "ad_1": ("adasum", "none", "float32", (1,), "sum"),
    "ad_7": ("adasum", "none", "float32", (7,), "sum"),
    "ad_1000": ("adasum", "none", "float32", (1000,), "sum"),
    "ad_4097": ("adasum", "none", "float32", (4097,), "sum"),
    "ad_f64": ("adasum", "none", "float64", (999,), "sum"),
    "ad_fused": ("adasum", "none", "float32", (250, 253, 256), "sum"),
    "ad_bf16": ("adasum", "bf16", "float32", (2048,), "sum"),
}


def inputs(name: str, rank: int) -> list[np.ndarray]:
    """Rank ``rank``'s inputs of a case: normal values, each tensor of a
    fused case at its own scale (norms 1e-2 to 1e2)."""
    _, _, dtype, lengths, _ = CASES[name]
    rng = np.random.default_rng([sum(map(ord, name)), rank])
    return [(rng.standard_normal(n) * 2.0 * 10.0 ** (2 * i - 2
                                                     if len(lengths) > 1
                                                     else 0))
            .astype(dtype) for i, n in enumerate(lengths)]


def run_plane(rank: int, size: int, records: dict) -> None:
    from horovod_tpu_torch.backend.nccl import NcclBackend, NcclCommunicator
    from horovod_tpu_torch.common.dtypes import from_any
    from horovod_tpu_torch.common.message import Response, ResponseType
    from horovod_tpu_torch.common.tensor_queue import TensorTableEntry
    from horovod_tpu_torch.compress import codec_from_name

    plane = NcclBackend(NcclCommunicator(device="cpu"))
    for name, (rtype, codec, _, _, op) in CASES.items():
        xs = [torch.from_numpy(x) for x in inputs(name, rank)]
        entries = [TensorTableEntry(tensor_name=f"{name}.{i}", tensor=x)
                   for i, x in enumerate(xs)]
        c = codec_from_name(codec)
        resp = Response(
            response_type=ResponseType.ADASUM if rtype == "adasum"
            else ResponseType.ALLREDUCE,
            tensor_names=[e.tensor_name for e in entries],
            devices=list(range(size)), tensor_type=from_any(xs[0].dtype),
            tensor_sizes=[x.numel() for x in xs],
            postscale_factor=1.0 / size if op == "average" else 1.0,
            codec=int(c), codec_block_size=256 if int(c) >= 3 else 0)
        assert plane.enabled(resp, entries), name
        plane.execute(resp, entries).raise_if_error()
        records[f"plane/{name}"] = tuple(dump(e.output) for e in entries)


def run_tcp(hvd, rank: int, records: dict) -> None:
    """The cast and Adasum cases through the port's TCP plane."""
    for name, (rtype, codec, _, _, op) in CASES.items():
        if codec in ("int8", "uint4"):
            continue
        xs = [torch.from_numpy(x) for x in inputs(name, rank)]
        kind = hvd.Adasum if rtype == "adasum" else \
            hvd.Average if op == "average" else hvd.Sum
        outs = hvd.grouped_allreduce(xs, name=name, op=kind,
                                     compression=codec)
        records[f"tcp/{name}"] = tuple(dump(o) for o in outs)


def main() -> int:
    rank, size, port = (int(a) for a in sys.argv[1:4])
    outdir = sys.argv[4]
    torch.set_num_threads(1)
    from horovod_tpu_torch.parallel import multihost
    from horovod_tpu_torch.runner.network import RendezvousClient

    records: dict[str, tuple] = {}
    kv = RendezvousClient("127.0.0.1", port, 60.0)
    os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = f"codec{size}"
    assert multihost.init_process_group(rank, size, kv=kv, backend="gloo",
                                        timeout=60.0)
    run_plane(rank, size, records)
    torch.distributed.barrier()
    multihost.shutdown()

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      HOROVOD_RENDEZVOUS_EPOCH=f"codectcp{size}",
                      HOROVOD_SHM_OPERATIONS="0", HOROVOD_ALGO="ring")
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        run_tcp(hvd, rank, records)
    finally:
        hvd.shutdown()
    with open(os.path.join(outdir, f"codec_{rank}.pkl"), "wb") as f:
        pickle.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
