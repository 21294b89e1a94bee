"""One rank of a torch-binding world for the reduction features: ``python
torch_binding_reduce_worker.py <side> <rank> <size> <rendezvous_port>
<outdir>``.

``side`` is ``port`` (``horovod_tpu_torch.torch``) or ``ref`` (the JAX
package's ``horovod_tpu.torch``).  On the shm plane and on the TCP ring
it trains an MLP, its weights drawn with numpy, for 3 steps through
``DistributedOptimizer(op=Adasum)`` (SGD and Adam, named and unnamed
parameters, one and two backward passes a step, the fp16 compressor) and
through the gradient optimizer with ``Compression.int8`` and ``uint4``,
and records every parameter as (dtype, shape, bytes) into
``<side>_<rank>.pkl``.  Fusion is off (``HOROVOD_FUSION_THRESHOLD=0``):
which gradients would share a buffer depends on when hooks fire, and a
quantized codec's blocks follow the buffer.
"""
import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from torch_binding_worker import Recorder  # noqa: E402

PHASES = {"shm": {},
          "ring": {"HOROVOD_SHM_OPERATIONS": "0", "HOROVOD_ALGO": "ring"}}
# (optimizer, backward passes a step, compression, named parameters)
ADASUM_CASES = (("sgd", 1, "none", True), ("adam", 1, "none", True),
                ("sgd", 2, "fp16", True), ("adam", 2, "fp16", False),
                ("sgd", 1, "none", False))
CODEC_CASES = (("sgd", 1, "int8", True), ("adamw", 2, "uint4", True),
               ("adamw", 1, "int8", False))


def make_model() -> torch.nn.Module:
    model = torch.nn.Sequential(
        torch.nn.Linear(256, 64), torch.nn.Tanh(),
        torch.nn.Linear(64, 64), torch.nn.ReLU(),
        torch.nn.Linear(64, 16))
    rng = np.random.default_rng(42)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32)
                / np.sqrt(p.shape[-1])))
    return model


def make_batch(rank: int, step: int, p: int):
    rng = np.random.default_rng([rank, step, p])
    return (torch.from_numpy(rng.standard_normal((8, 256))
                             .astype(np.float32)),
            torch.from_numpy(rng.standard_normal((8, 16))
                             .astype(np.float32)))


def optimizer(kind: str, params):
    if kind == "sgd":
        return torch.optim.SGD(params, lr=0.05, momentum=0.9)
    if kind == "adam":
        return torch.optim.Adam(params, lr=3e-3)
    return torch.optim.AdamW(params, lr=3e-3, weight_decay=1e-4)


def train(R, hvt, rank: int, battery: str, cases, op) -> None:
    for kind, passes, comp, named in cases:
        model = make_model()
        kw = dict(named_parameters=model.named_parameters()) if named \
            else {}
        opt = hvt.DistributedOptimizer(
            optimizer(kind, model.parameters()),
            compression=getattr(hvt.Compression, comp),
            backward_passes_per_step=passes, op=op, **kw)
        hvt.broadcast_parameters(model.state_dict(), root_rank=0)
        for step in range(3):
            for p in range(passes):
                x, y = make_batch(rank, step, p)
                torch.nn.functional.mse_loss(model(x), y).backward()
            opt.step()
            opt.zero_grad()
        case = f"{kind}-{passes}-{comp}-{'named' if named else 'unnamed'}"
        for name, p in model.named_parameters():
            R.keep(battery, f"{case}/{name}", p)


def main() -> int:
    side = sys.argv[1]
    rank, size, port = (int(a) for a in sys.argv[2:5])
    outdir = sys.argv[5]
    torch.set_num_threads(1)
    if side == "port":
        import horovod_tpu_torch.torch as hvt
    else:
        import horovod_tpu.torch as hvt
    base_env = dict(os.environ, HOROVOD_RANK=str(rank),
                    HOROVOD_SIZE=str(size),
                    HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                    HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                    HOROVOD_FUSION_THRESHOLD="0")
    base_env.setdefault("HOROVOD_GLOO_TIMEOUT_SECONDS", "90")
    records: dict[str, tuple] = {}
    for phase, env in PHASES.items():
        os.environ.clear()
        os.environ.update(base_env)
        os.environ.update(env)
        os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = \
            f"{base_env.get('HOROVOD_RENDEZVOUS_EPOCH', 'w')}.{phase}"
        hvt.init()
        R = Recorder(phase)
        train(R, hvt, rank, "adasum", ADASUM_CASES, hvt.Adasum)
        train(R, hvt, rank, "codec", CODEC_CASES, hvt.Average)
        records.update(R.records)
        hvt.shutdown()
    with open(os.path.join(outdir, f"{side}_{rank}.pkl"), "wb") as f:
        pickle.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
