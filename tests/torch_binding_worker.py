"""One rank of a torch-binding world: ``python torch_binding_worker.py
<side> <rank> <size> <rendezvous_port> <outdir>``.

``side`` is ``port`` (``horovod_tpu_torch.torch``) or ``ref`` (the JAX
package's ``horovod_tpu.torch``); both take CPU torch tensors, so one
battery serves both.  The cases follow ``tests/mp_worker.py``:
``battery_torch`` (``:610``), ``battery_torch_grid`` (``:1602``),
``battery_sparse`` (``:703``) and ``battery_syncbn`` (``:880``), with
their checks against a serial run, and then ``DistributedOptimizer`` over
SGD and AdamW, one and two backward passes a step, the fp16 and bf16
compressors and a gradient predivide factor, on the MLP of
``examples/pytorch_synthetic_benchmark.py`` (hidden 64) and on the
port's gpt_tiny.  Every output is recorded as (dtype, shape, bytes) into
``<side>_<rank>.pkl``; the test compares the two sides byte for byte.
"""
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# Each world runs the batteries on the shm plane (the default
# environment: every rank on one host) and on the TCP ring.
PHASES = {"shm": {},
          "ring": {"HOROVOD_SHM_OPERATIONS": "0", "HOROVOD_ALGO": "ring"}}

OPTIMIZER_CASES = (
    # (optimizer, backward passes a step, compression, predivide factor)
    ("sgd", 1, "none", 1.0), ("sgd", 1, "fp16", 1.0),
    ("sgd", 2, "bf16", 1.0), ("sgd", 2, "fp16", 2.0),
    ("adamw", 1, "none", 1.0), ("adamw", 1, "bf16", 1.0),
    ("adamw", 2, "fp16", 1.0), ("adamw", 1, "bf16", 4.0),
)
GPT_CASES = (("sgd", 1, "fp16", 1.0), ("adamw", 2, "bf16", 1.0),
             ("adamw", 1, "none", 2.0))


def dump(t: torch.Tensor) -> tuple:
    t = t.detach()
    if t.is_sparse:
        t = t.to_dense()
    t = t.contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return (str(t.dtype), tuple(t.shape), raw.numpy().tobytes())


class Recorder:
    def __init__(self, phase: str):
        self.phase = phase
        self.records: dict[str, tuple] = {}

    def keep(self, battery: str, key: str, out) -> None:
        self.records[f"{self.phase}/{battery}/{key}"] = \
            tuple(dump(o) for o in out) \
            if isinstance(out, (list, tuple)) else dump(out)


def _mlp(hidden: int = 16, d_in: int = 8, d_out: int = 4):
    torch.manual_seed(7)
    return torch.nn.Sequential(torch.nn.Linear(d_in, hidden),
                               torch.nn.Tanh(),
                               torch.nn.Linear(hidden, d_out))


def battery_torch(R, hvt, rank, size):
    """DistributedOptimizer end to end: sharded data-parallel training
    equals a serial run on the full batch (mp_worker.py:610)."""
    g = torch.Generator().manual_seed(42)
    X = torch.randn(4 * size, 8, generator=g)
    Y = torch.randn(4 * size, 4, generator=g)
    xs, ys = X[rank * 4:(rank + 1) * 4], Y[rank * 4:(rank + 1) * 4]

    def train(model, opt, inputs, targets, steps=3):
        for _ in range(steps):
            opt.zero_grad()
            loss = ((model(inputs) - targets) ** 2).mean()
            loss.backward()
            opt.step()

    model = _mlp()
    opt = hvt.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    hvt.broadcast_parameters(model.state_dict(), root_rank=0)
    train(model, opt, xs, ys)
    serial = _mlp()
    train(serial, torch.optim.SGD(serial.parameters(), lr=0.1), X, Y)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 serial.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        R.keep("torch", f"dp_{name}", p)

    t = torch.arange(4 * size * 2, dtype=torch.float32) \
        .reshape(4 * size, 2) * (rank + 1)
    R.keep("torch", "reducescatter", hvt.reducescatter(t, op=hvt.Sum,
                                                       name="t_rs"))

    model2 = _mlp()
    opt2 = hvt.DistributedOptimizer(
        torch.optim.SGD(model2.parameters(), lr=0.05),
        named_parameters=model2.named_parameters(),
        compression=hvt.Compression.fp16, backward_passes_per_step=2,
        groups=2)
    hvt.broadcast_parameters(model2.state_dict(), root_rank=0)
    for _ in range(2):
        ((model2(xs) - ys) ** 2).mean().backward()
    opt2.step()
    opt2.zero_grad()
    for name, p in model2.named_parameters():
        R.keep("torch", f"grouped_{name}", p)

    m3 = _mlp()
    opt3 = torch.optim.SGD(m3.parameters(), lr=0.1, momentum=0.9)
    ((m3(xs) - ys) ** 2).mean().backward()
    opt3.step()
    hvt.broadcast_optimizer_state(opt3, root_rank=0)
    for sid, s in sorted(opt3.state_dict()["state"].items()):
        for k, v in sorted(s.items()):
            if isinstance(v, torch.Tensor):
                R.keep("torch", f"opt_state_{sid}_{k}", v)
    R.records[f"{R.phase}/torch/param_groups"] = (
        "obj", repr(opt3.state_dict()["param_groups"]))


def battery_grid(R, hvt, rank, size):
    """Every wire dtype through the binding, in-place variants, async
    handles with poll, scales and alltoall's received splits
    (mp_worker.py:1602)."""
    dtypes = [torch.uint8, torch.int8, torch.int32, torch.int64,
              torch.float16, torch.bfloat16, torch.float32, torch.float64]
    for dt in dtypes:
        tag = str(dt).split(".")[-1]
        base = torch.arange(17) % 4 + rank + 1
        expected = sum((np.arange(17) % 4 + r + 1).astype(np.float64)
                       for r in range(size))
        out = hvt.allreduce(base.to(dt), op=hvt.Sum, name=f"tg_ar_{tag}")
        assert out.dtype == dt, (tag, out.dtype)
        np.testing.assert_allclose(out.to(torch.float64).numpy(), expected,
                                   rtol=1e-2, err_msg=tag)
        t2 = base.to(dt).clone()
        assert hvt.allreduce_(t2, op=hvt.Sum, name=f"tg_ari_{tag}") is t2
        R.keep("grid", f"ar_{tag}", out)
        R.keep("grid", f"ari_{tag}", t2)
        R.keep("grid", f"avg_{tag}", hvt.allreduce(
            base.to(dt) * 3, op=hvt.Average, name=f"tg_avg_{tag}"))
    R.keep("grid", "scale", hvt.allreduce(
        torch.ones(9), op=hvt.Sum, name="tg_scale", prescale_factor=2.0,
        postscale_factor=0.25))
    handles = [hvt.allreduce_async(torch.ones(4) * (rank + i), op=hvt.Sum,
                                   name=f"tg_async_{i}") for i in range(3)]
    for i in reversed(range(3)):
        out = hvt.synchronize(handles[i])
        assert hvt.poll(handles[i])
        R.keep("grid", f"async_{i}", out)
    for dt in (torch.int32, torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        ts = [torch.full((5 + i,), float(rank + i)).to(dt)
              for i in range(3)]
        hvt.grouped_allreduce_(ts, op=hvt.Sum, name=f"tg_gar_{tag}")
        R.keep("grid", f"gar_{tag}", ts)
        R.keep("grid", f"garo_{tag}", hvt.grouped_allreduce(
            [t * 0.5 for t in ts] if dt.is_floating_point else ts,
            op=hvt.Average, name=f"tg_garo_{tag}"))
    t = torch.full((3,), float(rank))
    hvt.broadcast_(t, root_rank=size - 1, name="tg_bc")
    R.keep("grid", "bc_", t)
    R.keep("grid", "bc", hvt.broadcast(
        torch.arange(6, dtype=torch.int64) * (rank + 1), root_rank=0,
        name="tg_bc_i64"))
    R.keep("grid", "ag", hvt.allgather(
        torch.full((rank + 1, 2), float(rank)), name="tg_ag"))
    rows = sum(d + 1 for d in range(size))
    out, recv = hvt.alltoall(torch.full((rows, 2), float(rank)),
                             splits=torch.tensor([d + 1 for d in
                                                  range(size)],
                                                 dtype=torch.int32),
                             name="tg_a2a")
    np.testing.assert_array_equal(recv.numpy(),
                                  np.full(size, rank + 1, np.int32))
    R.keep("grid", "a2a", (out, recv))
    R.keep("grid", "a2a_even", hvt.alltoall(
        torch.arange(2 * size, dtype=torch.float32) + 10 * rank,
        name="tg_a2a_even"))
    R.keep("grid", "rs_avg", hvt.reducescatter(
        torch.arange(3 * size + 1, dtype=torch.float32) * (rank + 1),
        name="tg_rs_avg"))


def battery_sparse(R, hvt, rank, size):
    """Gather-based sparse reduction and a sparse-gradient embedding
    through DistributedOptimizer (mp_worker.py:703)."""
    idx = torch.tensor([[0, rank + 1]])
    val = torch.ones(2, 4) * (rank + 1)
    sp = torch.sparse_coo_tensor(idx, val, size=(size + 2, 4))
    out = hvt.sparse_allreduce(sp, name="sp0", op=hvt.Sum)
    dense = out.to_dense().numpy()
    np.testing.assert_allclose(dense[0], np.full(4, sum(
        r + 1 for r in range(size))))
    R.keep("sparse", "sum", out)
    R.keep("sparse", "avg", hvt.sparse_allreduce(sp, name="sp1"))
    torch.manual_seed(3)
    emb = torch.nn.Embedding(8, 4, sparse=True)
    opt = hvt.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=0.1),
        named_parameters=emb.named_parameters())
    hvt.broadcast_parameters(emb.state_dict(), root_rank=0)
    before = emb.weight.detach().clone()
    loss = emb(torch.tensor([rank, rank])).sum()
    opt.zero_grad()
    loss.backward()
    opt.step()
    assert not torch.allclose(before[rank], emb.weight[rank])
    R.keep("sparse", "embedding", emb.weight)


def battery_syncbn(R, hvt, rank, size):
    """SyncBatchNorm forward and backward equal BatchNorm on the whole
    batch in one process (mp_worker.py:880)."""
    g = torch.Generator().manual_seed(3)
    X = torch.randn(2 * size, 5, 4, 4, generator=g)
    # A loss whose input gradient is O(1): mean(out ** 2) has a zero one
    # through BatchNorm, leaving round-off to compare.
    W = torch.randn(2 * size, 5, 4, 4, generator=g)
    lo, hi = rank * 2, (rank + 1) * 2
    xs = X[lo:hi].clone().requires_grad_(True)
    bn = hvt.SyncBatchNorm(5)
    bn.train()
    out = bn(xs)
    (out * W[lo:hi]).sum().backward()
    ref_x = X.clone().requires_grad_(True)
    ref_bn = torch.nn.BatchNorm2d(5)
    ref_bn.train()
    ref_out = ref_bn(ref_x)
    (ref_out * W).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               ref_out[lo:hi].detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xs.grad.numpy(), ref_x.grad[lo:hi].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               ref_bn.running_var.numpy(), rtol=1e-3,
                               atol=1e-5)
    for key, t in (("out", out), ("grad", xs.grad),
                   ("weight_grad", bn.weight.grad),
                   ("bias_grad", bn.bias.grad),
                   ("running_mean", bn.running_mean),
                   ("running_var", bn.running_var)):
        R.keep("syncbn", key, t)


def _optimizer(kind: str, params):
    if kind == "sgd":
        return torch.optim.SGD(params, lr=0.05, momentum=0.9)
    return torch.optim.AdamW(params, lr=3e-3, weight_decay=1e-4)


def _train_cases(R, hvt, rank, battery, cases, make_model, loss_fn,
                 make_batch):
    for kind, passes, comp, predivide in cases:
        model = make_model()
        opt = hvt.DistributedOptimizer(
            _optimizer(kind, model.parameters()),
            named_parameters=model.named_parameters(),
            compression=getattr(hvt.Compression, comp),
            backward_passes_per_step=passes,
            gradient_predivide_factor=predivide)
        hvt.broadcast_parameters(model.state_dict(), root_rank=0)
        hvt.broadcast_optimizer_state(opt, root_rank=0)
        for step in range(3):
            for p in range(passes):
                loss_fn(model, make_batch(rank, step, p)).backward()
            opt.step()
            opt.zero_grad()
        case = f"{kind}-{passes}-{comp}-{predivide}"
        for name, p in model.named_parameters():
            R.keep(battery, f"{case}/{name}", p)


def battery_optimizer(R, hvt, rank, size):
    """The MLP of examples/pytorch_synthetic_benchmark.py at hidden 64."""
    def make_model():
        torch.manual_seed(42)
        return torch.nn.Sequential(
            torch.nn.Linear(1024, 64), torch.nn.ReLU(),
            torch.nn.Linear(64, 64), torch.nn.ReLU(),
            torch.nn.Linear(64, 128))

    def make_batch(r, step, p):
        g = torch.Generator().manual_seed(1000 * r + 10 * step + p)
        return torch.randn(8, 1024, generator=g), \
            torch.randn(8, 128, generator=g)

    def loss_fn(model, batch):
        return torch.nn.functional.mse_loss(model(batch[0]), batch[1])

    _train_cases(R, hvt, rank, "optimizer_mlp", OPTIMIZER_CASES,
                 make_model, loss_fn, make_batch)


def battery_gpt(R, hvt, rank, size):
    """The port's gpt_tiny through DistributedOptimizer."""
    from horovod_tpu_torch import TransformerLM, gpt_tiny
    from horovod_tpu_torch.training import cross_entropy_loss

    def make_model():
        return TransformerLM(gpt_tiny(), device="cpu", seed=0)

    def make_batch(r, step, p):
        g = torch.Generator().manual_seed(7000 + 100 * r + 10 * step + p)
        return torch.randint(0, 256, (2, 33), generator=g)

    def loss_fn(model, tokens):
        logits = model(tokens[:, :-1], train=True)
        return cross_entropy_loss(logits, tokens[:, 1:])

    _train_cases(R, hvt, rank, "optimizer_gpt", GPT_CASES, make_model,
                 loss_fn, make_batch)


BATTERIES = (battery_torch, battery_grid, battery_sparse, battery_syncbn,
             battery_optimizer, battery_gpt)


def _route_reference_bf16() -> None:
    """The reference's ``_DistributedOptimizer._install_grad`` hands the
    core's output to ``torch.from_numpy``, which refuses an ml_dtypes
    bfloat16 array, so its bf16 compressor fails at the first step.  For
    the comparison the reference side converts it through the reference's
    own ``mpi_ops._from_np`` (the int16 view it uses everywhere else);
    the arithmetic is untouched."""
    from horovod_tpu.torch import mpi_ops, optimizer

    def _install_grad(self, p, tensor_compressed, c, out_np):
        out = mpi_ops._from_np(out_np).clone().view_as(tensor_compressed) \
            .type(tensor_compressed.dtype)
        grad = self._compression.decompress(out, c)
        p.grad = grad.type(p.dtype).view_as(
            p.grad if not p.grad.is_sparse else grad)

    optimizer._DistributedOptimizer._install_grad = _install_grad


def main() -> int:
    side = sys.argv[1]
    rank, size, port = (int(a) for a in sys.argv[2:5])
    outdir = sys.argv[5]
    torch.set_num_threads(1)
    if side == "port":
        import horovod_tpu_torch.torch as hvt
    else:
        import horovod_tpu.torch as hvt
        _route_reference_bf16()
    base_env = dict(os.environ, HOROVOD_RANK=str(rank),
                    HOROVOD_SIZE=str(size),
                    HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                    HOROVOD_GLOO_RENDEZVOUS_PORT=str(port))
    base_env.setdefault("HOROVOD_GLOO_TIMEOUT_SECONDS", "90")
    if size > 2:
        # Hooks fire as backward reaches each parameter, so which
        # gradients share a fused buffer depends on timing, and the ring
        # and shm sums order each element by its chunk of that buffer:
        # fp32 sums of more than two ranks would differ in their last
        # bits from run to run on either package.  Unfused, every
        # response holds one tensor (or one explicit group) and both
        # packages add in the same order.  Two ranks add commutatively,
        # so that world keeps fusion on.
        base_env["HOROVOD_FUSION_THRESHOLD"] = "0"
    records: dict[str, tuple] = {}
    for phase, env in PHASES.items():
        os.environ.clear()
        os.environ.update(base_env)
        os.environ.update(env)
        os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = \
            f"{base_env.get('HOROVOD_RENDEZVOUS_EPOCH', 'w')}.{phase}"
        hvt.init()
        R = Recorder(phase)
        for battery in BATTERIES:
            battery(R, hvt, rank, size)
        records.update(R.records)
        hvt.shutdown()
    with open(os.path.join(outdir, f"{side}_{rank}.pkl"), "wb") as f:
        pickle.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
