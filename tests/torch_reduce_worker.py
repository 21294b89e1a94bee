"""One rank of an eager reduction world: ``python torch_reduce_worker.py
<side> <suite> <rank> <size> <rendezvous_port> <outdir>``.

``side`` is ``port`` (``horovod_tpu_torch`` on CPU torch tensors) or
``ref`` (the JAX package's eager API on numpy arrays); ``suite`` is one
of ``tests/torch_reduce_battery.py``'s (codecs, adasum, hier, runtime).  Writes
``<side>_<rank>.pkl`` into ``outdir``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    side, suite = sys.argv[1], sys.argv[2]
    rank, size, port = (int(a) for a in sys.argv[3:6])
    outdir = sys.argv[6]
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port))
    os.environ.setdefault("HOROVOD_GLOO_TIMEOUT_SECONDS", "90")
    import torch_reduce_battery as battery
    if side == "port":
        import torch
        from torch_eager_worker import PortSide as Side

        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import core
        torch.set_num_threads(1)
    else:
        from torch_eager_ref_worker import RefSide as Side

        import horovod_tpu as hvd
        from horovod_tpu import core
    return battery.run_suite(Side, hvd, core, suite, rank, size, outdir)


if __name__ == "__main__":
    sys.exit(main())
