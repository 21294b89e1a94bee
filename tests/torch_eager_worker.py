"""One rank of a port eager world: ``python torch_eager_worker.py <rank>
<size> <rendezvous_port> <outdir>`` runs ``tests/torch_eager_battery.py``
through ``horovod_tpu_torch``'s eager API on CPU torch tensors and
writes ``port_<rank>.pkl`` into ``outdir``."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_eager_battery as battery  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import core  # noqa: E402


class PortSide:
    name = "port"

    @staticmethod
    def make(values: np.ndarray, dtype: str) -> torch.Tensor:
        if dtype == "bfloat16":
            return torch.from_numpy(values.astype(np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(values, dtype=dtype))

    @staticmethod
    def dump(out) -> tuple:
        t = out.contiguous()
        name = str(t.dtype).replace("torch.", "")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return (name, tuple(t.shape), raw.numpy().tobytes())


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(battery.worker_main(PortSide, hvd, core))
