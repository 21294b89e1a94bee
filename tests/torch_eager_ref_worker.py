"""One rank of a JAX-package eager world: ``python
torch_eager_ref_worker.py <rank> <size> <rendezvous_port> <outdir>`` runs
``tests/torch_eager_battery.py`` through ``horovod_tpu``'s eager API on
numpy arrays (launched like ``tests/mp_worker.py``) and writes
``ref_<rank>.pkl`` into ``outdir``."""
import os
import sys

import ml_dtypes
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_eager_battery as battery  # noqa: E402

import horovod_tpu as hvd  # noqa: E402
from horovod_tpu import core  # noqa: E402


class RefSide:
    name = "ref"

    @staticmethod
    def make(values: np.ndarray, dtype: str) -> np.ndarray:
        dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
        if dtype == "bfloat16":
            values = values.astype(np.float32)
        return values.astype(dt)

    @staticmethod
    def dump(out) -> tuple:
        a = np.ascontiguousarray(out) if np.ndim(out) else np.asarray(out)
        return (a.dtype.name, tuple(a.shape), a.tobytes())


if __name__ == "__main__":
    sys.exit(battery.worker_main(RefSide, hvd, core))
