"""The collectives both eager worlds run, written once for both packages.

``tests/torch_eager_ref_worker.py`` runs them through the JAX package's
eager API on numpy arrays, ``tests/torch_eager_worker.py`` through the
port's on CPU torch tensors.  Every input is made with numpy from the
rank, the same on both sides; every output (or the type and text of the
error it raised) is recorded under a key, and the test compares the two
packages' records byte for byte.  The batteries follow
``tests/mp_worker.py``: collectives (``:17``), matrix (``:109``), errors
(``:447``), join (``:463``), stall (``:324``) and shm (``:1133``).
"""
from __future__ import annotations

import os
import pickle
import sys
import time
import zlib

import numpy as np

def draw(key: str, rank: int, n, scale: float = 2.0) -> np.ndarray:
    """Normal values of shape ``n`` from a seed of the key and rank."""
    rng = np.random.default_rng([zlib.crc32(key.encode()), rank])
    return rng.standard_normal(n) * scale


INT_DTYPES = ["int8", "uint8", "int32", "int64"]
FLOAT_DTYPES = ["float16", "bfloat16", "float32", "float64"]

# Planes each world runs the batteries on: the TCP ring, the TCP tree
# (and in 4 ranks halving-doubling and the torus of a declared 2x2 grid)
# and the shared-memory plane.  The shm phase keeps the default
# environment (HOROVOD_SHM_OPERATIONS=auto forms it on one host); the
# stall battery runs last, in a world of its own, since it ends the world.
PHASES = {
    "ring": {"HOROVOD_SHM_OPERATIONS": "0", "HOROVOD_ALGO": "ring"},
    "tree": {"HOROVOD_SHM_OPERATIONS": "0", "HOROVOD_ALGO": "tree"},
    "rhd": {"HOROVOD_SHM_OPERATIONS": "0", "HOROVOD_ALGO": "rhd"},
    "torus": {"HOROVOD_SHM_OPERATIONS": "0",
              "HOROVOD_TOPOLOGY": "torus:2x2"},
    "shm": {},
    "stall": {"HOROVOD_STALL_CHECK_TIME_SECONDS": "1",
              "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "3"},
}


class Recorder:
    """Runs each op through the side's API and keeps its result."""

    def __init__(self, side, hvd, rank: int, size: int, phase: str):
        self.side, self.hvd = side, hvd
        self.rank, self.size, self.phase = rank, size, phase
        self.records: dict[str, tuple] = {}

    def t(self, values, dtype: str):
        return self.side.make(np.asarray(values), dtype)

    def keep(self, key: str, out) -> None:
        """A tensor, or a list or tuple of them (grouped allreduce, and
        alltoall's rows and received splits)."""
        self.records[f"{self.phase}/{key}"] = \
            tuple(self.side.dump(o) for o in out) \
            if isinstance(out, (list, tuple)) else self.side.dump(out)

    def run(self, key: str, fn, *args, **kwargs):
        """Record fn's output, or the type and text of its error."""
        try:
            out = fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - the error is the record
            self.records[f"{self.phase}/{key}"] = (
                "error", type(exc).__name__, str(exc))
            return None
        self.keep(key, out)
        return out


def battery_collectives(R: Recorder) -> None:
    hvd, rank, size = R.hvd, R.rank, R.size
    x = R.t(np.arange(16) + rank, "float32")
    R.run("ar_sum", hvd.allreduce, x, op=hvd.Sum, name="ar_sum")
    R.run("ar_avg", hvd.allreduce, x, op=hvd.Average, name="ar_avg")
    R.run("ar_scale", hvd.allreduce, R.t(np.ones(8), "float32"),
          op=hvd.Sum, name="ar_scale", prescale_factor=2.0,
          postscale_factor=0.5)
    for dt in ("float16", "float64", "int32", "int64", "bfloat16"):
        R.run(f"ar_{dt}", hvd.allreduce, R.t(np.ones(32) * (rank + 1), dt),
              op=hvd.Sum, name=f"ar_{dt}")
    xs = [R.t(np.full((4,), rank + i), "float32") for i in range(3)]
    R.run("gar", hvd.grouped_allreduce, xs, op=hvd.Sum, name="gar")
    R.run("ag", hvd.allgather, R.t(np.full((rank + 1, 3), rank), "float32"),
          name="ag")
    # Async burst: the allgathers land in one cycle and fuse.
    handles = [hvd.allgather_async(
        R.t(np.full((rank + 1, i + 2), 10.0 * rank + i), "float32"),
        name=f"ag_burst{i}") for i in range(4)]
    for i, h in enumerate(handles):
        R.run(f"ag_burst{i}", hvd.synchronize, h)
    R.run("bc", hvd.broadcast, R.t(np.arange(6) * (rank + 1), "float64"),
          root_rank=size - 1, name="bc")
    R.run("a2a", hvd.alltoall,
          R.t(np.arange(2 * size) + 100 * rank, "float32"),
          splits=[2] * size, name="a2a")
    hvd.barrier()
    for i in range(5):
        R.run(f"steady{i}", hvd.allreduce, R.t(np.ones(4), "float32"),
              op=hvd.Sum, name="steady")
    # Burst of small allreduces: one fused response, through the pack
    # kernel, on whatever plane serves it.
    hs = [hvd.allreduce_async(R.t(np.arange(5 + i) * (rank + 1), "float32"),
                              op=hvd.Sum, name=f"fuse{i}") for i in range(6)]
    for i, h in enumerate(hs):
        R.run(f"fuse{i}", hvd.synchronize, h)
    # A large allreduce (the ring's segmented adds and uneven chunks).
    big = (np.arange(200003) % 97 - 48) * (rank + 1) / 7.0
    R.run("big_f32", hvd.allreduce, R.t(big, "float32"), op=hvd.Average,
          name="big_f32")
    R.run("big_bf16", hvd.allreduce, R.t(np.round(big), "bfloat16"),
          op=hvd.Sum, name="big_bf16")


def battery_matrix(R: Recorder) -> None:
    hvd, rank, size = R.hvd, R.rank, R.size
    for dt in INT_DTYPES + FLOAT_DTYPES:
        R.run(f"mx_ar_{dt}", hvd.allreduce,
              R.t(np.arange(17) % 5 + rank + 1, dt), op=hvd.Sum,
              name=f"mx_ar_{dt}")
    R.run("mx_ar_bool", hvd.allreduce,
          R.t(np.array([rank == 0, True, False]), "bool"), op=hvd.Sum,
          name="mx_ar_bool")
    R.run("mx_i64_exact", hvd.allreduce,
          R.t(np.array([2 ** 40 + rank, -(2 ** 50) + rank]), "int64"),
          op=hvd.Sum, name="mx_i64_exact")
    R.run("mx_f64_exact", hvd.allreduce,
          R.t(np.array([1.0 + rank * 2.0 ** -40]), "float64"), op=hvd.Sum,
          name="mx_f64_exact")
    for dt in FLOAT_DTYPES:
        R.run(f"mx_scale_{dt}", hvd.allreduce, R.t(np.ones(9), dt),
              op=hvd.Sum, name=f"mx_scale_{dt}", prescale_factor=2.0,
              postscale_factor=0.25)
        R.run(f"mx_avg_{dt}", hvd.allreduce,
              R.t(np.ones(9) * (rank + 1), dt), op=hvd.Average,
              name=f"mx_avg_{dt}")
    # Integer averages: the factor multiplies in float64, then truncates.
    for dt in ("int32", "int64"):
        R.run(f"mx_avg_{dt}", hvd.allreduce,
              R.t(np.arange(9) * 1000003 + rank, dt), op=hvd.Average,
              name=f"mx_avg_{dt}")
    for dt in ("int32", "float32", "float64"):
        xs = [R.t(np.full(5 + i, rank + i + 1), dt) for i in range(3)]
        R.run(f"mx_gar_{dt}", hvd.grouped_allreduce, xs, op=hvd.Sum,
              name=f"mx_gar_{dt}")
    for dt in ("uint8", "int64", "float16", "float32", "float64"):
        R.run(f"mx_ag_{dt}", hvd.allgather,
              R.t(np.full((rank + 1, 2), rank + 1), dt), name=f"mx_ag_{dt}")
    for dt in ("int8", "int64", "bfloat16", "float64"):
        R.run(f"mx_bc_{dt}", hvd.broadcast,
              R.t(np.arange(7) * (rank + 1), dt), root_rank=size - 1,
              name=f"mx_bc_{dt}")
    for dt in ("int32", "int64", "float32"):
        R.run(f"mx_a2a_{dt}", hvd.alltoall,
              R.t(np.arange((rank + 1) * size) + 10 * rank, dt),
              splits=[rank + 1] * size, name=f"mx_a2a_{dt}")
    R.run("mx_a2a_even", hvd.alltoall,
          R.t(np.arange(3 * size * 2).reshape(3 * size, 2) + rank, "int64"),
          name="mx_a2a_even")
    for dt in ("int32", "float32", "float64"):
        R.run(f"mx_rs_{dt}", hvd.reducescatter,
              R.t(np.arange(2 * size * 2).reshape(2 * size, 2) * (rank + 1),
                  dt), op=hvd.Sum, name=f"mx_rs_{dt}")
    R.run("mx_rs_avg", hvd.reducescatter,
          R.t(np.arange(3 * size + 1) * (rank + 1), "float32"),
          name="mx_rs_avg")
    R.run("mx_rs_empty", hvd.reducescatter,
          R.t(np.ones((size - 1, 3)) * (rank + 1), "float32"), op=hvd.Sum,
          name="mx_rs_empty")
    R.run("mx_bc_scalar", hvd.broadcast,
          R.t(np.array(7.5 * (rank + 1)), "float32"), root_rank=0,
          name="mx_bc_scalar")
    R.run("mx_after", hvd.allreduce, R.t(np.ones(3), "float32"),
          op=hvd.Sum, name="mx_after")


def battery_schedules(R: Recorder) -> None:
    """Allreduces for the rhd and torus phases: odd and large lengths in
    every float dtype and int64, sums and averages, and a fused burst.
    (No barrier or one-element tensor: the reference's halving-doubling
    asserts on a payload smaller than the world.)"""
    hvd, rank = R.hvd, R.rank
    hs = [hvd.allreduce_async(R.t(np.arange(9 + i) * (rank + 1), "float32"),
                              op=hvd.Sum, name=f"s_fuse{i}")
          for i in range(6)]
    for i, h in enumerate(hs):
        R.run(f"s_fuse{i}", hvd.synchronize, h)
    # The last op is large: under HOROVOD_ALGO=auto on a declared torus
    # it takes the torus schedule (small ones take the tree).
    for n in (8, 17, 1001, 200003):
        base = (np.arange(n) % 89 - 44) * (rank + 1) / 3.0
        for dt in FLOAT_DTYPES + ["int64"]:
            vals = np.round(base) if dt in ("bfloat16", "int64") else base
            R.run(f"s_{dt}_{n}", hvd.allreduce, R.t(vals, dt), op=hvd.Sum,
                  name=f"s_{dt}_{n}")
        R.run(f"s_avg_{n}", hvd.allreduce, R.t(base, "float32"),
              op=hvd.Average, name=f"s_avg_{n}")


def battery_errors(R: Recorder) -> None:
    hvd, rank, size = R.hvd, R.rank, R.size
    R.run("err_shape", hvd.allreduce,
          R.t(np.ones((4,) if rank == 0 else (5,)), "float32"), op=hvd.Sum,
          name="mismatch")
    R.run("err_dtype", hvd.allreduce,
          R.t(np.ones(4), "float32" if rank == 0 else "float64"),
          op=hvd.Sum, name="mx_dtype_mismatch")
    R.run("err_group_shape", hvd.grouped_allreduce,
          [R.t(np.ones(4), "float32"),
           R.t(np.ones(5 if rank == 0 else 6), "float32")],
          op=hvd.Sum, name="mx_gar_mismatch")
    R.run("err_ag_shape", hvd.allgather,
          R.t(np.ones((2, 2 + rank)), "float32"), name="ag_mismatch")
    R.run("err_bc_root", hvd.broadcast, R.t(np.ones(3), "float32"),
          root_rank=rank, name="bc_root_mismatch")
    R.run("err_a2a_splits", hvd.alltoall, R.t(np.ones(4), "float32"),
          splits=[5] + [0] * (size - 1), name="a2a_bad")
    # The same name twice in flight: the second is refused at enqueue.
    h1 = hvd.allreduce_async(R.t(np.ones(2), "float32"), op=hvd.Sum,
                             name="dup")
    h2 = hvd.allreduce_async(R.t(np.ones(2), "float32"), op=hvd.Sum,
                             name="dup")
    R.run("err_dup", hvd.synchronize, h2)
    R.run("dup_first", hvd.synchronize, h1)
    R.run("after_errors", hvd.allreduce, R.t(np.ones(4), "float32"),
          op=hvd.Sum, name="after_mismatch")


def battery_join(R: Recorder) -> None:
    hvd, rank, size = R.hvd, R.rank, R.size
    for step in range(rank + 1):
        R.run(f"uneven_{step}", hvd.allreduce, R.t(np.ones(4), "float32"),
              op=hvd.Sum, name=f"uneven_{step}")
    last = hvd.join()
    R.records[f"{R.phase}/join_in_range"] = ("int", 0 <= last < size)
    R.run("after_join", hvd.allreduce, R.t(np.ones(2), "float32"),
          op=hvd.Sum, name="after_join")
    for i in range(2):
        R.run(f"join_ag{i}", hvd.allgather,
              R.t(np.full((rank + 1, 2), rank), "float32"), name="join_ag")
    if rank == size - 1:
        hvd.join()
    else:
        R.run("join_ag_err", hvd.allgather,
              R.t(np.full((rank + 1, 2), rank), "float32"), name="join_ag")
        hvd.join()
    R.run("after_join2", hvd.allreduce, R.t(np.ones(2), "float32"),
          op=hvd.Sum, name="after_join2")


def battery_objects(R: Recorder) -> None:
    hvd, rank = R.hvd, R.rank
    obj = hvd.broadcast_object({"rank": rank, "v": [1, 2, 3]}, root_rank=0,
                               name="bobj")
    R.records[f"{R.phase}/bobj"] = ("obj", obj)
    objs = hvd.allgather_object(("r", rank), name="gobj")
    R.records[f"{R.phase}/gobj"] = ("obj", objs)


def battery_stall(R: Recorder, global_state) -> None:
    """Rank 0 submits a collective no other rank joins; past the stall
    shutdown time the coordinator ends the world with a structured
    error, and the idle ranks see the shutdown."""
    hvd, rank = R.hvd, R.rank
    if rank == 0:
        R.run("lonely", hvd.allreduce, R.t(np.ones(4), "float32"),
              op=hvd.Sum, name="lonely")
        return
    deadline = time.time() + 20
    while time.time() < deadline:
        if not global_state.initialized or global_state.shutdown_requested:
            R.records[f"{R.phase}/idle_saw_shutdown"] = ("int", True)
            return
        time.sleep(0.1)
    R.records[f"{R.phase}/idle_saw_shutdown"] = ("int", False)


def _planes(global_state) -> list[str]:
    return [b.name for b in global_state.op_manager.backends]


def run_world(side, hvd, core, rank: int, size: int, outdir: str) -> int:
    """Every phase of one world on this rank; writes the records."""
    phases = ["ring", "tree", "rhd", "torus", "shm", "stall"] if size == 4 \
        else ["ring", "shm", "stall"]
    records: dict[str, tuple] = {}
    base_env = dict(os.environ)
    for phase in phases:
        os.environ.clear()
        os.environ.update(base_env)
        os.environ.update(PHASES[phase])
        os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = \
            f"{base_env.get('HOROVOD_RENDEZVOUS_EPOCH', 'w')}.{phase}"
        if phase == "shm":
            # One phase writes a timeline (rank r > 0 to '<path>.r<r>').
            os.environ["HOROVOD_TIMELINE"] = os.path.join(
                outdir, f"timeline_{side.name}.json")
        hvd.init()
        st = core.global_state()
        R = Recorder(side, hvd, rank, size, phase)
        R.records[f"{phase}/planes"] = ("planes", _planes(st))
        if phase == "stall":
            battery_stall(R, st)
        else:
            shm = next((b for b in st.op_manager.backends
                        if b.name == "shm"), None)
            if phase in ("rhd", "torus"):
                battery_schedules(R)
                R.records[f"{phase}/algo"] = (
                    "algo", st.tcp_collectives[0].last_algo)
            else:
                battery_collectives(R)
                battery_matrix(R)
            if phase == "shm":
                R.records["shm/shm_ops"] = ("int", shm is not None
                                            and shm.ops_executed > 0)
            if phase == "ring":
                battery_errors(R)
                battery_join(R)
                battery_objects(R)
        records.update(R.records)
        hvd.shutdown()
    with open(os.path.join(outdir, f"{side.name}_{rank}.pkl"), "wb") as f:
        pickle.dump(records, f)
    return 0


def worker_main(side, hvd, core) -> int:
    rank, size, port = (int(a) for a in sys.argv[1:4])
    outdir = sys.argv[4]
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"] = "127.0.0.1"
    os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"] = str(port)
    os.environ.setdefault("HOROVOD_GLOO_TIMEOUT_SECONDS", "90")
    return run_world(side, hvd, core, rank, size, outdir)
