"""The eager reduction features both packages run, written once for both:
the wire codecs on the TCP and shm planes, Adasum, and the hierarchical
plane.

``tests/torch_reduce_worker.py <side> <suite> <rank> <size> <port>
<outdir>`` runs a suite's phases through the side's eager API (the
port's on CPU torch tensors, or the JAX package's on numpy arrays, with
the ``PortSide``/``RefSide`` of ``tests/torch_eager_worker.py`` and
``tests/torch_eager_ref_worker.py``) and pickles every output, or the
type and text of its error, with ``torch_eager_battery.Recorder``.  The
tests compare the two packages' records byte for byte
(``run_worlds``, ``assert_phase_equal``).  Every input is drawn with numpy from
a seed of its key and the rank, the same on both sides.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

import torch_runtime_battery as runtime
from torch_eager_battery import Recorder, draw
from torch_world_lock import world_locked

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_reduce_worker.py")
WORLD_TIMEOUT = 150.0
CODECS = ("fp16", "bf16", "int8", "uint4")

# Each suite's phases (environment over the worker's) by world size.
_TCP = {"HOROVOD_SHM_OPERATIONS": "0"}
SUITES = {
    "codecs": {
        # HOROVOD_ALGO=auto: payloads under 64 KiB take the tree in
        # worlds above two ranks, the rest the ring.
        "tcp": _TCP,
        "tcp_chain": dict(_TCP, HOROVOD_FUSED_KERNELS="0"),
        "shm": {"HOROVOD_SHM_OPERATIONS": "1",
                "HOROVOD_SHM_CAPACITY": str(1 << 20)},
        "shm_chain": {"HOROVOD_SHM_OPERATIONS": "1",
                      "HOROVOD_SHM_CAPACITY": str(1 << 20),
                      "HOROVOD_FUSED_KERNELS": "0"},
    },
    "adasum": {"tcp": _TCP},
    # Two hosts of two ranks (tests/mp_worker.py:3460-3469); the layout
    # itself is set by layout_env.
    "hier": {
        "hshm": {},
        "htcp": _TCP,
        "htorus": dict(_TCP, HOROVOD_TOPOLOGY="torus:2x2"),
        "hflat": {},
    },
    "runtime": runtime.PHASES,
}


def layout_env(suite: str, phase: str, rank: int, size: int) -> dict:
    """The hierarchical suite's rank layout: host-major 2 x 2, or (phase
    hflat) slots striped across hosts, which is not host-major on ranks
    1 and 2, so every rank must keep the flat path."""
    if suite != "hier":
        return {}
    local, cross = rank % 2, rank // 2
    if phase == "hflat":
        local, cross = rank // 2, rank % 2
    return {"HOROVOD_LOCAL_RANK": str(local), "HOROVOD_LOCAL_SIZE": "2",
            "HOROVOD_CROSS_RANK": str(cross),
            "HOROVOD_CROSS_SIZE": str(size // 2),
            "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
            "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}


def _backend(global_state, name: str):
    return next((b for b in global_state.op_manager.backends
                 if b.name == name), None)


def battery_codecs(R: Recorder, st) -> None:
    """Each codec on sums, averages, scaled and grouped allreduces of the
    float dtypes at a tree size (1024 elements, block-aligned at 2 and 4
    ranks) and ring sizes (1001 and 100003), integer tensors riding
    uncompressed, a block size from the knob, a codec mismatch, and on
    the shm phases an oversized quantized buffer that shm declines."""
    hvd, rank, size = R.hvd, R.rank, R.size
    tcp = st.tcp_collectives[0]
    for codec in CODECS:
        for n in (1024, 1001, 100003):
            key = f"{codec}_f32_{n}"
            R.run(key, hvd.allreduce, R.t(draw(key, rank, n), "float32"),
                  op=hvd.Sum, name=key, compression=codec)
            R.records[f"{R.phase}/{key}_algo"] = ("algo", tcp.last_algo)
        key = f"{codec}_avg"
        R.run(key, hvd.allreduce, R.t(draw(key, rank, 3000), "float32"),
              op=hvd.Average, name=key, compression=codec)
        key = f"{codec}_scaled_f64"
        R.run(key, hvd.allreduce, R.t(draw(key, rank, 777), "float64"),
              op=hvd.Sum, name=key, compression=codec,
              prescale_factor=0.5, postscale_factor=3.0)
        for dt in ("float16", "bfloat16"):
            key = f"{codec}_{dt}"
            R.run(key, hvd.allreduce, R.t(draw(key, rank, 513), dt),
                  op=hvd.Sum, name=key, compression=codec)
        key = f"{codec}_grouped"
        xs = [R.t(draw(f"{key}{i}", rank, 300 + 7 * i, 10.0 ** (i - 1)),
                  "float32") for i in range(3)]
        R.run(key, hvd.grouped_allreduce, xs, op=hvd.Sum, name=key,
              compression=codec)
        key = f"{codec}_int32"
        R.run(key, hvd.allreduce,
              R.t(np.arange(50) * (rank + 1) - 7, "int32"), op=hvd.Sum,
              name=key, compression=codec)
    # The knobs: HOROVOD_COMPRESSION with no argument, a block size.
    os.environ["HOROVOD_COMPRESSION"] = "int8"
    os.environ["HOROVOD_COMPRESSION_BLOCK_SIZE"] = "64"
    try:
        R.run("env_int8_b64", hvd.allreduce,
              R.t(draw("env", rank, 5000), "float32"), op=hvd.Sum,
              name="env_int8_b64")
    finally:
        del os.environ["HOROVOD_COMPRESSION"]
        del os.environ["HOROVOD_COMPRESSION_BLOCK_SIZE"]
    R.run("mismatch", hvd.allreduce, R.t(np.ones(64), "float32"),
          op=hvd.Sum, name="codec_mismatch",
          compression="int8" if rank == 0 else "uint4")
    R.run("after_mismatch", hvd.allreduce,
          R.t(draw("after", rank, 99), "float32"), op=hvd.Sum,
          name="after_mismatch", compression="uint4")
    shm = _backend(st, "shm")
    if shm is not None:
        before = shm.ops_executed
        R.run("shm_fits", hvd.allreduce,
              R.t(draw("fits", rank, 200000), "float32"), op=hvd.Sum,
              name="shm_fits", compression="int8")
        fits = shm.ops_executed - before
        R.run("shm_oversized", hvd.allreduce,
              R.t(draw("big", rank, 1 << 20), "float32"), op=hvd.Sum,
              name="shm_oversized", compression="int8")
        R.records[f"{R.phase}/shm_served"] = (
            "int", (fits, shm.ops_executed - before - fits))


def battery_adasum(R: Recorder, st) -> None:
    """Adasum on single tensors of several lengths and dtypes, a zero
    tensor, a fused group of three tensors with norms 1e-2 to 1e2, the
    bf16 and fp16 casts, and the refusal of a quantized codec."""
    hvd, rank = R.hvd, R.rank
    for n in (1, 7, 1000, 4097):
        key = f"ad_f32_{n}"
        R.run(key, hvd.allreduce, R.t(draw(key, rank, n), "float32"),
              op=hvd.Adasum, name=key)
    for dt in ("float64", "float16", "bfloat16"):
        key = f"ad_{dt}"
        R.run(key, hvd.allreduce, R.t(draw(key, rank, 999), dt),
              op=hvd.Adasum, name=key)
    R.run("ad_zero", hvd.allreduce, R.t(np.zeros(64), "float32"),
          op=hvd.Adasum, name="ad_zero")
    R.run("ad_one_zero", hvd.allreduce,
          R.t(draw("one", rank, 64) * (rank % 2), "float32"),
          op=hvd.Adasum, name="ad_one_zero")
    xs = [R.t(draw(f"ad_group{i}", rank, 250 + 3 * i, 10.0 ** (2 * i - 2)),
              "float32") for i in range(3)]
    R.run("ad_group", hvd.grouped_allreduce, xs, op=hvd.Adasum,
          name="ad_group")
    for codec in ("bf16", "fp16"):
        key = f"ad_cast_{codec}"
        R.run(key, hvd.allreduce, R.t(draw(key, rank, 2048), "float32"),
              op=hvd.Adasum, name=key, compression=codec)
    R.run("ad_int8", hvd.allreduce, R.t(np.ones(32), "float32"),
          op=hvd.Adasum, name="ad_int8", compression="int8")
    R.run("ad_after", hvd.allreduce, R.t(draw("after", rank, 33), "float32"),
          op=hvd.Adasum, name="ad_after")


def battery_adasum_odd(R: Recorder, st) -> None:
    """A world whose size is not a power of two refuses Adasum."""
    hvd, rank = R.hvd, R.rank
    R.run("ad_odd", hvd.allreduce, R.t(draw("odd", rank, 16), "float32"),
          op=hvd.Adasum, name="ad_odd")


def battery_hier(R: Recorder, st) -> None:
    """Allreduces (fp32 at several sizes, bf16, fp16, int32, an average,
    a group of five) and ragged allgathers (single and a burst that
    fuses) through the hierarchical plane, and its per-leg counters."""
    hvd, rank = R.hvd, R.rank
    for n in (1, 1001, 100003):
        key = f"h_f32_{n}"
        R.run(key, hvd.allreduce, R.t(draw(key, rank, n), "float32"),
              op=hvd.Sum, name=key)
    R.run("h_bf16", hvd.allreduce, R.t(draw("hb", rank, 4099), "bfloat16"),
          op=hvd.Sum, name="h_bf16")
    R.run("h_f16", hvd.allreduce, R.t(draw("hh", rank, 515), "float16"),
          op=hvd.Sum, name="h_f16")
    R.run("h_int32", hvd.allreduce,
          R.t(np.arange(77) * (rank + 3), "int32"), op=hvd.Sum,
          name="h_int32")
    R.run("h_avg", hvd.allreduce, R.t(draw("havg", rank, 2000), "float64"),
          op=hvd.Average, name="h_avg")
    R.run("h_grouped", hvd.grouped_allreduce,
          [R.t(draw(f"hf{i}", rank, 10 + 5 * i), "float32")
           for i in range(5)], op=hvd.Sum, name="h_grouped")
    R.run("h_ag", hvd.allgather,
          R.t(np.full((rank + 1, 3), rank + 0.5), "float32"), name="h_ag")
    hier = _backend(st, "tcp-hierarchical")
    # Which of the burst's gathers fuse depends on timing, so the op
    # counts are read before it; the byte counts do not depend on it.
    R.records[f"{R.phase}/leg_ops"] = (
        "legs", None if hier is None else dict(hier.leg_ops))
    hs = [hvd.allgather_async(
        R.t(draw(f"hg{i}", rank, (rank + i, i + 2)), "float64"),
        name=f"h_ag_burst{i}") for i in range(3)]
    for i, h in enumerate(hs):
        R.run(f"h_ag_burst{i}", hvd.synchronize, h)
    R.records[f"{R.phase}/leg_bytes"] = (
        "legs", None if hier is None else dict(hier.leg_bytes))
    R.records[f"{R.phase}/shm_local"] = (
        "int", hier is not None and hier.shm_local is not None)


# Each suite's battery by phase, and what a suite reads after a phase's
# hvd.shutdown() (none but the runtime suite's).
BATTERIES = {
    "codecs": dict.fromkeys(SUITES["codecs"], battery_codecs),
    "adasum": {"tcp": battery_adasum, "odd": battery_adasum_odd},
    "hier": dict.fromkeys(SUITES["hier"], battery_hier),
    "runtime": runtime.BATTERIES,
}
FINISH = {"runtime": runtime.finish_phase}


def _no_finish(R: Recorder, phase: str, outdir: str, side: str) -> None:
    pass


def run_suite(side, hvd, core, suite: str, rank: int, size: int,
              outdir: str) -> int:
    """Every phase of one suite on this rank; writes the records.  A
    phase's environment may name ``{outdir}`` and ``{side}``."""
    records: dict[str, tuple] = {}
    base_env = dict(os.environ)
    # A world of three ranks runs Adasum's refusal alone.
    phases = {"odd": {}} if suite == "adasum" and size == 3 \
        else SUITES[suite]
    finish = FINISH.get(suite, _no_finish)
    for phase, env in phases.items():
        os.environ.clear()
        os.environ.update(base_env)
        os.environ.update({k: v.format(outdir=outdir, side=side.name)
                           for k, v in env.items()})
        os.environ.update(layout_env(suite, phase, rank, size))
        os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = \
            f"{base_env.get('HOROVOD_RENDEZVOUS_EPOCH', 'w')}.{phase}"
        hvd.init()
        st = core.global_state()
        R = Recorder(side, hvd, rank, size, phase)
        R.records[f"{phase}/planes"] = (
            "planes", [b.name for b in st.op_manager.backends])
        BATTERIES[suite][phase](R, st)
        hvd.shutdown()
        finish(R, phase, outdir, side.name)
        records.update(R.records)
    with open(os.path.join(outdir, f"{side.name}_{rank}.pkl"), "wb") as f:
        pickle.dump(records, f)
    return 0


# ---------------------------------------------------------------------------
# The test side: spawn both packages' worlds and read their records.
# ---------------------------------------------------------------------------
@world_locked("size")
def _run_world(side: str, suite: str, size: int, outdir: str,
               failures: list) -> None:
    if side == "port":
        from horovod_tpu_torch.runner.network import RendezvousServer
    else:
        from horovod_tpu.runner.network import RendezvousServer
    server = RendezvousServer()
    port = server.start()
    env = dict(os.environ)
    for var in list(env):
        if var.startswith("HOROVOD_"):
            del env[var]
    env["HOROVOD_RENDEZVOUS_EPOCH"] = f"{suite}{side}{size}"
    # One compute thread a rank: the worlds share the host with other
    # test files, and both sides run the same numpy either way.
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, side, suite, str(r), str(size), str(port),
         outdir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=WORLD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failures.append(f"{side} rank {r}: timeout")
            if p.returncode != 0:
                failures.append(f"{side} rank {r} rc={p.returncode}:\n"
                                + out.decode(errors="replace")[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()


def run_worlds(suite: str, sizes, outdir: str) -> dict:
    """Run the suite in a port world and a JAX world of each size, one
    world after another (the test files share the host with timing
    tests); returns {size: {rank: (port records, JAX records)}}."""
    failures: list[str] = []
    for size in sizes:
        os.makedirs(os.path.join(outdir, str(size)), exist_ok=True)
        for side in ("port", "ref"):
            _run_world(side, suite, size, os.path.join(outdir, str(size)),
                       failures)
    assert not failures, "\n".join(failures)
    out = {}
    for size in sizes:
        recs = {}
        for r in range(size):
            pair = []
            for side in ("port", "ref"):
                with open(os.path.join(outdir, str(size),
                                       f"{side}_{r}.pkl"), "rb") as f:
                    pair.append(pickle.load(f))
            recs[r] = tuple(pair)
        out[size] = recs
    return out


def phase_records(recs: dict, phase: str) -> dict:
    return {k: v for k, v in recs.items() if k.startswith(phase + "/")}


def assert_phase_equal(recs: dict, phase: str, skip=()) -> None:
    """Every record of the phase equal on both sides, on every rank."""
    for rank, (port, ref) in recs.items():
        p, j = phase_records(port, phase), phase_records(ref, phase)
        assert p, (rank, phase)
        assert sorted(p) == sorted(j), (rank, set(p) ^ set(j))
        bad = {k: (p[k], j[k]) for k in p
               if p[k] != j[k] and k.split("/", 1)[1] not in skip}
        assert not bad, (rank, phase, sorted(bad))
