"""The device plane's wire codecs and Adasum (``backend/nccl.py``) over a
gloo group, in 2- and 4-rank worlds on the CPU.

``tests/torch_device_codec_worker.py`` drives ``NcclBackend`` on CPU
tensors (the plane's code is ``torch.distributed`` code; only the
group's backend differs from the card's) and then runs the cast and
Adasum cases through the TCP plane.  The checks:

- int8/uint4 within the reference's bound (``battery_compress_xla``,
  ``tests/mp_worker.py:1868``: each rank's quantization error twice, plus
  one requantization), and against the XLA plane's semantics computed
  with ``horovod_tpu.compress`` (each rank's buffer quantized once, then
  dequantized and summed in fp32): equal within fp32 round-off of the
  exchange (2^-20 of the summed block magnitudes), and within one level
  where a quantization value lies within round-off of a half level;
- the cast codecs equal the TCP plane's bit for bit;
- Adasum within one fp32 ulp of the TCP plane's ``adasum_tcp`` (the
  card adds its dot products in another order), float64 within 1e-12.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu import compress as ref
from horovod_tpu_torch.runner.network import RendezvousServer

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
import torch_device_codec_worker as W  # noqa: E402
from torch_world_lock import world_locked

WORLD_TIMEOUT = 120.0


@world_locked("size")
def _run_world(size: int, outdir: str, failures: list) -> None:
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_device_codec_worker.py"),
         str(r), str(size), str(port), outdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=WORLD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failures.append(f"rank {r} of {size}: timeout")
            if p.returncode != 0:
                failures.append(f"rank {r} of {size} rc={p.returncode}:\n"
                                + out.decode(errors="replace")[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """size -> rank -> records; one world after the other."""
    failures: list[str] = []
    dirs = {s: str(tmp_path_factory.mktemp(f"codec{s}")) for s in (2, 4)}
    for s, d in dirs.items():
        _run_world(s, d, failures)
    assert not failures, "\n".join(failures)
    out = {}
    for s, d in dirs.items():
        out[s] = {}
        for r in range(s):
            with open(os.path.join(d, f"codec_{r}.pkl"), "rb") as f:
                out[s][r] = pickle.load(f)
    return out


def _arrays(rec) -> list[np.ndarray]:
    return [np.frombuffer(raw, dtype=dt).reshape(shape)
            for dt, shape, raw in rec]


def _blocks(x: np.ndarray, block: int) -> np.ndarray:
    nb = -(-x.size // block)
    pad = nb * block - x.size
    if pad:
        x = np.concatenate([x, np.full(pad, x[-1], np.float32)])
    return x.reshape(nb, block)


QUANT = [n for n, c in W.CASES.items() if c[1] in ("int8", "uint4")]
CAST = [n for n, c in W.CASES.items() if c[0] == "allreduce"
        and c[1] in ("fp16", "bf16")]
ADASUM = [n for n, c in W.CASES.items() if c[0] == "adasum"]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", QUANT)
def test_quantized_wire_is_the_xla_planes(worlds, size, name):
    _, codec, dtype, lengths, op = W.CASES[name]
    c = ref.CompressionCodec[codec.upper()]
    levels = 256 if codec == "int8" else 16
    per_rank = [W.inputs(name, r) for r in range(size)]
    # The fused buffer of the response, rank by rank, as fp32.
    flat = [np.concatenate(xs).astype(np.float32) for xs in per_rank]
    n = flat[0].size
    oracle = np.zeros(n, np.float32)
    tie = np.zeros(n, bool)
    level = np.zeros(n, np.float64)
    roundoff = np.zeros(n, np.float64)
    for x in flat:
        oracle += ref.dequantize(ref.quantize(x, c, 256))
        blocks = _blocks(x, 256)
        lo, hi = blocks.min(1), blocks.max(1)
        scale = (hi - lo) / np.float32(levels - 1)
        scale = np.where(scale > 0, scale, np.float32(1.0))
        v = (blocks - lo[:, None]) / scale[:, None]
        tie |= (np.abs(v - np.floor(v) - 0.5)
                <= 8 * 2.0 ** -23 * levels).reshape(-1)[:n]
        level += np.repeat(scale, 256)[:n]
        roundoff += np.repeat(np.abs(blocks).max(1), 256)[:n]
    scale_post = 1.0 / size if op == "average" else 1.0
    oracle = oracle.astype(np.float64) * scale_post
    exact = sum(x.astype(np.float64) for x in flat) * scale_post
    bound = (2 * sum(ref.roundtrip_error_bound(x, c, 256) for x in flat)
             + 1e-5) * scale_post
    tol = np.where(tie, level, 0.0) * scale_post \
        + 2.0 ** -20 * roundoff * scale_post
    for rank in range(size):
        got = np.concatenate([a.reshape(-1).astype(np.float64) for a in
                              _arrays(worlds[size][rank][f"plane/{name}"])])
        assert got.shape == exact.shape
        assert np.all(np.abs(got - exact) <= bound), \
            float(np.max(np.abs(got - exact) - bound))
        assert np.all(np.abs(got - oracle) <= tol), \
            float(np.max(np.abs(got - oracle) - tol))
        if rank:
            assert np.array_equal(got, np.concatenate([
                a.reshape(-1).astype(np.float64) for a in _arrays(
                    worlds[size][0][f"plane/{name}"])]))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", CAST)
def test_cast_wire_equals_the_tcp_plane(worlds, size, name):
    for rank in range(size):
        assert worlds[size][rank][f"plane/{name}"] == \
            worlds[size][rank][f"tcp/{name}"]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", ADASUM)
def test_adasum_within_an_ulp_of_the_tcp_plane(worlds, size, name):
    for rank in range(size):
        got = _arrays(worlds[size][rank][f"plane/{name}"])
        want = _arrays(worlds[size][rank][f"tcp/{name}"])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if g.dtype == np.float64:
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-300)
            else:
                ulp = np.spacing(np.abs(w).astype(np.float32))
                assert np.all(np.abs(g.astype(np.float64) - w) <= ulp), name
