"""The port's eager wire codecs against the JAX package's.

In one process: the numpy codec (``horovod_tpu_torch/compress/quantize.py``)
and the single-pass passes (``compress/fused.py``, natively and with
``HOROVOD_TPU_DISABLE_NATIVE=1``) are bitwise equal to
``horovod_tpu.compress`` on seeded inputs, the edge cases of
``tests/test_compress.py:63`` among them.  Then 2- and 4-rank worlds of
both packages run ``tests/torch_reduce_battery.py``'s codec battery (fp16,
bf16, int8, uint4 at tree and ring sizes, sums, averages, scaled and
grouped allreduces, integer tensors uncompressed, the codec mismatch, the
shm plane declining an oversized quantized buffer) on the TCP plane and
the shm plane, through the fused passes and the per-chunk chain; every
output and error must be equal byte for byte.
"""
from __future__ import annotations

import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu import compress as ref
from horovod_tpu.compress.fused import FusedKernels as RefFused
from horovod_tpu_torch import compress as port
from horovod_tpu_torch.compress.fused import FusedKernels as PortFused

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_reduce_battery as battery  # noqa: E402

CODECS = [port.CompressionCodec.INT8, port.CompressionCodec.UINT4]
# Lengths: empty, one element, odd (a pad nibble), a short tail block,
# block-aligned, and a few blocks with a ragged tail.
LENGTHS = [0, 1, 7, 64, 255, 1000, 4097]


def _inputs(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 3).astype(np.float32),
            np.full(n, 3.25, np.float32),                  # constant blocks
            np.concatenate([np.zeros(n // 2, np.float32),
                            np.full(n - n // 2, 1000.0, np.float32)]),
            (rng.standard_normal(n) * 1e-30).astype(np.float32)]


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("codec", CODECS, ids=["int8", "uint4"])
@pytest.mark.parametrize("block", [32, 64, 256])
def test_codec_is_the_reference_bitwise(codec, block):
    for n in LENGTHS:
        for i, x in enumerate(_inputs(n, n + block)):
            qp, qr = port.quantize(x, codec, block), \
                ref.quantize(x, ref.CompressionCodec(codec), block)
            for f in ("scales", "zero_points", "payload"):
                assert _same(getattr(qp, f), getattr(qr, f)), (n, i, f)
            assert _same(port.dequantize(qp), ref.dequantize(qr)), (n, i)
            raw = port.to_bytes(qp)
            assert raw == ref.to_bytes(qr)
            assert len(raw) == port.serialized_nbytes(n, codec, block)
            back = port.from_bytes(np.frombuffer(raw, np.uint8), n, codec,
                                   block)
            assert _same(port.dequantize(back), ref.dequantize(qr))
            assert _same(port.roundtrip_error_bound(x, codec, block),
                         ref.roundtrip_error_bound(
                             x, ref.CompressionCodec(codec), block))


def test_chunk_bounds_and_staged_nbytes_are_the_reference():
    for n in (0, 1, 5, 1000, 100003):
        for size in (1, 2, 3, 4, 8):
            assert _same(port.chunk_bounds(n, size),
                         ref.chunk_bounds(n, size))
            for codec in CODECS:
                assert port.staged_nbytes(n, size, codec, 256) == \
                    ref.staged_nbytes(n, size, ref.CompressionCodec(codec),
                                      256)
    assert port.num_blocks(513, 256) == ref.num_blocks(513, 256) == 3
    assert port.payload_nbytes(7, port.CompressionCodec.UINT4) == 4


def test_knob_defaults(monkeypatch):
    assert port.default_block_size() == ref.default_block_size() == 256
    assert port.default_codec() == port.CompressionCodec.NONE
    monkeypatch.setenv("HOROVOD_COMPRESSION", "uint4")
    monkeypatch.setenv("HOROVOD_COMPRESSION_BLOCK_SIZE", "64")
    assert port.default_codec() == port.CompressionCodec.UINT4
    assert port.default_block_size() == 64


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("codec", CODECS, ids=["int8", "uint4"])
def test_fused_passes_are_the_reference(monkeypatch, native, codec):
    """encode, decode_into and decode_add of the port equal the
    reference's FusedKernels (and so its per-chunk chain) byte for byte,
    through the native kernels and through the numpy form."""
    if native == "numpy":
        monkeypatch.setenv("HOROVOD_TPU_DISABLE_NATIVE", "1")
    rcodec = ref.CompressionCodec(codec)
    fp, fr = PortFused(), RefFused()
    for n in LENGTHS:
        for i, x in enumerate(_inputs(n, 7 * n + 1)):
            wp = fp.encode(x, codec, 64, ("e",)).copy()
            wr = fr.encode(x, rcodec, 64, ("e",)).copy()
            assert _same(wp, wr), (n, i)
            assert wp.tobytes() == ref.to_bytes(ref.quantize(x, rcodec, 64))
            if n == 0:
                continue
            out_p, out_r = np.empty(n, np.float32), np.empty(n, np.float32)
            fp.decode_into(wp, n, codec, 64, out_p, ("d",))
            fr.decode_into(wr, n, rcodec, 64, out_r, ("d",))
            assert _same(out_p, out_r), (n, i)
            acc_p = np.linspace(-1, 1, n).astype(np.float32)
            acc_r = acc_p.copy()
            fp.decode_add(wp, n, codec, 64, acc_p, ("a",))
            fr.decode_add(wr, n, rcodec, 64, acc_r, ("a",))
            assert _same(acc_p, acc_r), (n, i)


@pytest.mark.parametrize("wire", ["fp16", "bf16"])
def test_fused_cast_add_is_the_reference(wire):
    x = (np.random.default_rng(3).standard_normal(999) * 50) \
        .astype(np.float32)
    tdt = {"fp16": torch.float16, "bf16": torch.bfloat16}[wire]
    ndt = {"fp16": np.float16, "bf16": ml_dtypes.bfloat16}[wire]
    raw_p = torch.from_numpy(x).to(tdt).view(torch.int16).numpy().tobytes()
    raw_r = x.astype(ndt).tobytes()
    assert raw_p == raw_r
    acc_p = np.linspace(-3, 3, 999).astype(np.float32)
    acc_r = acc_p.copy()
    PortFused().cast_add(bytearray(raw_p), tdt, acc_p, ("c",))
    RefFused().cast_add(bytearray(raw_r), np.dtype(ndt), acc_r, ("c",))
    assert _same(acc_p, acc_r)


def test_numpy_exact_casts():
    """``backend/base.py`` ``cast``: float64 to float16 rounds once, as
    numpy does (torch alone rounds through float32); the bf16 cast is
    ml_dtypes'."""
    from horovod_tpu_torch.backend.base import cast
    rng = np.random.default_rng(11)
    x = rng.standard_normal(200000) * np.exp(rng.uniform(-25, 9, 200000))
    x = x[np.abs(x) < 60000.0]                    # finite in float16
    h = x.astype(np.float16).astype(np.float64)
    ulp = np.spacing(np.abs(x.astype(np.float16))).astype(np.float64)
    x = np.concatenate([x, h + ulp / 2 * (1 + 2.0 ** -35), h + ulp / 2])
    got = cast(torch.from_numpy(x), torch.float16)
    assert got.view(torch.int16).numpy().tobytes() == \
        x.astype(np.float16).tobytes()
    got = cast(torch.from_numpy(x), torch.bfloat16)
    assert got.view(torch.int16).numpy().tobytes() == \
        x.astype(ml_dtypes.bfloat16).tobytes()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return battery.run_worlds("codecs", (2, 4),
                              str(tmp_path_factory.mktemp("codecs")))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("phase", list(battery.SUITES["codecs"]))
def test_codec_worlds_equal_the_reference_bitwise(worlds, size, phase):
    battery.assert_phase_equal(worlds[size], phase)


@pytest.mark.parametrize("size", [2, 4])
def test_codec_worlds_ran_what_they_claim(worlds, size):
    """The schedules the battery asks for ran: the tree at 4 ranks for
    small payloads (quantized only when block-aligned), the ring
    otherwise; a mismatch is the controller's error; integers come back
    exact; shm served the fitting buffer and declined the oversized
    one."""
    for rank, (port_recs, _) in worlds[size].items():
        for phase in ("tcp", "tcp_chain"):
            algo = {k.split("/")[1]: v[1] for k, v in port_recs.items()
                    if k.startswith(phase) and k.endswith("_algo")}
            tree = size > 2
            assert algo["int8_f32_1024_algo"] == ("tree" if tree
                                                  else "ring")
            assert algo["int8_f32_1001_algo"] == "ring"
            assert algo["fp16_f32_1001_algo"] == ("tree" if tree
                                                  else "ring")
            assert algo["uint4_f32_100003_algo"] == "ring"
        for phase in battery.SUITES["codecs"]:
            kind, exc, text = port_recs[f"{phase}/mismatch"]
            assert kind == "error" and "Mismatched compression" in text
            dtype, shape, raw = port_recs[f"{phase}/int8_int32"]
            want = sum(np.arange(50) * (r + 1) - 7 for r in range(size))
            assert np.frombuffer(raw, np.int32).tolist() == want.tolist()
        for phase in ("shm", "shm_chain"):
            assert port_recs[f"{phase}/shm_served"] == ("int", (1, 0))


def test_codec_results_within_the_reference_bound(worlds):
    """A sanity check beside the bitwise one: the int8 sum of the 4-rank
    world is within every input's quantization error plus one
    requantization of the sum (tests/mp_worker.py:1738)."""
    size = 4
    _, shape, raw = worlds[size][0][0]["tcp/int8_f32_100003"]
    got = np.frombuffer(raw, np.float32).astype(np.float64)
    data = np.stack([battery.draw("int8_f32_100003", r, 100003)
                     .astype(np.float32) for r in range(size)])
    exact = data.astype(np.float64).sum(axis=0)
    inputs = sum(ref.roundtrip_error_bound(d, ref.CompressionCodec.INT8,
                                           256) for d in data)
    b = ref.chunk_bounds(exact.size, size)
    requant = np.concatenate([ref.roundtrip_error_bound(
        exact[b[r]:b[r + 1]].astype(np.float32), ref.CompressionCodec.INT8,
        256) for r in range(size)])
    assert np.all(np.abs(got - exact) <= 2 * inputs + requant + 1e-5)
