"""Eager Adasum of the port against the JAX package's.

2- and 4-rank TCP worlds of both packages run
``tests/torch_reduce_battery.py``'s Adasum battery (float32 at lengths 1
to 4097, float64, float16, bfloat16, a zero tensor, a group of three
tensors with norms from 1e-2 to 1e2 that the controller fuses, the bf16
and fp16 wire casts, and int8, which negotiation refuses); every output
and error must be equal byte for byte.  A 3-rank world must raise the
reference's power-of-2 error on every rank.  ``adasum_reference`` and
``adasum_combine`` are the reference's arithmetic.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from horovod_tpu.ops import adasum as ref_adasum
from horovod_tpu_torch.ops import adasum as port_adasum

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_reduce_battery as battery  # noqa: E402


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return battery.run_worlds("adasum", (2, 3, 4),
                              str(tmp_path_factory.mktemp("adasum")))


@pytest.mark.parametrize("size", [2, 4])
def test_adasum_worlds_equal_the_reference_bitwise(worlds, size):
    battery.assert_phase_equal(worlds[size], "tcp")


@pytest.mark.parametrize("size", [2, 4])
def test_adasum_matches_the_serial_oracle(worlds, size):
    """The world's float64 result is the reference's serial oracle,
    ``adasum_reference``, on the same inputs (the pairing tree is the
    same; numpy's dot products may add in another order than the
    fragments' sums, so within 1e-12 relative)."""
    for n in (7, 1000, 4097):
        key = f"ad_f32_{n}"
        _, _, raw = worlds[size][0][0][f"tcp/{key}"]
        got = np.frombuffer(raw, np.float32)
        data = [battery.draw(key, r, n).astype(np.float32)
                for r in range(size)]
        want = port_adasum.adasum_reference(data)
        assert np.array_equal(want, ref_adasum.adasum_reference(data))
        np.testing.assert_allclose(got, want.astype(np.float32),
                                   rtol=1e-6, atol=1e-6)


def test_adasum_refusals(worlds):
    """int8 is refused at negotiation with the reference's message, the
    world survives it, and a 3-rank world raises on every rank."""
    for rank, (port, ref) in worlds[4].items():
        kind, exc, text = port["tcp/ad_int8"]
        assert kind == "error" and "quantized compression" in text
        assert port["tcp/ad_after"][0] == "float32"
    for rank, (port, ref) in worlds[3].items():
        assert port["odd/ad_odd"] == ref["odd/ad_odd"]
        kind, exc, text = port["odd/ad_odd"]
        assert kind == "error" and "power-of-2" in text, text


@pytest.mark.parametrize("aa,bb", [(0.0, 0.0), (0.0, 2.0), (3.0, 0.0),
                                   (4.0, 9.0)])
def test_combine_is_the_reference(aa, bb):
    a = np.linspace(-1, 1, 17)
    b = np.cos(np.arange(17.0))
    ab = float(a @ b)
    assert np.array_equal(port_adasum.adasum_combine(a, b, aa, bb, ab),
                          ref_adasum.adasum_combine(a, b, aa, bb, ab))
