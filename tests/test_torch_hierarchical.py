"""The port's hierarchical plane against the JAX package's.

A 4-rank world of each package laid out as 2 hosts x 2 ranks
(``tests/mp_worker.py:3460-3469``) with both hierarchical knobs on runs
``tests/torch_reduce_battery.py``'s battery in four phases: shm local
legs (the default environment), TCP local legs
(``HOROVOD_SHM_OPERATIONS=0``), a declared ``torus:2x2`` (the ladder
along rows and columns), and a layout that is not host-major (every rank
must keep the flat planes).  Allreduces (fp32, bf16, fp16, int32, an
average, a group) and ragged allgathers (single and fused) must be equal
byte for byte, and so must the plane's per-leg op and byte counters.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_reduce_battery as battery  # noqa: E402

PHASES = list(battery.SUITES["hier"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return battery.run_worlds("hier", (4,),
                              str(tmp_path_factory.mktemp("hier")))[4]


@pytest.mark.parametrize("phase", PHASES)
def test_hierarchical_equals_the_reference_bitwise(world, phase):
    battery.assert_phase_equal(world, phase)


@pytest.mark.parametrize("phase", ["hshm", "htcp", "htorus"])
def test_hierarchical_plane_ran_its_legs(world, phase):
    for rank, (port, _) in world.items():
        planes = port[f"{phase}/planes"][1]
        assert planes[0] == "tcp-hierarchical", planes
        legs = port[f"{phase}/leg_ops"][1]
        # Eight allreduces (h_f32 x3, bf16, f16, int32, avg, group) run
        # each leg once, the single allgather each gather leg once.
        assert legs["cross_ar"] == 8 and legs["local_rs"] == 8, legs
        assert legs["local_gather"] == 1 and legs["cross_gather"] == 1
        assert port[f"{phase}/shm_local"] == ("int", phase == "hshm")


def test_layout_not_host_major_falls_back_on_every_rank(world):
    for rank, (port, ref) in world.items():
        assert "tcp-hierarchical" not in port["hflat/planes"][1]
        assert port["hflat/planes"] == ref["hflat/planes"]
        assert port["hflat/leg_ops"] == ("legs", None)


def test_hierarchical_sums_are_right(world):
    _, shape, raw = world[0][0]["htcp/h_f32_100003"]
    got = np.frombuffer(raw, np.float32)
    want = sum(battery.draw("h_f32_100003", r, 100003).astype(np.float32)
               .astype(np.float64) for r in range(4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
