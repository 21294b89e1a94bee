"""The port's autotuner against the JAX package's, in one process.

The Gaussian process and the Bayesian optimization are numpy in both
packages: on the same seeded samples they give the same numbers, bit for
bit.  ``ParameterManager`` is driven in both packages with a fake
controller and the same fake clock (``time.monotonic`` advances by a
seeded draw at every read), through the codec sweep, the pipeline sweep
(segment x streams), the fused-kernel sweep, the algorithm x
tree-threshold sweep and the Bayesian phase: both propose the same
``pending_tuned_*`` sequence and write the same log rows, timestamps
aside.  An inactive manager never proposes (after
``tests/test_autotune.py:85-124``).
"""
from __future__ import annotations

import types

import numpy as np
import pytest

from horovod_tpu.common import parameter_manager as ref_pm
from horovod_tpu.common.optim.bayesian_optimization import (
    BayesianOptimization as RefBO)
from horovod_tpu.common.optim.gaussian_process import (
    GaussianProcess as RefGP)
from horovod_tpu_torch.common import parameter_manager as port_pm
from horovod_tpu_torch.common.optim.bayesian_optimization import (
    BayesianOptimization as PortBO)
from horovod_tpu_torch.common.optim.gaussian_process import (
    GaussianProcess as PortGP)

_PENDING = ("pending_tuned_params", "pending_tuned_codec",
            "pending_tuned_pipeline", "pending_tuned_fused",
            "pending_tuned_algo")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,dim,alpha,optimize", [
    (2, 1, 1e-8, True), (12, 1, 1e-6, True), (18, 2, 0.8, True),
    (9, 2, 1e-4, False)])
def test_gaussian_process_is_the_reference_bitwise(n, dim, alpha,
                                                   optimize):
    rng = np.random.default_rng(n * 10 + dim)
    x = rng.uniform(0, 1, size=(n, dim))
    y = 5e8 * np.sin(3 * x.sum(-1)) + 3e9 + rng.normal(0, 1e8, n)
    q = rng.uniform(-0.5, 1.5, size=(33, dim))
    gps = [cls(length_scale=0.3, alpha=alpha, optimize=optimize)
           for cls in (PortGP, RefGP)]
    for gp in gps:
        gp.fit(x, y)
    assert gps[0].length_scale == gps[1].length_scale
    assert gps[0].last_lml == gps[1].last_lml
    (mp, sp), (mr, sr) = (gp.predict(q) for gp in gps)
    assert _same(mp, mr) and _same(sp, sr)


@pytest.mark.parametrize("seed", [0, 3])
def test_bayesian_optimization_is_the_reference_bitwise(seed):
    """The autotuner's own search space, noisy scores: every suggestion
    and the best sample are the reference's."""
    bounds = [(20.0, 28.0), (1.0, 25.0)]
    bos = [cls(bounds, alpha=0.8, seed=seed) for cls in (PortBO, RefBO)]
    rng = np.random.default_rng(seed)
    for step in range(12):
        xs = [bo.suggest_next() for bo in bos]
        assert _same(xs[0], xs[1]), step
        score = float(-((xs[0][0] - 24.0) ** 2) * 1e8
                      - (xs[0][1] - 5.0) ** 2 * 1e7 + 4e9
                      + rng.normal(0, 5e7))
        for bo in bos:
            bo.add_sample(xs[0], score)
    (bp, sp), (br, sr) = (bo.best() for bo in bos)
    assert _same(bp, br) and sp == sr
    assert bos[0].num_samples == bos[1].num_samples == 12


class _FakeController:
    tensor_fusion_threshold = 64 * 1024 * 1024

    def __init__(self) -> None:
        for name in _PENDING:
            setattr(self, name, None)


def _fake_time(seed: int):
    """A clock both packages read identically: each monotonic() read
    advances it by a seeded draw, so every window scores differently."""
    rng = np.random.default_rng(seed)
    state = {"t": 1000.0}

    def monotonic() -> float:
        state["t"] += float(rng.uniform(0.001, 0.05))
        return state["t"]

    return types.SimpleNamespace(monotonic=monotonic,
                                 time=lambda: 1.7e9)


def _drive(module, monkeypatch, tmp_path, active: bool, observes: int,
           seed: int):
    monkeypatch.setattr(module, "time", _fake_time(seed))
    log = tmp_path / f"{module.__name__}.csv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    ctrl = _FakeController()
    pm = module.ParameterManager(ctrl, active=active)
    proposals = []
    for i in range(observes):
        # Every third cycle carried no allreduce bytes (it is not a step).
        pm.observe(["t"], 0 if i % 3 == 2 else (1 << 20) + i)
        got = tuple(getattr(ctrl, name) for name in _PENDING)
        if any(v is not None for v in got):
            proposals.append((i, got))
        for name in _PENDING:     # broadcast: the coordinator clears it
            setattr(ctrl, name, None)
    rows = log.read_text().splitlines() if log.exists() else []
    return pm, proposals, rows


@pytest.mark.parametrize("compression,pipeline,streams,seed", [
    ("1", "1", "2", 0), ("0", "1", "3", 1), ("1", "0", "1", 2),
    ("0", "0", "1", 3)])
def test_parameter_manager_proposes_the_reference_sequence(
        monkeypatch, tmp_path, compression, pipeline, streams, seed):
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "2")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "5")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", compression)
    monkeypatch.setenv("HOROVOD_AUTOTUNE_PIPELINE", pipeline)
    monkeypatch.setenv("HOROVOD_NUM_STREAMS", streams)
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "2.5")
    pp, port, port_rows = _drive(port_pm, monkeypatch, tmp_path, True, 150,
                                 seed)
    pr, ref, ref_rows = _drive(ref_pm, monkeypatch, tmp_path, True, 150,
                               seed)
    assert pp._done and pr._done
    assert port == ref
    # Every sweep that was on proposed (codec, pipeline, fused, algo),
    # then the Bayesian phase and its converged pin.
    fields = {k for _, got in port for k, v in zip(_PENDING, got)
              if v is not None}
    want = {"pending_tuned_params"}
    if compression == "1":
        want.add("pending_tuned_codec")
    if pipeline == "1":
        want |= {"pending_tuned_pipeline", "pending_tuned_fused",
                 "pending_tuned_algo"}
    assert fields == want
    assert len(port_rows) == len(ref_rows) > 5
    assert port_rows[0] == ref_rows[0].strip()
    for a, b in zip(port_rows[1:], ref_rows[1:]):
        assert a.split(",")[1:] == b.split(",")[1:]
    assert port_rows[-1].endswith(",converged")


def test_inactive_parameter_manager_never_proposes(monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_PIPELINE", "1")
    for module in (port_pm, ref_pm):
        pm, proposals, rows = _drive(module, monkeypatch, tmp_path, False,
                                     100, 0)
        assert proposals == [] and rows == [] and not pm._done
