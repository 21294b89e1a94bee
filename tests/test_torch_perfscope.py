"""perfscope in the port against the JAX package's, on the CPU.

- the wire costs, the roofline time and the busbw arithmetic of every
  algorithm at 2, 3, 4, 8 and 16 ranks on flat, torus and host layouts:
  equal to the reference's to 1e-12 relative;
- the FLOP counts: ``model_step_flops`` of ResNet-18, ResNet-50, VGG-16
  and Inception V3 (the port's models built on the meta device, the
  flax models from the same presets) in train and forward mode equal;
  gpt_tiny's count the reference's plus the LM head's ``6 x tokens x
  vocab x d_model``; ``transformer_param_count`` the port model's
  ``numel`` sum and the flax model's leaf count (gpt_tiny, gpt_tiny with
  4 experts, where the reference's formula says 443,200, and gpt_small);
  an MoE model's FLOPs the reference's at the parameters a token passes
  through (the router and one expert a layer); any other model raises;
- the peak table: the H100 rows, the knob and the nominal peak;
- the ledger and its tools: ``build_ledger`` and ``ledger_summary`` on
  the reference's synthetic four-rank sweep, the perf CLI's PERF.json,
  ``perfcheck`` (its findings, text and exit codes on the same ledgers and
  on seeded regressions), ``report`` on the same dumps: equal JSON and
  text;
- the gauges: the Trainer's on dense gpt_tiny over 3 steps (the JAX
  Trainer's count plus the head), the serving replica's three,
  ``summary()``'s ``perf`` stamp, the efficiency gauge of the core, and
  the catalog of metric names against ``docs/observability.md``;
- one two-rank launcher world of the eager core (one compute thread a
  rank) whose rank dumps merge through ``python -m
  horovod_tpu_torch.telemetry.perf`` into the reference's ledger, with
  busbw rows equal to a recomputation from the dumps' histograms,
  ``perfcheck`` passing it against itself and failing a copy cut by
  half, the critical path of its timelines and ``report``'s tables.

The mesh-wide count of a sharded Trainer is held in the gloo world of
``tests/test_torch_sharding_world.py``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.common import topology as jtopo
from horovod_tpu.telemetry import perf as jperf
from horovod_tpu.telemetry import perfcheck as jperfcheck
from horovod_tpu.telemetry import perfmodel as jpm
from horovod_tpu.telemetry import report as jreport
from horovod_tpu.telemetry.registry import MetricsRegistry as JRegistry
from horovod_tpu_torch.common import topology as ttopo
from horovod_tpu_torch.telemetry import catalog as tcatalog
from horovod_tpu_torch.telemetry import perf as tperf
from horovod_tpu_torch.telemetry import perfcheck as tperfcheck
from horovod_tpu_torch.telemetry import perfmodel as tpm
from horovod_tpu_torch.telemetry import report as treport
from horovod_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
DOCS = REPO / "docs" / "observability.md"
FIXTURES = TESTS / "fixtures" / "telemetry"
RANKS = (2, 3, 4, 8, 16)
TORUS = {2: "torus:1x2", 3: "torus:1x3", 4: "torus:2x2", 8: "torus:2x4",
         16: "torus:4x4"}
OPS = ("allreduce", "adasum", "allgather", "reducescatter", "alltoall",
       "broadcast", "barrier")


def _layouts(n: int):
    """(label, port Topology, reference Topology) for n ranks."""
    out = [("flat", ttopo.Topology(size=n), jtopo.Topology(size=n)),
           ("torus", ttopo.parse(TORUS[n], size=n),
            jtopo.parse(TORUS[n], size=n))]
    if n % 2 == 0 and n > 2:
        out.append(("host", ttopo.Topology(size=n, kind="host",
                                           local_size=2),
                    jtopo.Topology(size=n, kind="host", local_size=2)))
    return out


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# (i) Wire costs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", RANKS)
def test_wire_costs_are_the_reference(n):
    algos = tuple(ttopo.ALGO_NAMES) + ("hier", "unknown")
    assert tuple(ttopo.ALGO_NAMES) == tuple(jtopo.ALGO_NAMES)
    for label, tt, jt in _layouts(n):
        assert tt.describe() == jt.describe()
        for algo in algos:
            for nbytes in (0.0, 4096.0, 1e6, 3.0 * 2 ** 27):
                got, want = tpm.wire_cost(algo, nbytes, tt), \
                    jpm.wire_cost(algo, nbytes, jt)
                assert got.hops == want.hops, (label, algo, nbytes)
                assert _close(got.wire_bytes, want.wire_bytes), \
                    (label, algo, nbytes)
                for peak, hop_us in ((0.0, 25.0), (1.2e4, 25.0),
                                     (9e5, 3.5)):
                    assert _close(
                        tpm.expected_ms(algo, nbytes, tt, peak, hop_us),
                        jpm.expected_ms(algo, nbytes, jt, peak, hop_us))
            assert _close(tpm.algo_overhead(algo, tt),
                          jpm.algo_overhead(algo, jt)), (label, algo)
    for op in OPS:
        assert tpm.busbw_factor(op, n) == jpm.busbw_factor(op, n)
        for nbytes, ms in ((4096, 0.05), (1 << 20, 1.7), (0, 1.0),
                           (1 << 24, 0.0)):
            assert _close(tpm.busbw_mbps(op, nbytes, ms, n),
                          jpm.busbw_mbps(op, nbytes, ms, n))
    for nbytes in (1, 4096, 4097, 1 << 20, (16 << 20) + 1, 1 << 30):
        assert tpm.size_bucket(nbytes) == jpm.size_bucket(nbytes)
    assert tpm.SIZE_BUCKETS == jpm.SIZE_BUCKETS


# ---------------------------------------------------------------------------
# (ii) FLOP counts
# ---------------------------------------------------------------------------
@pytest.fixture
def meta(monkeypatch):
    """The port's model constructors build on the meta device (shapes
    only): the 138 M-parameter VGG-16 costs nothing."""
    from horovod_tpu_torch.models import (inception, moe, resnet,
                                          transformer, vgg)
    for mod in (inception, moe, resnet, transformer, vgg):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda device=None: torch.device("meta"))
    return torch.Generator()


def _cnn_pairs(gen):
    from horovod_tpu.models import inception as jinc
    from horovod_tpu.models import resnet as jres
    from horovod_tpu.models import vgg as jvgg
    from horovod_tpu_torch.models import (VGG16, InceptionV3, ResNet18,
                                          ResNet50)
    return {"resnet18": (ResNet18(generator=gen), jres.ResNet18(), 224),
            "resnet50": (ResNet50(generator=gen), jres.ResNet50(), 224),
            "vgg16": (VGG16(generator=gen), jvgg.VGG16(), 224),
            "inception3": (InceptionV3(generator=gen), jinc.InceptionV3(),
                           299)}


@pytest.mark.parametrize("train", (True, False))
def test_cnn_step_flops_are_the_reference(meta, train):
    for name, (port, ref, size) in _cnn_pairs(meta).items():
        for batch, image in ((1, size), (128, size), (8, 112)):
            got = tpm.model_step_flops(port, batch, image_size=image,
                                       train=train)
            want = jpm.model_step_flops(ref, batch, image_size=image,
                                        train=train)
            assert got == want, (name, batch, image)
    assert tpm.model_step_flops(_cnn_pairs(meta)["resnet50"][0], 128) \
        == pytest.approx(2.9629e12, rel=1e-4)


def test_the_stage_plans_are_the_reference_fields(meta):
    for name, (port, ref, _) in _cnn_pairs(meta).items():
        if name.startswith("resnet"):
            assert port.stage_sizes == tuple(ref.stage_sizes)
            assert port.num_filters == ref.num_filters
            assert port.block_cls.__name__ == ref.block_cls.__name__
        elif name == "vgg16":
            assert port.stage_plan == tuple(ref.stages)
            assert port.stages == [n for n, _ in ref.stages]


def _flax_leaf_count(cfg, shapes_only=False) -> int:
    from horovod_tpu.models.transformer import TransformerLM
    model = TransformerLM(cfg)
    tokens = jnp.zeros((1, 8), jnp.int32)
    init = (lambda: model.init(jax.random.key(0), tokens))
    params = (jax.eval_shape(init) if shapes_only else init())["params"]
    return jpm.param_count(params)


@pytest.mark.parametrize("preset,kw,want", [
    ("gpt_tiny", {}, 164_160),
    ("gpt_tiny", {"moe_experts": 4}, 328_512),
    ("gpt_small", {}, 190_532_352),
])
def test_param_count_is_what_the_model_holds(meta, preset, kw, want):
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import transformer as ttr
    cfg = getattr(ttr, preset)(**kw)
    assert tpm.transformer_param_count(cfg) == want
    model = ttr.TransformerLM(cfg, generator=meta)
    assert tpm.param_count(model) == want
    jcfg = getattr(jtr, preset)(**kw)
    assert _flax_leaf_count(jcfg, shapes_only=preset == "gpt_small") \
        == want
    # The reference's formula ties the head to the embedding and counts
    # three matrices an expert.
    ref = jpm.transformer_param_count(jcfg)
    if kw:
        assert ref == 443_200
    else:
        assert ref + cfg.vocab_size * cfg.d_model == want


def test_gpt_small_step_flops():
    from horovod_tpu_torch.models import gpt_small
    flops = tpm.transformer_train_flops(gpt_small(), 8, 2048)
    assert flops == pytest.approx(2.0586e13, rel=1e-4)
    assert flops == 8 * 2048 * (6.0 * 190_532_352
                                + 12.0 * 12 * 768 * 2048 * 0.5)


@pytest.mark.parametrize("batch,seq", [(8, 16), (2, 128), (1, 1)])
def test_gpt_tiny_flops_are_the_reference_plus_the_head(batch, seq):
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import TransformerLM, gpt_tiny
    cfg, jcfg = gpt_tiny(), jtr.gpt_tiny()
    head = cfg.vocab_size * cfg.d_model
    model = TransformerLM(cfg, device="cpu")
    jmodel = jtr.TransformerLM(jcfg)
    got = tpm.model_step_flops(model, batch, seq=seq)
    want = jpm.model_step_flops(jmodel, batch, seq=seq)
    assert got == want + 6.0 * batch * seq * head
    got = tpm.model_step_flops(model, batch, seq=seq, train=False)
    want = jpm.model_step_flops(jmodel, batch, seq=seq, train=False)
    assert got == pytest.approx(want + batch * 2.0 * head, rel=1e-15)
    assert tpm.transformer_decode_flops(cfg, 37.5) == pytest.approx(
        jpm.transformer_decode_flops(jcfg, 37.5) + 2.0 * head, rel=1e-15)
    noncausal = gpt_tiny(causal=False)
    assert tpm.transformer_train_flops(noncausal, batch, seq) \
        == jpm.transformer_train_flops(jtr.gpt_tiny(causal=False), batch,
                                       seq) + 6.0 * batch * seq * head


@pytest.mark.parametrize("batch,seq", [(8, 16), (2, 128), (1, 1)])
def test_moe_flops_count_the_routed_expert(batch, seq):
    """An MoE layer's FLOPs count its router and the one expert top-1
    routing sends a token to, without the capacity factor: the reference's
    count at the flax model's own leaves less the experts a token does not
    pass through."""
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import TransformerLM, gpt_tiny
    cfg, jcfg = gpt_tiny(moe_experts=4), jtr.gpt_tiny(moe_experts=4)
    idle = cfg.num_layers * (4 - 1) * 2 * cfg.d_model * cfg.ff_dim
    active = _flax_leaf_count(jcfg) - idle
    assert tpm.transformer_active_param_count(cfg) == active == 131_904
    assert tpm.transformer_param_count(cfg) == 328_512
    assert tpm.transformer_active_param_count(gpt_tiny()) == 164_160
    model = TransformerLM(cfg, device="cpu")
    assert tpm.model_step_flops(model, batch, seq=seq) == \
        jpm.transformer_train_flops(jcfg, batch, seq, n_params=active)
    assert tpm.model_step_flops(model, batch, seq=seq, train=False) == \
        pytest.approx(batch * jpm.transformer_decode_flops(
            jcfg, seq, n_params=active), rel=1e-15)


def test_an_unknown_model_raises():
    with pytest.raises(TypeError, match="no FLOP count for Linear"):
        tpm.model_step_flops(torch.nn.Linear(2, 2), 4)


def test_peak_table(monkeypatch):
    monkeypatch.delenv("HOROVOD_PERF_PEAK_FLOPS", raising=False)
    assert tpm.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tpm.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert tpm.peak_flops("cpu") == tpm.NOMINAL_PEAK_FLOPS == \
        jpm.NOMINAL_PEAK_FLOPS == 1e12
    assert tpm.peak_flops("") == 1e12
    assert tpm.table_peak_flops("NVIDIA A100-SXM4-80GB") is None
    # Another H100 kind has another rate: no row of the SXM card's.
    assert tpm.table_peak_flops("NVIDIA H100 NVL") is None
    assert tpm.table_peak_flops("NVIDIA H100") is None
    assert tpm.table_peak_flops("TPU v4") is None     # no TPU row
    assert tpm.device_kind("cpu") == "cpu"
    monkeypatch.setenv("HOROVOD_PERF_PEAK_FLOPS", "2.5e14")
    assert tpm.peak_flops("NVIDIA H100 80GB HBM3") == 2.5e14
    assert tpm.peak_flops("cpu") == 2.5e14


def test_mfu():
    assert tpm.mfu(1e12, 0.5, 4e12) == jpm.mfu(1e12, 0.5, 4e12) == 0.5
    assert tpm.mfu(1e12, 0.0, 1e12) == 0.0 == tpm.mfu(1e12, 1.0, 0.0)


# ---------------------------------------------------------------------------
# (iii) The ledger and its tools
# ---------------------------------------------------------------------------
_BASE = {"4KiB": 40.0, "64KiB": 160.0, "1MiB": 260.0}
_FACTOR = {"ring": 1.0, "rhd": 0.95, "tree": 0.5}


def _sweep(registry_cls, ranks=4, gauges=True):
    """The reference's synthetic four-rank algorithm sweep
    (tests/test_perfscope.py), as snapshots of ``registry_cls``."""
    snaps = []
    for r in range(ranks):
        reg = registry_cls(r)
        for algo, f in _FACTOR.items():
            for bucket, busbw in _BASE.items():
                h = reg.histogram(
                    "horovod_collective_busbw_mbps", "busbw",
                    labels={"plane": "tcp", "op": "allreduce",
                            "codec": "none", "algo": algo,
                            "size_bucket": bucket})
                for i in range(3):
                    h.observe(busbw * f * (1.0 + 0.01 * ((r + i) % 3)))
        reg.histogram("horovod_collective_latency_ms", "latency",
                      labels={"plane": "tcp", "op": "allreduce",
                              "codec": "none", "algo": "ring"}
                      ).observe(0.4 + r)
        reg.gauge("horovod_collective_efficiency", "eff",
                  labels={"plane": "tcp", "algo": "ring",
                          "size_bucket": "1MiB"}).set(0.9 + 0.01 * r)
        if gauges:
            reg.gauge("horovod_train_mfu").set(0.17 + 0.01 * r)
            reg.gauge("horovod_train_step_flops").set(2.0586e13)
            reg.gauge("horovod_serve_tokens_per_sec").set(900.0 - r)
        snaps.append(reg.snapshot())
    return snaps


def _write(tmp_path, tag, snaps):
    paths = []
    for s in snaps:
        p = tmp_path / f"{tag}.r{s['rank']}.json"
        p.write_text(json.dumps(s))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("spec,peak,min_samples", [
    ("", 0.0, 1), ("torus:2x2", 0.0, 1), ("host", 500.0, 4),
    ("flat", 0.0, 7)])
def test_build_ledger_is_the_reference(spec, peak, min_samples):
    tsnaps, jsnaps = _sweep(TRegistry), _sweep(JRegistry)
    assert tsnaps == jsnaps
    tt = ttopo.parse(spec, size=4, local_size=2, cross_size=2)
    jt = jtopo.parse(spec, size=4, local_size=2, cross_size=2)
    got = tpm.build_ledger(tsnaps, tt, peak_mbps=peak,
                           min_samples=min_samples)
    want = jpm.build_ledger(jsnaps, jt, peak_mbps=peak,
                            min_samples=min_samples)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    for top in (1, 6, 20):
        assert tpm.ledger_summary(got, top) == jpm.ledger_summary(want, top)
    assert tpm.build_ledger([]) == jpm.build_ledger([])
    assert tpm.ledger_summary(tpm.build_ledger([])) == \
        jpm.ledger_summary(jpm.build_ledger([]))
    buckets = [[0.5, 3], [1.0, 0], [4.0, 9], [64.0, 1]]
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert tpm._merged_quantile(buckets, q) == \
            jpm._merged_quantile(buckets, q)


def test_perf_cli_is_the_reference(tmp_path, capsys):
    tpaths = _write(tmp_path, "t", _sweep(TRegistry))
    jpaths = _write(tmp_path, "j", _sweep(JRegistry))
    (tmp_path / "junk.json").write_text("[1, 2]")
    for extra in ([], ["--topology", "torus:2x2", "--size", "4"],
                  ["--peak-mbps", "300", "--min-samples", "4",
                   "--summary"]):
        assert tperf.main(tpaths + [str(tmp_path / "junk.json"),
                                    "-o", str(tmp_path / "t.out")]
                          + extra) == 0
        terr = capsys.readouterr().err
        assert jperf.main(jpaths + [str(tmp_path / "junk.json"),
                                    "-o", str(tmp_path / "j.out")]
                          + extra) == 0
        jerr = capsys.readouterr().err
        got = json.loads((tmp_path / "t.out").read_text())
        want = json.loads((tmp_path / "j.out").read_text())
        assert got.pop("skipped") == want.pop("skipped")
        assert got == want
        assert terr == jerr
    # Nothing to read: rc 1 on both sides.
    assert tperf.main([str(tmp_path / "junk.json")]) == 1
    tout = capsys.readouterr()
    assert jperf.main([str(tmp_path / "junk.json")]) == 1
    jout = capsys.readouterr()
    assert (tout.out, tout.err) == (jout.out, jout.err)


def _ledger_files(tmp_path):
    base = tpm.build_ledger(_sweep(TRegistry),
                            ttopo.parse("", size=4))
    cut = json.loads(json.dumps(base))
    for row in cut["busbw"]:
        if row["size_bucket"] == "64KiB":
            row["busbw_mbps"] *= 0.7
    cut["step"]["train_mfu"] *= 0.5
    switched = json.loads(json.dumps(base))
    for row in switched["busbw"]:
        if row["algo"] == "ring":
            row["samples"] = 0       # the cell now runs tree and rhd only
    files = {}
    for name, led in (("base", base), ("cut", cut), ("switched", switched),
                      ("wrapped", {"perf": base, "n": 1}),
                      ("list", [{"cmd": "x", "rc": 0}, {"perf": cut}]),
                      ("none", {"n": 1, "tail": "..."})):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(led))
        files[name] = str(p)
    files["missing"] = str(tmp_path / "absent.json")
    return base, cut, switched, files


@pytest.mark.parametrize("current,baselines,tol", [
    ("base", ["base"], "0"),
    ("cut", ["base"], "10"),
    ("cut", ["base"], "60"),
    ("switched", ["base"], "10"),
    ("base", ["cut", "wrapped"], "10"),
    ("wrapped", ["list", "missing"], "5"),
    ("list", ["base"], "10"),
    ("base", ["none", "missing"], "10"),
    ("none", ["base"], "10"),
    ("missing", ["base"], "10"),
])
def test_perfcheck_is_the_reference(tmp_path, capsys, current, baselines,
                                    tol):
    _, _, _, files = _ledger_files(tmp_path)
    argv = [files[current], "--baseline", *[files[b] for b in baselines],
            "--tolerance-pct", tol]
    rc = tperfcheck.main(argv)
    tout = capsys.readouterr()
    assert jperfcheck.main(argv) == rc
    jout = capsys.readouterr()
    assert (tout.out, tout.err) == (jout.out, jout.err)
    if (current, tol) == ("cut", "10"):
        assert rc == 1 and "REGRESSION" in tout.err
        findings = json.loads(tout.out)["findings"]
        assert {f["metric"] for f in findings} == {"busbw_mbps",
                                                    "train_mfu"}
        for f in findings:
            if f["metric"] == "busbw_mbps":
                assert f["size_bucket"] == "64KiB"
                assert f["delta_pct"] == pytest.approx(-30.0)


def test_perfcheck_compare_is_the_reference(tmp_path):
    base, cut, switched, _ = _ledger_files(tmp_path)
    for cur, bases, tol in ((cut, [base], 10.0), (switched, [base], 1.0),
                            (base, [cut, switched], 0.0),
                            (cut, [cut, base], 35.0)):
        assert tperfcheck.compare(cur, bases, tol) == \
            jperfcheck.compare(cur, bases, tol)
    assert tperfcheck._extract_ledgers([{"perf": base}, 3, "x"]) == \
        jperfcheck._extract_ledgers([{"perf": base}, 3, "x"])


def test_the_knobs_are_the_clis_defaults(tmp_path, capsys, monkeypatch):
    """``HOROVOD_PERF_TOLERANCE_PCT`` is perfcheck's tolerance and
    ``HOROVOD_PERF_MIN_SAMPLES`` the perf CLI's sample floor when their
    flags are not given: each changes the CLI's result, as the
    reference's."""
    _, _, _, files = _ledger_files(tmp_path)
    argv = [files["cut"], "--baseline", files["base"]]
    for tol, want_rc in (("", 1), ("60", 0), ("25", 1)):
        monkeypatch.setenv("HOROVOD_PERF_TOLERANCE_PCT", tol)
        assert tperfcheck.main(argv) == want_rc
        tout = capsys.readouterr()
        assert jperfcheck.main(argv) == want_rc
        assert tout == capsys.readouterr()
    monkeypatch.delenv("HOROVOD_PERF_TOLERANCE_PCT")
    tpaths = _write(tmp_path, "t", _sweep(TRegistry))
    jpaths = _write(tmp_path, "j", _sweep(JRegistry))
    rows = {}
    for floor in ("", "12", "13"):
        monkeypatch.setenv("HOROVOD_PERF_MIN_SAMPLES", floor)
        assert tperf.main(tpaths + ["-o", str(tmp_path / "t.out")]) == 0
        assert jperf.main(jpaths + ["-o", str(tmp_path / "j.out")]) == 0
        got = json.loads((tmp_path / "t.out").read_text())
        assert got == json.loads((tmp_path / "j.out").read_text())
        rows[floor] = len(got["busbw"])
    # 3 observations a cell on each of 4 ranks: 12 samples a cell.
    assert rows == {"": 9, "12": 9, "13": 0}
    capsys.readouterr()


def test_report_is_the_reference(tmp_path, capsys):
    tpaths = _write(tmp_path, "d", _sweep(TRegistry))
    for path in tpaths[:2]:
        payload = json.loads(Path(path).read_text())
        assert treport.summarize_dump(payload) == \
            jreport.summarize_dump(payload)
        assert treport.summarize_file(path) == jreport.summarize_file(path)
    merged = str(FIXTURES / "merged_trace.json")
    assert treport.summarize_file(merged) == jreport.summarize_file(merged)
    empty = {"rank": 2, "metrics": []}
    assert treport.summarize_dump(empty) == jreport.summarize_dump(empty)
    assert treport.summarize_timeline([]) == jreport.summarize_timeline([])
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    argv = [tpaths[0], merged, str(bad)]
    assert treport.main(argv) == 1
    tout = capsys.readouterr()
    assert jreport.main(argv) == 1
    jout = capsys.readouterr()
    assert (tout.out, tout.err) == (jout.out, jout.err)


# ---------------------------------------------------------------------------
# (iv) The gauges
# ---------------------------------------------------------------------------
@pytest.fixture
def metrics_on(monkeypatch):
    from horovod_tpu import telemetry as jtm
    from horovod_tpu_torch import telemetry as ttm
    monkeypatch.setenv("HOROVOD_METRICS", "on")
    monkeypatch.delenv("HOROVOD_PERF_PEAK_FLOPS", raising=False)
    regs = ttm.configure(), jtm.configure()
    yield regs
    monkeypatch.delenv("HOROVOD_METRICS")
    ttm.configure()
    jtm.configure()


def test_trainer_gauges_are_the_reference_plus_the_head(metrics_on):
    from horovod_tpu import training as jtraining
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.parallel import GradSyncConfig as JSync
    from horovod_tpu.parallel import MeshSpec, build_mesh as jbuild_mesh
    from horovod_tpu_torch import (GradSyncConfig, Trainer, TransformerLM,
                                   build_mesh, gpt_tiny)
    treg, jreg = metrics_on
    batch = {k: np.asarray(v) for k, v in jtraining.synthetic_text_batch(
        8, seq_len=16, vocab_size=256).items()}
    jmodel = jtr.TransformerLM(jtr.gpt_tiny(dtype=jnp.float32))
    jtrainer = jtraining.Trainer(
        jmodel, optax.adamw(1e-3), jbuild_mesh(MeshSpec(dp=8)),
        sync=JSync(axes=("dp",), op="average"))
    jstate = jtrainer.init(jax.random.key(0), batch)
    model = TransformerLM(gpt_tiny(dtype=torch.float32), device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    trainer = Trainer(model, opt, build_mesh(dp=1, device="cpu"),
                      sync=GradSyncConfig(op="average"))
    state = trainer.init()
    tbatch = {k: torch.tensor(v, dtype=torch.long)
              for k, v in batch.items()}
    hist = treg.histogram("horovod_train_step_ms")
    sums = []
    for _ in range(3):
        jstate, jmetrics = jtrainer.step(jstate, batch)
        state, _ = trainer.step(state, tbatch)
        sums.append(hist.sum)
    jax.block_until_ready(jmetrics)
    head = 6.0 * 8 * 16 * 256 * 64
    flops = treg.gauge("horovod_train_step_flops").value
    assert flops == jreg.gauge("horovod_train_step_flops").value + head
    mfu = treg.gauge("horovod_train_mfu").value
    assert 0.0 < mfu < 1.0
    snap = {m["name"]: m for m in treg.snapshot()["metrics"]}
    step_ms = snap["horovod_train_step_ms"]
    assert step_ms["count"] == 2            # the first step arms the clock
    # The gauge is the last step's: the count over its time and one
    # CPU's nominal peak (a mesh of one rank).
    assert trainer._peak_flops == tpm.NOMINAL_PEAK_FLOPS
    last_ms = sums[2] - sums[1]
    assert mfu == pytest.approx(flops / (last_ms / 1e3) / 1e12, rel=1e-9)


def test_trainer_sets_no_gauge_with_metrics_off(monkeypatch):
    from horovod_tpu_torch import (GradSyncConfig, Trainer, TransformerLM,
                                   build_mesh, gpt_tiny, telemetry,
                                   synthetic_text_batch)
    monkeypatch.delenv("HOROVOD_METRICS", raising=False)
    telemetry.configure()
    model = TransformerLM(gpt_tiny(dtype=torch.float32), device="cpu")
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                      build_mesh(dp=1, device="cpu"),
                      sync=GradSyncConfig(op="average"))
    state = trainer.init()
    batch = synthetic_text_batch(2, 8, 256, device="cpu")
    for _ in range(2):
        state, _ = trainer.step(state, batch)
    assert trainer._step_flops is None and trainer._last_step is None


def test_trainer_refuses_an_unknown_model_under_metrics(metrics_on):
    from horovod_tpu_torch import GradSyncConfig, Trainer, build_mesh
    model = torch.nn.Sequential(torch.nn.Embedding(16, 4),
                                torch.nn.Linear(4, 16))

    def fwd(x, train=False):
        return torch.nn.Sequential.forward(model, x)
    model.forward = fwd
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                      build_mesh(dp=1, device="cpu"),
                      sync=GradSyncConfig(op="average"))
    batch = {"input": torch.zeros(2, 3, dtype=torch.long),
             "label": torch.zeros(2, 3, dtype=torch.long)}
    with pytest.raises(TypeError, match="no FLOP count for Sequential"):
        trainer.step(trainer.init(), batch)


def test_replica_sets_the_serve_gauges(metrics_on):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt_tiny
    from horovod_tpu_torch.serving.replica import ReplicaExecutor, ServeConfig
    hvd.init()
    treg = hvd.telemetry.metrics()        # init built a fresh registry
    try:
        cfg = gpt_tiny(dtype=torch.float32)
        ex = ReplicaExecutor(ServeConfig(max_batch=2, token_budget=256,
                                         max_seq=64, model_cfg=cfg),
                             device="cpu")
        seen = []
        orig = ex._note_perf

        def note(tokens, ctx_sum, dt):
            seen.append((tokens, ctx_sum, dt))
            orig(tokens, ctx_sum, dt)
        ex._note_perf = note
        for n in (5, 9, 7):
            ex.queue.submit(list(range(1, n + 1)), 6)
        ex.serve_loop(stop_when=lambda: True, max_steps=200)
    finally:
        hvd.shutdown()
    decoding = [s for s in seen if s[0] > 0]
    assert len(decoding) >= 6
    tps = 0.0
    for tokens, _, dt in decoding:
        rate = tokens / dt
        tps = rate if tps <= 0.0 else 0.8 * tps + 0.2 * rate
    tokens, ctx_sum, _ = decoding[-1]
    fpt = tpm.transformer_decode_flops(cfg, ctx_sum / tokens)
    assert treg.gauge("horovod_serve_tokens_per_sec").value == \
        pytest.approx(tps, rel=1e-12)
    assert treg.gauge("horovod_serve_flops_per_token").value == fpt
    assert treg.gauge("horovod_serve_mfu").value == \
        pytest.approx(tps * fpt / tpm.NOMINAL_PEAK_FLOPS, rel=1e-12)
    # The count is of the slots that decoded: each holds its context.
    assert all(1 <= c / t <= 64 for t, c, _ in decoding)


def test_summary_stamps_the_reference_ledger(metrics_on):
    from horovod_tpu import telemetry as jtm
    from horovod_tpu_torch import telemetry as ttm
    for reg in metrics_on:
        reg.histogram(
            "horovod_collective_busbw_mbps", "busbw",
            labels={"plane": "tcp", "op": "allreduce", "codec": "none",
                    "algo": "ring", "size_bucket": "64KiB"}).observe(120.0)
        reg.gauge("horovod_train_mfu").set(0.25)
    got = ttm.summary()
    assert got == jtm.summary()
    assert got["perf"]["busbw"][0]["algo"] == "ring"
    assert got["perf"]["busbw"][0]["efficiency"] == pytest.approx(1.0)
    assert got["perf"]["step"] == {"train_mfu": 0.25}


def test_summary_has_no_stamp_without_evidence(metrics_on):
    from horovod_tpu_torch import telemetry as ttm
    metrics_on[0].counter("horovod_controller_cache_hit_total").inc(2)
    assert "perf" not in ttm.summary()


@pytest.mark.parametrize("knob", ["", "2000"])
def test_core_sets_the_efficiency_gauge(metrics_on, monkeypatch, knob):
    from horovod_tpu import core as jcore
    from horovod_tpu.common import message as jmsg
    from horovod_tpu_torch import core as tcore
    from horovod_tpu_torch.common import message as tmsg
    monkeypatch.setenv("HOROVOD_PERF_PEAK_MBPS", knob)
    for core, msg, reg in ((tcore, tmsg, metrics_on[0]),
                           (jcore, jmsg, metrics_on[1])):
        class _St:
            size = 4
        for i, (n, ms) in enumerate(((1 << 18, 2.0), (1 << 18, 1.0),
                                     (1 << 10, 0.3), (1 << 18, 4.0))):
            resp = msg.Response(response_type=msg.ResponseType.ALLREDUCE,
                                tensor_names=[f"t{i}"],
                                tensor_type=msg.DataType.FLOAT32,
                                tensor_sizes=[n])
            core._observe_collective(reg, resp, "tcp", 0, ms, "ring",
                                     _St())
    assert metrics_on[0].snapshot() == metrics_on[1].snapshot()
    gauge = metrics_on[0].gauge(
        "horovod_collective_efficiency",
        labels={"plane": "tcp", "algo": "ring", "size_bucket": "1MiB"})
    peak = float(knob) if knob else 1.5 * 4 * (1 << 18) / 1e3
    want = 1.5 * 4 * (1 << 18) / 4.0 / 1e3 / peak
    assert gauge.value == pytest.approx(want, rel=1e-12)


def test_the_catalog_is_documented():
    docs = DOCS.read_text()
    assert tcatalog.undocumented_metrics(docs) == []
    from horovod_tpu.telemetry import catalog as jcatalog
    port = tcatalog.registered_metric_names()
    assert port <= jcatalog.registered_metric_names()
    assert {"horovod_train_mfu", "horovod_train_step_flops",
            "horovod_train_step_ms", "horovod_serve_mfu",
            "horovod_serve_flops_per_token", "horovod_serve_tokens_per_sec",
            "horovod_collective_efficiency"} <= port
    assert tcatalog.undocumented_metrics("| `horovod_world_size` |") \
        and "horovod_world_size" not in tcatalog.undocumented_metrics(
            "| `horovod_world_size` |")
    src = "f('horovod_tpu_torch'); g('horovod_x_'); h('horovod_ok_total')"
    assert tcatalog._names_in_source(src) == {"horovod_ok_total"}


# ---------------------------------------------------------------------------
# A two-rank launcher world
# ---------------------------------------------------------------------------
LADDER = (4 << 10, 64 << 10, 1 << 20)


@pytest.fixture(scope="module")
def ladder_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("perfworld")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS)]),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               HOROVOD_METRICS="on",
               HOROVOD_METRICS_FILE=str(tmp / "dump.json"),
               HOROVOD_TIMELINE=str(tmp / "tl.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", sys.executable, str(TESTS / "torch_perfscope_worker.py"),
         "cpu", ",".join(str(n) for n in LADDER), "4"],
        env=env, cwd=tmp, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return tmp, env


def _cli(tool, args, env, cwd):
    return subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.telemetry.{tool}",
         *args], env=env, cwd=cwd, capture_output=True, text=True,
        timeout=120)


def test_world_dumps_merge_into_the_reference_ledger(ladder_world):
    tmp, env = ladder_world
    dumps = [str(tmp / f"dump.r{r}.json") for r in range(2)]
    timelines = [str(tmp / "tl.json"), str(tmp / "tl.r1.json")]
    proc = _cli("perf", dumps + ["-o", str(tmp / "PERF.json"),
                                 "--timeline", *timelines, "--summary"],
                env, tmp)
    assert proc.returncode == 0, proc.stderr
    ledger = json.loads((tmp / "PERF.json").read_text())
    want, rc = jperf.build(dumps, timeline_paths=timelines)
    assert rc == 0
    assert ledger == json.loads(json.dumps(want))
    assert ledger["world"] == {"ranks": 2, "dumps": 2, "topology": "flat"}
    # Each busbw row is the mean of the dumps' observations of its cell.
    snaps = [json.loads(Path(d).read_text()) for d in dumps]
    cells: dict = {}
    for snap in snaps:
        for m in snap["metrics"]:
            if m["name"] == "horovod_collective_busbw_mbps":
                key = tuple(m["labels"][k] for k in
                            ("plane", "op", "codec", "algo", "size_bucket"))
                c = cells.setdefault(key, [0, 0.0])
                c[0] += m["count"]
                c[1] += m["sum"]
    rows = ledger["busbw"]
    assert len(rows) == len(cells)
    assert {r["size_bucket"] for r in rows} >= {"4KiB", "64KiB", "1MiB"}
    for r in rows:
        n, total = cells[(r["plane"], r["op"], r["codec"], r["algo"],
                          r["size_bucket"])]
        assert r["samples"] == n
        assert r["busbw_mbps"] == total / n
        assert 0.0 < r["efficiency"] <= 1.0
    assert ledger["lost_time"]["collectives"] >= 3 * len(LADDER)
    assert "critical path: rank" in ledger["lost_time"]["critical_path"]
    assert proc.stderr.splitlines()[0].startswith("peak ")
    # Every rank's efficiency gauges are set.
    for snap in snaps:
        assert any(m["name"] == "horovod_collective_efficiency"
                   for m in snap["metrics"])


def test_world_ledger_gates_and_traces(ladder_world):
    tmp, env = ladder_world
    dumps = [str(tmp / f"dump.r{r}.json") for r in range(2)]
    perf_json = tmp / "PERF.gate.json"
    assert _cli("perf", dumps + ["-o", str(perf_json)], env,
                tmp).returncode == 0
    ok = _cli("perfcheck", [str(perf_json), "--baseline", str(perf_json)],
              env, tmp)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout)["findings"] == []
    cut = json.loads(perf_json.read_text())
    for row in cut["busbw"]:
        row["busbw_mbps"] *= 0.5
    bad = tmp / "PERF.cut.json"
    bad.write_text(json.dumps(cut))
    fail = _cli("perfcheck", [str(bad), "--baseline", str(perf_json)],
                env, tmp)
    assert fail.returncode == 1
    assert "perfcheck: REGRESSION busbw_mbps at" in fail.stderr
    finding = json.loads(fail.stdout)["findings"][0]
    assert finding["delta_pct"] == pytest.approx(-50.0)
    assert finding["plane"] in ("tcp", "shm")
    timelines = [str(tmp / "tl.json"), str(tmp / "tl.r1.json")]
    crit = _cli("trace", timelines + ["--critical-path", "-o",
                                      str(tmp / "merged.json")], env, tmp)
    assert crit.returncode == 0, crit.stderr
    last = crit.stdout.strip().splitlines()[-1]
    assert last.startswith("critical path: rank ")
    assert ", phase " in last
    rep = _cli("report", [dumps[0], str(tmp / "merged.json")], env, tmp)
    assert rep.returncode == 0, rep.stderr
    assert rep.stdout == jreport.summarize_file(dumps[0]) + "\n" \
        + jreport.summarize_file(str(tmp / "merged.json")) + "\n"
    assert "horovod_collective_busbw_mbps" in rep.stdout
    assert "ALLREDUCE" in rep.stdout
