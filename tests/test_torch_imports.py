"""The port stands alone: it imports no JAX (nor ml_dtypes) and nothing of
horovod_tpu, its native kernels are its own copy, and its entry points run
on the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_sigterm import restore_sigterm  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "horovod_tpu")

_IMPORT_ALL = """
import pkgutil, sys, importlib
before = set(sys.modules)
import horovod_tpu_torch
for info in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                  "horovod_tpu_torch."):
    importlib.import_module(info.name)
new = sorted(set(sys.modules) - before)
print(len([m for m in new if m.startswith("horovod_tpu_torch")]))
assert "horovod_tpu_torch.compress.ops" in new
for sub in ("common.controller", "backend.tcp", "backend.shm", "native",
            "runner.network", "core", "eager", "backend.nccl",
            "parallel.multihost", "torch", "torch.mpi_ops",
            "torch.optimizer", "torch.functions", "torch.compression",
            "torch.sync_batch_norm", "telemetry", "telemetry.exporter",
            "telemetry.flight", "telemetry.straggler", "telemetry.perfmodel",
            "telemetry.report", "telemetry.trace", "telemetry.perf",
            "telemetry.perfcheck", "telemetry.catalog",
            "analysis.fingerprint", "common.parameter_manager",
            "common.optim.gaussian_process",
            "common.optim.bayesian_optimization", "resilience",
            "resilience.context", "resilience.heartbeat",
            "resilience.chaos", "resilience.policy", "runner.hosts",
            "runner.safe_shell_exec", "runner.driver_service",
            "runner.launch", "runner.run_worker",
            "runner.elastic_run_worker", "runner.run_api", "elastic",
            "elastic.discovery", "elastic.registration", "elastic.rpc",
            "elastic.worker", "elastic.driver", "elastic.state",
            "elastic.sampler", "elastic.run", "elastic.launcher",
            "torch.elastic", "parallel.ring_attention", "parallel.ulysses",
            "parallel.pipeline", "models.moe", "statesync",
            "statesync.snapshot", "checkpoint", "spark", "spark.store",
            "data", "data.loader", "callbacks", "statesync.stream",
            "statesync.service", "statesync.autoscale",
            "serving.kvstream", "runner.controlplane", "runner.mpi_run",
            "runner.js_run"):
    assert "horovod_tpu_torch." + sub in new, sub
bad = [m for m in new
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
                              "horovod_tpu")]
print("BAD", bad)
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= 105           # every module: the eager core,
    # the device plane, the torch binding, the runtime's telemetry,
    # fingerprint and autotuner, the failure half's resilience, the
    # launcher and elastic layer, sequence, expert and pipeline
    # parallelism, the fit loop with its state and data, and elastic
    # membership (statesync's streaming, service and autoscale, and
    # serving's kvstream) too
    assert bad == "BAD []", bad


def _python_files():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            names = [node.args[0].value]
        for name in names:
            assert not _forbidden(name), f"{path}:{node.lineno} {name}"


def test_native_kernels_are_the_ports_own_copy():
    """The loader builds kernels.cc from the port's tree, and the copy
    carries every entry point of the reference's."""
    from horovod_tpu_torch import native
    src = Path(native._SRC)
    assert src == PACKAGE / "native" / "kernels.cc"
    assert Path(native.library_path()).parent == PACKAGE / "_build"
    ref = (REPO / "horovod_tpu" / "native" / "kernels.cc").read_text()
    ours = src.read_text()
    import re
    entry = re.compile(r"\b(hvd_[a-z0-9_]+)\(")
    assert set(entry.findall(ref)) == set(entry.findall(ours))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_cpu_is_asked(no_cuda):
    from horovod_tpu_torch import (VGG16, InceptionV3, ReplicaExecutor,
                                   ResNet18, ResNet50, ServeConfig,
                                   TransformerLM, build_mesh,
                                   flash_attention, gpt_tiny,
                                   synthetic_image_batch,
                                   synthetic_text_batch)
    from horovod_tpu_torch.parallel.mesh import Mesh
    from horovod_tpu_torch.training import Trainer

    cfg = gpt_tiny()
    q = torch.zeros(1, 8, 2, 16)
    for call in (lambda: TransformerLM(cfg), build_mesh,
                 lambda: flash_attention(q, q, q),
                 lambda: synthetic_text_batch(1, 8), ReplicaExecutor,
                 lambda: ReplicaExecutor(ServeConfig(paged=True)),
                 ResNet50, VGG16, InceptionV3,
                 lambda: synthetic_image_batch(1, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    model = TransformerLM(cfg, device="cpu")
    mesh = Mesh(shape={"dp": 1}, group=None, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1), mesh)
    # Asked for the CPU, each runs there.
    assert build_mesh(device="cpu").device.type == "cpu"
    assert flash_attention(q, q, q, device="cpu").shape == q.shape
    assert synthetic_text_batch(1, 8, device="cpu")["input"].device.type \
        == "cpu"
    import horovod_tpu_torch as hvd
    hvd.init(rank=0, size=1)           # the executor's world is hvd's
    try:
        replica = ReplicaExecutor(ServeConfig(max_seq=32), device="cpu")
        assert replica.model.device.type == "cpu"
    finally:
        hvd.shutdown()
    assert ResNet18(num_filters=8, device="cpu").head.weight.device.type \
        == "cpu"
    assert synthetic_image_batch(1, 8, device="cpu")["image"].device.type \
        == "cpu"


def test_moe_layer_needs_cuda_unless_cpu_is_asked(no_cuda):
    from horovod_tpu_torch import MoEMLP
    from horovod_tpu_torch.common.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        MoEMLP(8, num_experts=2, d_ff=16)
    layer = MoEMLP(8, num_experts=2, d_ff=16, device="cpu")
    assert {p.device.type for p in layer.parameters()} == {"cpu"}


def test_cpu_tensors_with_cuda_device_are_refused():
    q = torch.zeros(1, 8, 2, 16)
    from horovod_tpu_torch import flash_attention
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="expected"):
            flash_attention(q, q, q, device="cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            flash_attention(q, q, q, device="cuda")


def test_mesh_is_dp_only_at_world_one():
    from horovod_tpu_torch import build_mesh
    mesh = build_mesh(device="cpu")
    assert mesh.shape["dp"] == 1 and mesh.group is None and mesh.size == 1
    with pytest.raises(ValueError, match="require"):
        build_mesh(dp=2, device="cpu")


def test_binding_keeps_torch_pointing_at_pytorch():
    """Inside ``horovod_tpu_torch.torch`` an absolute ``import torch`` is
    PyTorch, not the binding package."""
    import horovod_tpu_torch.torch as hvt
    from horovod_tpu_torch.torch import mpi_ops
    assert mpi_ops.torch is torch and hvt is not torch
    assert hvt.__name__ == "horovod_tpu_torch.torch"
