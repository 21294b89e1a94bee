"""Elastic worlds of the port end to end, on the CPU: worker processes
under ``horovodrun-tpu-torch``'s elastic launcher, with localhost aliases
as hosts (the reference's ``tests/test_elastic_integration.py`` recipe).

- ``happy``: 2 ranks train to the end;
- ``node-failure``: at 2 ranks, ``127.0.0.1`` exits at epoch 2, and the
  survivor restores its last commit and finishes at size 1, rank 0;
- ``grow``: from 1 to 2 through a discovery script: rank 0 adds a host to
  the script's file, the driver notifies, every rank interrupts at a
  commit and the world re-forms at size 2;
- ``shrink``: ``HOROVOD_ON_FAILURE=shrink`` under
  ``HOROVOD_FAULT_TOLERANCE`` at 3 ranks with a chaos kill of rank 2:
  every survivor sees a ``RanksFailedError`` naming rank 2, restores and
  finishes at size 2;
- ``run``: ``hvd.run(fn, hosts="localhost:2", min_np=2, max_np=2)``,
  results keyed by final rank;
- ``TorchState`` worlds of both packages (``horovod_tpu.torch`` under the
  reference's launcher, ``horovod_tpu_torch.torch`` under the port's) on
  one seeded ``nn.Linear`` and SGD with momentum, through
  ``DistributedOptimizer`` at 2 ranks, under the same chaos spec (a
  failed collective at epoch 2 on every rank): the final parameters are
  bitwise equal.

The worlds, their checks and their workers are
``tests/torch_elastic_worker.py``'s (``run_scenario``): each world runs
alone, its launcher a subprocess with ``communicate(timeout=...)``, one
compute thread a rank and CUDA hidden.
"""
from __future__ import annotations

import pytest

import torch_elastic_worker as worlds
from torch_world_lock import world_lock


@pytest.mark.parametrize("name", worlds.SCENARIOS)
def test_scenario(tmp_path, name):
    with world_lock(3 if name == "shrink" else 2):
        result = worlds.run_scenario(name, tmp_path)
    assert result["problems"] == []
    if name in ("node-failure", "grow", "shrink"):
        assert result["fault_to_recovery_s"] is not None


def test_torch_state_worlds_match_the_reference(tmp_path):
    """One chaos spec (a failed ``loss.2`` allreduce on every rank, once)
    in a TorchState world of each package: each restores its epoch-2
    commit, re-forms, and ends on bitwise the same parameters."""
    finals = {}
    for name in ("torch-ref", "torch-port"):
        out = tmp_path / name
        out.mkdir()
        result = worlds.run_scenario(name, out)
        assert result["problems"] == []
        finals[name] = result["params"]
    assert finals["torch-port"] == finals["torch-ref"]
