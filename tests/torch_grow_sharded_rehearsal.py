"""A rehearsal of ``chip_smoke.py``'s leg (f) (the sharded grow of the
cards phase) on the CPU, with four fake cards.

    python tests/torch_grow_sharded_rehearsal.py OUT.json
        runs ``chip_smoke.phase_cards_grow_sharded()`` here and writes its
        printed lines (and its error, if it raised) to OUT.json;
    python tests/torch_grow_sharded_rehearsal.py --statesync-worker ...
        is one process of the leg's world: the leg starts them through
        this file (``chip_smoke.__file__`` points here), so that each
        takes the same patches.

The patches are ``tests/torch_cards_rehearsal.py``'s (the CPU for every
``resolve_device``, ``torch.cuda``'s calls as no-ops, a fake card for each
rank and a gloo plane), four cards, gpt_small cut to the narrow model of
``tests/torch_statesync_worker.py``'s sharded grow (every dim the FSDP
table cuts divides by 2 and 3) on rows of 64 tokens.  The flash kernels
do not launch on the CPU and the tensors lie on it, so the launch and
device checks fail here; everything else is the leg's own code and
checks.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_cards_rehearsal as cards  # noqa: E402
from torch_statesync_worker import SHARDED_MODEL  # noqa: E402

chip_smoke = cards.chip_smoke


def patch() -> None:
    import horovod_tpu_torch as pkg
    from horovod_tpu_torch import gpt_tiny
    cards.patch()
    torch.cuda.device_count = lambda: 4
    torch.cuda.current_device = lambda: 0

    def small(**kw):
        kw.pop("max_seq_len", None)
        return gpt_tiny(**{**SHARDED_MODEL, **kw})
    pkg.gpt_small = small
    chip_smoke.SHARD["seq"] = 64
    chip_smoke.__file__ = os.path.abspath(__file__)


def main() -> int:
    patch()
    if len(sys.argv) > 1 and sys.argv[1].startswith("--"):
        return chip_smoke.main()
    buf = io.StringIO()
    error = None
    with contextlib.redirect_stdout(buf):
        try:
            chip_smoke.phase_cards_grow_sharded()
        except Exception as exc:  # noqa: BLE001 - reported to the caller
            error = f"{type(exc).__name__}: {exc}"
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    with open(sys.argv[1], "w") as f:
        json.dump({"lines": lines, "error": error}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
