"""A rehearsal of ``chip_smoke.py``'s shard phase on the CPU, with four
fake cards.

    python tests/torch_shard_rehearsal.py OUT.json
        runs ``chip_smoke.phase_shard()`` here and writes its printed
        lines (and its error, if it raised) to OUT.json;
    python tests/torch_shard_rehearsal.py --shard-worker DIR
        is one rank of the phase's launcher world: the phase starts its
        ranks through this file (``chip_smoke.__file__`` points here), so
        that every rank takes the same patches.

The patches are ``tests/torch_cards_rehearsal.py``'s (the CPU for every
``resolve_device``, ``torch.cuda``'s calls as no-ops, a fake card for
each rank and a gloo plane), with four cards and the phase's sizes cut
to gpt_tiny, a 4-expert MoE and a two-stage ResNet.  The kernels' own
checks and the profile need a card and do not run here; everything else
is the phase's own code and checks.
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

chip_smoke = cards.chip_smoke

SIZES = dict(gpt="gpt_tiny", batch=8, seq=32,
             moe=dict(batch=4, seq=32, experts=4),
             resnet=dict(stage_sizes=(1, 1), num_filters=8, num_classes=10),
             image=16, cnn_batch=8)


def patch() -> None:
    cards.patch()
    torch.cuda.device_count = lambda: 4
    chip_smoke.SHARD.update(SIZES)
    chip_smoke.__file__ = os.path.abspath(__file__)


def main() -> int:
    patch()
    if len(sys.argv) > 1 and sys.argv[1] == "--shard-worker":
        return chip_smoke.main()
    buf = io.StringIO()
    error = None
    with contextlib.redirect_stdout(buf):
        try:
            chip_smoke.phase_shard()
        except Exception as exc:  # noqa: BLE001 - reported to the caller
            error = f"{type(exc).__name__}: {exc}"
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    with open(sys.argv[1], "w") as f:
        json.dump({"lines": lines, "error": error}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
