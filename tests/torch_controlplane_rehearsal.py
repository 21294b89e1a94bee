"""A rehearsal of ``chip_smoke.py``'s controlplane phase on the CPU.

    python tests/torch_controlplane_rehearsal.py OUT.json [CARDS]
        runs ``chip_smoke.phase_controlplane()`` here with CARDS fake cards
        (1 by default; 4 runs leg (d) too) and writes its printed lines
        (and its error, if it raised) to OUT.json;
    python tests/torch_controlplane_rehearsal.py --cp-worker ...
        (or ``--launch-worker``, ``--statesync-worker``) is one process of
        the phase's worlds: the phase starts them through this file
        (``chip_smoke.__file__`` points here), so that each takes the
        same patches.

The patches are ``tests/torch_cards_rehearsal.py``'s (the CPU for every
``resolve_device``, ``torch.cuda``'s calls as no-ops, a fake card for each
rank and a gloo plane), with gpt_small cut to gpt_tiny on rows of 64 tokens.
The flash kernels do not launch on the CPU, so the phase's launch checks
fail here; everything else is the phase's own code and checks.
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


def patch(n_cards: int) -> None:
    import horovod_tpu_torch as pkg
    from horovod_tpu_torch import gpt_tiny
    cards.patch()
    torch.cuda.device_count = lambda: n_cards
    os.environ["CHIP_SMOKE_REHEARSAL_CARDS"] = str(n_cards)
    real_batch = pkg.synthetic_text_batch

    def small(**kw):
        kw.pop("max_seq_len", None)
        return gpt_tiny(**kw)

    def batch(rows, seq, vocab, seed=0):
        return real_batch(rows, 64, vocab, seed=seed)
    pkg.gpt_small = small
    pkg.synthetic_text_batch = batch
    chip_smoke.__file__ = os.path.abspath(__file__)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1].startswith("--"):
        patch(int(os.environ.get("CHIP_SMOKE_REHEARSAL_CARDS", "1")))
        return chip_smoke.main()
    patch(int(sys.argv[2]) if len(sys.argv) > 2 else 1)
    buf = io.StringIO()
    error = None
    with contextlib.redirect_stdout(buf):
        try:
            chip_smoke.phase_controlplane()
        except Exception as exc:  # noqa: BLE001 - reported to the caller
            error = f"{type(exc).__name__}: {exc}"
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    with open(sys.argv[1], "w") as f:
        json.dump({"lines": lines, "error": error}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
