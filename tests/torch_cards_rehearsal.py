"""A rehearsal of ``chip_smoke.py``'s cards phase on the CPU, with two
fake cards.

    python tests/torch_cards_rehearsal.py OUT.json
        runs ``chip_smoke.phase_cards()`` here and writes its printed
        lines (and its error, if it raised) to OUT.json;
    python tests/torch_cards_rehearsal.py --cards-worker MODE DIR
        is one rank of the phase's launcher world: the phase starts its
        ranks through this file (``chip_smoke.__file__`` points here), so
        that every rank takes the same patches.

The patches: the phase's sizes are gpt_tiny's and a two-stage ResNet's;
``resolve_device`` gives the CPU in every loaded ``horovod_tpu_torch``
module; ``torch.cuda`` reports two cards whose calls do nothing; each
rank offers a card of its own (``multihost.local_card``, a fake
identity) and the plane's process group is gloo, so ``hvd.init()`` forms
the device plane as it does on the cards; the one-rank NCCL group of the
references is a one-rank gloo group; card timings use the host's clock.
The two-card reduce (its own NCCL workers) and the statesync legs do not
run here.  Everything else is the phase's own code and checks.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SIZES = dict(gpt="gpt_tiny", batch=4, seq=32,
             resnet=dict(stage_sizes=(1, 1), num_filters=8, num_classes=10),
             image=16, cnn_batch=8, plane_rows=10, fused_bytes=1 << 16,
             stream_tensors=4, stream_elements=64, syncbn_shape=(2, 4, 3, 3),
             statesync=False)


class _Stream:
    def __init__(self, *args, **kwargs):
        pass


def _host_time_ms(fn, calls=1, rounds=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


@contextlib.contextmanager
def _one_rank_gloo():
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", chip_smoke._free_port(), 1,
                          is_master=True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def patch() -> None:
    import horovod_tpu_torch  # noqa: F401  (loads the modules patched)
    import horovod_tpu_torch.torch  # noqa: F401
    from horovod_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    # The launcher's ranks import the package from the repository.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    os.environ.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    chip_smoke.CARDS.update(SIZES)
    chip_smoke.CARDS_BACKEND = "gloo"
    chip_smoke.__file__ = os.path.abspath(__file__)
    chip_smoke.time_ms = _host_time_ms
    chip_smoke._one_rank_nccl = _one_rank_gloo
    chip_smoke._rank_device = lambda: torch.device("cpu")
    chip_smoke._reduce_two_cards = lambda problems: {
        "not_run": "the CPU rehearsal (its workers need two cards)"}

    def resolve_device(device=None):
        return torch.device("cpu")
    for name, mod in list(sys.modules.items()):
        if name.startswith("horovod_tpu_torch") and \
                hasattr(mod, "resolve_device"):
            mod.resolve_device = resolve_device
    cuda = torch.cuda
    cuda.is_available = lambda: True
    cuda.device_count = lambda: 2
    for fn in ("set_device", "synchronize", "reset_peak_memory_stats",
               "empty_cache"):
        setattr(cuda, fn, lambda *a, **k: None)
    cuda.max_memory_allocated = lambda *a, **k: 0
    cuda.get_device_name = lambda *a, **k: "cpu"
    cuda.Stream = _Stream
    multihost.should_init = lambda size, local_rank=0: size > 1
    multihost._card_identity = lambda index: f"rehearsal-card-{index}"
    init_group = multihost.init_process_group

    def gloo_group(*args, **kwargs):
        kwargs["backend"] = "gloo"
        return init_group(*args, **kwargs)
    multihost.init_process_group = gloo_group


def main() -> int:
    patch()
    if len(sys.argv) > 1 and sys.argv[1] == "--cards-worker":
        return chip_smoke.main()
    buf = io.StringIO()
    error = None
    with contextlib.redirect_stdout(buf):
        try:
            chip_smoke.phase_cards()
        except Exception as exc:  # noqa: BLE001 - reported to the test
            error = f"{type(exc).__name__}: {exc}"
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    with open(sys.argv[1], "w") as f:
        json.dump({"lines": lines, "error": error}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
