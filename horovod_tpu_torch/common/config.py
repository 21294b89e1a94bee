"""The environment knobs this package reads.

The same ``HOROVOD_*`` names, types and meanings as the JAX package's
registry (``horovod_tpu/common/config.py``), kept here as a copy of the
few the port uses so that the port imports nothing of that package.  Two
things differ: a value that does not parse raises, where the registry
falls back to the default, and the default of
``STREAMING_CE_MIN_ELEMENTS`` is ``None``, which is what leaving it unset
means in the reference's training step too.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str            # environment variable
    default: Any
    parser: Callable[[str], Any]
    doc: str = ""

    def get(self) -> Any:
        """The value set in the environment, else the default; a value
        that does not parse raises."""
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        try:
            return self.parser(raw)
        except (ValueError, TypeError) as exc:
            raise ValueError(f"{self.name} must be a plain "
                             f"{self.parser.__name__} (got {raw!r})") from exc


FUSION_THRESHOLD = Knob(
    "HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024, int,
    "Tensor-fusion bucket threshold in bytes; the default of "
    "GradSyncConfig.fusion_threshold_bytes.")
TRACK_ACCURACY = Knob(
    "HOROVOD_TRACK_ACCURACY", True, _parse_bool,
    "Compute the per-step training-accuracy metric in Trainer.step.  For "
    "LM-head-sized logits the argmax is a full extra read of the logits; "
    "disable for throughput runs.")
STREAMING_CE_MIN_ELEMENTS = Knob(
    "HOROVOD_STREAMING_CE_MIN_ELEMENTS", None, int,
    "Logit-tensor element count above which the loss streams over the "
    "vocab axis; unset (None) derives the threshold from device memory "
    "(memory/16), 0 forces streaming everywhere (training.py).")
