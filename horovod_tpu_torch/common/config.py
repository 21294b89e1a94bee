"""The environment knobs this package reads.

The same ``HOROVOD_*`` names, types and meanings as the JAX package's
registry (``horovod_tpu/common/config.py``), kept here as a copy of the
ones the port uses so that the port imports nothing of that package.  Two
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


# --- Inference serving (serving/; the reference's docs/serving.md) ----------
SERVE_MAX_BATCH = Knob(
    "HOROVOD_SERVE_MAX_BATCH", 8, int,
    "Decode slots per replica: the continuous batcher admits new "
    "requests into in-flight decode batches up to this many concurrent "
    "sequences per replica (the KV cache is allocated for exactly this "
    "batch).")
SERVE_TOKEN_BUDGET = Knob(
    "HOROVOD_SERVE_TOKEN_BUDGET", 256, int,
    "Per-replica token budget of one serve step: prefill tokens of newly "
    "admitted requests plus one decode token per active slot must fit; "
    "the batcher defers admissions that would exceed it.")
SERVE_QUEUE_DEPTH = Knob(
    "HOROVOD_SERVE_QUEUE_DEPTH", 1024, int,
    "Front-end ingress queue bound; submissions beyond it are shed at "
    "the door, never buffered.")
SERVE_SLO_MS = Knob(
    "HOROVOD_SERVE_SLO_MS", 30000.0, float,
    "Default per-request SLO in ms, stamped as an absolute deadline at "
    "ingress; admission sheds a request that cannot finish inside it.")
SERVE_SHED_QUEUE_FRACTION = Knob(
    "HOROVOD_SERVE_SHED_QUEUE_FRACTION", 0.9, float,
    "Admission sheds new requests while the queue depth exceeds this "
    "fraction of HOROVOD_SERVE_QUEUE_DEPTH.")
SERVE_MAX_SEQ = Knob(
    "HOROVOD_SERVE_MAX_SEQ", 256, int,
    "KV-cache length per decode slot (prompt + generated tokens).")
SERVE_GROUP_SIZE = Knob(
    "HOROVOD_SERVE_GROUP_SIZE", 1, int,
    "Ranks per serving replica group: 1 = pure data-parallel; N > 1 runs "
    "each group's members in lockstep on identical batch plans.  Must "
    "divide the world size, else it falls back to 1.")
SERVE_PAGED = Knob(
    "HOROVOD_SERVE_PAGED", False, _parse_bool,
    "Paged KV cache (serving/kvpool.py): slot KV state lives in "
    "fixed-size blocks from a per-replica pool, with prefix caching and "
    "copy-on-write block sharing.")
SERVE_BLOCK_TOKENS = Knob(
    "HOROVOD_SERVE_BLOCK_TOKENS", 16, int,
    "Tokens per KV block under HOROVOD_SERVE_PAGED: the unit of "
    "allocation, prefix hashing and copy-on-write.")
SERVE_POOL_BLOCKS = Knob(
    "HOROVOD_SERVE_POOL_BLOCKS", 0, int,
    "KV blocks in the per-replica paged pool (0 = auto: "
    "HOROVOD_SERVE_MAX_BATCH x ceil(max_seq / block_tokens), the dense "
    "layout's token memory).")
SERVE_PAGED_SLOTS = Knob(
    "HOROVOD_SERVE_PAGED_SLOTS", 0, int,
    "Decode slots per replica under HOROVOD_SERVE_PAGED (0 = auto: 2 x "
    "HOROVOD_SERVE_MAX_BATCH), backed by the shared block pool.")
SERVE_MAX_DEFERRALS = Knob(
    "HOROVOD_SERVE_MAX_DEFERRALS", 8, int,
    "Steps a queued prompt may be deferred before the batcher turns it "
    "urgent (it then bypasses the token budget and holds back everything "
    "behind it), so small prompts cannot starve a large one.")
SERVE_PREFILL_RANKS = Knob(
    "HOROVOD_SERVE_PREFILL_RANKS", 0, int,
    "Disaggregated prefill/decode: the highest N ranks prefill only and "
    "stream KV blocks to the decode ranks.  Not ported (ROADMAP queue A "
    "items 8 and 11): a value above 0 raises NotImplementedError.")
