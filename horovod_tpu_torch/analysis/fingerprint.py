"""Runtime collective fingerprinting.

The port's own copy of ``horovod_tpu/analysis/fingerprint.py``, with its
own copy of ``fold_token`` (``horovod_tpu/analysis/hvdshard/specs.py``).
The divergence report's text is the reference's, word for word, its hints
at the reference's static passes included (those passes are ROADMAP
queue A item 12 in the port).

Every rank folds each submitted collective request — (op, tensor name,
dtype, dims, codec) — into a rolling 64-bit hash, in submission order.
The per-rank (sequence, digest) pair plus a bounded tail of recent op
records ride the existing RequestList gather, so the coordinator can
compare the streams whenever negotiation happens and turn cross-rank
divergence into a structured ``Response.ERROR`` naming the FIRST
divergent op — long before the stall inspector's 60s warning, and
instead of the silent hang the reference runtime exhibits when ranks
disagree on *which* collectives to run (the controller's per-tensor
validation only catches disagreement on a collective's *parameters*).

Modes (``HOROVOD_FINGERPRINT``):

- ``off``    — no folding, no wire overhead (default).
- ``cycle``  — fingerprints compared on every natural negotiation cycle.
  Cache steady state (which never ships RequestLists) is not re-checked
  until the next negotiation, so detection can lag by however long the
  cache keeps hitting.
- ``strict`` — additionally forces a negotiation heartbeat every cycle,
  so divergence is caught within one background-loop cycle even in cache
  steady state, at the cost of steady-state RequestList traffic.

The comparison is sequence-aligned: ranks legitimately run ahead of each
other (that transient is the stall inspector's domain), so digests are
only compared at the highest sequence number every rank has reached, and
the divergence point is located by walking the shipped tails backward to
the smallest commonly-visible sequence where digests disagree.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..common import config
from ..common.message import Request, RequestType

_MASK = (1 << 64) - 1
_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3


def fold_token(op: str, token: str) -> str:
    """The sharding-spec token as folded into the cross-rank fingerprint:
    ALLGATHER's first dim is rank-local by contract (the uneven-row
    gather rule in ``describe``), so its dim-0 spec entry folds as
    ``*``."""
    if op != "ALLGATHER" or not token.startswith("("):
        return token
    inner = token[1:-1].split(",")
    inner[0] = "*"
    return "(" + ",".join(inner) + ")"


def _fnv1a(data: bytes, h: int = _FNV_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


class FingerprintMode(enum.Enum):
    OFF = "off"
    CYCLE = "cycle"
    STRICT = "strict"

    @classmethod
    def parse(cls, raw: str) -> "FingerprintMode":
        try:
            return cls(str(raw).strip().lower())
        except ValueError:
            return cls.OFF


@dataclass(frozen=True)
class OpRecord:
    """One folded op: the rolling digest AFTER folding it."""
    seq: int
    digest: int
    descriptor: str

    @property
    def tensor_name(self) -> str:
        parts = self.descriptor.split("|")
        return parts[1] if len(parts) > 1 else self.descriptor


@dataclass
class Divergence:
    """First cross-rank disagreement the coordinator could locate."""
    seq: int
    # rank -> descriptor at `seq` (only ranks whose tail still covers it).
    descriptors: dict[int, str] = field(default_factory=dict)
    exact: bool = True   # False: diverged at-or-before `seq` (window edge)

    def tensor_names(self) -> list[str]:
        names = []
        for desc in self.descriptors.values():
            parts = desc.split("|")
            name = parts[1] if len(parts) > 1 else desc
            if name not in names:
                names.append(name)
        return sorted(names)

    def _spec_divergent(self) -> bool:
        """True when any located descriptor carries a sharding-spec
        column (the op×spec identity class: ops may agree while the
        spec disagrees)."""
        return any(len(d.split("|")) >= 6 and d.split("|")[5]
                   for d in self.descriptors.values())

    def message(self) -> str:
        by_rank = ", ".join(
            f"rank {r}: {_pretty(d)}"
            for r, d in sorted(self.descriptors.items()))
        where = (f"at op #{self.seq}" if self.exact
                 else f"at or before op #{self.seq} (divergence predates "
                      f"the fingerprint window; raise "
                      f"HOROVOD_FINGERPRINT_WINDOW to pin it exactly)")
        if self._spec_divergent():
            hint = (f"Every rank must submit the same collectives — "
                    f"op, name, dims AND sharding spec — in the same "
                    f"order; check for rank-gated collective or spec "
                    f"choices (hvdshard: python -m "
                    f"horovod_tpu.analysis.lint --shard reports the "
                    f"same spec-annotated per-arm streams as HVD803).")
        else:
            hint = (f"Every rank must submit the same collectives in "
                    f"the same order; check for rank-gated collective "
                    f"calls (hvdlint/hvdflow: python -m "
                    f"horovod_tpu.analysis.lint --flow reports the "
                    f"same per-arm op streams as HVD601).")
        return (f"Collective fingerprint divergence {where}: {by_rank}. "
                + hint)


def _pretty(descriptor: str) -> str:
    parts = descriptor.split("|")
    if len(parts) >= 4:
        op, name, dtype, dims = parts[:4]
        shape = dims or "scalar"
        if len(parts) >= 6 and parts[5]:
            return f"{op}({name}, {dtype}, shape={shape}, spec={parts[5]})"
        return f"{op}({name}, {dtype}, shape={shape})"
    return descriptor


def describe(req: Request, with_spec: bool = False) -> str:
    """Canonical descriptor folded into the hash:
    op|name|dtype|dims|codec[|spec].

    ALLGATHER's FIRST dim is rank-local by contract (uneven-row gather
    is the documented semantic — allgather_object payloads, serving
    completion exchanges), so it folds as ``*``: a cross-rank digest
    that included it would flag every legitimate uneven gather as a
    divergence.  Trailing dims must still agree.

    With ``with_spec`` (the tracker's fold_spec flag), a non-empty ``sp_spec`` token appends as a sixth column —
    folded through :func:`fold_token`, which wildcards
    ALLGATHER's rank-local dim-0 entry exactly like the shape rule
    above.  Unannotated requests keep the 5-column descriptor
    byte-identical to pre-sharding builds."""
    shape = list(req.tensor_shape)
    parts = [str(int(d)) for d in shape]
    from ..common.message import RequestType
    if req.request_type == RequestType.ALLGATHER and parts:
        parts[0] = "*"
    dims = "x".join(parts)
    desc = (f"{req.request_type.name}|{req.tensor_name}|"
            f"{req.tensor_type.name}|{dims}|"
            f"{req.codec}/{req.codec_block_size}")
    spec = getattr(req, "sp_spec", "")
    if with_spec and spec:
        desc += "|" + fold_token(req.request_type.name, spec)
    return desc


class FingerprintTracker:
    """Per-rank rolling fingerprint + coordinator-side comparison.

    Single-threaded by design: fold/snapshot run on the background
    coordination thread only (the same thread that owns the controller),
    so no locking is needed.
    """

    def __init__(self, mode: FingerprintMode | str = FingerprintMode.OFF,
                 window: int = 64) -> None:
        if isinstance(mode, str):
            mode = FingerprintMode.parse(mode)
        self.mode = mode
        self.window = max(int(window), 1)
        # Spec column gate.  The core leaves it on: no request the port
        # builds carries an ``sp_spec`` token, so the column folds only
        # for requests decoded from a peer that sent one.
        self.fold_spec = True
        self.seq = 0
        self.digest = _FNV_OFFSET
        self._tail: list[OpRecord] = []
        self._reported = False

    @classmethod
    def from_config(cls) -> "FingerprintTracker":
        return cls(FingerprintMode.parse(config.FINGERPRINT.get()),
                   config.FINGERPRINT_WINDOW.get())

    @property
    def enabled(self) -> bool:
        return self.mode is not FingerprintMode.OFF

    @property
    def strict(self) -> bool:
        return self.mode is FingerprintMode.STRICT

    # --- worker side -------------------------------------------------------
    def fold(self, req: Request) -> None:
        """Fold one submitted request, once (re-queued cache hits pass
        through compute_response_list again and must not double-count).
        JOIN is excluded: joining is rank-asymmetric by design."""
        if not self.enabled or req.request_type == RequestType.JOIN:
            return
        if getattr(req, "_fp_folded", False):
            return
        req._fp_folded = True  # type: ignore[attr-defined]
        desc = describe(req, with_spec=self.fold_spec)
        self.seq += 1
        self.digest = _fnv1a(desc.encode(), self.digest)
        self._tail.append(OpRecord(self.seq, self.digest, desc))
        if len(self._tail) > self.window:
            del self._tail[0]

    def snapshot(self) -> tuple[int, int, list[OpRecord]]:
        return self.seq, self.digest, list(self._tail)

    # --- coordinator side --------------------------------------------------
    def check_gathered(
            self,
            per_rank: list[tuple[int, int, list[OpRecord]]]
    ) -> Divergence | None:
        """Compare gathered (seq, digest, tail) triples; None = consistent
        (or not comparable yet).  Reports at most once per tracker: a
        divergent stream stays divergent, and one structured error is the
        actionable signal — repeating it every cycle would bury it."""
        if not self.enabled or self._reported or len(per_rank) < 2:
            return None
        div = find_divergence(per_rank)
        if div is not None:
            self._reported = True
        return div

    def reset(self) -> None:
        self.seq = 0
        self.digest = _FNV_OFFSET
        self._tail.clear()
        self._reported = False


def find_divergence(
        per_rank: list[tuple[int, int, list[OpRecord]]]
) -> Divergence | None:
    """Locate the first divergent op across per-rank fingerprint streams.

    Digests are comparable only at equal sequence numbers, so the probe
    set is the intersection of sequences every rank can still produce a
    digest for (its current head plus its shipped tail), capped at the
    slowest rank's head.  Within that set the first sequence where
    digests disagree is the divergence point; if even the earliest
    commonly-visible sequence disagrees, the true first divergence
    scrolled out of the window and is reported as inexact.
    """
    heads = [seq for seq, _, _ in per_rank]
    common_head = min(heads)
    if common_head <= 0:
        return None

    # rank -> {seq: digest}, rank -> {seq: descriptor}
    digests: list[dict[int, int]] = []
    descs: list[dict[int, str]] = []
    for seq, digest, tail in per_rank:
        d = {rec.seq: rec.digest for rec in tail}
        d[seq] = digest
        digests.append(d)
        descs.append({rec.seq: rec.descriptor for rec in tail})

    probe_seqs = set(digests[0])
    for d in digests[1:]:
        probe_seqs &= set(d)
    probe_seqs = sorted(s for s in probe_seqs if 0 < s <= common_head)
    if not probe_seqs:
        return None   # windows no longer overlap: not comparable

    latest = probe_seqs[-1]
    if len({d[latest] for d in digests}) == 1:
        return None   # consistent up to the slowest rank's head

    first = next(s for s in probe_seqs
                 if len({d[s] for d in digests}) > 1)
    # `first` is exact iff an earlier probe sequence agreed (every probe
    # before `first` did, by construction) or it is op #1; when the
    # earliest commonly-visible sequence already disagrees, the true
    # first divergence scrolled out of the window.
    exact = first == 1 or probe_seqs[0] < first
    divergence = Divergence(seq=first, exact=exact)
    for rank, dd in enumerate(descs):
        if first in dd:
            divergence.descriptors[rank] = dd[first]
    if not divergence.descriptors:
        # Head-only digest (empty tails): name nothing but still report.
        divergence.exact = False
    return divergence
