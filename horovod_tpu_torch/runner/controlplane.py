"""The rendezvous KV's record application and digest.

The port's copy of the part of ``horovod_tpu/runner/controlplane.py``
that the in-memory KV of ``runner/network.py`` needs: ``apply_record``,
``fold_digest`` and the FNV constants.  The write-ahead log, its replay
and the replica set (``HOROVOD_RENDEZVOUS_WAL_DIR``) are ROADMAP queue A
item 12 and raise ``NotImplementedError`` at ``RendezvousServer``.
"""
from __future__ import annotations

KIND_PUT = "put"
KIND_DELETE = "delete"
KIND_CLAIM = "claim"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fold_digest(digest: int, kind: str, scope: str, key: str,
                value: bytes) -> int:
    """FNV-1a fold of one applied record into a rolling 64-bit digest."""
    for chunk in (kind.encode(), scope.encode(), key.encode(), value):
        for b in chunk:
            digest = ((digest ^ b) * _FNV_PRIME) & _MASK64
        digest = ((digest ^ 0x1F) * _FNV_PRIME) & _MASK64
    return digest


def apply_record(state: dict, kind: str, scope: str, key: str,
                 value: bytes) -> None:
    """Apply one data record to a KV state dict (``kv`` / ``counters``
    / ``claims`` / ``digest`` keys, the shape the live server mutates)."""
    if kind == KIND_PUT:
        state["kv"].setdefault(scope, {})[key] = value
    elif kind == KIND_DELETE:
        if key:
            state["kv"].get(scope, {}).pop(key, None)
        else:
            state["kv"].pop(scope, None)
    elif kind == KIND_CLAIM:
        # value = b"claimant|index": the index assigned at commit time.
        claimant, _, idx = value.decode().rpartition("|")
        n = int(idx)
        ckey = f"{scope}/{key}"
        state["counters"][ckey] = max(state["counters"].get(ckey, 0),
                                      n + 1)
        if claimant:
            state["claims"].setdefault(ckey, {})[claimant] = n
    else:
        return
    state["digest"] = fold_digest(state.get("digest", _FNV_OFFSET),
                                  kind, scope, key, value)
