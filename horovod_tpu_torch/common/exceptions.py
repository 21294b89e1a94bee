"""Exception hierarchy (reference: horovod/common/exceptions.py:19-46).

The port's copy of ``horovod_tpu/common/exceptions.py``.

`HorovodInternalError` signals a failed collective — in elastic mode the
training loop catches it, restores the last committed state and
re-rendezvouses.  `HostsUpdatedInterrupt` is raised proactively when host
membership changed so workers can re-form the mesh without losing state.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """Internal error raised when a collective routine fails.

    In elastic mode this triggers state restore + re-rendezvous
    (reference: horovod/common/elastic.py:151-175).
    """


class HorovodVersionMismatchError(HorovodInternalError):
    pass


class HostsUpdatedInterrupt(HorovodTpuError):
    """Host membership changed; re-rendezvous without restoring state.

    ``skip_sync`` mirrors the reference's distinction between an immediate
    update (state already consistent) and one discovered after a failure.
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class RanksFailedError(HorovodInternalError, ConnectionError):
    """One or more ranks died, became unreachable, or missed a collective
    deadline; the hang was converted into this structured, attributed
    error (resilience/; docs/resilience.md).

    Subclasses :class:`HorovodInternalError` so the elastic retry loop's
    restore/re-rendezvous path fires unchanged, and :class:`ConnectionError`
    so pre-resilience transport-failure handlers keep working.

    ``failed_ranks`` is the set of ranks believed dead/unreachable, ``op``
    names the collective that observed the failure, ``phase`` the blocking
    wait that expired (``recv``/``send``/``gather``/``shm_barrier``/...).
    """

    _WIRE_RE = None   # compiled lazily; see from_wire

    def __init__(self, failed_ranks, op: str = "", phase: str = "",
                 message: str = ""):
        self.failed_ranks = frozenset(int(r) for r in failed_ranks)
        self.op = op
        self.phase = phase
        self.detail = message
        super().__init__(self.to_wire())

    def to_wire(self) -> str:
        """Stable one-line form that survives Status.reason and the
        Response.error_message wire field; parse back with from_wire."""
        ranks = ",".join(str(r) for r in sorted(self.failed_ranks))
        head = f"[ranks-failed ranks={ranks} op={self.op} " \
               f"phase={self.phase}]"
        tail = self.detail or (
            f"rank(s) {{{ranks}}} failed or became unreachable during "
            f"'{self.op or 'collective'}' ({self.phase or 'wait'}); the "
            f"hang was converted into this error by the resilience "
            f"layer (HOROVOD_FAULT_TIMEOUT).")
        return f"{head} {tail}"

    @staticmethod
    def matches(message: str) -> bool:
        return bool(message) and message.startswith("[ranks-failed ")

    @classmethod
    def from_wire(cls, message: str) -> "RanksFailedError":
        import re
        if cls._WIRE_RE is None:
            cls._WIRE_RE = re.compile(
                r"^\[ranks-failed ranks=([\d,]*) op=([^ \]]*) "
                r"phase=([^ \]]*)\] ?(.*)$", re.S)
        m = cls._WIRE_RE.match(message or "")
        if not m:
            return cls(frozenset(), message=message)
        ranks = [int(r) for r in m.group(1).split(",") if r]
        return cls(ranks, op=m.group(2), phase=m.group(3),
                   message=m.group(4))


class NotSupportedError(HorovodTpuError):
    """Requested operation is not supported on this backend/topology."""


class TensorShapeMismatchError(HorovodTpuError):
    """Cross-rank tensor shape mismatch detected by the controller."""


class TensorDtypeMismatchError(HorovodTpuError):
    """Cross-rank tensor dtype mismatch detected by the controller."""
