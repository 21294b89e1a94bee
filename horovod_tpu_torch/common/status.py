"""Status type threaded through every collective operation.

The port's copy of ``horovod_tpu/common/status.py``.

TPU-native analogue of the reference Status class
(reference: horovod/common/common.h:138-196): a collective either completes
OK, is still IN_PROGRESS (async), was ABORTED at shutdown, hit an
INVALID_ARGUMENT (cross-rank mismatch) or a generic ERROR.  The reference
delivers these to user callbacks instead of hanging — "mismatch → structured
error, not hang" is a first-class behavior we preserve.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class StatusType(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclass(frozen=True)
class Status:
    type: StatusType = StatusType.OK
    reason: str = field(default="")

    @staticmethod
    def ok() -> "Status":
        return _OK

    @staticmethod
    def unknown_error(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def precondition_error(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def invalid_argument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)

    @staticmethod
    def ranks_failed(exc) -> "Status":
        """A collective observed dead/unreachable ranks (resilience/).
        The structured attribution rides the reason string in
        RanksFailedError wire form so it survives both the in-process
        Status path and the Response.error_message wire field;
        raise_if_error re-raises the typed exception."""
        return Status(StatusType.UNKNOWN_ERROR, exc.to_wire())

    @staticmethod
    def in_progress() -> "Status":
        return _IN_PROGRESS

    def ok_p(self) -> bool:
        return self.type == StatusType.OK

    def in_progress_p(self) -> bool:
        return self.type == StatusType.IN_PROGRESS

    def raise_if_error(self) -> None:
        if self.type in (StatusType.OK, StatusType.IN_PROGRESS):
            return
        from .exceptions import HorovodInternalError, RanksFailedError

        if RanksFailedError.matches(self.reason):
            raise RanksFailedError.from_wire(self.reason)
        raise HorovodInternalError(self.reason or self.type.name)


_OK = Status(StatusType.OK, "")
_IN_PROGRESS = Status(StatusType.IN_PROGRESS, "")
