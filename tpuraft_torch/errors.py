"""Status / error model.

Reference parity: ``core:error/RaftError`` enum and ``core:Status`` —
every async operation completes with a Status; closures become awaitables
in this build (SURVEY.md §9).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class RaftError(enum.IntEnum):
    """Error codes, mirroring the reference's RaftError enum semantics."""

    SUCCESS = 0
    UNKNOWN = 1
    # Raft protocol errors
    ERAFTTIMEDOUT = 10001      # op timed out (election, replication...)
    ESTATEMACHINE = 10002      # user state machine raised
    ECATCHUP = 10003           # peer catch-up failed (membership change)
    ELEADERREMOVED = 10004     # leader removed from configuration
    ESETPEER = 10005           # bad set-peer request
    ENODESHUTTING = 10006      # node is shutting down
    EHIGHERTERMREQUEST = 10007 # saw request with higher term
    EHIGHERTERMRESPONSE = 10008
    EBADNODE = 10009
    EVOTEFORCANDIDATE = 10010
    ENEWLEADER = 10011         # a new leader emerged; pending ops invalidated
    ELEADERCONFLICT = 10012
    ETRANSFERLEADERSHIP = 10013
    ELOGDELETED = 10014        # log entry compacted away
    ENOMOREUSERLOG = 10015
    # generic posix-flavored errors the reference reuses
    EINVAL = 22
    EIO = 5
    EAGAIN = 11
    EINTR = 4
    EBUSY = 16
    ETIMEDOUT = 110
    EPERM = 1008
    EINTERNAL = 1004
    ECANCELED = 1009
    EHOSTDOWN = 112
    ESHUTDOWN = 108
    ENOENT = 2
    EEXISTS = 17
    # transport: no handler registered for the requested method.  A
    # DEDICATED code so capability probes (send plane / heartbeat hub
    # falling back to per-item RPCs against an older receiver) match on
    # the code, not on the wording of an error message.
    ENOMETHOD = 1010


@dataclass(frozen=True)
class Status:
    """Operation outcome: code + human message. ``Status.OK()`` is success."""

    code: int = 0
    error_msg: str = ""

    @staticmethod
    def OK() -> "Status":
        return _OK

    @staticmethod
    def error(code: RaftError | int, msg: str = "") -> "Status":
        code = int(code)
        if not msg:
            try:
                msg = RaftError(code).name
            except ValueError:
                msg = f"error {code}"
        return Status(code, msg)

    def is_ok(self) -> bool:
        return self.code == 0

    @property
    def raft_error(self) -> RaftError:
        try:
            return RaftError(self.code)
        except ValueError:
            return RaftError.UNKNOWN

    def __bool__(self) -> bool:  # truthy == ok, matches reference Status#isOk usage
        return self.is_ok()

    def __str__(self) -> str:
        if self.is_ok():
            return "Status[OK]"
        return f"Status[{self.raft_error.name}<{self.code}>: {self.error_msg}]"


_OK = Status(0, "")


class RaftException(Exception):
    """Raised for fatal errors that must stop a node (reference: RaftException)."""

    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status
