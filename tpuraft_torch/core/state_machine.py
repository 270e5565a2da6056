"""User state machine contract.

Reference parity: ``core:StateMachine`` + ``core:core/StateMachineAdapter``
+ ``core:core/IteratorImpl`` (SURVEY.md §9): ``on_apply(iterator)`` is the
only required method; committed entries arrive in batches through the
iterator, each with its index/term and (on the leader) the Task's done
closure.
"""

from __future__ import annotations

import logging
from typing import Awaitable, Callable, Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.entity import LogEntry
from tpuraft_torch.errors import Status

LOG = logging.getLogger(__name__)


class Iterator:
    """Batch iterator over committed DATA entries (reference: IteratorImpl).

    Usage in on_apply::

        while it.valid():
            process(it.data())
            it.next()

    ``done()`` is the leader-side completion closure (None on followers);
    the framework runs it with Status.OK() automatically after on_apply
    unless the user already ran it.
    """

    def __init__(self, entries: list[LogEntry],
                 closures: list[Optional[Callable[[Status], None]]]):
        self._entries = entries
        self._closures = closures
        self._pos = 0
        self.stopped_status: Optional[Status] = None

    def valid(self) -> bool:
        return self._pos < len(self._entries) and self.stopped_status is None

    def data(self) -> bytes:
        return self._entries[self._pos].data

    def index(self) -> int:
        return self._entries[self._pos].id.index

    def term(self) -> int:
        return self._entries[self._pos].id.term

    def done(self) -> Optional[Callable[[Status], None]]:
        return self._closures[self._pos]

    def next(self) -> None:
        self._pos += 1

    def set_error_and_rollback(self, ntail: int = 1, status: Optional[Status] = None
                               ) -> None:
        """Stop applying; the current batch from pos-ntail is not consumed
        (reference: Iterator#setErrorAndRollback)."""
        self._pos = max(0, self._pos - ntail)
        self.stopped_status = status or Status.error(10002, "state machine error")

    @property
    def applied_upto(self) -> int:
        """Last index actually consumed (pos-1's index)."""
        if self._pos == 0:
            return self._entries[0].id.index - 1 if self._entries else 0
        return self._entries[self._pos - 1].id.index


class StateMachine:
    """Override on_apply at minimum. All methods run on the node's loop,
    serialized — never call back into Node synchronously from them."""

    async def on_apply(self, it: Iterator) -> None:
        raise NotImplementedError

    async def on_shutdown(self) -> None:
        pass

    async def on_snapshot_save(self, writer, done: Callable[[Status], None]) -> None:
        """Write state into ``writer`` (SnapshotWriter), then done(OK)."""
        done(Status.error(1, "snapshot not supported"))

    async def on_snapshot_load(self, reader) -> bool:
        return False

    async def on_leader_start(self, term: int) -> None:
        pass

    async def on_leader_stop(self, status: Status) -> None:
        pass

    async def on_error(self, status: Status) -> None:
        LOG.error("raft error: %s", status)

    async def on_configuration_committed(self, conf: Configuration) -> None:
        pass

    async def on_start_following(self, leader_id, term: int) -> None:
        pass

    async def on_stop_following(self, leader_id, term: int) -> None:
        pass


# the reference ships an adapter with no-op defaults; ours IS the base class
StateMachineAdapter = StateMachine


# graftcheck: loop-confined — FSMCaller runs every callback serialized
# on the node's event loop
class WitnessStateMachine(StateMachine):
    """The null FSM a WITNESS node runs: a witness journals log
    METADATA only (its incoming appends are payload-stripped), so there
    is nothing to apply and nothing to snapshot — the applied index
    still advances through the FSMCaller (commit bookkeeping, log
    compaction), and snapshots commit empty so prefix truncation keeps
    the metadata journal bounded.  ``Node.init`` installs this
    automatically when ``NodeOptions.witness`` is set, shadowing
    whatever FSM the hosting engine wired (a KV store's FSM applying a
    stripped entry would corrupt state)."""

    async def on_apply(self, it: Iterator) -> None:
        while it.valid():      # consume: payloads were stripped upstream
            it.next()

    async def on_snapshot_save(self, writer, done: Callable[[Status], None]
                               ) -> None:
        done(Status.OK())      # empty snapshot: meta-only compaction point

    async def on_snapshot_load(self, reader) -> bool:
        return True            # nothing to load; meta advances the log
