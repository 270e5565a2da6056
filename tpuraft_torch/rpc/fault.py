"""FaultInjectingTransport: drops/delays/partitions over ANY transport.

The in-proc loopback has fault injection built in (the reference's
TestCluster pattern); this wrapper adds the same injection surface on
top of the real-socket transports (asyncio TCP, native epoll), so
chaos and adversarial drives run against production wire paths too.

A dropped call raises EHOSTDOWN after a short delay, modeling a lost
request the way the loopback does; the caller's retry/timeout machinery
reacts identically either way.

Beyond drop/delay/partition it injects the two other classic network
faults: **duplication** (the request is delivered and EXECUTED twice at
the receiver; the duplicate's response is discarded — receiver handlers
must be idempotent) and **bounded reordering** (a frame is held for a
random bounded interval so later frames overtake it).

Geo shaping: an attached :class:`~tpuraft.rpc.topology.NetworkTopology`
adds per-link (zone x zone, per-direction) latency/jitter/loss/
bandwidth on TOP of the global knobs.  The two fault layers compose and
heal independently: :meth:`FaultInjectingTransport.heal` clears only
the nemesis layer (per-destination blocks), while
:meth:`heal_topology` clears only the topology's DYNAMIC events
(degrades / zone partitions / flaps) — a nemesis action healing its
noise can no longer stomp the standing WAN shape, and vice versa.
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, Optional

from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rpc.topology import NetworkTopology
from tpuraft_torch.rpc.transport import RpcError, TransportBase


class FaultInjectingTransport(TransportBase):
    def __init__(self, inner: TransportBase, seed: Optional[int] = None):
        self._inner = inner
        self.endpoint = inner.endpoint
        self._rng = random.Random(seed)
        self.drop_rate = 0.0
        self.delay_ms = 0.0
        self.duplicate_rate = 0.0
        self.reorder_rate = 0.0
        self.reorder_max_delay_ms = 10.0
        self._blocked_dsts: set[str] = set()
        # geo shaping: per-link latency/jitter/loss/bandwidth matrix;
        # usually one shared topology across every store's transport
        self.topology: Optional[NetworkTopology] = None

    # -- injection controls --------------------------------------------------

    def set_drop_rate(self, rate: float) -> None:
        self.drop_rate = rate

    def set_delay_ms(self, ms: float) -> None:
        self.delay_ms = ms

    def set_duplicate_rate(self, rate: float) -> None:
        """Each call is delivered (and executed) twice with probability
        ``rate``; the duplicate's response is discarded."""
        self.duplicate_rate = rate

    def set_reorder(self, rate: float, max_delay_ms: float = 10.0) -> None:
        """With probability ``rate``, hold a frame for a seeded random
        interval in (0, max_delay_ms] so later frames overtake it —
        bounded reordering, never starvation."""
        self.reorder_rate = rate
        self.reorder_max_delay_ms = max_delay_ms

    def block(self, dst: str) -> None:
        """Partition: calls to dst fail (one-way, from this side)."""
        self._blocked_dsts.add(dst)

    def unblock(self, dst: str) -> None:
        self._blocked_dsts.discard(dst)

    def set_topology(self, topology: Optional[NetworkTopology]) -> None:
        self.topology = topology

    def heal(self) -> None:
        """Heal the NEMESIS layer only: per-destination blocks.  The
        topology's standing shape AND its dynamic events survive — a
        noise action's heal must not silently flatten the WAN."""
        self._blocked_dsts.clear()

    def heal_topology(self) -> None:
        """Heal the TOPOLOGY layer only: clears dynamic events
        (degrades / zone partitions / flaps) on the attached topology;
        the base zone matrix and any nemesis-layer blocks stay."""
        if self.topology is not None:
            self.topology.heal_events()

    # -- transport surface ---------------------------------------------------

    async def call(self, dst: str, method: str, request: Any,
                   timeout_ms: Optional[float] = None) -> Any:
        if self.topology is not None:
            await self.topology.traverse(self.endpoint, dst, request,
                                         timeout_ms)
        if self.reorder_rate > 0 and self._rng.random() < self.reorder_rate:
            # hold THIS frame so later-submitted frames overtake it
            await asyncio.sleep(
                self._rng.uniform(0.0, self.reorder_max_delay_ms) / 1000.0)
        if self.delay_ms > 0:
            await asyncio.sleep(self.delay_ms / 1000.0)
        if dst in self._blocked_dsts or (
                self.drop_rate > 0 and self._rng.random() < self.drop_rate):
            # match the loopback's drop behavior (transport.py): a lost
            # request is only detected after a wait, so callers' timeout
            # and backoff machinery engages instead of hot-loop retrying
            wait_ms = min(timeout_ms, 50.0) if timeout_ms else 50.0
            await asyncio.sleep(wait_ms / 1000.0)
            raise RpcError(Status.error(
                RaftError.EHOSTDOWN, f"injected drop to {dst}"))
        if self.duplicate_rate > 0 \
                and self._rng.random() < self.duplicate_rate:
            # the wire delivered the frame twice: the receiver executes
            # both; we return the first response and drop the other's
            dup = asyncio.ensure_future(
                self._inner.call(dst, method, request, timeout_ms))
            dup.add_done_callback(
                lambda t: t.cancelled() or t.exception())
        return await self._inner.call(dst, method, request, timeout_ms)

    async def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            await close()
