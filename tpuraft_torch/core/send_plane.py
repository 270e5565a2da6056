"""SendPlane: one batched sender per destination endpoint.

The TPU-native answer to the reference's per-(group, peer) sender
threads (``core:Replicator`` posting to shared ``Utils.cpus()``
executors — SURVEY.md §3.5 "Replication pipelining", §8.2 "the host
applies device outputs (send-plans)"): with thousands of raft groups
multiplexed on a handful of process endpoints, per-group vote fanouts
and per-(group, peer) replication tasks cost O(G x P) standing asyncio
tasks — the measured 16K-group election-starvation wall
(BENCH_SCALE.json r3).  Here every protocol send targeting one endpoint
is enqueued to that endpoint's :class:`EndpointSender`, whose single
drain task packs everything pending into ONE ``multi_append`` /
``multi_vote`` RPC (a :class:`~tpuraft.rpc.messages.BatchRequest`) per
round trip.  Standing tasks become O(endpoints); responses fan back out
as short-lived per-group tasks only when they arrive.

The per-tick send *plan* stays host-event-driven (log appends, acks and
the engine's event masks trigger :meth:`Replicator.pump`); the plane is
the dispatch layer that turns those plans into endpoint-batched wire
traffic — the generalization of HeartbeatHub from beats to votes and
entry-bearing AppendEntries.

Ordering contract: ONE drain RPC in flight per endpoint (stop-and-wait
per endpoint pair, windowed WITHIN the batch), and a group submits at
most one append batch at a time — so a group's frames can never race
each other across RPCs, and the receiver (NodeManager._handle_multi_
append) only needs in-batch per-group ordering.  Throughput per group
is window x batch per endpoint round trip, same as the former
per-(group, peer) inflight FIFO, but the round trip is shared by every
group on the endpoint pair.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Optional

from tpuraft_torch.rpc.messages import BatchRequest, ErrorResponse
from tpuraft_torch.rpc.transport import RpcError, is_no_method

LOG = logging.getLogger(__name__)


def _consume(t: "asyncio.Task") -> None:
    if not t.cancelled():
        t.exception()


# graftcheck: loop-confined — the queue/lane state is only touched by
# submit_* calls and drain tasks on the owning process's event loop
class EndpointSender:
    """Batches every pending protocol send to one destination endpoint.

    Items:
      - votes: (node, RequestVoteRequest, async cb) — cb fires as its
        own short task per response; silence on error (same contract as
        a dropped direct RPC).
      - append batches: (replicator, [AppendEntriesRequest, ...]) — the
        whole batch resolves through replicator.on_batch_responses /
        on_batch_error, in send order.

    Two lanes: appends keep strict ONE-RPC-in-flight stop-and-wait (the
    per-group ordering contract); votes have NO ordering constraint, so
    they drain on their own lane with several chunked RPCs in flight —
    an election herd at high group counts must not queue behind the
    appends' round trips or behind its own serialization (a 16K-group
    herd's votes per endpoint pair otherwise drain slower than the
    vote-round timeout, and no round ever completes).
    """

    # cap per append RPC: bounds receiver fan-out burst (each item may
    # carry entries + a disk flush) and response-task burst
    MAX_ITEMS_PER_RPC = 128
    # votes are tiny (no entries, no disk): bigger chunks, more lanes
    MAX_VOTES_PER_RPC = 1024
    VOTE_LANES = 4

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self._votes: list[tuple[object, object, Callable]] = []
        self._appends: list[tuple[object, list, float]] = []
        self._task: Optional[asyncio.Task] = None
        self._round_pending: list[tuple[object, list, float]] = []
        self._vote_tasks: set = set()
        self._transport = None
        self._legacy = False  # receiver lacks multi_* handlers
        self.rpcs_sent = 0
        self.items_sent = 0

    # -- submit --------------------------------------------------------------

    def submit_vote(self, node, req, cb) -> None:
        self._votes.append((node, req, cb))
        self._transport = node.transport
        self._kick_votes()

    def submit_append(self, replicator, reqs: list) -> None:
        node = replicator._node
        self._appends.append(
            (replicator, reqs, node.options.election_timeout_ms))
        self._transport = node.transport
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._drain())
            self._task.add_done_callback(_consume)

    def _kick_votes(self) -> None:
        while self._votes and len(self._vote_tasks) < self.VOTE_LANES:
            chunk = self._votes[:self.MAX_VOTES_PER_RPC]
            del self._votes[:self.MAX_VOTES_PER_RPC]
            items = [req for _n, req, _cb in chunk]
            routes = [("v", cb, node) for node, _req, cb in chunk]
            # groups with DIFFERENT election timeouts share the chunk:
            # budget for the slowest, or a short-timeout group submitted
            # last would expire every co-batched long-timeout group's
            # round early (and vice versa starve retries)
            timeout_ms = max(n.options.election_timeout_ms
                             for _k, _cb, n in routes)
            t = asyncio.ensure_future(
                self._send_chunk(items, routes, timeout_ms))
            self._vote_tasks.add(t)

            def _done(tt, self=self):
                self._vote_tasks.discard(tt)
                _consume(tt)
                self._kick_votes()  # drain what queued meanwhile

            t.add_done_callback(_done)

    def queued(self) -> int:
        return len(self._votes) + sum(len(r) for _, r, _t in self._appends)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for t in list(self._vote_tasks):
            t.cancel()
        self._vote_tasks.clear()
        self._fail_all()

    def _fail_all(self) -> None:
        votes, self._votes = self._votes, []
        appends, self._appends = self._appends, []
        # the in-flight round's unresolved batches too: stranding them
        # would leave their replicators _pending=True forever (pump
        # gated, replication silently stopped for the pair)
        pending, self._round_pending = self._round_pending, []
        for rep, *_ in pending + appends:
            self._spawn(rep.on_batch_error())
        del votes  # silence, like a dropped RPC

    @staticmethod
    def _spawn(coro) -> None:
        t = asyncio.ensure_future(coro)
        t.add_done_callback(_consume)

    # -- drain ---------------------------------------------------------------

    async def _drain(self) -> None:
        """Append lane: strictly sequential chunk RPCs (the per-group
        ordering contract)."""
        try:
            while self._appends:
                appends, self._appends = self._appends, []
                await self._round(appends)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a sender bug must not silence
            LOG.exception("endpoint sender %s crashed", self.endpoint)
            self._fail_all()

    async def _round(self, appends) -> None:
        # an append batch never straddles chunks (its responses resolve
        # as one unit), and chunks go out strictly sequentially so
        # per-group order holds regardless.  _round_pending tracks the
        # not-yet-resolved tail so a mid-round cancel/crash can fail
        # exactly the stranded batches (see _fail_all).
        self._round_pending = list(appends)
        chunk_items: list = []
        chunk_routes: list = []  # ("a", rep, count)
        chunk_timeout = 0.0

        async def flush_chunk():
            nonlocal chunk_timeout
            if not chunk_items:
                return
            items, routes = list(chunk_items), list(chunk_routes)
            timeout_ms, chunk_timeout = chunk_timeout, 0.0
            chunk_items.clear()
            chunk_routes.clear()
            await self._send_chunk(items, routes, timeout_ms)
            done = {id(r[1]) for r in routes}
            self._round_pending = [b for b in self._round_pending
                                   if id(b[0]) not in done]

        for rep, reqs, tmo in appends:
            if chunk_items and (
                    len(chunk_items) + len(reqs) > self.MAX_ITEMS_PER_RPC):
                await flush_chunk()
            chunk_items.extend(reqs)
            chunk_routes.append(("a", rep, len(reqs)))
            chunk_timeout = max(chunk_timeout, tmo)  # budget for slowest
        await flush_chunk()

    async def _send_chunk(self, items: list, routes: list,
                          timeout_ms: float) -> None:
        if self._legacy:
            await self._send_legacy(items, routes)
            return
        method = "multi_vote" if routes[0][0] == "v" else "multi_append"
        self.rpcs_sent += 1
        self.items_sent += len(items)
        try:
            resp = await self._transport.call(
                self.endpoint, method, BatchRequest(items=items),
                timeout_ms=timeout_ms)
            acks = resp.items
        except RpcError as e:
            if is_no_method(e):
                # receiver predates the batch plane: resend these as
                # single RPCs and stay legacy for this endpoint
                self._legacy = True
                await self._send_legacy(items, routes)
                return
            self._dispatch_error(routes)
            return
        except Exception:  # noqa: BLE001
            LOG.exception("batch RPC to %s failed", self.endpoint)
            self._dispatch_error(routes)
            return
        if len(acks) != len(items):
            self._dispatch_error(routes)
            return
        i = 0
        slow_votes = []
        for route in routes:
            if route[0] == "v":
                ack = acks[i]
                i += 1
                if not isinstance(ack, ErrorResponse):
                    # INLINE, not spawned, when the node's meta storage
                    # is volatile: a 16K-group election herd's response
                    # tasks otherwise pile up faster than the loop
                    # drains them (measured: 35K stacked tasks, tick
                    # rate collapsed 5x, zero groups converging).
                    # Inline consumption is the backpressure — the next
                    # vote chunk only ships once this chunk's responses
                    # are processed.  With DURABLE meta a winning round
                    # fsyncs {term, votedFor} inside the handler, which
                    # must not head-of-line-block up to 1023 sibling
                    # responses — those gather below instead.
                    node = route[2]
                    if getattr(node._meta, "SYNC_CHEAP", False):
                        try:
                            await route[1](ack)
                        except Exception:  # noqa: BLE001 — one group's
                            LOG.exception("vote response handler failed")
                    else:
                        slow_votes.append(route[1](ack))
            else:
                _k, rep, count = route
                self._spawn(rep.on_batch_responses(acks[i:i + count]))
                i += count
        if slow_votes:
            # ONE awaited gather instead of len(slow_votes) spawned
            # tasks: task count stays O(vote lanes), the handlers run
            # concurrently — so their meta fsyncs coalesce into shared
            # group-commit rounds (multimeta://) — and awaiting inline
            # keeps the lane's backpressure: the next vote chunk ships
            # only after this chunk's {term, votedFor} persists land.
            for r in await asyncio.gather(*slow_votes,
                                          return_exceptions=True):
                if isinstance(r, BaseException) and not isinstance(
                        r, asyncio.CancelledError):
                    LOG.error("vote response handler failed: %r", r)

    def _dispatch_error(self, routes) -> None:
        for route in routes:
            if route[0] == "a":
                self._spawn(route[1].on_batch_error())
            # votes: silence, like a dropped direct RPC

    async def _send_legacy(self, items: list, routes: list) -> None:
        """Per-item RPCs for receivers without batch handlers."""
        i = 0
        for route in routes:
            if route[0] == "v":
                req, cb, node = items[i], route[1], route[2]
                i += 1

                async def one_vote(req=req, cb=cb, node=node):
                    try:
                        resp = await node.transport.request_vote(
                            self.endpoint, req,
                            timeout_ms=node.options.election_timeout_ms)
                    except RpcError:
                        return
                    await cb(resp)

                self._spawn(one_vote())
            else:
                _k, rep, count = route
                reqs = items[i:i + count]
                i += count
                self._spawn(self._legacy_appends(rep, reqs))

    async def _legacy_appends(self, rep, reqs: list) -> None:
        await sequential_appends(rep, self.endpoint, reqs)


async def sequential_appends(rep, endpoint: str, reqs: list,
                             timed: bool = False) -> None:
    """Per-frame append_entries fallback shared by legacy-endpoint mode
    and _DirectSender (bare managerless nodes): same resolution contract
    as a batch — acks in order, the tail failed on first error (the
    remaining frames would arrive out of order)."""
    node = rep._node
    acks: list = []
    for req in reqs:
        try:
            if timed:
                with node.metrics.timer("replicate-entries"):
                    acks.append(await node.transport.append_entries(
                        endpoint, req,
                        timeout_ms=node.options.election_timeout_ms))
            else:
                acks.append(await node.transport.append_entries(
                    endpoint, req,
                    timeout_ms=node.options.election_timeout_ms))
        except RpcError:
            acks.append(ErrorResponse(0, "send failed"))
            break
    while len(acks) < len(reqs):
        acks.append(ErrorResponse(0, "not sent"))
    await rep.on_batch_responses(acks)


# graftcheck: loop-confined
class SendPlane:
    """All endpoint senders of one process endpoint (lives on the
    NodeManager, like the HeartbeatHub)."""

    def __init__(self) -> None:
        self._senders: dict[str, EndpointSender] = {}

    def sender(self, endpoint: str) -> EndpointSender:
        s = self._senders.get(endpoint)
        if s is None:
            s = self._senders[endpoint] = EndpointSender(endpoint)
        return s

    def stats(self) -> dict:
        return {
            "endpoints": len(self._senders),
            "rpcs_sent": sum(s.rpcs_sent for s in self._senders.values()),
            "items_sent": sum(s.items_sent for s in self._senders.values()),
        }

    def shutdown(self) -> None:
        for s in self._senders.values():
            s.stop()
        self._senders.clear()
