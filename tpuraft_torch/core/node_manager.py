"""NodeManager: groupId -> Node routing on one shared RPC endpoint.

Reference parity: ``core:NodeManager`` + the per-request processors bound
to one RpcServer (SURVEY.md §2 "Key structural fact"): N raft groups
multiplex one server; requests route by (group_id, peer_id).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from tpuraft_torch.core.node import Node, State
from tpuraft_torch.entity import PeerId
from tpuraft_torch.rpc.messages import BatchResponse, BeatAck
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rpc.transport import RpcError, RpcServer

LOG = logging.getLogger(__name__)


class NodeManager:
    """One per process endpoint."""

    def __init__(self, server: RpcServer):
        self.server = server
        self._nodes: dict[tuple[str, str], Node] = {}
        # (group, leader) -> (FIFO, worker) of in-order AppendEntries execution
        self._append_lanes: dict[
            tuple[str, str], tuple[asyncio.Queue, asyncio.Task]] = {}
        for method in ("append_entries", "request_vote", "timeout_now",
                       "install_snapshot", "read_index"):
            server.register(method, self._make_handler(method))
        # get_file serves snapshot chunks; routed by reader_id not group
        self._file_readers: dict[int, object] = {}
        self._next_reader_id = 1
        server.register("get_file", self._handle_get_file)
        # coalesced heartbeats (HeartbeatHub): one RPC per endpoint pair
        server.register("multi_heartbeat", self._handle_multi_heartbeat)
        # batched send plane (SendPlane): votes + entry-bearing appends
        # coalesced the same way — O(endpoints) RPCs, O(endpoints)
        # standing sender tasks
        server.register("multi_append", self._handle_multi_append)
        server.register("multi_vote", self._handle_multi_vote)
        # store-wide append rounds (AppendBatcher): every led group's
        # pending entry window toward this endpoint in ONE RPC per
        # window — the write-plane mirror of multi_beat_fast
        server.register("store_append", self._handle_store_append)
        server.register("multi_beat_fast", self._handle_multi_beat_fast)
        # store-level liveness lease (quiescence): one tiny beat per
        # endpoint pair proves a whole store alive while its groups
        # hibernate (HeartbeatHub receiver side)
        server.register("store_lease", self._handle_store_lease)
        self._send_plane = None
        self._heartbeat_hub = None  # created on first coalescing leader
        # at most ONE outstanding beat handler per (group, peer): beats
        # behind a busy node lock must answer EBUSY, not stack a new
        # lock waiter every round (queue flooding starves vote handling)
        self._beat_inflight: set[tuple[str, str]] = set()
        # same guard for batched appends: a stuck node (long fsync /
        # snapshot load) must not accumulate one shielded handler —
        # each carrying a full entry window — per leader retry cycle
        self._append_inflight: set[tuple[str, str]] = set()

    @property
    def heartbeat_hub(self):
        if self._heartbeat_hub is None:
            from tpuraft_torch.core.heartbeat_hub import HeartbeatHub

            self._heartbeat_hub = HeartbeatHub()
        return self._heartbeat_hub

    @property
    def send_plane(self):
        if self._send_plane is None:
            from tpuraft_torch.core.send_plane import SendPlane

            self._send_plane = SendPlane()
        return self._send_plane

    async def _handle_multi_beat_fast(self, request):
        """Beat-plane fast path: steady-state heartbeats processed
        INLINE — no node lock, no per-beat task.  At region density the
        classic per-beat handler fan-out is the dominant idle burn
        (G beats/s, each lock + shielded task on a 1-core host); here a
        beat that matches the receiver's (FOLLOWER, term, leader,
        committed) row just touches the election deadline.  Any
        deviation answers ok=False and the sender follows up with a
        classic full-semantics beat for that group only."""
        acks = []
        for b in request.items:
            node = self._nodes.get((b.group_id, b.peer_id))
            if (node is not None
                    and node.state == State.FOLLOWER
                    and node.current_term == b.term
                    and str(node.leader_id) == b.server_id
                    and b.committed_index
                    <= node.ballot_box.last_committed_index):
                node._ctrl.note_leader_contact()
                node._last_leader_timestamp = node._clock.monotonic()
                ok = True
                if getattr(b, "quiesce", False):
                    # quiesce handshake: join the hibernation ONLY when
                    # this follower is provably at the leader's tail
                    # (the leader's committed == its last index == our
                    # last index and we applied it) — a lagging or
                    # timer-mode follower refuses, keeping the group
                    # active and its election timer live
                    enter = getattr(node._ctrl,
                                    "enter_quiescent_follower", None)
                    ok = (enter is not None
                          and node.log_manager.last_log_index()
                          == b.committed_index
                          and node.ballot_box.last_committed_index
                          == b.committed_index
                          and enter(PeerId.parse(b.server_id).endpoint,
                                    getattr(b, "lease_ms", 0)))
                else:
                    # a NORMAL beat from an active leader: a follower
                    # still hibernating (aborted handshake, leader woke)
                    # resumes fault detection with it
                    node._ctrl.note_activity()
                acks.append(BeatAck(ok=bool(ok), term=node.current_term,
                                    clock_ms=self._clock_ms()))
            else:
                acks.append(BeatAck(
                    ok=False,
                    term=node.current_term if node is not None else 0,
                    clock_ms=self._clock_ms()))
        return BatchResponse(items=acks)

    def _clock_ms(self) -> int:
        """This store's clock reading (monotonic ms) for ack piggyback —
        the peer-skew estimator's raw sample (ISSUE 18)."""
        return int(self.heartbeat_hub.clock.monotonic() * 1000)

    async def _handle_store_lease(self, request):
        """Receiver side of the store-level liveness lease: re-arm the
        sending store's lease; the hub's watcher wakes every dependent
        quiescent group the moment it expires."""
        from tpuraft_torch.rpc.messages import StoreLeaseAck

        deps = self.heartbeat_hub.note_lease_from(
            request.endpoint, request.lease_ms)
        return StoreLeaseAck(ok=True, dependents=deps,
                             clock_ms=self._clock_ms())

    async def _handle_multi_vote(self, request):
        """Fan a vote BatchRequest out concurrently; vote handlers only
        hold the node lock briefly (no disk waits)."""
        from tpuraft_torch.rpc.messages import BatchResponse, ErrorResponse

        async def one(req):
            try:
                node = self._nodes.get((req.group_id, req.peer_id))
                if node is None:
                    return ErrorResponse(int(RaftError.ENOENT),
                                         f"no node for {req.group_id}")
                return await node.handle_request_vote(req)
            except RpcError as e:
                return ErrorResponse(e.status.code, e.status.error_msg)
            except Exception as e:  # noqa: BLE001 — one bad item only
                LOG.exception("multi_vote item failed")
                return ErrorResponse(int(RaftError.EINTERNAL), repr(e))

        acks = await asyncio.gather(*(one(r) for r in request.items))
        return BatchResponse(items=list(acks))

    async def _handle_multi_append(self, request):
        """Fan an AppendEntries BatchRequest out: per TARGET NODE the
        items execute sequentially in batch order (the in-order
        execution contract pipelined replication needs — the sender
        guarantees no cross-RPC races by keeping one RPC in flight per
        endpoint); distinct nodes run concurrently, so their log
        flushes coalesce into the same multilog group-commit round.

        A node that cannot serve an item within half an election
        timeout gets EBUSY for that item AND every later item of the
        same node in this batch (executing later items while the stuck
        one still holds the lane would reorder the group's log writes);
        the shielded handler keeps running, the leader just rolls back
        and re-probes, exactly like a dropped direct RPC."""
        from tpuraft_torch.rpc.messages import BatchResponse

        return BatchResponse(
            items=await self._serve_append_items(request.items))

    async def _handle_store_append(self, request):
        """AppendBatcher's store-wide append round: per-node in-order
        execution like ``multi_append``, but LEAN — one task per node
        run and direct awaits per row instead of the per-item
        shield/wait_for pair.  The per-item EBUSY budget moves to the
        node run: a node that cannot finish its rows within half an
        election timeout answers EBUSY for the unserved tail (the
        handler itself keeps running shielded — cancelling a
        mid-flush append would tear durability ordering).  At region
        density the per-item timer+task machinery was a measurable
        slice of the loop's saturated write path; rounds are already
        windowed sender-side, so the receiver doesn't need a second
        layer of per-item pacing."""
        from tpuraft_torch.rpc.messages import ErrorResponse, StoreAppendResponse

        rows = request.rows
        out: list = [None] * len(rows)
        by_node: dict[tuple[str, str], list[int]] = {}
        for i, req in enumerate(rows):
            by_node.setdefault((req.group_id, req.peer_id), []).append(i)

        async def run_node(key, idxs):
            node = self._nodes.get(key)
            if node is None:
                err = ErrorResponse(int(RaftError.ENOENT),
                                    f"no node for {key[0]}")
                for i in idxs:
                    out[i] = err
                return
            if key in self._append_inflight:
                busy = ErrorResponse(int(RaftError.EBUSY), f"{key[0]} busy")
                for i in idxs:
                    out[i] = busy
                return
            answered = [False]   # round replied: drop any late writes
            # claim the lane SYNCHRONOUSLY, before the task is even
            # scheduled: deferring the add into run_rows opens a
            # window where two concurrent rounds for the same node
            # both pass the busy-check above and interleave the
            # group's log writes (the in-order contract the guard
            # exists for)
            self._append_inflight.add(key)

            async def run_rows():
                try:
                    for i in idxs:
                        try:
                            r = await node.handle_append_entries(rows[i])
                        except RpcError as e:
                            r = ErrorResponse(e.status.code,
                                              e.status.error_msg)
                        except asyncio.CancelledError:
                            raise
                        except Exception as e:  # noqa: BLE001
                            LOG.exception("store_append row failed")
                            r = ErrorResponse(int(RaftError.EINTERNAL),
                                              repr(e))
                        if answered[0]:
                            return  # reply already serialized: too late
                        out[i] = r
                finally:
                    self._append_inflight.discard(key)

            budget = node.options.election_timeout_ms / 1000.0 / 2
            task = asyncio.ensure_future(run_rows())
            try:
                await asyncio.wait_for(asyncio.shield(task), budget)
            except asyncio.TimeoutError:
                # the node is stuck (long fsync / snapshot load): EBUSY
                # its unserved tail NOW; the shielded run keeps going
                # (cancelling a mid-flush append tears durability
                # ordering) but may no longer touch this reply
                answered[0] = True
                task.add_done_callback(
                    lambda t: t.cancelled() or t.exception())
                busy = ErrorResponse(int(RaftError.EBUSY),
                                     f"{key[0]} busy")
                for i in idxs:
                    if out[i] is None:
                        out[i] = busy

        if len(by_node) == 1:
            # the common round shape: no gather layer
            key, idxs = next(iter(by_node.items()))
            await run_node(key, idxs)
        else:
            await asyncio.gather(*(run_node(k, v)
                                   for k, v in by_node.items()))
        return StoreAppendResponse(acks=out)

    async def _serve_append_items(self, items) -> list:
        from tpuraft_torch.rpc.messages import ErrorResponse

        out: list = [None] * len(items)
        by_node: dict[tuple[str, str], list[int]] = {}
        for i, req in enumerate(items):
            by_node.setdefault((req.group_id, req.peer_id), []).append(i)

        async def run_node(key, idxs):
            node = self._nodes.get(key)
            if node is None:
                err = ErrorResponse(int(RaftError.ENOENT),
                                    f"no node for {key[0]}")
                for i in idxs:
                    out[i] = err
                return
            if key in self._append_inflight:
                # a previous window's handler is still stuck on this
                # node: answering EBUSY NOW (without spawning) keeps
                # leader retries from stacking one shielded handler —
                # each holding a full entry window — per cycle
                busy = ErrorResponse(int(RaftError.EBUSY),
                                     f"{key[0]} busy")
                for i in idxs:
                    out[i] = busy
                return
            budget = node.options.election_timeout_ms / 1000.0 / 2
            for pos, i in enumerate(idxs):
                try:
                    self._append_inflight.add(key)
                    task = asyncio.ensure_future(
                        node.handle_append_entries(items[i]))

                    def _done(t, key=key):
                        self._append_inflight.discard(key)
                        if not t.cancelled():
                            t.exception()

                    task.add_done_callback(_done)
                    out[i] = await asyncio.wait_for(
                        asyncio.shield(task), budget)
                except asyncio.TimeoutError:
                    busy = ErrorResponse(int(RaftError.EBUSY),
                                         f"{key[0]} busy")
                    for j in idxs[pos:]:
                        out[j] = busy
                    return
                except RpcError as e:
                    out[i] = ErrorResponse(e.status.code,
                                           e.status.error_msg)
                except Exception as e:  # noqa: BLE001
                    LOG.exception("multi_append item failed")
                    out[i] = ErrorResponse(int(RaftError.EINTERNAL),
                                           repr(e))

        await asyncio.gather(*(run_node(k, v) for k, v in by_node.items()))
        return out

    async def _handle_multi_heartbeat(self, request):
        """Fan a MultiHeartbeatRequest out to the local nodes; each beat
        gets a full per-group response frame, in order."""
        from tpuraft_torch.rpc.messages import (
            ErrorResponse,
            MultiHeartbeatResponse,
            decode_message,
            encode_message,
        )

        import asyncio

        async def one(blob: bytes) -> bytes:
            # concurrent fan-out: each beat takes its own node's lock; a
            # group mid-election (lock held across awaits) must not
            # head-of-line-block the whole batch's ack — the batch only
            # returns when its SLOWEST beat does.  A beat that can't be
            # served promptly answers EBUSY while the real handler keeps
            # running shielded (cancelling a handler mid-step-down would
            # corrupt state); the sender just misses one group's ack for
            # one round, exactly like a dropped direct heartbeat.
            try:
                beat = decode_message(blob)
                key = (beat.group_id, beat.peer_id)
                node = self._nodes.get(key)
                if node is None:
                    raise RpcError(Status.error(
                        RaftError.ENOENT, f"no node for {beat.group_id}"))
                if key in self._beat_inflight:
                    # previous beat still waiting on this node's lock
                    return encode_message(ErrorResponse(
                        int(RaftError.EBUSY), f"{beat.group_id} busy"))
                budget = node.options.election_timeout_ms / 1000.0 / 2
                self._beat_inflight.add(key)
                task = asyncio.ensure_future(
                    node.handle_append_entries(beat))

                def _done(t, key=key):
                    self._beat_inflight.discard(key)
                    if not t.cancelled():
                        t.exception()  # consume if we timed out below

                task.add_done_callback(_done)
                try:
                    resp = await asyncio.wait_for(
                        asyncio.shield(task), budget)
                except asyncio.TimeoutError:
                    resp = ErrorResponse(int(RaftError.EBUSY),
                                         f"{beat.group_id} busy")
            except RpcError as e:
                resp = ErrorResponse(e.status.code, e.status.error_msg)
            except Exception as e:  # noqa: BLE001 — one bad beat only
                LOG.exception("multi_heartbeat beat failed")
                resp = ErrorResponse(int(RaftError.EINTERNAL), repr(e))
            return encode_message(resp)

        acks = await asyncio.gather(*(one(b) for b in request.beats))
        return MultiHeartbeatResponse(acks=list(acks))

    def _make_handler(self, method: str):
        async def handler(request):
            node = self._nodes.get((request.group_id, request.peer_id))
            if node is None:
                raise RpcError(Status.error(
                    RaftError.ENOENT,
                    f"no node for group={request.group_id} peer={request.peer_id}"))
            if method == "append_entries" and request.entries:
                # pipelined replication: a leader keeps a window of
                # AppendEntries in flight; execution here must follow
                # arrival order per (group, leader) or in-window
                # requests would race to the node lock and shuffle,
                # tripping prev-log rejections on every dispatch
                # (reference: AppendEntriesRequestProcessor's
                # per-connection sequence-keyed executors).  EMPTY
                # appends (heartbeats, probes) bypass the lane: a beat
                # must not wait behind a window of synced disk appends
                # (head-of-line blocking would time out ReadIndex SAFE
                # rounds while replication is healthy)
                return await self._ordered_append(node, request)
            return await getattr(node, f"handle_{method}")(request)

        return handler

    async def _ordered_append(self, node: Node, request):
        key = (request.group_id, request.server_id)
        fut = asyncio.get_running_loop().create_future()
        entry = self._append_lanes.get(key)
        if entry is None:
            lane: asyncio.Queue = asyncio.Queue()
            worker = asyncio.ensure_future(self._lane_worker(key, lane))
            entry = self._append_lanes[key] = (lane, worker)
        entry[0].put_nowait((node, request, fut))
        return await fut

    async def _lane_worker(self, key, lane: "asyncio.Queue") -> None:
        idle_reap_s = 60.0
        try:
            while True:
                try:
                    node, req, fut = await asyncio.wait_for(
                        lane.get(), idle_reap_s)
                except asyncio.TimeoutError:
                    if lane.empty():
                        return
                    continue
                try:
                    resp = await node.handle_append_entries(req)
                    if not fut.done():
                        fut.set_result(resp)
                except asyncio.CancelledError:
                    if not fut.done():
                        fut.set_exception(RpcError(Status.error(
                            RaftError.ENODESHUTTING, "lane shut down")))
                    raise
                except Exception as e:  # noqa: BLE001 — per-request error
                    if not fut.done():
                        fut.set_exception(e)
        finally:
            entry = self._append_lanes.get(key)
            if entry is not None and entry[0] is lane:
                del self._append_lanes[key]
                while not lane.empty():
                    _node, _req, fut = lane.get_nowait()
                    if not fut.done():
                        fut.set_exception(RpcError(Status.error(
                            RaftError.ENODESHUTTING, "lane shut down")))

    def add(self, node: Node) -> None:
        self._nodes[(node.group_id, str(node.server_id))] = node

    def remove(self, node: Node) -> None:
        self._nodes.pop((node.group_id, str(node.server_id)), None)
        # tear down this group's append lanes: no worker may linger to
        # execute a queued append against a stopped node, and test
        # teardowns must not see pending-task warnings.  Lanes are keyed
        # by (group, LEADER) and serve every co-hosted node of the
        # group, so only reap once the LAST node of the group leaves —
        # else removing one follower cancels queued appends for its
        # siblings (in-proc topologies host several nodes per server).
        # While siblings remain, still purge THIS node's queued appends:
        # they'd otherwise head-of-line-delay siblings with per-entry
        # EHOSTDOWN rejections and pin the dead node in the queue.
        group_lane_keys = [k for k in self._append_lanes
                           if k[0] == node.group_id]
        if any(g == node.group_id for g, _ in self._nodes):
            for key in group_lane_keys:
                lane, _worker = self._append_lanes[key]
                keep = []
                while not lane.empty():
                    item = lane.get_nowait()
                    if item[0] is node:
                        if not item[2].done():
                            item[2].set_exception(RpcError(Status.error(
                                RaftError.ENODESHUTTING, "node removed")))
                    else:
                        keep.append(item)
                for item in keep:
                    lane.put_nowait(item)
            return
        for key in group_lane_keys:
            lane, worker = self._append_lanes.pop(key)
            worker.cancel()
            while not lane.empty():
                _n, _r, fut = lane.get_nowait()
                if not fut.done():
                    fut.set_exception(RpcError(Status.error(
                        RaftError.ENODESHUTTING, "node removed")))

    def get(self, group_id: str, peer_id: str) -> Optional[Node]:
        return self._nodes.get((group_id, peer_id))

    def list_nodes(self) -> list[Node]:
        return list(self._nodes.values())

    # -- snapshot file service (reference: core:storage/FileService) --------

    def register_file_reader(self, reader) -> int:
        rid = self._next_reader_id
        self._next_reader_id += 1
        self._file_readers[rid] = reader
        return rid

    def unregister_file_reader(self, reader_id: int) -> None:
        self._file_readers.pop(reader_id, None)

    async def _handle_get_file(self, request):
        from tpuraft_torch.rpc.messages import GetFileResponse

        reader = self._file_readers.get(request.reader_id)
        if reader is None:
            raise RpcError(Status.error(
                RaftError.ENOENT, f"no file reader {request.reader_id}"))
        count = request.count
        throttle = getattr(reader, "throttle", None)
        if throttle is not None:
            count = await throttle.acquire_upto(count)
        data, eof = reader.read_file(request.filename, request.offset, count)
        return GetFileResponse(eof=eof, data=data)
