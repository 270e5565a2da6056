"""RheaKVStore: the user-facing distributed KV client.

Reference parity: ``rhea:client/DefaultRheaKVStore`` (SURVEY.md §3.2
"Client", §4.5): key → region lookup via RegionRouteTable, request to
the region leader's store, bounded retry with epoch-stale route patching
and not-leader failover; multi-region scan/delete_range fan-out; the
distributed lock and sequence APIs.

All methods are async (the reference's closure style); the reference's
blocking ``b*`` variants are just ``asyncio.run``-style waits in Python.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
from tpuraft_torch.rheakv.kv_service import (
    ERR_INVALID_EPOCH,
    ERR_KEY_OUT_OF_RANGE,
    ERR_NO_REGION,
    ERR_STORE_BUSY,
    KVCommandBatchRequest,
    KVCommandRequest,
    ListRegionsOnStoreRequest,
    decode_batch_reply,
    decode_result,
    encode_batch_item,
    scan_op,
)
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.pd_client import PlacementDriverClient
from tpuraft_torch.rheakv.raw_store import Sequence
from tpuraft_torch.rheakv.region_route_table import RegionRouteTable
from tpuraft_torch.rpc.transport import RpcError, is_no_method
from tpuraft_torch.util.trace import TRACER, pack_ctx, wire_ctx

LOG = logging.getLogger(__name__)

# ops any replica can serve linearizably (readIndex barrier + local read)
_READONLY_OPS = {KVOp.GET, KVOp.MULTI_GET, KVOp.CONTAINS_KEY, KVOp.SCAN}

# not leader / electing / readIndex round timed out under load: worth
# another attempt against a different store.  ERR_STORE_BUSY is the
# gray-failure SHED bounce (a SICK store failing fast instead of
# queueing) — retryable, and by the jittered backoff later leadership
# has usually evacuated to a healthy store.
_RETRYABLE_CODES = {
    int(RaftError.EPERM), int(RaftError.EBUSY), int(RaftError.EAGAIN),
    int(RaftError.ERAFTTIMEDOUT), int(RaftError.ETIMEDOUT),
    ERR_STORE_BUSY,
}


class RheaKVError(Exception):
    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status


@dataclass
class BatchingOptions:
    """Client-side op coalescing (reference: ``rhea:options/
    BatchingOptions`` + the ``Batching`` ring buffers in
    DefaultRheaKVStore).  The asyncio analog of the reference's
    disruptor consumers: concurrent ``put``/``get`` calls issued within
    the same event-loop iteration are drained into one ``put_list`` /
    ``multi_get`` per region instead of one RPC each."""

    enabled: bool = False
    max_write_batch: int = 128
    max_read_batch: int = 128
    # cap on (region, op) items per store-grouped ``kv_command_batch``
    # RPC (the serving-plane analog of the send plane's
    # MAX_ITEMS_PER_RPC: bounds the receiver's per-RPC fan-out burst)
    max_store_batch: int = 1024
    # concurrent kv_command_batch RPCs per store: ops are independent
    # (no per-region ordering to preserve), so a window stalled on one
    # slow region's quorum must not idle the whole store pipe — same
    # reasoning as the send plane's multi-lane vote dispatch
    max_store_inflight: int = 4
    # optional WorkerLane (tpuraft.core.lanes): batch-item encode moves
    # off the event loop onto the lane thread, one hop per send window —
    # the client-side half of the store's apply lane (a hot client loop
    # spends a measurable slice purely serializing op blobs).  Items
    # whose encode fails are failed INDIVIDUALLY at send time, same
    # attribution contract as the inline encode path.
    encode_lane: Optional[object] = None


# graftcheck: loop-confined
class _Batcher:
    """Coalesces items queued in one loop iteration into chunked flushes.

    Rounds fire concurrently (one per loop iteration): the per-STORE
    windowing that adapts batch size to the serving rate lives in
    :class:`_StoreSender`, which every round's flush submits through."""

    def __init__(self, max_batch: int, flush_fn):
        self._max = max_batch
        self._flush_fn = flush_fn
        self._pending: list = []  # (item, future)
        self._scheduled = False

    def add(self, item) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((item, fut))
        if not self._scheduled:
            self._scheduled = True
            asyncio.ensure_future(self._drain())
        return fut

    async def _drain(self) -> None:
        # one microtask hop: everything enqueued by tasks runnable in
        # this loop iteration joins the batch
        await asyncio.sleep(0)
        self._scheduled = False
        batch, self._pending = self._pending, []

        async def flush(chunk):
            try:
                await self._flush_fn(chunk)
            except Exception as e:  # noqa: BLE001 — fail the whole chunk
                for _, fut in chunk:
                    if not fut.done():
                        fut.set_exception(e)

        # the common round fits one chunk: await it directly instead of
        # paying a gather + task wrap per drain (per-op task-fan thinning
        # — at w256 this is ~one task per loop iteration saved per
        # batcher, and the drain itself is already a task)
        if len(batch) <= self._max:
            await flush(batch)
            return
        # chunks are independent: flush them concurrently
        await asyncio.gather(*[
            flush(batch[i:i + self._max])
            for i in range(0, len(batch), self._max)])


# graftcheck: loop-confined
class _StoreSender:
    """One batched ``kv_command_batch`` sender per store endpoint — the
    serving-plane analog of the send plane's EndpointSender: a bounded
    window of RPC lanes per store (``max_store_inflight``), and
    everything submitted while the window is full rides the next lane
    together.  Batch size adapts to the store's service rate, a slow
    region on one store never convoys items bound for another, and
    items resolve INDIVIDUALLY (future per item) the moment their RPC
    returns."""

    def __init__(self, client: "RheaKVStore", endpoint: str):
        self._client = client
        self.endpoint = endpoint
        self._q: list = []   # (region, peer_str, op, fut)
        self._task: Optional[asyncio.Task] = None
        self._lanes: set = set()   # in-flight send tasks
        # nudges the drain out of its lane-completion wait when a NEW
        # item arrives with lane slots free: without it, items submitted
        # while the drain parks on FIRST_COMPLETED convoy behind the
        # slowest in-flight RPC even though slots are open — the same
        # stalled-wait shape ReadConfirmBatcher._drain fixed in the
        # gray-failure round (write-path latency under load dropped
        # ~25% when this landed)
        self._arrival = asyncio.Event()

    def submit(self, region: Region, peer: str, op: KVOperation,
               spread: bool = False) -> asyncio.Future:
        """``spread=True`` marks a read routed OFF the leader (read_from
        follower/learner fan-out): its outcome must not touch the
        leader cache — a follower serving (or bouncing) a read says
        nothing about who leads."""
        fut = asyncio.get_running_loop().create_future()
        # encode HERE, not in the send path: a malformed op (bad key
        # type) must fail its OWN caller, never poison the unrelated
        # items sharing its lane (the same invariant RaftRawKVStore.
        # apply holds one layer down).  With an encode_lane configured
        # the serialize moves to the lane thread at send time — _send
        # keeps the same per-item attribution there.
        if self._client._batch_opts.encode_lane is None:
            try:
                blob = encode_batch_item(region.id, region.epoch.conf_ver,
                                         region.epoch.version, op.encode())
            except Exception as e:  # noqa: BLE001
                fut.set_result(RheaKVError(Status.error(
                    RaftError.EINVAL, f"malformed op: {e!r}")))
                return fut
        else:
            blob = None
        # trace plane: only a SAMPLED op's context rides the row (and
        # the wire) — unsampled slow-candidates keep the serving path
        # untouched (wire_ctx masks them to 0)
        tid = wire_ctx(op.trace_id)
        self._q.append((region, peer, blob, fut, spread, tid,
                        time.perf_counter() if tid else 0.0, op))
        self._arrival.set()
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._drain())
        return fut

    async def _drain(self) -> None:
        # microtask hop so a burst submitted in this loop iteration
        # rides one RPC; then windowed drain — up to max_store_inflight
        # lanes in flight, each lane stop-and-wait over its own batch
        await asyncio.sleep(0)
        cap = max(1, self._client._batch_opts.max_store_batch)
        lanes = max(1, self._client._batch_opts.max_store_inflight)
        while self._q or self._lanes:
            while self._q and len(self._lanes) < lanes:
                batch = self._q[:cap]
                del self._q[:len(batch)]
                t = asyncio.ensure_future(self._send_safe(batch))
                self._lanes.add(t)
                t.add_done_callback(self._lanes.discard)
            if self._lanes:
                # wake on a lane completing OR a new item arriving:
                # with lane slots free a fresh item must ship NOW, not
                # convoy behind the slowest in-flight RPC
                self._arrival.clear()
                arrival = asyncio.ensure_future(self._arrival.wait())
                try:
                    await asyncio.wait(set(self._lanes) | {arrival},
                                       return_when=asyncio.FIRST_COMPLETED)
                finally:
                    arrival.cancel()

    async def _send_safe(self, batch: list) -> None:
        try:
            await self._send(batch)
        except Exception as e:  # noqa: BLE001 — fail THIS batch only
            st = Status.error(RaftError.EINTERNAL, f"batch send: {e!r}")
            for row in batch:
                if not row[3].done():
                    row[3].set_result(RheaKVError(st))

    async def _send(self, batch: list) -> None:
        client = self._client
        lane = client._batch_opts.encode_lane
        if lane is not None:
            # one lane hop serializes the whole window off-loop; a row
            # whose encode raises fails its OWN future here (same
            # attribution the inline path gives at submit time) and is
            # dropped from the RPC
            blobs = await lane.submit(_encode_rows, batch)
            keep = []
            for row, blob in zip(batch, blobs):
                if isinstance(blob, Exception):
                    if not row[3].done():
                        row[3].set_result(RheaKVError(Status.error(
                            RaftError.EINVAL, f"malformed op: {blob!r}")))
                    continue
                keep.append(row[:2] + (blob,) + row[3:])
            batch = keep
            if not batch:
                return
        req = KVCommandBatchRequest(
            items=[row[2] for row in batch])
        rpc0 = 0.0
        if TRACER.enabled:
            rpc0 = time.perf_counter()
            for row in batch:
                if row[5]:  # client-queue stage: submit -> this send
                    TRACER.span(row[5], "client_queue", row[6], rpc0,
                                proc="client", store=self.endpoint)
            # per-item contexts as the trailing wire field (b"" when
            # nothing in the batch is traced)
            req.trace_ctx = pack_ctx([row[5] for row in batch])
        t0 = asyncio.get_running_loop().time()
        try:
            resp = await client.transport.call(
                self.endpoint, "kv_command_batch", req, client.timeout_ms)
        except RpcError as e:
            if is_no_method(e):
                # a pre-batch store: downgrade permanently, serve this
                # batch through the per-op path
                client._batch_ok = False
                client.batch_fallbacks += 1
                outs = await asyncio.gather(
                    *(client._call_region_outcome(region, op)
                      for region, _p, _b, _f, _s, _t, _ts, op in batch))
                for row, out in zip(batch, outs):
                    if not row[3].done():
                        row[3].set_result(out)
                return
            for region, _p, _b, fut, spread, _t, _ts, _op in batch:
                if not spread:          # dead store: retryable
                    client._leaders.pop(region.id, None)
                if not fut.done():
                    fut.set_result(_Retry(status=e.status))
            return
        client.batch_rpcs += 1
        client.batch_items += len(batch)
        if rpc0:
            rpc1 = time.perf_counter()
            for row in batch:
                if row[5]:
                    TRACER.span(row[5], "kv_batch_rpc", rpc0, rpc1,
                                proc="client", store=self.endpoint,
                                items=len(batch))
        # feed the endpoint EMA only when the store actually SERVED
        # something: a SICK store's instant shed bounces (or a follower
        # instantly answering EPERM) would otherwise read as "fast" and
        # drag a gray endpoint's EMA back under the slow floor, undoing
        # the routing signal the EMA exists for
        if any(len(b) >= 8 and decode_batch_reply(b)[0] == 0
               for b in resp.items):
            client._note_ep_latency(self.endpoint,
                                    asyncio.get_running_loop().time() - t0)
        if len(resp.items) != len(batch):
            # a short (or over-long) reply must FAIL the batch, not zip-
            # truncate: unmatched futures would otherwise never resolve
            # and their callers wedge forever (the send plane applies the
            # same len(acks) != len(items) guard)
            st = Status.error(
                RaftError.EINTERNAL,
                f"kv_command_batch reply carried {len(resp.items)} items "
                f"for {len(batch)} requests")
            for row in batch:
                if not row[3].done():
                    row[3].set_result(RheaKVError(st))
            return
        for (region, peer, _b, fut, spread, _t, _ts, _op), blob \
                in zip(batch, resp.items):
            if not fut.done():
                fut.set_result(client._decode_outcome(region, peer, blob,
                                                      spread=spread))


def _encode_rows(rows: list) -> list:
    """Serialize a send window's op blobs (runs ON the encode lane
    thread — touches only the rows' immutable region/op fields).  A
    failed encode yields its exception in place so the caller can fail
    that item individually."""
    out = []
    for region, _p, _b, _f, _s, _t, _ts, op in rows:
        try:
            out.append(encode_batch_item(region.id, region.epoch.conf_ver,
                                         region.epoch.version, op.encode()))
        except Exception as e:  # noqa: BLE001 — attributed per item
            out.append(e)
    return out


# graftcheck: loop-confined — route table, batchers and store senders
# are all touched from the client's event loop only
class RheaKVStore:
    def __init__(self, pd_client: PlacementDriverClient, transport,
                 timeout_ms: float = 5000, max_retries: int = 8,
                 retry_interval_ms: float = 50,
                 batching: Optional[BatchingOptions] = None,
                 read_preference: str = "leader",
                 read_from: str = "",
                 jitter_seed: Optional[int] = None):
        if read_preference not in ("leader", "any"):
            raise ValueError(f"read_preference {read_preference!r} "
                             "(must be 'leader' or 'any')")
        # read_from: where GETs (and other read-only ops) are served —
        #   "leader"   (default) leader store, batched with writes;
        #   "follower" nearest non-leader voter (local serve after a
        #              forwarded-ReadIndex fence), batched per store;
        #   "learner"  learner read replicas first (PR 2's membership
        #              learners as real read capacity), batched;
        #   "any"      legacy round-robin over ALL data replicas via the
        #              per-op path (read_preference="any" alias).
        # Witness replicas hold no state and are never read targets.
        if read_from == "":
            read_from = "any" if read_preference == "any" else "leader"
        if read_from not in ("leader", "follower", "learner", "any"):
            raise ValueError(f"read_from {read_from!r} (must be 'leader', "
                             "'follower', 'learner' or 'any')")
        self.pd = pd_client
        self.transport = transport
        self.route_table = RegionRouteTable()
        self.timeout_ms = timeout_ms
        self.max_retries = max_retries
        self.retry_interval_ms = retry_interval_ms
        # seeded jitter on every outer retry backoff: a bounced
        # 256-worker batch re-probing in lockstep is a synchronized
        # retry herd that a gray (slow-but-alive) leader turns into a
        # thundering retry storm — each sleep spreads over
        # [0.5, 1.5) x the linear schedule instead
        self._backoff_rng = random.Random(jitter_seed)
        self.read_from = read_from
        # per-endpoint service latency EMA (ms): fed by every batch RPC
        # and per-op call, consulted by the read fan-out so spread reads
        # route OFF slow (gray) replicas — client-side mirror of the
        # store-side per-peer health scores
        self._ep_lat_ms: dict[str, float] = {}
        # legacy alias (pre-read_from callers introspect this)
        self.read_preference = "any" if read_from == "any" else "leader"
        # read fan-out observability: who actually SERVED spread reads
        self.read_serves = {"leader": 0, "follower": 0, "learner": 0}
        self._read_rr: dict[int, int] = {}   # region id -> rotation cursor
        # region id -> endpoint of the last known leader's store
        self._leaders: dict[int, str] = {}
        self._started = False
        self._batch_opts = batching if batching is not None \
            else BatchingOptions()
        self._put_batcher: Optional[_Batcher] = None
        self._get_batcher: Optional[_Batcher] = None
        if batching is not None and batching.enabled:
            self._put_batcher = _Batcher(batching.max_write_batch,
                                         self._flush_put_batch)
            self._get_batcher = _Batcher(batching.max_read_batch,
                                         self._flush_get_batch)
        # does the fleet serve kv_command_batch?  Optimistic until an
        # ENOMETHOD proves otherwise (a pre-batch store), then the
        # legacy per-region kv_command path takes over PERMANENTLY —
        # the same wire-compat pattern as the PD delta-batch fallback
        self._batch_ok = True
        self.batch_rpcs = 0        # kv_command_batch RPCs sent
        self.batch_items = 0       # (region, op) items carried in them
        self.batch_fallbacks = 0   # ENOMETHOD downgrades observed
        self.batch_retries: dict[int, int] = {}  # bounced items by code
        # endpoint -> windowed batch sender (one RPC in flight each)
        self._senders: dict[str, _StoreSender] = {}
        self._refresh_inflight: Optional[asyncio.Task] = None
        # region lifecycle (merges): region ids whose stores bounced
        # ERR_NO_REGION — candidates for merged-away eviction.  The next
        # PD-answered refresh adjudicates: still listed = alive (a
        # lagging split child), gone = absorbed by a neighbor, evict it
        # so the absorbing region's extended range takes over the route.
        self._merge_suspects: set[int] = set()
        self.merged_evictions = 0

    # ------------------------------------------------------------------
    # store-grouped batch dispatch (the kv_command_batch fast path)
    # ------------------------------------------------------------------

    def _store_candidates(self, region: Region, attempt: int) -> list[str]:
        """Per-attempt candidate stores for a region, leader hint first,
        then EVERY voter (rotated by attempt so a retry herd doesn't
        camp on one store) — same coverage contract as _endpoints_for:
        one attempt cycle must be able to reach the real leader even
        when the cached hint is stale."""
        # witnesses can never lead: probing one as a leader candidate is
        # a guaranteed EPERM bounce (they forward nothing)
        voters = [p for p in region.peers if not p.endswith("/learner")
                  and not p.endswith("/witness")]
        if not voters:
            return [region.peers[0]] if region.peers else []
        k = attempt % len(voters)
        cands = []
        leader = self._leaders.get(region.id)
        if leader and leader in voters:
            cands.append(leader)
        cands.extend(p for p in voters[k:] + voters[:k] if p not in cands)
        return cands

    async def _call_region_outcome(self, region: Region, op: KVOperation):
        """_call_region with its control flow reified as a value so batch
        dispatch can zip outcomes back to pairs: ("ok", result) |
        _Retry | RheaKVError."""
        try:
            return ("ok", await self._call_region(region, op))
        except _Retry as r:
            return r
        except RheaKVError as e:
            return e

    def _decode_outcome(self, region: Region, peer: str, blob: bytes,
                        spread: bool = False):
        code, msg, result, meta = decode_batch_reply(blob)
        if code == 0:
            if spread:
                # fan-out observability — and NO leader-cache update: a
                # follower/learner serving a read says nothing about
                # who leads
                self._note_read_serve(region, peer)
            else:
                self._leaders[region.id] = peer
            return ("ok", decode_result(result))
        st = Status(code, msg)
        self.batch_retries[code] = self.batch_retries.get(code, 0) + 1
        if code in (ERR_INVALID_EPOCH, ERR_KEY_OUT_OF_RANGE):
            if meta:
                fresh = Region.decode(meta)
                if spread and (fresh.epoch.version, fresh.epoch.conf_ver) \
                        < (region.epoch.version, region.epoch.conf_ver):
                    # a LAGGING replica (pre-split view): its meta is
                    # useless and a sibling replica can still serve —
                    # bounce to the next candidate, no route refresh
                    return _Retry(status=st)
                self.route_table.add_or_update(fresh)
            return _Retry(refresh=True, status=st)
        if code == ERR_NO_REGION:
            if not spread:
                self._leaders.pop(region.id, None)
            self._merge_suspects.add(region.id)
            return _Retry(refresh=True, status=st)
        if code in _RETRYABLE_CODES:
            if not spread:
                self._leaders.pop(region.id, None)
            return _Retry(status=st)
        return RheaKVError(st)

    def _note_read_serve(self, region: Region, peer: str) -> None:
        """Classify which replica class served a spread read (fan-out
        observability, read_serves counters)."""
        if peer.endswith("/learner"):
            self.read_serves["learner"] += 1
        elif peer == self._leaders.get(region.id):
            self.read_serves["leader"] += 1
        else:
            self.read_serves["follower"] += 1

    def _backoff_s(self, attempt: int) -> float:
        """Outer retry backoff: linear schedule x seeded jitter in
        [0.5, 1.5) — bounced herds spread instead of re-probing in
        lockstep."""
        return (self.retry_interval_ms * (attempt + 1)
                * (0.5 + self._backoff_rng.random()) / 1000.0)

    def _note_ep_latency(self, endpoint: str, dur_s: float) -> None:
        ms = dur_s * 1000.0
        cur = self._ep_lat_ms.get(endpoint)
        self._ep_lat_ms[endpoint] = ms if cur is None \
            else cur + 0.25 * (ms - cur)

    def _order_by_speed(self, pool: list[str]) -> list[str]:
        """Stable-partition a read-candidate pool: endpoints observed
        SLOW (EMA > 3x the pool's fastest and over an absolute floor)
        go last — spread reads route off gray replicas while the
        rotation inside each partition keeps spreading load.

        Self-healing: a demoted endpoint no longer serves, so it gets
        no fresh samples and a frozen EMA would exile it FOREVER after
        a healed transient limp.  Each demotion decays its stored EMA
        slightly; after ~O(100) reads it drops under the floor, gets
        re-probed, and one real sample either clears it or (alpha
        0.25 on a still-slow reply) demotes it again within a few
        reads — bounded re-probe cost, no permanent capacity loss."""
        emas = [self._ep_lat_ms.get(_endpoint(p)) for p in pool]
        known = [e for e in emas if e is not None]
        if len(known) < 2:
            return pool
        floor = max(3.0 * min(known), 20.0)
        fast = [p for p, e in zip(pool, emas) if e is None or e <= floor]
        slow = [p for p, e in zip(pool, emas) if not (e is None or e <= floor)]
        for p in slow:
            self._ep_lat_ms[_endpoint(p)] *= 0.98
        return fast + slow

    def _sender(self, endpoint: str) -> _StoreSender:
        s = self._senders.get(endpoint)
        if s is None:
            s = self._senders[endpoint] = _StoreSender(self, endpoint)
        return s

    async def _dispatch_region_ops(self, pairs: list, attempt: int = 0
                                   ) -> list:
        """One attempt cycle over many (region, op) pairs, each routed
        through its leader store's :class:`_StoreSender` — everything
        pending fleet-wide for one store rides ONE kv_command_batch per
        window (the raft plane's ``multi_append`` pattern one layer up),
        and every pair resolves independently (a slow region on one
        store never convoys its neighbours).  Pairs that can't ride a
        batch — 'any'-spread reads (per-region round-robin) or a
        downgraded fleet — go through _call_region.  Returns one
        outcome per pair (see _call_region_outcome).

        Task-fan shape: sender submits are SYNCHRONOUS (each returns a
        plain future), so a round over N pairs is N submit calls plus
        ONE gather of futures — no per-pair coroutine/task.  A pair
        bounced RETRYABLY (not leader, electing) advances to its next
        candidate store in the next round, the batch analog of
        _call_region probing every endpoint within one attempt cycle:
        a cold leader cache costs extra round trips, never the outer
        backoff sleep."""
        if TRACER.enabled:
            # one trace per (region, op) dispatch cycle: the root span
            # opens here (sampling + slow-op candidacy decided inside)
            # and closes when the cycle's outcome lands below
            for _region, op in pairs:
                if not op.trace_id:
                    op.trace_id = TRACER.begin_op("kv_op", proc="client")
        outs: list = [None] * len(pairs)
        direct: list[int] = []
        live: list[list] = []   # [pair index, candidates, cursor, spread]
        for i, (region, op) in enumerate(pairs):
            if (not self._batch_ok
                    or (self.read_from == "any"
                        and op.op in _READONLY_OPS)):
                direct.append(i)
                continue
            spread = (self.read_from in ("follower", "learner")
                      and op.op in _READONLY_OPS)
            cands = (self._read_candidates(region, attempt) if spread
                     else self._store_candidates(region, attempt))
            live.append([i, cands, 0, spread])
        # the per-op escape hatch still needs real tasks (one coroutine
        # each); batched pairs never do
        direct_gather = asyncio.gather(
            *(self._call_region_outcome(*pairs[i]) for i in direct)) \
            if direct else None
        while live:
            futs = [self._sender(_endpoint(row[1][row[2]])).submit(
                        pairs[row[0]][0], row[1][row[2]],
                        pairs[row[0]][1], spread=row[3])
                    for row in live]
            round_outs = await asyncio.gather(*futs)
            nxt = []
            for row, out in zip(live, round_outs):
                outs[row[0]] = out
                # a mid-flight ENOMETHOD downgrade means the sender
                # already served the item through the per-op path:
                # outcome is final regardless of shape
                if (self._batch_ok
                        and isinstance(out, _Retry) and not out.refresh
                        and row[2] + 1 < len(row[1])):
                    row[2] += 1
                    nxt.append(row)
            live = nxt
        if direct_gather is not None:
            for i, out in zip(direct, await direct_gather):
                outs[i] = out
        if TRACER.enabled:
            for (_region, op), out in zip(pairs, outs):
                if op.trace_id:
                    TRACER.end_op(op.trace_id, ok=isinstance(out, tuple))
        return outs

    # ------------------------------------------------------------------
    # client-side batcher flushes (one drain round)
    # ------------------------------------------------------------------

    async def _flush_batched_ops(self, chunk, key_fn, op_fn, deliver) -> None:
        """Drain one batcher chunk: resolve each item's region ONCE per
        round (the round's route cache — invalidated only through the
        retry path on epoch/region errors), group regions by leader
        store into kv_command_batch RPCs, deliver per-item results, and
        re-shard ONLY the failed/escaped items after a refresh."""
        pending = list(chunk)
        last = Status.error(RaftError.EAGAIN, "exhausted retries")
        for attempt in range(self.max_retries):
            groups: dict[int, tuple[Region, list]] = {}
            unroutable: list = []
            for item, fut in pending:
                try:
                    r = self.route_table.find_region_by_key(key_fn(item))
                except Exception as e:  # noqa: BLE001 — malformed key:
                    # fail ITS caller, not the whole chunk
                    if not fut.done():
                        fut.set_exception(RheaKVError(Status.error(
                            RaftError.EINVAL, f"malformed key: {e!r}")))
                    continue
                if r is None:
                    unroutable.append((item, fut))
                else:
                    groups.setdefault(r.id, (r, []))[1].append((item, fut))
            retry: list = list(unroutable)
            need_refresh = bool(unroutable)
            parts = list(groups.values())
            outcomes = await self._dispatch_region_ops(
                [(region, op_fn(items)) for region, items in parts], attempt)
            for (region, items), out in zip(parts, outcomes):
                if isinstance(out, tuple):
                    deliver(items, out[1])
                elif isinstance(out, _Retry):
                    need_refresh = need_refresh or out.refresh
                    if out.status is not None:
                        last = out.status
                    retry.extend(items)
                else:   # hard error fails ITS region's calls only
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(out)
            if not retry:
                return
            pending = retry
            if need_refresh:
                await self._refresh_routes()
            await asyncio.sleep(self._backoff_s(attempt))
        err = RheaKVError(last)
        for _, fut in pending:
            if not fut.done():
                fut.set_exception(err)

    async def _flush_put_batch(self, chunk) -> None:
        def deliver(items, result):
            for _, fut in items:
                if not fut.done():
                    fut.set_result(bool(result))

        await self._flush_batched_ops(
            chunk, key_fn=lambda kv: kv[0],
            op_fn=lambda items: KVOperation.put_list(
                [kv for kv, _ in items]),
            deliver=deliver)

    async def _flush_get_batch(self, chunk) -> None:
        def deliver(items, result):
            res = dict(result)   # list[(key, Optional[value])]
            for k, fut in items:
                if not fut.done():
                    fut.set_result(res.get(k))

        await self._flush_batched_ops(
            chunk, key_fn=lambda k: k,
            op_fn=lambda items: KVOperation.multi_get(
                list(dict.fromkeys(k for k, _ in items))),
            deliver=deliver)

    async def start(self) -> None:
        # best-effort initial route pull: a PD that is still booting (or
        # electing) must not fail client startup — ops refresh routes on
        # demand through _execute's ENOENT path
        try:
            self.route_table.reset(await self.pd.list_regions())
        except Exception as e:  # noqa: BLE001
            # visible at default level: a typo'd PD endpoint would
            # otherwise surface only as per-op ENOENT after timeouts
            LOG.warning("initial route pull from PD failed (%s); "
                        "deferring to on-demand refresh", e)
        self._started = True

    async def shutdown(self) -> None:
        self._started = False

    # ------------------------------------------------------------------
    # routing & retry engine
    # ------------------------------------------------------------------

    async def _refresh_routes(self) -> None:
        """Single-flight wrapper: at region density one refresh decodes
        every store's whole region list, so a retry herd must share ONE
        O(regions) pass instead of running one each."""
        if self._refresh_inflight is None or self._refresh_inflight.done():
            self._refresh_inflight = asyncio.ensure_future(
                self._refresh_routes_once())
        # shield: one caller timing out must not cancel the shared pass
        await asyncio.shield(self._refresh_inflight)

    async def _refresh_routes_once(self) -> None:
        """Re-pull the region layout: PD first, then store-reported truth
        (PD-less mode — and PD outages — discover split regions this way).
        Best-effort: a down PD must not fail ops the cached routes or the
        stores themselves can still serve."""
        regions: list[Region] = []
        pd_ids: Optional[set[int]] = None
        try:
            regions = await self.pd.list_regions()
            pd_ids = {r.id for r in regions}
        except Exception:  # noqa: BLE001 — PD unreachable / electing
            LOG.debug("pd route refresh failed; falling back to stores",
                      exc_info=True)
        # dedupe on the store endpoint: the same store may be a voter in
        # one region and a '/learner' in another
        endpoints = {_endpoint(p) for r in regions for p in r.peers}
        # also ask every store we already know about (covers PD-down case)
        endpoints.update(_endpoint(p) for r in self.route_table.list_regions()
                         for p in r.peers)
        async def ask(ep: str):
            return await self.transport.call(
                ep, "kv_list_regions",
                ListRegionsOnStoreRequest(), self.timeout_ms)

        answers = await asyncio.gather(
            *(ask(ep) for ep in endpoints), return_exceptions=True)
        for resp in answers:
            if isinstance(resp, BaseException):
                continue
            for blob in resp.regions:
                regions.append(Region.decode(blob))
        # fold: keep the freshest epoch per region id — seeded with the
        # table we already hold, so a refresh answered only by lagging
        # replicas (leader down, PD stale) can never regress the view
        regions.extend(self.route_table.list_regions())
        best: dict[int, Region] = {}
        for r in regions:
            cur = best.get(r.id)
            if cur is None or (r.epoch.version, r.epoch.conf_ver) > \
                    (cur.epoch.version, cur.epoch.conf_ver):
                best[r.id] = r
        # merged-away eviction (region lifecycle): a region the stores
        # bounce with ERR_NO_REGION and a PD answer no longer lists was
        # absorbed into a neighbor — drop it from the fold so the
        # absorbing region's extended range (same start key, and NOT
        # necessarily a higher version — the absorbed side may have
        # split more) can take over the route.  A suspect the PD still
        # lists is alive (a lagging split child); PD-down refreshes
        # adjudicate nothing (conservative — both cases look the same
        # from the stores alone).
        if pd_ids is not None and self._merge_suspects:
            for rid in list(self._merge_suspects):
                self._merge_suspects.discard(rid)
                if rid not in pd_ids and rid in best:
                    best.pop(rid)
                    self._leaders.pop(rid, None)
                    self.route_table.remove_region(rid)
                    self.merged_evictions += 1
                    LOG.debug("evicted merged-away region %d", rid)
        if best:  # never wipe a usable cache with an empty refresh
            self.route_table.reset(list(best.values()))

    def _endpoints_for(self, region: Region) -> list[str]:
        """Leader-first candidate ordering of the region's store endpoints.

        Learner replicas (``/learner``-suffixed peers — read-only, never
        leaders) go last: they can only serve by forwarding, so they are
        a fallback when no voter answers, not a first hop.  Witness
        voters (``/witness``) are skipped entirely: they never lead and
        hold no data to serve or forward from.
        """
        eps = []
        voters = [p for p in region.peers if not p.endswith("/learner")
                  and not p.endswith("/witness")]
        leader = self._leaders.get(region.id)
        if leader and leader in voters:
            eps.append(leader)
        eps.extend(p for p in voters if p not in eps)
        eps.extend(p for p in region.peers if p.endswith("/learner"))
        return eps

    def _read_endpoints_for(self, region: Region) -> list[str]:
        """Round-robin over the DATA replicas (voters, learners, leader
        alike) for read-only ops under read_from='any' — witness
        replicas hold no state and are never read targets.  Like the
        follower/learner fan-out, observed-slow (gray) endpoints drop
        to the back of the rotation."""
        peers = [p for p in region.peers if not p.endswith("/witness")]
        cur = self._read_rr.get(region.id, region.id)
        self._read_rr[region.id] = cur + 1
        rotated = [peers[(cur + i) % len(peers)] for i in range(len(peers))]
        return self._order_by_speed(rotated)

    def _read_candidates(self, region: Region, attempt: int) -> list[str]:
        """read_from='follower'|'learner' candidate ordering: the
        preferred replica class first (rotated per region so fan-out
        spreads), then the remaining data replicas as fallback — a
        region with no replica of the preferred class still serves.
        Witnesses are never read targets (no state to serve)."""
        learners = [p for p in region.peers if p.endswith("/learner")]
        voters = [p for p in region.peers if not p.endswith("/learner")
                  and not p.endswith("/witness")]
        leader = self._leaders.get(region.id)
        followers = [p for p in voters if p != leader]
        leader_tail = [leader] if leader in voters else []
        if self.read_from == "learner":
            pool, rest = learners, followers + leader_tail
        else:
            pool, rest = followers, leader_tail + learners
        if not pool:
            pool, rest = voters, learners
        if not pool:
            return [p for p in region.peers if not p.endswith("/witness")]
        cur = self._read_rr.get(region.id, region.id)
        self._read_rr[region.id] = cur + 1
        k = (cur + attempt) % len(pool)
        rotated = pool[k:] + pool[:k]
        # gray replicas last: observed-slow endpoints only serve when
        # every faster candidate bounced (per-endpoint latency EMA)
        return self._order_by_speed(rotated) \
            + [p for p in rest if p not in pool]

    async def _call_region(self, region: Region, op: KVOperation):
        """One attempt cycle over a region's stores; raises on hard error."""
        last_status = Status.error(RaftError.EAGAIN, "no store reachable")
        spread_read = (self.read_from != "leader"
                       and op.op in _READONLY_OPS)
        if not spread_read:
            eps = self._endpoints_for(region)
        elif self.read_from == "any":
            eps = self._read_endpoints_for(region)
        else:
            eps = self._read_candidates(region, 0)
        for ep_str in eps:
            # peers are PeerId strings; the store serves on ip:port
            endpoint = _endpoint(ep_str)
            req = KVCommandRequest(
                region_id=region.id,
                conf_ver=region.epoch.conf_ver,
                version=region.epoch.version,
                op_blob=op.encode(),
                trace_id=wire_ctx(op.trace_id))
            rpc0 = time.perf_counter() if wire_ctx(op.trace_id) else 0.0
            t0 = asyncio.get_running_loop().time()
            try:
                resp = await self.transport.call(endpoint, "kv_command", req,
                                                 self.timeout_ms)
            except RpcError as e:
                last_status = e.status
                if not spread_read:   # a dead read replica says nothing
                    self._leaders.pop(region.id, None)   # about the leader
                continue
            if rpc0:
                TRACER.span(op.trace_id, "kv_rpc", rpc0,
                            time.perf_counter(), proc="client",
                            store=endpoint, code=resp.code)
            if resp.code == 0:
                # EMA only on served replies (an instant error bounce
                # must not make a gray endpoint look fast again)
                self._note_ep_latency(
                    endpoint, asyncio.get_running_loop().time() - t0)
                if not spread_read:
                    self._leaders[region.id] = ep_str
                else:
                    self._note_read_serve(region, ep_str)
                return decode_result(resp.result)
            if resp.code in (ERR_INVALID_EPOCH, ERR_KEY_OUT_OF_RANGE):
                fresh = Region.decode(resp.region_meta)
                if spread_read and (fresh.epoch.version,
                                    fresh.epoch.conf_ver) < \
                        (region.epoch.version, region.epoch.conf_ver):
                    # a LAGGING replica (pre-split view): its meta is
                    # useless and the other replicas can still serve —
                    # don't abort the cycle into a full route refresh
                    last_status = Status(resp.code, resp.msg)
                    continue
                self.route_table.add_or_update(fresh)
                raise _Retry(refresh=True)
            if resp.code == ERR_NO_REGION:
                self._leaders.pop(region.id, None)
                self._merge_suspects.add(region.id)
                raise _Retry(refresh=True)
            if resp.code in _RETRYABLE_CODES:
                # not leader / electing / readIndex round timed out under
                # load: try the next store
                last_status = Status(resp.code, resp.msg)
                if not spread_read:
                    self._leaders.pop(region.id, None)
                continue
            raise RheaKVError(Status(resp.code, resp.msg))
        raise _Retry(status=last_status)

    async def _execute(self, key: bytes, op: KVOperation):
        """Route by key, run with bounded retries."""
        tid = TRACER.begin_op("kv_op", proc="client") \
            if TRACER.enabled and not op.trace_id else 0
        if tid:
            op.trace_id = tid
        try:
            return await self._execute_traced(key, op)
        finally:
            if tid:
                TRACER.end_op(tid)

    async def _execute_traced(self, key: bytes, op: KVOperation):
        last = Status.error(RaftError.EAGAIN, "exhausted retries")
        for attempt in range(self.max_retries):
            region = self.route_table.find_region_by_key(key)
            if region is None:
                await self._refresh_routes()
                region = self.route_table.find_region_by_key(key)
                if region is None:
                    raise RheaKVError(Status.error(
                        RaftError.ENOENT, f"no region covers key {key!r}"))
            try:
                return await self._call_region(region, op)
            except _Retry as r:
                if r.refresh:
                    await self._refresh_routes()
                if r.status is not None:
                    last = r.status
                # linear backoff (jittered): elections take a few
                # election timeouts, and lockstep re-probes would herd
                await asyncio.sleep(self._backoff_s(attempt))
        raise RheaKVError(last)

    # ------------------------------------------------------------------
    # single-key ops
    # ------------------------------------------------------------------

    async def get(self, key: bytes) -> Optional[bytes]:
        if self._get_batcher is not None:
            return await self._get_batcher.add(key)
        return await self._execute(key, KVOperation(KVOp.GET, key))

    async def contains_key(self, key: bytes) -> bool:
        return await self._execute(key, KVOperation(KVOp.CONTAINS_KEY, key))

    async def put(self, key: bytes, value: bytes) -> bool:
        if self._put_batcher is not None:
            return await self._put_batcher.add((key, value))
        return await self._execute(key, KVOperation(KVOp.PUT, key, value))

    async def put_if_absent(self, key: bytes, value: bytes) -> Optional[bytes]:
        return await self._execute(
            key, KVOperation(KVOp.PUT_IF_ABSENT, key, value))

    async def get_and_put(self, key: bytes, value: bytes) -> Optional[bytes]:
        return await self._execute(
            key, KVOperation(KVOp.GET_AND_PUT, key, value))

    async def compare_and_put(self, key: bytes, expect: bytes,
                              update: bytes) -> bool:
        return await self._execute(key, KVOperation.cas(key, expect, update))

    async def merge(self, key: bytes, value: bytes) -> bool:
        return await self._execute(key, KVOperation(KVOp.MERGE, key, value))

    async def delete(self, key: bytes) -> bool:
        return await self._execute(key, KVOperation(KVOp.DELETE, key))

    # ------------------------------------------------------------------
    # multi-key ops (fan out by owning region)
    # ------------------------------------------------------------------

    async def _run_sharded(self, items: list, key_fn, op_fn):
        """Group items by owning region, run each group, and — crucially —
        RE-SHARD whatever failed after every route refresh: a split that
        races the batch must never commit keys through the wrong group
        (the server also range-checks, returning ERR_KEY_OUT_OF_RANGE).
        Returns the list of per-group results.

        A thin wrapper over _flush_batched_ops (one retry engine for the
        batcher flushes AND the multi-key APIs): each item gets a
        future, per-group results accumulate via deliver."""
        results: list = []
        chunk = [(it, asyncio.get_running_loop().create_future())
                 for it in items]

        def deliver(group_items, result):
            results.append(result)
            for _, fut in group_items:
                if not fut.done():
                    fut.set_result(True)

        await self._flush_batched_ops(
            chunk, key_fn=key_fn,
            op_fn=lambda pairs: op_fn([it for it, _ in pairs]),
            deliver=deliver)
        errs = [err for _, fut in chunk
                if (err := fut.exception()) is not None]
        if errs:
            raise errs[0]
        return results

    async def multi_get(self, keys: list[bytes]
                        ) -> dict[bytes, Optional[bytes]]:
        parts = await self._run_sharded(
            keys, lambda k: k, KVOperation.multi_get)
        out: dict[bytes, Optional[bytes]] = {}
        for pairs in parts:
            out.update(dict(pairs))
        return out

    async def put_list(self, kvs: list[tuple[bytes, bytes]]) -> bool:
        parts = await self._run_sharded(
            kvs, lambda kv: kv[0], KVOperation.put_list)
        return all(parts)

    async def delete_list(self, keys: list[bytes]) -> bool:
        parts = await self._run_sharded(
            keys, lambda k: k, KVOperation.delete_list)
        return all(parts)

    # ------------------------------------------------------------------
    # range ops (span regions)
    # ------------------------------------------------------------------

    def _clip(self, region: Region, start: bytes, end: bytes
              ) -> tuple[bytes, bytes]:
        s = max(start, region.start_key) if region.start_key else start
        if region.end_key:
            e = region.end_key if not end else min(end, region.end_key)
        else:
            e = end
        return s, e

    async def _ranged(self, start: bytes, end: bytes, make_op,
                      reverse: bool = False,
                      remaining=lambda results: -1) -> list:
        """Cursor walk over the regions intersecting [start, end).

        The region AND its clip are re-resolved from the current route
        table on every attempt, so a split racing the walk narrows the
        next step instead of wedging the whole call on a permanently
        out-of-range pre-clipped op (the server range-checks every op).
        ``make_op(s, e, remaining)`` builds the per-slice op;
        ``remaining(results)`` returns the item budget left (-1 =
        unlimited, 0 = stop).
        """
        results: list = []
        attempts = 0
        last = Status.error(RaftError.EAGAIN, "exhausted retries")
        cursor = end if reverse else start
        while remaining(results) != 0:
            lo, hi = (start, cursor) if reverse else (cursor, end)
            regions = self.route_table.find_regions_by_range(lo, hi)
            if not regions:
                await self._refresh_routes()
                regions = self.route_table.find_regions_by_range(lo, hi)
                if not regions:
                    break
            region = regions[-1] if reverse else regions[0]
            s, e = self._clip(region, lo, hi)
            try:
                results.append(await self._call_region(
                    region, make_op(s, e, remaining(results))))
                attempts = 0  # per-slice retry budget, not per-walk
            except _Retry as r:
                attempts += 1
                if attempts >= self.max_retries:
                    raise RheaKVError(r.status or last)
                if r.status is not None:
                    last = r.status
                if r.refresh:
                    await self._refresh_routes()
                await asyncio.sleep(self._backoff_s(attempts - 1))
                continue
            if reverse:
                if not region.start_key or (start and region.start_key <= start):
                    break
                cursor = region.start_key
            else:
                if not region.end_key or (end and region.end_key >= end):
                    break
                cursor = region.end_key
        return results

    @staticmethod
    def _scan_budget(limit: int):
        def remaining(parts: list) -> int:
            if limit < 0:
                return -1
            return max(limit - sum(len(p) for p in parts), 0)
        return remaining

    async def scan(self, start: bytes, end: bytes, limit: int = -1,
                   return_value: bool = True
                   ) -> list[tuple[bytes, Optional[bytes]]]:
        parts = await self._ranged(
            start, end,
            lambda s, e, rem: scan_op(s, e, rem, return_value),
            remaining=self._scan_budget(limit))
        return [kv for p in parts for kv in p]

    async def reverse_scan(self, start: bytes, end: bytes, limit: int = -1,
                           return_value: bool = True
                           ) -> list[tuple[bytes, Optional[bytes]]]:
        parts = await self._ranged(
            start, end,
            lambda s, e, rem: scan_op(s, e, rem, return_value, reverse=True),
            reverse=True,
            remaining=self._scan_budget(limit))
        return [kv for p in parts for kv in p]

    def iterator(self, start: bytes, end: bytes, buf_size: int = 64,
                 return_value: bool = True):
        """Paged async iterator over [start, end) (reference:
        ``DefaultRheaKVStore#iterator`` / ``RheaIterator``): fetches
        ``buf_size`` entries per scan RPC and yields ``(key, value)``
        in order, transparently crossing region boundaries::

            async for k, v in kv.iterator(b"a", b"z"):
                ...
        """
        if buf_size <= 0:
            raise ValueError("buf_size must be positive")
        return self._iterate(start, end, buf_size, return_value)

    async def _iterate(self, start: bytes, end: bytes, buf_size: int,
                       return_value: bool):
        cursor = start
        while True:
            page = await self.scan(cursor, end, limit=buf_size,
                                   return_value=return_value)
            for kv in page:
                yield kv
            if len(page) < buf_size:
                return
            cursor = page[-1][0] + b"\x00"   # smallest key after the last

    async def delete_range(self, start: bytes, end: bytes) -> bool:
        parts = await self._ranged(
            start, end,
            lambda s, e, rem: KVOperation.delete_range(s, e))
        return all(parts)

    # ------------------------------------------------------------------
    # sequences & locks
    # ------------------------------------------------------------------

    async def get_sequence(self, key: bytes, step: int) -> Sequence:
        start, end = await self._execute(key,
                                         KVOperation.get_sequence(key, step))
        return Sequence(start, end)

    async def get_latest_sequence(self, key: bytes) -> int:
        return (await self.get_sequence(key, 0)).start

    async def reset_sequence(self, key: bytes) -> bool:
        return await self._execute(key, KVOperation(KVOp.RESET_SEQUENCE, key))

    def get_distributed_lock(self, key: bytes, lease_ms: int = 30_000
                             ) -> "DistributedLock":
        return DistributedLock(self, key, lease_ms)


class _Retry(Exception):
    def __init__(self, refresh: bool = False,
                 status: Optional[Status] = None):
        self.refresh = refresh
        self.status = status


def _endpoint(peer_str: str) -> str:
    """PeerId string ('ip:port[:idx[:priority]][/learner]') -> endpoint."""
    return ":".join(peer_str.split("/", 1)[0].split(":")[:2])


class DistributedLock:
    """Lease-based distributed lock with fencing tokens.

    Reference parity: ``rhea:client/DefaultRheaKVStore#getDistributedLock``
    + ``KVOperation.KEY_LOCK`` (SURVEY.md §3.2 "Distributed lock &
    sequence").  ``watchdog`` renews the lease at lease/3 cadence while
    held (the reference leaves renewal to the caller's scheduler).
    """

    def __init__(self, store: RheaKVStore, key: bytes, lease_ms: int):
        self._store = store
        self.key = key
        self.lease_ms = lease_ms
        self.locker_id = uuid.uuid4().bytes
        self.fencing_token: int = -1
        self._held = False
        self._watchdog: Optional[asyncio.Task] = None

    @property
    def held(self) -> bool:
        return self._held

    async def try_lock(self, watchdog: bool = False) -> bool:
        ok, token, _owner = await self._store._execute(
            self.key,
            KVOperation.key_lock(self.key, self.locker_id, self.lease_ms,
                                 keep_lease=False))
        if ok:
            self.fencing_token = token
            self._held = True
            if watchdog and (self._watchdog is None or self._watchdog.done()):
                self._watchdog = asyncio.ensure_future(self._renew_loop())
        return ok

    async def lock(self, watchdog: bool = False,
                   retry_interval_ms: float = 200,
                   timeout_ms: Optional[float] = None) -> bool:
        """Block until acquired (or timeout)."""
        loop = asyncio.get_running_loop()
        deadline = None
        if timeout_ms is not None:
            # graftcheck: allow(raw-clock) — client-side retry budget:
            # the CALLER's real deadline
            deadline = loop.time() + timeout_ms / 1000.0
        while True:
            if await self.try_lock(watchdog=watchdog):
                return True
            # graftcheck: allow(raw-clock) — client-side retry budget: the CALLER's real deadline
            if deadline is not None and loop.time() >= deadline:
                return False
            await asyncio.sleep(retry_interval_ms / 1000.0)

    async def _renew_loop(self) -> None:
        try:
            while self._held:
                await asyncio.sleep(self.lease_ms / 3000.0)
                if not self._held:
                    break
                try:
                    ok, token, _ = await self._store._execute(
                        self.key,
                        KVOperation.key_lock(self.key, self.locker_id,
                                             self.lease_ms, keep_lease=True))
                except Exception:  # noqa: BLE001 — transient (election etc.)
                    # retry quickly; the lease may still be alive
                    await asyncio.sleep(self.lease_ms / 6000.0)
                    continue
                if not ok:
                    # someone else owns it now — we lost the lease for real
                    self._held = False
                    break
                if token != self.fencing_token:
                    # our lease lapsed and the store silently re-granted
                    # under a NEW fencing token: someone else may have held
                    # (and released) the lock in the gap, so continuity is
                    # broken — surrender the accidental re-acquisition
                    # rather than masquerade as an unbroken hold
                    self._held = False
                    try:
                        await self._store._execute(
                            self.key, KVOperation.key_unlock(
                                self.key, self.locker_id))
                    except Exception:  # noqa: BLE001 — lease will expire
                        pass
                    break
        except asyncio.CancelledError:
            pass
        finally:
            self._watchdog = None

    async def unlock(self) -> bool:
        self._held = False
        if self._watchdog is not None:
            self._watchdog.cancel()
            self._watchdog = None
        return await self._store._execute(
            self.key, KVOperation.key_unlock(self.key, self.locker_id))
