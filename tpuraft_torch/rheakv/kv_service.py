"""Region KV RPC service: wire messages + the store-side processor.

Reference parity: ``rhea:cmd/store/*`` requests +
``rhea:DefaultRegionKVService`` / ``KVCommandProcessor`` (SURVEY.md
§4.5): a request names a region and the client's view of its epoch; the
store checks the epoch (INVALID_REGION_EPOCH → client refreshes route),
then drives the region's RaftRawKVStore.

One generic ``KVCommandRequest`` carries any encoded KVOperation rather
than one message class per op — the op byte inside the blob dispatches.
Results travel as a tagged blob (see ``encode_result``).
"""

from __future__ import annotations

import asyncio
import struct
import time
from dataclasses import dataclass, field
from typing import Optional

from tpuraft_torch.core.read_only import ReadIndexError
from tpuraft_torch.util.trace import RECORDER, TRACER, store_proc, unpack_ctx
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.raft_store import KVStoreError
from tpuraft_torch.rpc.messages import register_message
from tpuraft_torch.rpc.transport import RpcError

# RheaKV-layer error codes (reference: rhea:errors/Errors enum)
ERR_INVALID_EPOCH = 2001
ERR_NO_REGION = 2002
ERR_STORE_BUSY = 2003
ERR_KEY_OUT_OF_RANGE = 2004


@dataclass
class KVCommandRequest:
    region_id: int
    conf_ver: int
    version: int
    op_blob: bytes  # encoded KVOperation
    # TRAILING trace-plane extension (old decoders stop before it):
    # the client op's trace context; 0 = untraced
    trace_id: int = 0


@dataclass
class KVCommandResponse:
    code: int = 0
    msg: str = ""
    result: bytes = b""       # tagged result blob
    region_meta: bytes = b""  # current Region encoding on epoch mismatch


@dataclass
class ListRegionsOnStoreRequest:
    pass


@dataclass
class ListRegionsOnStoreResponse:
    regions: list[bytes] = field(default_factory=list)  # Region encodings


@dataclass
class KVCommandBatchRequest:
    """Store-grouped command batch: ONE RPC carries many (region, op)
    items — the client groups everything pending by leader store the way
    the raft plane's ``multi_append`` groups log frames by endpoint.
    Each item blob packs (region_id, conf_ver, version, op_blob); see
    :func:`encode_batch_item`.  Epoch checks and result/error codes are
    PER ITEM — one stale region never fails its neighbours."""

    items: list[bytes] = field(default_factory=list)
    # TRAILING trace-plane extension: one packed i64 trace context per
    # item (util/trace.pack_ctx), b"" when nothing is traced — old
    # decoders stop before it, the untraced path pays zero wire bytes
    trace_ctx: bytes = b""


@dataclass
class KVCommandBatchResponse:
    """One reply blob per request item, in order (:func:`encode_batch_reply`)."""

    items: list[bytes] = field(default_factory=list)


@dataclass
class MergeAbsorbRequest:
    """Keyspace handoff (lifecycle plane): the SOURCE region's leader
    store hands the sealed range to the TARGET region's leader, which
    replicates it through the target group as a MERGE_ABSORB entry."""

    target_region_id: int = 0
    source_region_id: int = 0
    source_start: bytes = b""
    source_end: bytes = b""
    data_blob: bytes = b""    # serialized source range (RawKVStore codec)


@dataclass
class MergeAbsorbResponse:
    code: int = 0
    msg: str = ""


register_message(128, KVCommandRequest)
register_message(129, KVCommandResponse)
register_message(130, ListRegionsOnStoreRequest)
register_message(131, ListRegionsOnStoreResponse)
register_message(132, KVCommandBatchRequest)
register_message(133, KVCommandBatchResponse)
register_message(134, MergeAbsorbRequest)
register_message(135, MergeAbsorbResponse)


# ---- batch item / reply codecs ---------------------------------------------

_ITEM_HDR = struct.Struct("<qqq")   # region_id, conf_ver, version


def encode_batch_item(region_id: int, conf_ver: int, version: int,
                      op_blob: bytes) -> bytes:
    return _ITEM_HDR.pack(region_id, conf_ver, version) + op_blob


def decode_batch_item(blob: bytes) -> tuple[int, int, int, bytes]:
    region_id, conf_ver, version = _ITEM_HDR.unpack_from(blob, 0)
    return region_id, conf_ver, version, bytes(blob[_ITEM_HDR.size:])


def encode_batch_reply(code: int, msg: str = "", result: bytes = b"",
                       region_meta: bytes = b"") -> bytes:
    m = msg.encode()
    return (struct.pack("<qI", code, len(m)) + m
            + struct.pack("<I", len(result)) + result
            + struct.pack("<I", len(region_meta)) + region_meta)


def decode_batch_reply(blob: bytes) -> tuple[int, str, bytes, bytes]:
    buf = memoryview(blob)
    code, mlen = struct.unpack_from("<qI", buf, 0)
    off = 12
    msg = bytes(buf[off:off + mlen]).decode()
    off += mlen
    (rlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    result = bytes(buf[off:off + rlen])
    off += rlen
    (glen,) = struct.unpack_from("<I", buf, off)
    off += 4
    return code, msg, result, bytes(buf[off:off + glen])


# ---- tagged result codec ---------------------------------------------------

_T_NONE, _T_BOOL, _T_BYTES, _T_SEQ, _T_PAIRS, _T_LOCK = range(6)


def encode_result(result) -> bytes:
    if result is None:
        return struct.pack("<B", _T_NONE)
    if isinstance(result, bool):
        return struct.pack("<BB", _T_BOOL, int(result))
    if isinstance(result, bytes):
        return struct.pack("<B", _T_BYTES) + result
    if isinstance(result, tuple) and len(result) == 2 \
            and all(isinstance(x, int) for x in result):
        return struct.pack("<Bqq", _T_SEQ, result[0], result[1])
    if isinstance(result, tuple) and len(result) == 3:  # lock triple
        ok, token, owner = result
        return (struct.pack("<BBq", _T_LOCK, int(ok), token)
                + struct.pack("<I", len(owner)) + owner)
    if isinstance(result, list):  # list[(key, Optional[value])]
        out = bytearray(struct.pack("<BI", _T_PAIRS, len(result)))
        for k, v in result:
            out += struct.pack("<I", len(k)) + k
            if v is None:
                out += struct.pack("<i", -1)
            else:
                out += struct.pack("<i", len(v)) + v
        return bytes(out)
    raise TypeError(f"cannot encode KV result {result!r}")


def decode_result(blob: bytes):
    buf = memoryview(blob)
    (tag,) = struct.unpack_from("<B", buf, 0)
    if tag == _T_NONE:
        return None
    if tag == _T_BOOL:
        return bool(buf[1])
    if tag == _T_BYTES:
        return bytes(buf[1:])
    if tag == _T_SEQ:
        a, b = struct.unpack_from("<qq", buf, 1)
        return (a, b)
    if tag == _T_LOCK:
        ok, token = struct.unpack_from("<Bq", buf, 1)
        (n,) = struct.unpack_from("<I", buf, 10)
        owner = bytes(buf[14:14 + n])
        return (bool(ok), token, owner)
    if tag == _T_PAIRS:
        (n,) = struct.unpack_from("<I", buf, 1)
        off = 5
        out = []
        for _ in range(n):
            (kl,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = bytes(buf[off:off + kl])
            off += kl
            (vl,) = struct.unpack_from("<i", buf, off)
            off += 4
            if vl < 0:
                out.append((k, None))
            else:
                out.append((k, bytes(buf[off:off + vl])))
                off += vl
        return out
    raise ValueError(f"bad result tag {tag}")


# ---- store-side processor ---------------------------------------------------

# ops a follower may NOT serve; everything routes through the region leader
_WRITE_OPS = {
    KVOp.PUT, KVOp.PUT_IF_ABSENT, KVOp.DELETE, KVOp.COMPARE_PUT,
    KVOp.DELETE_RANGE, KVOp.GET_SEQUENCE, KVOp.MERGE, KVOp.PUT_LIST,
    KVOp.DELETE_LIST, KVOp.GET_AND_PUT, KVOp.RESET_SEQUENCE, KVOp.KEY_LOCK,
    KVOp.KEY_LOCK_RELEASE, KVOp.RANGE_SPLIT,
}


# graftcheck: loop-confined — handlers run on the store's RPC loop;
# counters are lockless by that confinement
class KVCommandProcessor:
    """Registered as methods ``kv_command`` (one op, one region) and
    ``kv_command_batch`` (store-grouped: many regions' ops in one RPC,
    per-item epoch checks and per-item results) on the store's RpcServer."""

    def __init__(self, store_engine) -> None:
        self._se = store_engine
        # trace-plane process identity: spans emitted by this store's
        # handlers land on their own pid row even when several stores
        # share one OS process (the in-proc bench/test topology)
        self._proc = store_proc(store_engine.server_id)
        # per-region heat intake (fleet observability): writes noted at
        # admission (op count + op-blob bytes in), reads at serve (op
        # count + reply bytes out) — one dict bump per item, the O(1)
        # hot-path contract the bench-gate heat row enforces
        self._heat = store_engine.heat
        store_engine.rpc_server.register("kv_command", self.handle)
        store_engine.rpc_server.register("kv_command_batch",
                                         self.handle_batch)
        store_engine.rpc_server.register("kv_list_regions",
                                         self.handle_list_regions)
        store_engine.rpc_server.register("kv_merge_absorb",
                                         self.handle_merge_absorb)
        # observability (bench counters / wire-compat tests)
        self.batch_rpcs = 0      # kv_command_batch RPCs served
        self.batch_items = 0     # items carried inside them
        self.batch_regions = 0   # distinct regions proposed per batch, summed
        self.single_rpcs = 0     # legacy per-op kv_command RPCs served
        # serving-plane degradation (gray failures): items currently in
        # the propose/apply pipe, and how many we bounced with EBUSY +
        # retry-after because the store was SICK past the backlog bound
        self.inflight_items = 0
        self.shed_items = 0
        # read plane: N batched GETs of one region cost ONE read_index
        # fence (fenced_reads / read_fences = the amortization ratio)
        self.read_fences = 0     # read_index barriers taken for batches
        self.fenced_reads = 0    # read ops served under those barriers

    async def handle_list_regions(self, req: ListRegionsOnStoreRequest
                                  ) -> ListRegionsOnStoreResponse:
        """Region discovery for PD-less clients (split makes new regions
        the static route table has never heard of)."""
        return ListRegionsOnStoreResponse(
            regions=[r.encode() for r in self._se.list_regions()])

    async def handle_merge_absorb(self, req: MergeAbsorbRequest
                                  ) -> MergeAbsorbResponse:
        """Target-side half of a region merge: replicate the handed-over
        keyspace through the target group (store-to-store RPC — the
        source leader calls this after its seal barrier applied)."""
        engine = self._se.get_region_engine(req.target_region_id)
        if engine is None:
            return MergeAbsorbResponse(
                code=ERR_NO_REGION,
                msg=f"target region {req.target_region_id} not on "
                    f"store {self._se.server_id}")
        try:
            await engine.raft_store.merge_absorb(
                req.source_region_id, req.source_start, req.source_end,
                req.data_blob)
        except KVStoreError as e:
            # EPERM (not leader) / ESTATEMACHINE etc. bounce to the
            # source store, which retries against the fresh leader
            return MergeAbsorbResponse(code=e.status.code,
                                       msg=e.status.error_msg)
        except Exception as e:  # noqa: BLE001
            return MergeAbsorbResponse(code=int(RaftError.EINTERNAL),
                                       msg=str(e))
        return MergeAbsorbResponse()

    def _validate(self, region_id: int, conf_ver: int, version: int,
                  op_blob: bytes):
        """Shared per-item admission: returns either ``(None, engine, op)``
        or ``((code, msg, region_meta), None, None)`` on rejection."""
        engine = self._se.get_region_engine(region_id)
        if engine is None:
            return ((ERR_NO_REGION,
                     f"region {region_id} not on store {self._se.server_id}",
                     b""), None, None)
        region = engine.region
        if (region.epoch.conf_ver != conf_ver
                or region.epoch.version != version):
            return ((ERR_INVALID_EPOCH,
                     (f"region {region_id} epoch is "
                      f"{region.epoch.conf_ver}.{region.epoch.version}, "
                      f"client sent {conf_ver}.{version}"),
                     region.encode()), None, None)
        op = KVOperation.decode(op_blob)
        if op.op in _WRITE_OPS \
                and (engine.sealing
                     or getattr(engine.fsm, "sealed_into", -1) >= 0):
            # merge barrier: new writes bounce RETRYABLY the moment the
            # seal is decided (leader-local `sealing` covers the window
            # before the entry applies); reads keep serving off the
            # immutable sealed range until retirement.  The client
            # retries, lands ERR_NO_REGION after retirement, refreshes
            # and reroutes into the absorbing region.
            return ((ERR_STORE_BUSY,
                     f"region {region_id} sealed for merge "
                     f"(retry-after-ms=100)", b""), None, None)
        if not _keys_in_region(op, region):
            # epoch matched but a key escapes the range: the client grouped
            # a batch against a route view that split under it — make it
            # re-shard rather than silently committing through this group
            return ((ERR_KEY_OUT_OF_RANGE,
                     f"key(s) outside region {region_id} range",
                     region.encode()), None, None)
        return None, engine, op

    async def _execute_op(self, rs, op: KVOperation
                          ) -> tuple[int, str, object]:
        """Run one admitted op through the region store; (code, msg, result)."""
        try:
            if op.op in _WRITE_OPS:
                result = await rs.apply(op)
            else:
                # ONE dispatch table for reads: fence here, then the
                # same local-serve path the batched fast path uses —
                # on the apply lane when one owns the store
                await rs.node.read_index()
                if rs.lane is not None:
                    return await rs.lane.submit(_serve_read_local, rs, op)
                return _serve_read_local(rs, op)
        except KVStoreError as e:
            return e.status.code, e.status.error_msg, None
        except (RpcError, ReadIndexError) as e:
            # keep the real status code: ETIMEDOUT/EPERM/ERAFTTIMEDOUT are
            # retryable by the client; EINTERNAL would hard-fail the call
            return e.status.code, e.status.error_msg, None
        except Exception as e:  # noqa: BLE001
            return int(RaftError.EINTERNAL), str(e), None
        return 0, "", result

    async def handle(self, req: KVCommandRequest) -> KVCommandResponse:
        self.single_rpcs += 1
        if self._se.draining:
            # SIGTERM drain: bounce NEW work with a retryable busy (the
            # client re-offers it to the surviving stores) while already
            # admitted items finish and ack — see StoreEngine.drain
            return KVCommandResponse(
                code=ERR_STORE_BUSY,
                msg="store draining (retry-after-ms=100)")
        shed, retry_ms = self._se.should_shed()
        if shed:
            self.shed_items += 1
            # coalesced: shed fires at REQUEST rate during the exact
            # incident the recorder ring must survive
            RECORDER.record_coalesced("shed", str(self._se.server_id),
                                      items=1, retry_ms=retry_ms)
            return KVCommandResponse(
                code=ERR_STORE_BUSY,
                msg=f"store sick: shedding (retry-after-ms={retry_ms})")
        rejected, engine, op = self._validate(
            req.region_id, req.conf_ver, req.version, req.op_blob)
        if rejected is not None:
            code, msg, meta = rejected
            return KVCommandResponse(code=code, msg=msg, region_meta=meta)
        if req.trace_id and TRACER.enabled:
            # same gate as the batch path: a wire-borne context only
            # produces spans where the local tracer is armed
            op.trace_id = req.trace_id
        is_write = op.op in _WRITE_OPS
        if is_write:
            # disk-pressure admission (FULL): shed WRITES retryably,
            # keep serving reads — a full store remains a useful read
            # replica while reclaim frees space (ISSUE 17 layer 3)
            wshed, wretry = self._se.should_shed_writes()
            if wshed:
                self._se.disk_shed_items += 1
                RECORDER.record_coalesced("disk_shed",
                                          str(self._se.server_id),
                                          items=1, retry_ms=wretry)
                return KVCommandResponse(
                    code=ERR_STORE_BUSY,
                    msg=f"store disk full: shedding writes "
                        f"(retry-after-ms={wretry})")
        if self._heat is not None and is_write:
            self._heat.note_write(req.region_id, 1, len(req.op_blob))
        self.inflight_items += 1
        try:
            code, msg, result = await self._execute_op(engine.raft_store, op)
        finally:
            self.inflight_items -= 1
        if code:
            return KVCommandResponse(code=code, msg=msg)
        blob = encode_result(result)
        if self._heat is not None and not is_write:
            self._heat.note_read(req.region_id, 1, len(blob))
        return KVCommandResponse(result=blob)

    async def handle_batch(self, req: KVCommandBatchRequest
                           ) -> KVCommandBatchResponse:
        """The store-grouped fast path: validate every item, then propose
        each region's write sub-batch as ONE multi-op log entry — every
        region's quorum round runs CONCURRENTLY instead of op-by-op
        through sequential ``kv_command`` handlers."""
        self.batch_rpcs += 1
        self.batch_items += len(req.items)
        if self._se.draining:
            bounce = encode_batch_reply(
                ERR_STORE_BUSY, "store draining (retry-after-ms=100)")
            return KVCommandBatchResponse(items=[bounce] * len(req.items))
        # serving-plane degradation: under a SICK local score with the
        # pipe already backed up, SHED — a deadline-aware EBUSY with a
        # retry-after hint beats queueing 256 workers behind a stalling
        # disk into p99=inf (the client treats it as retryable and its
        # jittered backoff spreads the re-offered load; by then
        # evacuation has usually moved leadership off this store)
        shed, retry_ms = self._se.should_shed()
        if shed:
            self.shed_items += len(req.items)
            RECORDER.record_coalesced("shed", str(self._se.server_id),
                                      items=len(req.items),
                                      retry_ms=retry_ms)
            bounce = encode_batch_reply(
                ERR_STORE_BUSY,
                f"store sick: shedding (retry-after-ms={retry_ms})")
            return KVCommandBatchResponse(items=[bounce] * len(req.items))
        self.inflight_items += len(req.items)
        try:
            return await self._handle_batch_admitted(req)
        finally:
            self.inflight_items -= len(req.items)

    async def _handle_batch_admitted(self, req: KVCommandBatchRequest
                                     ) -> KVCommandBatchResponse:
        replies: list[bytes] = [b""] * len(req.items)
        groups: dict[int, list[tuple[int, KVOperation]]] = {}
        # trace plane: per-item contexts ride the trailing trace_ctx
        # field; adopting them onto the decoded ops lets the propose /
        # flush / apply stages downstream join the client's trace
        tids = (unpack_ctx(req.trace_ctx, len(req.items))
                if TRACER.enabled and req.trace_ctx else None)
        v0 = time.perf_counter() if tids else 0.0
        # disk-pressure admission (FULL): per-ITEM, not whole-batch —
        # the batch's reads keep serving while its writes bounce with
        # the retryable busy (ISSUE 17: a full store stays a read
        # replica; the client re-offers writes after retry-after)
        wshed, wretry = self._se.should_shed_writes()
        wsheds = 0
        for i, blob in enumerate(req.items):
            region_id, conf_ver, version, op_blob = decode_batch_item(blob)
            rejected, engine, op = self._validate(
                region_id, conf_ver, version, op_blob)
            if rejected is not None:
                code, msg, meta = rejected
                replies[i] = encode_batch_reply(code, msg, region_meta=meta)
                continue
            if wshed and op.op in _WRITE_OPS:
                wsheds += 1
                replies[i] = encode_batch_reply(
                    ERR_STORE_BUSY,
                    f"store disk full: shedding writes "
                    f"(retry-after-ms={wretry})")
                continue
            if tids and tids[i]:
                op.trace_id = tids[i]
            if self._heat is not None and op.op in _WRITE_OPS:
                self._heat.note_write(region_id, 1, len(op_blob))
            groups.setdefault(region_id, []).append((i, op))
        if wsheds:
            self._se.disk_shed_items += wsheds
            RECORDER.record_coalesced("disk_shed", str(self._se.server_id),
                                      items=wsheds, retry_ms=wretry)
        if tids:
            v1 = time.perf_counter()
            for tid in tids:
                if tid:
                    TRACER.span(tid, "srv_validate", v0, v1,
                                proc=self._proc)
        self.batch_regions += len(groups)

        async def run_region(rid: int, items: list) -> None:
            engine = self._se.get_region_engine(rid)
            if engine is None:   # vanished between validation and here
                for i, _ in items:
                    replies[i] = encode_batch_reply(
                        ERR_NO_REGION, f"region {rid} dropped mid-batch")
                return
            rs = engine.raft_store
            writes = [(i, op) for i, op in items if op.op in _WRITE_OPS]
            reads = [(i, op) for i, op in items if op.op not in _WRITE_OPS]

            async def run_writes():
                try:
                    outs = await rs.apply_multi([op for _, op in writes])
                    for (i, _), (st, result) in zip(writes, outs):
                        replies[i] = (
                            encode_batch_reply(0, result=encode_result(result))
                            if st.is_ok()
                            else encode_batch_reply(st.code, st.error_msg))
                except KVStoreError as e:
                    for i, _ in writes:
                        replies[i] = encode_batch_reply(e.status.code,
                                                        e.status.error_msg)
                except Exception as e:  # noqa: BLE001
                    for i, _ in writes:
                        replies[i] = encode_batch_reply(
                            int(RaftError.EINTERNAL), str(e))

            async def run_reads() -> None:
                # ONE read fence for the whole region sub-batch: every
                # read here was pinned before the fence's confirmation
                # round started, so serving all of them at the fenced
                # index is linearizable — and a kv_command_batch with N
                # GETs for one region costs one confirmation, not N
                rtids = ([op.trace_id for _, op in reads if op.trace_id]
                         if TRACER.enabled else [])
                f0 = time.perf_counter() if rtids else 0.0
                try:
                    await rs.node.read_index()
                except (RpcError, ReadIndexError) as e:
                    # keep the real (retryable) status per item
                    for i, _ in reads:
                        replies[i] = encode_batch_reply(e.status.code,
                                                        e.status.error_msg)
                    return
                except Exception as e:  # noqa: BLE001
                    for i, _ in reads:
                        replies[i] = encode_batch_reply(
                            int(RaftError.EINTERNAL), str(e))
                    return
                self.read_fences += 1
                self.fenced_reads += len(reads)
                if rtids:
                    f1 = time.perf_counter()
                    for tid in rtids:
                        TRACER.span(tid, "srv_read_fence", f0, f1,
                                    proc=self._proc)
                served = out_bytes = 0
                lane = rs.lane
                if lane is not None:
                    # lane mode: the lane thread owns the store — serve
                    # the whole fenced sub-batch in ONE lane hop (one
                    # shared serve-span envelope for traced ops)
                    s0 = time.perf_counter() if rtids else 0.0
                    outs = await lane.submit(_serve_reads_sync, rs, reads)
                    if rtids:
                        s1 = time.perf_counter()
                        for tid in rtids:
                            TRACER.span(tid, "srv_read_serve", s0, s1,
                                        proc=self._proc)
                    for (i, _op), (code, msg, result) in zip(reads, outs):
                        replies[i] = (
                            encode_batch_reply(0,
                                               result=encode_result(result))
                            if code == 0 else encode_batch_reply(code, msg))
                        if code == 0:
                            served += 1
                            out_bytes += len(replies[i])
                else:
                    for i, op in reads:
                        s0 = time.perf_counter() if op.trace_id else 0.0
                        code, msg, result = _serve_read_local(rs, op)
                        if op.trace_id:
                            TRACER.span(op.trace_id, "srv_read_serve", s0,
                                        time.perf_counter(), proc=self._proc)
                        replies[i] = (
                            encode_batch_reply(0,
                                               result=encode_result(result))
                            if code == 0 else encode_batch_reply(code, msg))
                        if code == 0:
                            served += 1
                            out_bytes += len(replies[i])
                if served and self._heat is not None:
                    self._heat.note_read(rid, served, out_bytes)

            if not reads:
                # the pure-write sub-batch (the w256 shape): no gather
                # layer — one less task per region per RPC on the
                # saturated write path
                await run_writes()
            elif not writes:
                await run_reads()
            else:
                await asyncio.gather(run_writes(), run_reads())

        # pure-write region groups skip the task layer ENTIRELY:
        # submit_multi queues the region's ONE MULTI entry synchronously
        # and hands back a plain future — a kv_command_batch spanning
        # hundreds of regions (the w256 shape at 1024 regions) costs one
        # gather over futures instead of one task per region.  Mixed and
        # read groups keep the run_region coroutine (the read fence must
        # be awaited per region).
        lite: list[tuple[list, asyncio.Future]] = []
        tasks = []
        for rid, items in groups.items():
            fut = None
            if all(op.op in _WRITE_OPS for _, op in items):
                engine = self._se.get_region_engine(rid)
                if engine is None:  # vanished between validation and here
                    for i, _ in items:
                        replies[i] = encode_batch_reply(
                            ERR_NO_REGION, f"region {rid} dropped mid-batch")
                    continue
                fut = engine.raft_store.submit_multi(
                    [op for _, op in items])
            if fut is None:
                tasks.append(run_region(rid, items))
            else:
                lite.append((items, fut))
        if lite or tasks:
            results = await asyncio.gather(
                *(f for _, f in lite), *tasks, return_exceptions=True)
            for (items, _f), res in zip(lite, results):
                if isinstance(res, KVStoreError):
                    for i, _ in items:
                        replies[i] = encode_batch_reply(res.status.code,
                                                        res.status.error_msg)
                elif isinstance(res, BaseException):
                    for i, _ in items:
                        replies[i] = encode_batch_reply(
                            int(RaftError.EINTERNAL), str(res))
                else:
                    for (i, _), (st, result) in zip(items, res):
                        replies[i] = (
                            encode_batch_reply(0,
                                               result=encode_result(result))
                            if st.is_ok()
                            else encode_batch_reply(st.code, st.error_msg))
        return KVCommandBatchResponse(items=replies)


def _serve_read_local(rs, op: KVOperation) -> tuple[int, str, object]:
    """Serve one read-only op DIRECTLY off the local store — the caller
    already holds the region's read fence (read_index + wait_applied),
    so no per-op barrier is taken."""
    try:
        if op.op == KVOp.GET:
            result = rs.store.get(op.key)
        elif op.op == KVOp.MULTI_GET:
            keys = KVOperation.unpack_key_list(op.value)
            got = rs.store.multi_get(keys)
            result = [(k, got[k]) for k in keys]
        elif op.op == KVOp.CONTAINS_KEY:
            result = rs.store.contains_key(op.key)
        elif op.op == KVOp.SCAN:
            (limit, rv, reverse) = struct.unpack("<iBB", op.aux)
            scan = rs.store.reverse_scan if reverse else rs.store.scan
            result = scan(op.key, op.value, limit, bool(rv))
        else:
            return int(RaftError.EINVAL), f"bad read op {op.op}", None
    except Exception as e:  # noqa: BLE001
        return int(RaftError.EINTERNAL), str(e), None
    return 0, "", result


def _serve_reads_sync(rs, reads: list) -> list[tuple[int, str, object]]:
    """One lane job serving a whole fenced region read sub-batch."""
    return [_serve_read_local(rs, op) for _, op in reads]


_SINGLE_KEY_OPS = {
    KVOp.PUT, KVOp.PUT_IF_ABSENT, KVOp.DELETE, KVOp.COMPARE_PUT,
    KVOp.GET_SEQUENCE, KVOp.MERGE, KVOp.GET_AND_PUT, KVOp.RESET_SEQUENCE,
    KVOp.KEY_LOCK, KVOp.KEY_LOCK_RELEASE, KVOp.RANGE_SPLIT, KVOp.GET,
    KVOp.CONTAINS_KEY,
}


def _keys_in_region(op: KVOperation, region: Region) -> bool:
    code = op.op
    if code in _SINGLE_KEY_OPS:
        return region.contains_key(op.key)
    if code in (KVOp.DELETE_RANGE, KVOp.SCAN):
        return region.contains_range(op.key, op.value)
    if code == KVOp.PUT_LIST:
        return all(region.contains_key(k)
                   for k, _ in KVOperation.unpack_kv_list(op.value))
    if code in (KVOp.DELETE_LIST, KVOp.MULTI_GET):
        return all(region.contains_key(k)
                   for k in KVOperation.unpack_key_list(op.value))
    return True


def scan_op(start: bytes, end: bytes, limit: int = -1,
            return_value: bool = True, reverse: bool = False) -> KVOperation:
    return KVOperation(KVOp.SCAN, start, end,
                       struct.pack("<iBB", limit, int(return_value),
                                   int(reverse)))
