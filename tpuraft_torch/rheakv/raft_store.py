"""RaftRawKVStore: the async KV API that routes writes through raft.

Reference parity: ``rhea:storage/RaftRawKVStore`` (SURVEY.md §4.5) —
every mutation becomes a serialized KVOperation applied via
``Node#apply``; reads take the readIndex barrier then read the local
store (linearizable without a log write — reference routes reads through
``Node#readIndex`` the same way).
"""

from __future__ import annotations

import asyncio
import struct
import time
from typing import Optional

from tpuraft_torch.core.node import Node
from tpuraft_torch.entity import Task
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
from tpuraft_torch.rheakv.raw_store import RawKVStore, Sequence
from tpuraft_torch.rheakv.state_machine import KVClosure
from tpuraft_torch.util.trace import TRACER, store_proc


class KVStoreError(Exception):
    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status


# blind writes: ops whose FSM result is known a priori (always True) —
# the set eligible for ack-at-commit (the pipelined-apply fast path);
# anything whose result depends on store state (CAS, sequences, locks,
# reads-via-log) must wait for its apply
_BLIND_OPS = frozenset((KVOp.PUT, KVOp.DELETE, KVOp.PUT_LIST,
                        KVOp.DELETE_LIST, KVOp.DELETE_RANGE, KVOp.MERGE))

_NOT_EAGER = object()


class RaftRawKVStore:
    def __init__(self, node: Node, store: RawKVStore,
                 apply_batch: int = 32, multi_entries: bool = True,
                 ack_at_commit: bool = True, lane=None):
        self.node = node
        self.store = store
        # apply worker lane (StoreEngineOptions.apply_lane): when set,
        # the lane thread owns the raw store — local reads below are
        # SUBMITTED through it (queue FIFO is the happens-before edge
        # past the read fence) instead of touching the store from the
        # loop while another region's apply mutates it
        self.lane = lane
        # pipelined apply: blind writes ack their proposer at COMMIT
        # (the entry's linearization point — the result is known a
        # priori) and the FSM applies behind in coalesced batches;
        # reads still observe applied state through the read fence
        # (read_index + wait_applied).  False = ack after apply (the
        # pre-write-plane behavior).
        self._ack_at_commit = ack_at_commit
        # multi_entries=False is the mixed-version escape hatch: a
        # KVOp.MULTI log entry replicated to a pre-batch replica would
        # fail its apply (unknown op) and silently diverge state — in a
        # rolling upgrade, keep per-op entries until every store's FSM
        # understands MULTI (StoreEngineOptions.multi_op_entries)
        self._multi_entries = multi_entries
        # server-side apply micro-batching (reference: the apply
        # Disruptor drains up to applyBatch=32 tasks per event):
        # concurrent RPC handlers coalesce into ONE Node.apply_batch —
        # one node-lock acquisition and one flush wait per drain round
        # instead of per op
        self._apply_batch = max(1, apply_batch)
        self._pending: list[tuple[bytes, asyncio.Future, int]] = []
        self._drainer: Optional[asyncio.Task] = None
        # propose-plane observability (fleet metrics): drain rounds and
        # the entries they coalesced — proposed_ops/propose_drains is
        # the live write-amortization factor (ROADMAP item 1's number)
        self.propose_drains = 0
        self.proposed_ops = 0
        # trace-plane process identity for the propose-stage span
        self._proc = store_proc(node.server_id)

    # -- write path (through the log) ---------------------------------------

    async def apply(self, op: KVOperation, eager_result=_NOT_EAGER):
        """Replicate one KVOperation through the region's raft group and
        return its FSM result (public API — the KV command processors
        drive proposals through here).  Raises :class:`KVStoreError` on
        a failed proposal or a failed apply.

        ``eager_result``: pipelined-apply fast path — when set (or
        derived below for blind ops), the proposal acks at COMMIT with
        this pre-known result instead of waiting for the FSM apply."""
        if eager_result is _NOT_EAGER and self._ack_at_commit \
                and op.op in _BLIND_OPS:
            eager_result = True  # blind writes always apply to True
        elif not self._ack_at_commit:
            eager_result = _NOT_EAGER
        fut = asyncio.get_running_loop().create_future()
        # encode HERE, not in the drainer: a malformed op (bad key
        # type) must fail its own caller, not kill the drain task and
        # hang every op coalesced into the same batch
        blob = op.encode()
        tid = op.trace_id
        # propose-stage span: drain-queue wait + node.apply_batch (lock
        # + stage + fsync wait) + quorum round + FSM apply, ending when
        # the closure resolves — the server-side submit→ack envelope
        t0 = time.perf_counter() if tid else 0.0
        self._pending.append((blob, fut, tid, eager_result))
        if self._drainer is None or self._drainer.done():
            self._drainer = asyncio.ensure_future(self._drain())
        status, result = await fut
        if tid:
            TRACER.span(tid, "srv_propose", t0, time.perf_counter(),
                        proc=self._proc, ok=status.is_ok())
        if not status.is_ok():
            raise KVStoreError(status)
        return result

    # compat alias (pre-batch callers reached into the private name)
    _apply = apply

    async def apply_multi(self, ops: list[KVOperation]
                          ) -> list[tuple[Status, object]]:
        """Replicate MANY ops as ONE log entry (one quorum round, one
        fsync amortized over the whole sub-batch) and return per-op
        ``(status, result)`` — the server side of ``kv_command_batch``'s
        cross-region fan-out.  A sub-op failure fails only its slot; a
        failed PROPOSAL (not leader, shutting down) raises for the whole
        batch, exactly like :meth:`apply`."""
        if not ops:
            return []
        if len(ops) == 1:
            # no wrapping overhead for the degenerate batch
            try:
                return [(Status.OK(), await self.apply(ops[0]))]
            except KVStoreError as e:
                if e.status.code == int(RaftError.ESTATEMACHINE):
                    return [(e.status, None)]  # op-level, not proposal-level
                raise
        if not self._multi_entries:
            # per-op log entries (pre-batch-replica compatible): the
            # sub-batch still coalesces into one drain round / one
            # node-lock acquisition, just without log-entry amortization
            outs = await asyncio.gather(*(self.apply(op) for op in ops),
                                        return_exceptions=True)
            results: list[tuple[Status, object]] = []
            for out in outs:
                if isinstance(out, KVStoreError):
                    results.append((out.status, None))
                elif isinstance(out, BaseException):
                    raise out
                else:
                    results.append((Status.OK(), out))
            return results
        mop = KVOperation.multi(ops)
        # the MULTI entry carries ONE trace context: the first traced
        # sub-op's (the whole sub-batch shares one log entry / quorum
        # round, so its flush/quorum/apply stages are genuinely shared)
        mop.trace_id = next((o.trace_id for o in ops if o.trace_id), 0)
        eager = _NOT_EAGER
        if self._ack_at_commit and all(o.op in _BLIND_OPS for o in ops):
            # an all-blind MULTI's per-op outcomes are known a priori
            # too — ack the whole sub-batch at commit, apply behind
            eager = [(0, "", True)] * len(ops)
        outs = await self.apply(mop, eager_result=eager)
        return [(Status.OK() if code == 0 else Status(code, msg), result)
                for code, msg, result in outs]

    def submit_multi(self, ops: list[KVOperation]
                     ) -> Optional[asyncio.Future]:
        """Task-free region sub-batch submission: encode ONE MULTI log
        entry, queue it for the propose drainer, and return a plain
        future resolving to per-op ``(Status, result)`` (or raising
        :class:`KVStoreError` on a failed PROPOSAL, like
        :meth:`apply_multi`).  The batch handler collects MANY regions'
        futures into ONE gather instead of spawning a task per region —
        the server half of the per-op task fan the loop profile blamed.

        Returns ``None`` when multi-op entries are disabled (the
        mixed-version escape hatch) — the caller falls back to the
        task-per-region path."""
        if not self._multi_entries:
            return None
        loop = asyncio.get_running_loop()
        out = loop.create_future()
        if not ops:
            out.set_result([])
            return out
        mop = KVOperation.multi(ops)
        mop.trace_id = next((o.trace_id for o in ops if o.trace_id), 0)
        eager = _NOT_EAGER
        if self._ack_at_commit and all(o.op in _BLIND_OPS for o in ops):
            eager = [(0, "", True)] * len(ops)
        try:
            blob = mop.encode()
        except Exception as e:  # noqa: BLE001 — fail this batch only
            out.set_exception(KVStoreError(
                Status.error(RaftError.EINVAL, f"encode: {e!r}")))
            return out
        tid = mop.trace_id
        t0 = time.perf_counter() if tid else 0.0
        inner = loop.create_future()
        self._pending.append((blob, inner, tid, eager))
        if self._drainer is None or self._drainer.done():
            self._drainer = asyncio.ensure_future(self._drain())
        proc = self._proc

        def _resolve(f: asyncio.Future) -> None:
            if f.cancelled():
                return
            status, result = f.result()
            if tid:
                TRACER.span(tid, "srv_propose", t0, time.perf_counter(),
                            proc=proc, ok=status.is_ok())
            if out.done():
                return
            if not status.is_ok():
                out.set_exception(KVStoreError(status))
                return
            out.set_result([(Status.OK() if code == 0 else Status(code, msg),
                             res) for code, msg, res in result])

        inner.add_done_callback(_resolve)
        return out

    async def _drain(self) -> None:
        # same drain-until-empty invariant as ReadOnlyService's rounds:
        # ops queued while a batch is in flight are picked up by the
        # next loop iteration, never orphaned
        while self._pending:
            batch = self._pending[:self._apply_batch]
            del self._pending[:len(batch)]
            self.propose_drains += 1
            self.proposed_ops += len(batch)
            tasks = []
            for blob, fut, tid, eager_result in batch:
                closure = KVClosure(fut)
                if eager_result is not _NOT_EAGER:
                    # ack-at-commit: the result is pre-known, so the
                    # closure carries it from the start — the commit
                    # fires it, the apply behind finds the future done
                    closure.result = eager_result
                tasks.append(Task(data=blob, done=closure, trace_id=tid,
                                  ack_at_commit=eager_result
                                  is not _NOT_EAGER))
            try:
                await self.node.apply_batch(tasks)
            except Exception as e:  # noqa: BLE001 — fail THIS batch only
                st = Status.error(RaftError.EINTERNAL, f"apply: {e!r}")
                for _, fut, _tid, _eager in batch:
                    if not fut.done():
                        fut.set_result((st, None))

    async def put(self, key: bytes, value: bytes) -> bool:
        return await self._apply(KVOperation(KVOp.PUT, key, value))

    async def put_if_absent(self, key: bytes, value: bytes) -> Optional[bytes]:
        return await self._apply(KVOperation(KVOp.PUT_IF_ABSENT, key, value))

    async def get_and_put(self, key: bytes, value: bytes) -> Optional[bytes]:
        return await self._apply(KVOperation(KVOp.GET_AND_PUT, key, value))

    async def compare_and_put(self, key: bytes, expect: bytes,
                              update: bytes) -> bool:
        return await self._apply(KVOperation.cas(key, expect, update))

    async def merge(self, key: bytes, value: bytes) -> bool:
        return await self._apply(KVOperation(KVOp.MERGE, key, value))

    async def put_list(self, kvs: list[tuple[bytes, bytes]]) -> bool:
        return await self._apply(KVOperation.put_list(kvs))

    async def delete(self, key: bytes) -> bool:
        return await self._apply(KVOperation(KVOp.DELETE, key))

    async def delete_list(self, keys: list[bytes]) -> bool:
        return await self._apply(KVOperation.delete_list(keys))

    async def delete_range(self, start: bytes, end: bytes) -> bool:
        return await self._apply(KVOperation.delete_range(start, end))

    async def get_sequence(self, key: bytes, step: int) -> Sequence:
        if step < 0:
            raise KVStoreError(Status.error(RaftError.EINVAL, "step < 0"))
        if step == 0:  # pure read of the current value
            start, end = await self._apply(KVOperation.get_sequence(key, 0))
            return Sequence(start, end)
        start, end = await self._apply(KVOperation.get_sequence(key, step))
        return Sequence(start, end)

    async def reset_sequence(self, key: bytes) -> bool:
        return await self._apply(KVOperation(KVOp.RESET_SEQUENCE, key))

    async def try_lock_with(self, key: bytes, locker_id: bytes, lease_ms: int,
                            keep_lease: bool = False
                            ) -> tuple[bool, int, bytes]:
        return await self._apply(
            KVOperation.key_lock(key, locker_id, lease_ms, keep_lease))

    async def release_lock(self, key: bytes, locker_id: bytes) -> bool:
        return await self._apply(KVOperation.key_unlock(key, locker_id))

    async def range_split(self, new_region_id: int, split_key: bytes) -> bool:
        return await self._apply(
            KVOperation.range_split(new_region_id, split_key))

    # -- region-merge choreography (lifecycle plane) -------------------------
    # none of these are blind: the seal barrier's position in the log
    # IS the merge's linearization point, so the proposer must observe
    # its actual apply (and any deterministic rejection), never an
    # eager commit-time ack

    async def merge_seal(self, target_region_id: int) -> bool:
        return await self._apply(KVOperation.merge_seal(target_region_id))

    async def merge_absorb(self, source_region_id: int, source_start: bytes,
                           source_end: bytes, data_blob: bytes) -> bool:
        return await self._apply(KVOperation.merge_absorb(
            source_region_id, source_start, source_end, data_blob))

    async def merge_commit(self, target_region_id: int) -> bool:
        return await self._apply(KVOperation.merge_commit(target_region_id))

    # -- read path (readIndex barrier + local read) --------------------------

    async def _read(self, fn, *args):
        """Fenced local read: read_index barrier, then the store call —
        on the apply lane when one owns the store, else inline."""
        await self.node.read_index()
        if self.lane is not None:
            return await self.lane.submit(fn, *args)
        return fn(*args)

    async def get(self, key: bytes) -> Optional[bytes]:
        return await self._read(self.store.get, key)

    async def multi_get(self, keys: list[bytes]
                        ) -> dict[bytes, Optional[bytes]]:
        return await self._read(self.store.multi_get, keys)

    async def contains_key(self, key: bytes) -> bool:
        return await self._read(self.store.contains_key, key)

    async def scan(self, start: bytes, end: bytes, limit: int = -1,
                   return_value: bool = True
                   ) -> list[tuple[bytes, Optional[bytes]]]:
        return await self._read(self.store.scan, start, end, limit,
                                return_value)

    async def reverse_scan(self, start: bytes, end: bytes, limit: int = -1,
                           return_value: bool = True
                           ) -> list[tuple[bytes, Optional[bytes]]]:
        return await self._read(self.store.reverse_scan, start, end, limit,
                                return_value)
