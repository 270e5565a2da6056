"""KVStoreStateMachine: applies committed KVOperations to the raw store.

Reference parity: ``rhea:storage/KVStoreStateMachine`` (SURVEY.md §3.2,
§4.5) — batches committed entries, dispatches by op-code to the shared
RawKVStore, sets per-op results on the proposing closure, handles
region snapshots (range-serialized) and RANGE_SPLIT.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Optional

from tpuraft_torch.core.state_machine import Iterator, StateMachine
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.raw_store import RawKVStore

LOG = logging.getLogger(__name__)


def range_covers(region: Region, src_start: bytes,
                 src_end: bytes) -> bool:
    """True when ``region``'s range already contains ``[src_start,
    src_end)`` (b"" bounds are -inf/+inf sentinels).  Regions tile the
    keyspace disjointly, so containment of another region's range can
    only mean "absorbed before" — this is the idempotency test both
    the absorb apply and the PD's merge bookkeeping rely on."""
    lo_ok = (region.start_key == b"" if src_start == b""
             else region.start_key == b"" or region.start_key <= src_start)
    hi_ok = (region.end_key == b"" if src_end == b""
             else region.end_key == b"" or src_end <= region.end_key)
    return lo_ok and hi_ok


def extend_region_over(region: Region, src_start: bytes,
                       src_end: bytes) -> None:
    """Extend ``region``'s keyspace over an ADJACENT absorbed range and
    bump its epoch version — the deterministic metadata half of a
    MERGE_ABSORB apply (every target replica runs this with identical
    inputs).  Raises on a non-adjacent range: a PD that proposed one
    has a policy bug, and silently absorbing would tear the keyspace
    tiling invariant.

    Idempotent: a range the region ALREADY covers (a resumed merge
    re-absorbing after a source-leader retry, or log replay over a
    snapshot that post-dates the absorb) is a no-op (``range_covers``)."""
    if range_covers(region, src_start, src_end):
        return
    if src_end != b"" and src_end == region.start_key:
        region.start_key = src_start          # source sat to our LEFT
    elif region.end_key != b"" and region.end_key == src_start:
        region.end_key = src_end              # source sat to our RIGHT
    else:
        raise RuntimeError(
            f"absorb range [{src_start!r}, {src_end!r}) is not adjacent "
            f"to region {region.id} [{region.start_key!r}, "
            f"{region.end_key!r})")
    region.epoch.version += 1


class KVClosure:
    """Proposal completion carrying an op result back to the proposer
    (reference: ``rhea:storage/KVStoreClosure#setData``).

    Thread-safe against worker-lane apply: when the FSM fires it from
    the store's apply lane, the resolution hops back to the proposer's
    loop via ``call_soon_threadsafe``.  ``_fired`` (set before the hop)
    makes the first caller win — the FSMCaller's loop-side
    auto-complete must not override a lane-fired error status whose
    delivery is still in flight."""

    def __init__(self, fut):
        self._fut = fut
        self.result = None
        self._fired = False

    def __call__(self, status: Status) -> None:
        if self._fired:
            return
        self._fired = True
        fut = self._fut
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is fut.get_loop():
            if not fut.done():
                fut.set_result((status, self.result))
        else:
            fut.get_loop().call_soon_threadsafe(self._deliver, status)

    def _deliver(self, status: Status) -> None:
        if not self._fut.done():
            self._fut.set_result((status, self.result))


class KVStoreStateMachine(StateMachine):
    # write ops the apply coalescer folds into one mixed store write
    # (all return True and only touch the data namespace)
    _RUN_OPS = frozenset(
        (KVOp.PUT, KVOp.DELETE, KVOp.PUT_LIST, KVOp.DELETE_LIST))
    # ops a SEALED region still applies: the merge choreography itself
    # plus log-replicated reads (the data keeps serving until the
    # target's absorb commits and this group retires)
    _SEALED_OK = frozenset((KVOp.MERGE_SEAL, KVOp.MERGE_COMMIT,
                            KVOp.GET, KVOp.MULTI_GET, KVOp.CONTAINS_KEY))

    def __init__(self, region: Region, store: RawKVStore,
                 store_engine=None, coalesce_applies: bool = True) -> None:
        self.region = region
        self.store = store
        self.store_engine = store_engine  # for RANGE_SPLIT
        self.leader_term = -1
        # apply worker lane (StoreEngineOptions.apply_lane): when set,
        # the lane thread OWNS the raw store — apply_sync runs there,
        # and snapshot serialization below is submitted through it
        # instead of touching the store from the loop
        self.lane = None
        # coalesced-apply knob + counters (StoreEngineOptions.fsm_coalesce):
        # consecutive PUT/DELETE(-list) entries flush as ONE native batch
        # write instead of one store call per op
        self.coalesce_applies = coalesce_applies
        self.coalesced_flushes = 0   # flushes that merged more than one row
        self.coalesced_ops = 0       # rows that rode a merged flush
        # merge barrier (lifecycle plane): >= 0 once a MERGE_SEAL entry
        # applied, naming the absorbing region.  Derived ONLY from the
        # applied log (+ snapshot), so every replica agrees; writes
        # sequenced after the seal are deterministically rejected
        # (ESTATEMACHINE) — the barrier IS the merge's linearization
        # point in the source group's log
        self.sealed_into = -1

    # -- apply ---------------------------------------------------------------

    def _run_rows(self, op: KVOperation
                  ) -> list[tuple[bytes, Optional[bytes]]]:
        code = op.op
        if code == KVOp.PUT:
            return [(op.key, op.value)]
        if code == KVOp.DELETE:
            return [(op.key, None)]
        if code == KVOp.PUT_LIST:
            return list(KVOperation.unpack_kv_list(op.value))
        return [(k, None) for k in KVOperation.unpack_key_list(op.value)]

    def _flush_run(self, rows: list, dones: list) -> None:
        try:
            self.store.apply_write_batch(rows)
            if len(rows) > 1:
                self.coalesced_flushes += 1
                self.coalesced_ops += len(rows)
            st = Status.OK()
        except Exception as e:  # noqa: BLE001 — run-level failure, not fatal
            LOG.exception("region %d coalesced apply (%d rows) failed",
                          self.region.id, len(rows))
            st = Status.error(RaftError.ESTATEMACHINE, str(e))
        for done, closure in dones:
            if closure is not None and st.is_ok():
                closure.result = True
            if done is not None:
                done(st)
        rows.clear()
        dones.clear()

    async def on_apply(self, it: Iterator) -> None:
        self.on_lane_applied(self.apply_sync(it))

    def on_lane_applied(self, applied_ops: int) -> None:
        """Post-apply bookkeeping that must stay on the loop (the heat
        tracker is loop-confined): the FSMCaller calls this after a
        lane-submitted apply_sync returns; the loop path above calls it
        inline."""
        # per-region heat (fleet observability): the applied lane is the
        # replication-side load — followers see it for regions they
        # never serve, giving the store a full local picture; the PD
        # only ever reads the leaders' serving rates
        heat = getattr(self.store_engine, "heat", None)
        if heat is not None and applied_ops:
            heat.note_applied(self.region.id, applied_ops)

    def apply_sync(self, it: Iterator) -> int:
        """The apply body, synchronous — runnable on the loop (via
        on_apply) or on the store's apply worker lane (FSMCaller submits
        it when StoreEngineOptions.apply_lane is on).  Returns the
        applied op count for on_lane_applied."""
        run_rows: list = []
        run_dones: list = []   # (done, closure) per coalesced entry
        applied_ops = 0        # heat telemetry: replication-side rate
        while it.valid():
            applied_ops += 1
            op = KVOperation.decode(it.data())
            done = it.done()
            closure = done if isinstance(done, KVClosure) else None
            if self.coalesce_applies and op.op in self._RUN_OPS \
                    and self.sealed_into < 0:
                run_rows.extend(self._run_rows(op))
                run_dones.append((done, closure))
                it.next()
                continue
            if run_dones:
                self._flush_run(run_rows, run_dones)
            try:
                result = self._dispatch(op)
                if closure is not None:
                    closure.result = result
                if done is not None:
                    done(Status.OK())
            except Exception as e:  # noqa: BLE001 — op-level failure, not fatal
                LOG.exception("region %d apply op %s failed",
                              self.region.id, op.op)
                if done is not None:
                    done(Status.error(RaftError.ESTATEMACHINE, str(e)))
            it.next()
        if run_dones:
            self._flush_run(run_rows, run_dones)
        return applied_ops

    def _dispatch(self, op: KVOperation):
        s = self.store
        code = op.op
        if self.sealed_into >= 0 and code not in self._SEALED_OK:
            # deterministic on every replica: the seal entry precedes
            # this op in the SAME log, so all replicas reject it — a
            # write that raced the seal and lost reroutes (via the
            # client's bounce path) into the absorbing region
            raise RuntimeError(
                f"region sealed into {self.sealed_into} (merging)")
        if code == KVOp.PUT:
            s.put(op.key, op.value)
            return True
        if code == KVOp.PUT_IF_ABSENT:
            return s.put_if_absent(op.key, op.value)
        if code == KVOp.DELETE:
            s.delete(op.key)
            return True
        if code == KVOp.COMPARE_PUT:
            return s.compare_and_put(op.key, op.aux, op.value)
        if code == KVOp.DELETE_RANGE:
            s.delete_range(op.key, op.value)
            return True
        if code == KVOp.GET_SEQUENCE:
            (step,) = struct.unpack("<q", op.aux)
            seq = s.get_sequence(op.key, step)
            return (seq.start, seq.end)
        if code == KVOp.RESET_SEQUENCE:
            s.reset_sequence(op.key)
            return True
        if code == KVOp.MERGE:
            s.merge(op.key, op.value)
            return True
        if code == KVOp.PUT_LIST:
            s.put_list(KVOperation.unpack_kv_list(op.value))
            return True
        if code == KVOp.DELETE_LIST:
            s.delete_list(KVOperation.unpack_key_list(op.value))
            return True
        if code == KVOp.GET_AND_PUT:
            return s.get_and_put(op.key, op.value)
        if code == KVOp.KEY_LOCK:
            lease_ms, keep = struct.unpack("<qB", op.aux)
            return s.try_lock_with(op.key, op.value, lease_ms, bool(keep))
        if code == KVOp.KEY_LOCK_RELEASE:
            return s.release_lock(op.key, op.value)
        if code == KVOp.MULTI:
            return self._dispatch_multi(KVOperation.unpack_multi(op.value))
        if code == KVOp.RANGE_SPLIT:
            (new_region_id,) = struct.unpack("<q", op.aux)
            if self.store_engine is None:
                raise RuntimeError("split requires a store engine")
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                # lane apply: do_split mutates loop-confined StoreEngine
                # state (region table, heat rows, the new engine's boot
                # task) — hop it back to the engine's loop.  The range
                # narrowing lands a beat later; serving-side range
                # checks re-validate per request, so the window only
                # delays the client's epoch refresh.
                self.store_engine.loop_call_threadsafe(
                    self.store_engine.do_split,
                    self.region.id, new_region_id, op.key)
                return True
            self.store_engine.do_split(self.region.id, new_region_id, op.key)
            return True
        if code == KVOp.MERGE_SEAL:
            (target_id,) = struct.unpack("<q", op.aux)
            # idempotent: a re-proposed seal (leader retry) re-applies
            # to the same state
            self.sealed_into = target_id
            return True
        if code == KVOp.MERGE_ABSORB:
            src_id, src_start, src_end = \
                KVOperation.unpack_merge_absorb(op.aux)
            # containment FIRST: a duplicate absorb (the PD re-issuing
            # the pending pair after a lost ack, racing the first
            # absorb's completion) carries the sealed source's blob —
            # loading it again would roll back writes this region
            # accepted in its extended range since the first absorb
            # (lost updates).  Covered range == absorbed before; skip
            # the data load AND the (no-op) extension.
            if range_covers(self.region, src_start, src_end):
                return True
            # data first, in the store-owning context (idempotent
            # overwrite: on a shared per-store raw store the source's
            # rows are already physically present)
            if op.value:
                s.load_serialized(op.value)
            self._absorb_meta(src_id, src_start, src_end)
            return True
        if code == KVOp.MERGE_COMMIT:
            (target_id,) = struct.unpack("<q", op.aux)
            if self.store_engine is not None:
                try:
                    asyncio.get_running_loop()
                except RuntimeError:
                    # lane apply: retirement mutates loop-confined
                    # StoreEngine state (region table, heat rows, the
                    # engine shutdown task) — hop to the engine's loop
                    self.store_engine.loop_call_threadsafe(
                        self.store_engine.do_retire,
                        self.region.id, target_id)
                    return True
                self.store_engine.do_retire(self.region.id, target_id)
            return True
        if code == KVOp.GET:  # linearizable-via-log read
            return s.get(op.key)
        if code == KVOp.MULTI_GET:
            keys = KVOperation.unpack_key_list(op.value)
            got = s.multi_get(keys)
            return [(k, got[k]) for k in keys]
        if code == KVOp.CONTAINS_KEY:
            return s.contains_key(op.key)
        raise ValueError(f"unknown KV op {code}")

    def _dispatch_multi(self, ops: list[KVOperation]
                        ) -> list[tuple[int, str, object]]:
        """Apply a MULTI entry's sub-ops in order with PER-OP outcomes
        ``(code, msg, result)`` — a sub-op failure fails only its item,
        never the whole entry (the batch handler maps each outcome back
        to its kv_command_batch item).  Consecutive PUT/DELETE(-list)
        sub-ops coalesce into one store write, same as entry-level runs."""
        outs: list = [None] * len(ops)
        i, n = 0, len(ops)
        while i < n:
            if self.coalesce_applies and ops[i].op in self._RUN_OPS \
                    and self.sealed_into < 0:
                j = i
                rows: list = []
                while j < n and ops[j].op in self._RUN_OPS:
                    rows.extend(self._run_rows(ops[j]))
                    j += 1
                try:
                    self.store.apply_write_batch(rows)
                    if len(rows) > 1:
                        self.coalesced_flushes += 1
                        self.coalesced_ops += len(rows)
                    out = (0, "", True)
                except Exception as e:  # noqa: BLE001
                    LOG.exception("region %d multi-apply run (%d rows) failed",
                                  self.region.id, len(rows))
                    out = (int(RaftError.ESTATEMACHINE), str(e), None)
                for k in range(i, j):
                    outs[k] = out
                i = j
                continue
            try:
                outs[i] = (0, "", self._dispatch(ops[i]))
            except Exception as e:  # noqa: BLE001
                LOG.exception("region %d multi-apply op %s failed",
                              self.region.id, ops[i].op)
                outs[i] = (int(RaftError.ESTATEMACHINE), str(e), None)
            i += 1
        return outs

    def _absorb_meta(self, src_id: int, src_start: bytes,
                     src_end: bytes) -> None:
        """Metadata half of a MERGE_ABSORB apply: range extension +
        epoch bump (+ store-engine bookkeeping), hopped to the engine's
        loop when applying on the store's worker lane — same contract
        as the RANGE_SPLIT arm."""
        if self.store_engine is None:
            extend_region_over(self.region, src_start, src_end)
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            self.store_engine.loop_call_threadsafe(
                self.store_engine.do_absorb,
                self.region.id, src_id, src_start, src_end)
            return
        self.store_engine.do_absorb(self.region.id, src_id,
                                    src_start, src_end)

    # -- leadership ----------------------------------------------------------

    async def on_leader_start(self, term: int) -> None:
        self.leader_term = term
        if self.store_engine is not None:
            self.store_engine.on_region_leader_start(self.region.id, term)

    async def on_leader_stop(self, status: Status) -> None:
        self.leader_term = -1
        if self.store_engine is not None:
            self.store_engine.on_region_leader_stop(self.region.id)

    async def on_configuration_committed(self, conf) -> None:
        """Committed conf entries update the region's replica roster and
        bump conf_ver — every replica applies the same entries, so the
        roster/epoch stay deterministic fleet-wide.  Before the
        lifecycle plane region.peers never tracked joint-consensus
        changes, so a MOVEd region kept advertising its old store
        forever.  No-op re-commits (a new leader re-committing the
        stable conf) are skipped so restart replay can't drift conf_ver
        across replicas."""
        w = set(conf.witnesses)
        toks = [f"{p}/witness" if p in w else str(p)
                for p in sorted(conf.peers)]
        toks += [f"{p}/learner" for p in sorted(conf.learners)]
        if not toks or set(toks) == set(self.region.peers):
            return
        self.region.peers = toks
        self.region.epoch.conf_ver += 1
        if self.store_engine is not None:
            self.store_engine.on_region_conf_changed(self.region.id)

    # -- snapshot ------------------------------------------------------------

    async def on_snapshot_save(self, writer, done) -> None:
        try:
            # lane mode: the lane thread owns the store — OTHER regions'
            # applies run there concurrently with this region's save, so
            # the range serialization must ride the lane queue too
            if self.lane is not None:
                blob = await self.lane.submit(
                    self.store.serialize_range,
                    self.region.start_key, self.region.end_key)
            else:
                blob = self.store.serialize_range(self.region.start_key,
                                                  self.region.end_key)
            writer.write_file("kv_data", blob)
            writer.write_file("region_meta", self.region.encode())
            if self.sealed_into >= 0:
                # a replica installing this snapshot must come up SEALED
                # (the seal entry may sit below the snapshot index) —
                # trailing file, absent on pre-lifecycle snapshots
                writer.write_file("merge_state",
                                  struct.pack("<q", self.sealed_into))
            done(Status.OK())
        except Exception as e:  # noqa: BLE001
            done(Status.error(RaftError.EIO, f"kv snapshot save: {e}"))

    async def on_snapshot_load(self, reader) -> bool:
        blob = reader.read_file("kv_data")
        if blob is None:
            return False
        meta = reader.read_file("region_meta")
        if meta is not None:
            saved = Region.decode(meta)
            # adopt the snapshot's view of the range/epoch (it may post-date
            # a split that this lagging replica never applied)
            self.region.start_key = saved.start_key
            self.region.end_key = saved.end_key
            self.region.epoch = saved.epoch
        sealed = reader.read_file("merge_state")
        self.sealed_into = struct.unpack("<q", sealed)[0] \
            if sealed is not None else -1
        # exact state reset of our slice (data + sequences + locks), then
        # load — merging would leave post-snapshot keys behind and make
        # log replay after restart non-deterministic across replicas
        if self.lane is not None:
            await self.lane.submit(self._load_sync, blob)
        else:
            self._load_sync(blob)
        return True

    def _load_sync(self, blob: bytes) -> None:
        self.store.reset_range(self.region.start_key, self.region.end_key)
        self.store.load_serialized(blob)

    async def on_error(self, status: Status) -> None:
        LOG.error("region %d FSM error: %s", self.region.id, status)
