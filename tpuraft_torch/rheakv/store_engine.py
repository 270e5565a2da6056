"""StoreEngine: one KV storage process hosting many region raft groups.

Reference parity: ``rhea:StoreEngine`` (SURVEY.md §3.2) — boots the
shared RPC server + NodeManager, the shared RawKVStore, one RegionEngine
per region, the KV command processor, split handling, and (optionally)
heartbeats to the placement driver.

TPU-native design: when given a :class:`MultiRaftEngine`, every region's
quorum/commit bookkeeping runs on the engine's fused ``[G, P]`` device
tick — thousands of regions advance their commit indexes in one XLA
dispatch per tick instead of per-group Python work (SURVEY.md §3.5
"multi-group data parallelism", the BASELINE.json north star).
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.cli_service import CliProcessors
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.entity import PeerId
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.options import NodeOptions, ReadOnlyOption, SnapshotOptions
from tpuraft_torch.rheakv.kv_service import KVCommandProcessor
from tpuraft_torch.rheakv.metadata import Region, StoreMeta
from tpuraft_torch.rheakv.raw_store import (
    MemoryRawKVStore,
    MetricsRawKVStore,
    RawKVStore,
)
from tpuraft_torch.rpc.messages import BatchRequest, CompactBeat
from tpuraft_torch.rpc.transport import RpcError, is_no_method
from tpuraft_torch.util import clock as clockmod
from tpuraft_torch.util.clock import ClockSentinel
from tpuraft_torch.util.metrics import MetricRegistry, prometheus_text
from tpuraft_torch.util.trace import RECORDER, TRACER
from tpuraft_torch.rheakv.region_engine import RegionEngine

LOG = logging.getLogger(__name__)


def _dir_usage_bytes(root: str) -> int:
    """Recursive file-size sum (the disk reconcile's 'du'); runs on an
    executor thread — never call from the event loop."""
    total = 0
    for dirpath, _dirs, names in os.walk(root):
        for n in names:
            try:
                total += os.path.getsize(os.path.join(dirpath, n))
            except OSError:
                pass
    return total


@dataclass
class StoreEngineOptions:
    cluster_name: str = "rheakv"
    server_id: str = ""                  # this store's PeerId string
    initial_regions: list[Region] = field(default_factory=list)
    data_path: str = ""                  # "" = memory storage
    election_timeout_ms: int = 1000
    snapshot_interval_secs: int = 0      # 0 = on-demand only
    raw_store_factory: Callable[[], RawKVStore] = MemoryRawKVStore
    # least keys a region must hold before a split is sensible
    least_keys_on_split: int = 16
    # PD heartbeat cadence (only used when a pd_client is wired)
    heartbeat_interval_ms: int = 1000
    # linearizable read mode for region groups (SAFE: quorum heartbeat
    # round per read batch; LEASE_BASED: trust the leader lease — the
    # reference's ReadOnlyOption, surfaced here like RheaKVStoreOptions)
    read_only_option: ReadOnlyOption = ReadOnlyOption.SAFE
    # wrap the raw store in the op-latency decorator (reference:
    # MetricsRawKVStore, enabled by RheaKVStoreOptions metrics flags)
    enable_kv_metrics: bool = False
    # "file" = one segment dir per region (round-1 layout);
    # "multilog" = ALL regions of this store share ONE C++ journal
    # engine — group-keyed records, one fsync per flush round across
    # regions, O(bytes/segment) fds (the reference's single-RocksDB
    # role; storage/multilog.py).  Only used when data_path is set.
    log_scheme: str = "file"
    # cap per-region log segment size (file/native schemes; 0 = the
    # storage default, 64MB).  Prefix compaction frees disk in whole-
    # segment units, so tight storage budgets want small segments —
    # reclaim can then actually return bytes between snapshots.
    log_segment_max_bytes: int = 0
    # group quiescence (engine-driven regions only): an idle, fully
    # replicated region hibernates after this many consecutive fully-
    # acked beat rounds — see RaftOptions.quiesce_after_rounds.  0 = off.
    quiesce_after_rounds: int = 0
    # cap for the PD-heartbeat failure backoff (bounded exponential:
    # interval x 2^fails, clamped here) — a down PD costs one cheap
    # probe per cap interval, not a hot retry loop
    pd_backoff_max_ms: int = 30000
    # serving-plane apply coalescing: the region FSMs flush consecutive
    # PUT/DELETE(-list) entries as ONE store batch write (one ctypes
    # call + one WAL record per run) instead of one call per op — see
    # KVStoreStateMachine.coalesce_applies
    fsm_coalesce: bool = True
    # kv_command_batch write sub-batches ride ONE KVOp.MULTI log entry
    # per region (one quorum round amortized).  Set False during a
    # rolling upgrade from a pre-batch build: a MULTI entry replicated
    # to a replica whose FSM predates it fails to apply and silently
    # diverges state — per-op entries stay wire/FSM-compatible both ways
    multi_op_entries: bool = True
    # geo deployment: this store's zone (failure-domain) label.  Carried
    # on PD heartbeats so the PD spreads leaders across zones; "" =
    # unlabeled (single-zone legacy deployments)
    zone: str = ""
    # store-wide SAFE ReadIndex amortization: pending read confirmations
    # of ALL led groups coalesce into one beat-plane round per window
    # (ReadConfirmBatcher) instead of one quorum heartbeat round per
    # group.  False = per-group rounds (the pre-batch behavior).
    read_confirm_batching: bool = True
    # store-wide WRITE amortization (the read plane's mirror): every led
    # group's pending entry windows toward one destination endpoint ride
    # ONE windowed store_append round (core/append_batcher.AppendBatcher)
    # instead of the send plane's stop-and-wait endpoint lane.  Receivers
    # that predate the RPC get permanent per-group AppendEntries
    # fallback.  False = the pre-write-plane send-plane lane.
    append_batching: bool = True
    # pipelined FSM apply: blind writes (PUT/DELETE/... — result known a
    # priori) ack the client the moment their entry COMMITS; the FSM
    # applies behind in coalesced batches, and the read fence
    # (read_index + wait_applied) keeps reads observing applied state.
    # False = ack after apply (the pre-write-plane behavior).
    ack_at_commit: bool = True
    # -- apply worker lane (compartmentalization) ----------------------------
    # run FSM apply on a dedicated store-wide worker thread instead of
    # the event loop (tpuraft/core/lanes.py): the lane thread OWNS the
    # raw store — fenced reads, snapshot serialization and split-point
    # probing are submitted through its FIFO queue, so the loop only
    # pays an await per batch and a hot store saturates a second core.
    # False = apply on the loop (the single-core default; the native
    # store's C calls already release the GIL under the lane, the
    # memory store still offloads the loop's share).
    apply_lane: bool = False
    # -- gray-failure survival (fail-slow detection + mitigation) ------------
    # score this store {HEALTHY, DEGRADED, SICK} from hot-path signals
    # (append/fsync latency, peer ack RTTs, apply backlog — see
    # tpuraft/util/health.py) and mitigate: a SICK self-score evacuates
    # led groups' leadership at a bounded rate, and the KV serving plane
    # sheds with EBUSY+retry-after instead of queueing behind a dying
    # disk.  False = observe-only never (no tracker at all).
    health_scoring: bool = True
    # custom thresholds/hysteresis (None = HealthOptions defaults)
    health_options: Optional[object] = None
    # scoring cadence; hysteresis counts these rounds, so
    # interval x worsen_after bounds detection latency
    health_eval_interval_ms: int = 500
    # SICK => proactively transfer led groups to the healthiest
    # caught-up voter.  False = detect + shed only (operator drains).
    evacuate_on_sick: bool = True
    # at most this many transfers per evaluation round, so evacuation
    # itself can never storm the cluster with elections
    evacuation_rate: int = 2
    # a region just transferred (or attempted) is left alone for this
    # many evaluation rounds
    evacuation_cooldown_rounds: int = 4
    # serving-plane degradation: once SICK, kv_command_batch sheds with
    # per-item EBUSY + retry-after when this many items are already in
    # flight (0 = never shed).  A gray store fails fast instead of
    # timing out 256 workers at p99=inf.
    shed_backlog_items: int = 512
    shed_retry_after_ms: int = 250
    # -- disk-pressure survival (capacity accounting + reaction ladder) ------
    # account this store's on-disk usage into hysteretic {OK, NEAR_FULL,
    # FULL} pressure (tpuraft/util/health.py DiskBudget; hot-path fed:
    # log-append bytes, snapshot commit/prune deltas, ENOSPC
    # observations; periodically reconciled against real usage).  The
    # reaction ladder: NEAR_FULL floors health DEGRADED (PD stops
    # placing leaders here) and starts urgent snapshot+compaction
    # reclaim; FULL floors SICK (evacuation) and sheds WRITES at
    # kv_service admission with retryable ERR_STORE_BUSY while reads
    # keep serving.  Requires data_path; False = no tracker.  See
    # docs/operations.md "Disk-pressure runbook".
    disk_guard: bool = True
    # byte budget for this store's data directory.  0 = derive capacity
    # from os.statvfs at reconcile (whole filesystem — production);
    # tests/soaks set an explicit budget matching the chaos quota.
    disk_budget_bytes: int = 0
    # pressure thresholds as fractions of the budget.  full_frac < 1.0
    # is the RESERVED HEADROOM: admission stops at full_frac so
    # reclaim's own writes (snapshot temp dirs, compaction tmp files)
    # still fit under the hard budget — the can't-compact-when-full
    # deadlock guard.
    disk_near_full_frac: float = 0.80
    disk_full_frac: float = 0.92
    # reconcile real usage (directory walk / statvfs, on an executor
    # thread) every N health rounds
    disk_reconcile_rounds: int = 4
    # pressure reclaim: urgent snapshot+log-compaction across led
    # regions, at most this many per health round, with a per-region
    # cooldown so one region isn't re-snapshotted every round
    disk_reclaim_rate: int = 2
    disk_reclaim_cooldown_rounds: int = 8
    # -- live metrics exposition ---------------------------------------------
    # serve Prometheus text at GET /metrics on a stdlib HTTP listener:
    # None = off (the default — the describe_metrics admin RPC and
    # SIGUSR2 describer dumps still work), 0 = bind an ephemeral port
    # (tests; the bound port lands in StoreEngine.metrics_http_port),
    # N = bind that port.  The listener runs on its own daemon thread
    # and only READS counters — best-effort consistency by design.
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    # metrics_text() render cache: per-region aggregation is O(regions),
    # so a tight scrape loop against a 1024-region store would burn the
    # serving thread re-rendering identical text — scrapes within the
    # TTL serve the cached render (stale-ok; the render's age is itself
    # exposed as tpuraft_metrics_age_seconds, bounded by this TTL).
    # 0 = render every call (tests / debugging).
    metrics_cache_ttl_ms: int = 250
    # -- per-region heat telemetry (fleet observability) ---------------------
    # track decayed EWMAs of writes/s, reads/s and bytes in/out per
    # region (util/heat.RegionHeatTracker), fed O(1) from the KV
    # serving paths and FSM apply, reported to the PD on the delta-
    # batched heartbeat (noise-gated) — the signal ROADMAP item 2's
    # split/merge/move policy consumes.  False = no tracker at all
    # (the bench-gate A/B knob).
    heat_tracking: bool = True
    # EWMA half-life: how fast a region's rates chase the live load /
    # decay when it goes idle.  ~10 heartbeat intervals by default.
    heat_half_life_s: float = 10.0
    # steady-heat keepalive: a led region whose standing rate hasn't
    # been reported for this long is re-reported even though the noise
    # gate sees no movement — the PD expires rates not refreshed
    # within ClusterStatsManager.heat_stale_s (30s), so this must stay
    # WELL below that or a steadily-hot region vanishes from the view
    heat_refresh_s: float = 10.0
    # -- time discipline (ISSUE 18) ------------------------------------------
    # injectable store clock (util/clock.py): EVERY timing-sensitive
    # consumer of this store — election timers, engine tick deadlines,
    # store-lease bookkeeping, health hysteresis — reads this clock, so
    # a ChaosClock here skews the store exactly like a machine with a
    # bad oscillator.  None = the process-wide SystemClock (zero
    # indirection cost: module default, bench-gated <=2%).
    clock: Optional[object] = None
    # assumed maximum relative clock drift rho between any two stores
    # (e.g. 0.05 = 5%).  Shrinks the leader's usable lease window and
    # the receiver-side store-lease grant by (1 - rho), and arms the
    # peer-skew sentinel's fencing: a store whose clock the beat-plane
    # skew estimator flags as deviating beyond rho stops serving
    # lease reads (SAFE fallback) until it recovers.  0.0 = legacy
    # exact-clock behavior (no pads, sentinel observes but never
    # fences).
    clock_drift_bound: float = 0.0


class _GroupFence:
    """One group's pending read fence inside a ReadConfirmBatcher round:
    the (node, term) pinned at round build plus the ack tally.  Resolves
    its futures True the moment a voter quorum (both configs while
    joint) has acked IN TERM — stragglers then only delay other groups,
    never this one's readers."""

    __slots__ = ("node", "term", "futs", "new_peers", "old_peers", "acked",
                 "device")

    def __init__(self, node, futs: list) -> None:
        self.node = node
        self.term = node.current_term
        self.futs = futs
        self.new_peers = set(node.conf_entry.conf.peers)
        self.old_peers = set(node.conf_entry.old_conf.peers)
        self.acked = {node.server_id}
        # True when the quorum tally runs on the engine's device fence
        # lane (EngineControl.arm_read_fence) instead of this host set
        self.device = False

    def _quorum(self) -> bool:
        ok_new = (len(self.acked & self.new_peers)
                  >= len(self.new_peers) // 2 + 1)
        if not self.old_peers:
            return ok_new
        # joint consensus: a read fence must prove leadership against
        # BOTH quorums — a new-config-only majority may not intersect
        # the electorate that could depose us mid-change
        return ok_new and (len(self.acked & self.old_peers)
                           >= len(self.old_peers) // 2 + 1)

    def note_ack(self, peer) -> None:
        node = self.node
        if not node.is_leader() or node.current_term != self.term:
            return  # deposed/re-elected mid-round: this fence is void
        self.acked.add(peer)
        if self._quorum():
            self.resolve(True)

    def note_quorum(self) -> None:
        """Device fence lane callback: the engine tick's fused q_ack
        reduction covered this round's start.  Same (is_leader, term)
        gate as the per-ack path — the device counts raw ack arrival
        times, the host still vouches for the leadership pin."""
        node = self.node
        if not node.is_leader() or node.current_term != self.term:
            return
        self.resolve(True)

    def resolve(self, ok: bool) -> None:
        for fut in self.futs:
            if not fut.done():
                fut.set_result(ok)

    @property
    def done(self) -> bool:
        return all(fut.done() for fut in self.futs)


# graftcheck: loop-confined — one batcher per StoreEngine, driven from
# the store's event loop; pending lists, fences and counters are
# lockless by that confinement
class ReadConfirmBatcher:
    """Store-wide SAFE ReadIndex confirmation amortizer.

    ``ReadOnlyService`` already batches the concurrent readers of ONE
    group into one confirmation round; at region density that still
    costs one quorum heartbeat round PER GROUP with pending reads.  This
    batcher coalesces the pending SAFE confirmations of ALL led groups
    on a store into one beat-plane round: each round packs every pending
    group's read fence as a ``CompactBeat`` row and sends ONE
    ``multi_beat_fast`` RPC per destination endpoint (exactly how the
    HeartbeatHub amortizes idle beats), then tallies per-group in-term
    acks.  A ``BeatAck(ok=True)`` proves the follower saw this node as
    the leader of this term when it answered — the same leadership proof
    an empty-AppendEntries ack carries — so the fence is SAFE, not
    clock-dependent.  Deviating rows (term moved, follower restarted,
    committed behind) get a classic full-semantics beat as the follow-up
    and its in-term ack still counts.

    Safety argument (docs/architecture.md "Read-fence batching"):
    read_index is pinned BEFORE ``confirm()`` enqueues, every beat of a
    round is built AFTER the round collected its batch, and a fence only
    counts acks while ``(is_leader, term)`` still match the values
    pinned at round build — so each reader's confirmation round-trip
    strictly follows its invoke, which is the ReadIndex linearizability
    requirement.  Rounds are windowed (``max_inflight_rounds``): one
    dead endpoint's RPC timeout delays only its own round's stragglers,
    not the store's whole read plane.
    """

    max_inflight_rounds = 4

    def __init__(self) -> None:
        self._pending: list = []   # (node, future)
        self._task: Optional[asyncio.Task] = None
        self._rounds_inflight: set = set()
        self._fast_ok: dict[str, bool] = {}  # dst serves multi_beat_fast
        # nudges the drain out of its completed-round wait when a NEW
        # fence arrives with window slots free: without it, one STALLED
        # (not dead) endpoint's round parked the drain on
        # FIRST_COMPLETED and every later fence — healthy endpoints
        # included — convoyed behind the stall until its RPC timed out
        # (found by the gray-failure stalled-endpoint tests)
        self._arrival = asyncio.Event()
        # gray-failure signal sink (HealthTracker): every fence round's
        # RPC doubles as a per-endpoint RTT probe
        self.health = None
        # store clock (ISSUE 18): StoreEngine re-points this at its
        # injected clock so RTT probes stay on the store's time plane
        self.clock = clockmod.SYSTEM
        # counters (describe() + bench/soak stats lines)
        self.confirms = 0       # fences requested
        self.rounds = 0         # store-wide rounds run
        self.beat_rpcs = 0      # multi_beat_fast RPCs sent
        self.beats = 0          # CompactBeat fence rows carried
        self.classic_beats = 0  # classic per-peer follow-ups/fallbacks
        self.failed = 0         # fences that ended unconfirmed
        self.device_fences = 0  # fences tallied on the engine device lane
        # gauges bound to the live counters (the HeartbeatHub idiom)
        self.metrics = MetricRegistry()
        for name in ("confirms", "rounds", "beat_rpcs", "beats",
                     "classic_beats", "failed", "device_fences"):
            self.metrics.gauge(f"read_batcher.{name}",
                               lambda n=name: getattr(self, n))
        self.metrics.gauge(
            "read_batcher.reads_per_round",
            lambda: self.confirms / self.rounds if self.rounds else 0.0)

    def counters(self) -> dict:
        return {
            "read_confirms": self.confirms,
            "read_rounds": self.rounds,
            "read_beat_rpcs": self.beat_rpcs,
            "read_beats": self.beats,
            "read_classic_beats": self.classic_beats,
            "read_failed": self.failed,
            "read_device_fences": self.device_fences,
        }

    def describe(self) -> str:
        amort = self.confirms / self.rounds if self.rounds else 0.0
        return (f"ReadConfirmBatcher<confirms={self.confirms} "
                f"rounds={self.rounds} reads_per_round={amort:.2f} "
                f"beat_rpcs={self.beat_rpcs} beats={self.beats} "
                f"classic={self.classic_beats} failed={self.failed} "
                f"device_fences={self.device_fences}>")

    async def confirm(self, node) -> bool:
        """Enqueue one group's SAFE leadership fence; resolves True once
        a voter quorum acked a beat of a round that started after this
        call."""
        self.confirms += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((node, fut))
        self._arrival.set()
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._drain())
        return await fut

    async def shutdown(self) -> None:
        for _node, fut in self._pending:
            if not fut.done():
                fut.set_result(False)
        self._pending.clear()
        for t in list(self._rounds_inflight):
            t.cancel()
        if self._task is not None and not self._task.done():
            self._task.cancel()
        self._task = None

    async def _drain(self) -> None:
        # microtask hop: every fence enqueued by tasks runnable in this
        # loop iteration joins the first round (the _Batcher idiom);
        # then windowed rounds — a round stuck on a dead endpoint's
        # timeout must not convoy later readers behind it
        await asyncio.sleep(0)
        while self._pending or self._rounds_inflight:
            while self._pending \
                    and len(self._rounds_inflight) < self.max_inflight_rounds:
                batch, self._pending = self._pending, []
                t = asyncio.ensure_future(self._round(batch))
                self._rounds_inflight.add(t)
                t.add_done_callback(self._reap_round)
            if self._rounds_inflight:
                # wake on a round completing OR a new fence arriving:
                # with window slots free the new fence must start ITS
                # OWN round now, not convoy behind a stalled endpoint's
                self._arrival.clear()
                arrival = asyncio.ensure_future(self._arrival.wait())
                try:
                    await asyncio.wait(
                        set(self._rounds_inflight) | {arrival},
                        return_when=asyncio.FIRST_COMPLETED)
                finally:
                    arrival.cancel()

    def _reap_round(self, t: asyncio.Task) -> None:
        self._rounds_inflight.discard(t)
        if not t.cancelled() and t.exception() is not None:
            LOG.warning("read-confirm round failed: %r", t.exception())

    async def _round(self, batch: list) -> None:
        """One store-wide round: build every pending group's fence beats
        SYNCHRONOUSLY (no await between the is_leader check and the
        build — the HeartbeatHub invariant), dispatch one RPC per
        destination, tally."""
        self.rounds += 1
        groups: dict[int, _GroupFence] = {}
        order: list[_GroupFence] = []
        for node, fut in batch:
            st = groups.get(id(node))
            if st is None:
                st = groups[id(node)] = _GroupFence(node, [fut])
                order.append(st)
            else:
                st.futs.append(fut)
        by_dst: dict[str, list] = {}
        classic: list = []
        try:
            for st in order:
                node = st.node
                if not node.is_leader():
                    st.resolve(False)
                    continue
                # engine-backed group: the quorum tally rides the device
                # tick's fused q_ack reduction (the fence_ok lane) — the
                # beats below still go out (they ARE the acks the lane
                # counts), but the per-ack host set arithmetic is skipped
                ctrl = getattr(node, "_ctrl", None)
                if ctrl is not None and getattr(ctrl, "drives_read_fences",
                                                False):
                    ctrl.arm_read_fence(st)
                    st.device = True
                    self.device_fences += 1
                voters = st.new_peers | st.old_peers
                committed = node.ballot_box.last_committed_index
                for r in node.replicators.all():
                    if r.peer not in voters:
                        continue   # a learner's ack proves nothing
                    if (r.peer_multi_hb and r._matched
                            and self._fast_ok.get(r.peer.endpoint, True)):
                        beat = CompactBeat(
                            group_id=node.group_id,
                            server_id=str(node.server_id),
                            peer_id=str(r.peer),
                            term=st.term,
                            committed_index=min(committed, r.match_index))
                        by_dst.setdefault(r.peer.endpoint, []
                                          ).append((st, r, beat))
                    else:
                        classic.append((st, r))
                if not st.device:
                    st.note_ack(node.server_id)  # self-only quorum case
            await asyncio.gather(
                *(self._beat_dst(dst, rows) for dst, rows in by_dst.items()),
                *(self._classic(st, r) for st, r in classic))
        finally:
            # device fences: the RPCs completed, so every ack this round
            # can produce is already in the engine's last_ack rows — one
            # forced tick per distinct engine reduces them and fires
            # fence_ok NOW (the adaptive loop's own tick may be a task
            # behind), so resolution is deterministic before the sweep
            dev_pending = [st for st in order
                           if st.device and not st.done]
            if dev_pending:
                engines = {id(st.node._ctrl.engine): st.node._ctrl.engine
                           for st in dev_pending}
                for eng in engines.values():
                    try:
                        eng.tick_once()
                    except Exception:  # noqa: BLE001 — fall to the sweep
                        LOG.exception("fence-resolve tick failed")
            failed_groups = 0
            for st in order:
                if st.device:
                    # the fence dies with the round either way; a void
                    # entry left armed would pin fence_start and spin
                    # dirty marks on every later ack
                    ctrl = getattr(st.node, "_ctrl", None)
                    if ctrl is not None:
                        ctrl.engine.discard_read_fence(ctrl.slot, st)
                if not st.done:
                    self.failed += 1
                    failed_groups += 1
                st.resolve(False)
            if failed_groups:
                # fence-round outcome (flight recorder): one event per
                # round with failures, not per group — a total
                # partition at region density must not churn the ring
                # with thousands of identical rows per round
                RECORDER.record("fence_round_failed", "",
                                groups=failed_groups,
                                beats=len(by_dst) + len(classic))

    async def _beat_dst(self, dst: str, rows: list) -> None:
        node = rows[0][0].node
        self.beat_rpcs += 1
        self.beats += len(rows)
        t0 = self.clock.monotonic()
        try:
            resp = await node.transport.call(
                dst, "multi_beat_fast",
                BatchRequest(items=[b for _s, _r, b in rows]),
                timeout_ms=node.options.election_timeout_ms // 2 or 1)
        except RpcError as e:
            if is_no_method(e):
                # pre-beat-plane receiver: classic beats from now on
                self._fast_ok[dst] = False
                await asyncio.gather(
                    *(self._classic(st, r) for st, r, _b in rows))
            return  # silence: the fences just miss these acks
        if self.health is not None:
            self.health.note_peer_rtt(dst, self.clock.monotonic() - t0)
        if len(resp.items) != len(rows):
            # short/overlong reply reads as silence for the whole chunk
            # (zip would pair acks with the wrong fences)
            LOG.warning("read-fence multi_beat_fast %s: %d acks for %d "
                        "beats", dst, len(resp.items), len(rows))
            return
        now = self.clock.monotonic()
        fallback: list = []
        for (st, r, _b), ack in zip(rows, resp.items):
            if getattr(ack, "ok", False):
                # inline ack bookkeeping, exactly like the hub's fast
                # path: the lease plane sees the (peer, when) write too
                # (for device fences on_peer_ack IS the tally — it lands
                # in the engine's last_ack row the fence_ok lane reduces)
                r.last_rpc_ack = now
                st.node.on_peer_ack(r.peer, now)
                if not st.device:
                    st.note_ack(r.peer)
            else:
                fallback.append((st, r))
        if fallback:
            # full-semantics follow-up: ok=False may just mean the
            # follower's committed lags (restart) — a classic beat still
            # returns the in-term ack the fence needs, and handles a
            # higher term via the normal step-down path
            await asyncio.gather(*(self._classic(st, r)
                                   for st, r in fallback))

    async def _classic(self, st: _GroupFence, r) -> None:
        self.classic_beats += 1
        try:
            ok = await r.send_heartbeat()
        except Exception:  # noqa: BLE001 — one peer's beat only
            return
        if ok and not st.device:
            # device fences: send_heartbeat already recorded the ack
            # arrival into the engine row the fence_ok lane reduces
            st.note_ack(r.peer)


class StoreEngine:
    def __init__(self, opts: StoreEngineOptions, rpc_server, transport,
                 multi_raft_engine=None, pd_client=None) -> None:
        self.opts = opts
        self.cluster_name = opts.cluster_name
        self.server_id = PeerId.parse(opts.server_id)
        self.rpc_server = rpc_server
        self.transport = transport
        # time discipline (ISSUE 18): ONE clock per store; every timing
        # consumer below reads it.  The sentinel rides the beat-plane
        # ack RTT probes to estimate per-peer skew; with drift_bound > 0
        # a suspect local clock fences lease reads (SAFE fallback).
        self.clock = clockmod.resolve(opts.clock)
        self.clock_sentinel = ClockSentinel(
            drift_bound=opts.clock_drift_bound,
            clock=self.clock, label=str(opts.server_id))
        self.node_manager = NodeManager(rpc_server)
        CliProcessors(self.node_manager)
        hub = self.node_manager.heartbeat_hub
        hub.clock = self.clock
        hub.clock_drift_bound = opts.clock_drift_bound
        hub.clock_sentinel = self.clock_sentinel
        # per-region heat telemetry: ONE tracker per store, fed from
        # the KV serving paths (kv_processor binds it at construction)
        # + FSM apply, folded and reported on the PD heartbeat cadence
        self.heat = None
        if opts.heat_tracking:
            from tpuraft_torch.util.heat import RegionHeatTracker

            self.heat = RegionHeatTracker(
                half_life_s=opts.heat_half_life_s)
        self.kv_processor = KVCommandProcessor(self)
        # store-wide SAFE read-confirmation amortizer (attached to every
        # region node's ReadOnlyService by RegionEngine.start)
        self.read_batcher: Optional[ReadConfirmBatcher] = \
            ReadConfirmBatcher() if opts.read_confirm_batching else None
        if self.read_batcher is not None:
            self.read_batcher.clock = self.clock
            from tpuraft_torch.util import describer

            describer.register(self.read_batcher)
        # store-wide write plane (the read batcher's mirror): every
        # region node's replicators submit their windows here
        # (RegionEngine.start attaches it to each node)
        self.append_batcher = None
        if opts.append_batching:
            from tpuraft_torch.core.append_batcher import AppendBatcher
            from tpuraft_torch.util import describer

            self.append_batcher = AppendBatcher()
            self.append_batcher.clock = self.clock
            describer.register(self.append_batcher)
        # gray-failure plane: one HealthTracker per store, fed by the
        # hot path (LogManager flush timing, beat-plane ack RTTs, FSM
        # apply backlog) and acted on by the health loop below
        self.health = None
        self._health_task: Optional[asyncio.Task] = None
        self._evac_round = 0                   # evaluation round counter
        self._evac_cooldown: dict[int, int] = {}  # region -> round gate
        self.evacuations = 0          # transfers triggered by SICK score
        self.evacuation_rounds = 0    # eval rounds that attempted any
        if opts.health_scoring:
            from tpuraft_torch.util import describer
            from tpuraft_torch.util.health import HealthTracker

            self.health = HealthTracker(opts.health_options,
                                        clock=self.clock.monotonic,
                                        label=str(self.server_id))
            describer.register(self.health)
            if self.read_batcher is not None:
                self.read_batcher.health = self.health
            if self.append_batcher is not None:
                # write-plane rounds double as per-endpoint RTT probes
                self.append_batcher.health = self.health
        # disk-pressure plane: one DiskBudget per store, fed by the hot
        # path (LogManager append bytes, snapshot commit/prune deltas,
        # ENOSPC observations) and reconciled + acted on by the health
        # loop's _disk_round below
        self.disk_budget = None
        self.disk_reclaims = 0        # pressure snapshots that completed
        self.disk_reclaim_rounds = 0  # rounds that attempted reclaim
        self.disk_shed_items = 0      # writes bounced at FULL admission
        self._reclaim_cooldown: dict[int, int] = {}  # region -> round gate
        if opts.disk_guard and opts.data_path:
            from tpuraft_torch.util import describer
            from tpuraft_torch.util.health import DiskBudget, DiskBudgetOptions

            self.disk_budget = DiskBudget(
                DiskBudgetOptions(
                    budget_bytes=opts.disk_budget_bytes,
                    near_full_frac=opts.disk_near_full_frac,
                    full_frac=opts.disk_full_frac),
                label=str(self.server_id))
            describer.register(self.disk_budget)
        self.metrics = MetricRegistry(enabled=opts.enable_kv_metrics)
        if self.health is not None:
            self.health.register_gauges(self.metrics)
        if self.disk_budget is not None:
            self.disk_budget.register_gauges(self.metrics)
        self.clock_sentinel.register_gauges(self.metrics)
        from tpuraft_torch.util import describer as _describer
        _describer.register(self.clock_sentinel)
        raw: RawKVStore = opts.raw_store_factory()
        if opts.enable_kv_metrics:
            raw = MetricsRawKVStore(raw, self.metrics)
        self.raw_store: RawKVStore = raw
        # apply worker lane: ONE dedicated thread per store owning the
        # raw store's mutation order (see StoreEngineOptions.apply_lane)
        self.apply_lane = None
        if opts.apply_lane:
            from tpuraft_torch.core.lanes import WorkerLane

            self.apply_lane = WorkerLane(
                name=f"apply-{self.server_id.endpoint}")
        # SIGTERM drain (process topology): True bounces NEW kv work
        # with a retryable busy while admitted items finish — see drain()
        self.draining = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.multi_raft_engine = multi_raft_engine
        self.pd_client = pd_client
        self._regions: dict[int, RegionEngine] = {}
        self._leader_regions: set[int] = set()
        self._started = False
        self._pending_splits: set[int] = set()
        # region lifecycle plane (merge/move) counters — the soak exit
        # gate and admin `regions` view read these
        self.merges_led = 0        # source-side merges this store drove
        self.regions_retired = 0   # source replicas retired (merged away)
        self.regions_absorbed = 0  # absorb applies folded into a target
        self.moves_applied = 0     # PD-ordered replica moves executed
        # regions this store retired (merged away) -> absorbing target.
        # The PD only finalizes a pending merge on an explicit report,
        # so a re-issued KIND_MERGE that arrives after local retirement
        # is answered from this map with a fresh report (the original
        # may have been lost with a crashed leader).  Repopulated by
        # MERGE_COMMIT replay after a restart.
        self._retired_into: dict[int, int] = {}
        self._heartbeat_task: Optional[asyncio.Task] = None
        self._meta_journal = None  # store-lifetime ref (multilog scheme)
        # delta-batched PD reporting state: region -> (fingerprint,
        # last-reported approximate_keys); dirty = force-report next
        # round (fresh leadership, failed instruction); need_full =
        # next batch carries EVERY led region (first contact, or the
        # PD answered need_full after its own failover)
        self._pd_reported: dict[int, tuple] = {}
        self._pd_dirty: set[int] = set()
        self._pd_need_full = True
        # does the PD client's store_heartbeat_batch accept health= /
        # heat=?  Probed from the signature (not by catching TypeError,
        # which would also swallow bugs inside a real implementation):
        # a pre-health/pre-heat subclass override is reported to
        # without the kwargs it predates — the alternative is the
        # retry loop eating its TypeError forever and silently
        # starving the PD of heartbeats.
        self._pd_health_kwarg = True
        self._pd_heat_kwarg = True
        if pd_client is not None:
            import inspect

            try:
                params = inspect.signature(
                    pd_client.store_heartbeat_batch).parameters
                has_var_kw = any(p.kind == p.VAR_KEYWORD
                                 for p in params.values())
                self._pd_health_kwarg = "health" in params or has_var_kw
                self._pd_heat_kwarg = "heat" in params or has_var_kw
            except (TypeError, ValueError):
                pass  # unintrospectable callable: assume current API
        self.pd_batches_sent = 0     # observability (bench counters)
        self.pd_deltas_sent = 0
        self.pd_full_syncs = 0
        self.pd_hb_failures = 0
        self.pd_heat_rows_sent = 0
        if self.heat is not None:
            from tpuraft_torch.util import describer

            describer.register(self.heat)
        # region -> (last-reported heat score, reported-at monotonic) —
        # the noise gate's memory (mirrors _pd_reported for the keys/
        # epoch delta plane) plus the steady-heat keepalive's clock
        self._pd_heat_reported: dict[int, tuple[float, float]] = {}
        # live metrics exposition: the describe_metrics admin RPC makes
        # a running fleet scrapeable over the wire (no signals), and the
        # optional HTTP listener serves the same text to Prometheus
        self.rpc_server.register("cli_describe_metrics",
                                 self._handle_describe_metrics)
        self._metrics_httpd = None
        self.metrics_http_port: Optional[int] = None
        # metrics_text render cache (satellite: a tight scrape loop at
        # region density must not burn the serving thread re-rendering):
        # (body, rendered_at_monotonic); the HTTP daemon thread and the
        # loop-side RPC handler both serve through it
        self._metrics_cache_lock = threading.Lock()
        self._metrics_cache: tuple[Optional[str], float] = \
            (None, 0.0)  # guarded-by: _metrics_cache_lock
        self.metrics_renders = 0       # actual renders (cache misses)
        self.metrics_cache_hits = 0    # scrapes served from the cache

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        if self.health is not None:
            # beat-plane RPCs double as per-endpoint RTT probes
            self.node_manager.heartbeat_hub.health = self.health
            # event-loop lag probe: scheduling delay of a call_later
            # chain — loop saturation becomes a scored gray-failure
            # signal instead of a bench-only inference
            self.health.loop_lag.start()
        if self.multi_raft_engine is not None:
            await self.multi_raft_engine.start()
        # batched-concurrent region boot: one region at a time serializes
        # every node.init's await points — at region density (rhea:
        # StoreEngine's thousands-of-regions role) that alone dominates
        # store restart time.  Bounded batches keep the task herd small.
        BOOT_BATCH = 128
        regions = list(self.opts.initial_regions)
        for i in range(0, len(regions), BOOT_BATCH):
            # settle the WHOLE batch before failing: a bare gather would
            # abort on the first error while sibling boots keep running
            # detached against a half-torn store
            results = await asyncio.gather(
                *(self._start_region(r) for r in regions[i:i + BOOT_BATCH]),
                return_exceptions=True)
            for res in results:
                if isinstance(res, BaseException):
                    raise res
        self._started = True
        if self.pd_client is not None:
            self._heartbeat_task = asyncio.ensure_future(
                self._heartbeat_loop())
        if self.health is not None:
            self._wire_multilog_probe()
        if self.health is not None or self.disk_budget is not None:
            self._health_task = asyncio.ensure_future(self._health_loop())
        if self.opts.metrics_port is not None:
            self._start_metrics_http()
        LOG.info("store engine %s up with %d regions", self.server_id,
                 len(self._regions))

    def _wire_multilog_probe(self) -> None:
        """multilog scheme: the shared group commit times every fsync
        in its executor thread — feed those samples to the disk probe
        (the LogManager's flush timing covers the file scheme)."""
        if self.opts.log_scheme != "multilog" or not self.opts.data_path:
            return
        from tpuraft_torch.storage.multilog import peek_engine

        store_base = (f"{self.opts.data_path}/"
                      f"{self.server_id.ip}_{self.server_id.port}")
        eng = peek_engine(f"{store_base}/mlog")
        if eng is not None:
            eng.group_commit.health_probe = self.health.disk

    async def shutdown(self) -> None:
        self._started = False
        if self._metrics_httpd is not None:
            httpd = self._metrics_httpd
            self._metrics_httpd = None
            # serve_forever exits on shutdown(); it blocks up to the
            # poll interval, so hop off the event loop for it
            await asyncio.get_running_loop().run_in_executor(
                None, httpd.shutdown_blocking)
        if self.heat is not None:
            from tpuraft_torch.util import describer

            describer.unregister(self.heat)
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            self._heartbeat_task = None
        if self._health_task is not None:
            self._health_task.cancel()
            self._health_task = None
        if self.health is not None:
            from tpuraft_torch.util import describer

            self.health.loop_lag.stop()
            describer.unregister(self.health)
        if self.disk_budget is not None:
            from tpuraft_torch.util import describer

            describer.unregister(self.disk_budget)
        if self.read_batcher is not None:
            from tpuraft_torch.util import describer

            describer.unregister(self.read_batcher)
            await self.read_batcher.shutdown()
        if self.append_batcher is not None:
            from tpuraft_torch.util import describer

            describer.unregister(self.append_batcher)
            await self.append_batcher.shutdown()
        for engine in list(self._regions.values()):
            await engine.shutdown()
        self._regions.clear()
        if self.multi_raft_engine is not None:
            await self.multi_raft_engine.shutdown()
        if self.apply_lane is not None:
            # after the regions: no FSMCaller is left to submit applies
            await self.apply_lane.aclose()
        close = getattr(self.raw_store, "close", None)
        if close is not None:
            close()  # native engine: flush + release the WAL fd
        if self._meta_journal is not None:
            from tpuraft_torch.storage.meta_multilog import _release_journal

            _release_journal(self._meta_journal)
            self._meta_journal = None

    def loop_call_threadsafe(self, fn, *args) -> None:
        """Hop a loop-confined engine call off a worker lane thread
        (lane-applied RANGE_SPLIT is the one caller today)."""
        loop = self._loop
        if loop is None:
            fn(*args)
            return
        loop.call_soon_threadsafe(fn, *args)

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """SIGTERM drain: stop admitting NEW kv work (handlers bounce it
        with a retryable busy the client re-offers elsewhere), then wait
        until every already-admitted item has acked — bounded by
        ``timeout_s``.  Returns True when the pipe emptied in time.
        The caller shuts the engine down afterwards; leadership moves
        when the silenced groups' peers time out, exactly like a crash
        but with zero lost acks."""
        self.draining = True
        # graftcheck: allow(raw-clock) — SIGTERM drain budget is REAL
        # wall seconds: a frozen/slow store clock must not stretch the
        # operator's shutdown window
        deadline = time.monotonic() + timeout_s
        while self.kv_processor.inflight_items > 0:
            # graftcheck: allow(raw-clock) — same real-time drain budget
            if time.monotonic() >= deadline:
                LOG.warning("drain timed out with %d items in flight",
                            self.kv_processor.inflight_items)
                return False
            await asyncio.sleep(0.01)
        return True

    # -- gray-failure survival: health loop + leadership evacuation ----------

    async def _health_loop(self) -> None:
        """Steady-cadence scoring (hysteresis counts these rounds) +
        SICK-triggered mitigation.  Detection latency is bounded by
        interval x worsen_after; evacuation is rate-bounded per round
        so mitigation can never itself storm the cluster."""
        from tpuraft_torch.util.health import SICK

        interval = self.opts.health_eval_interval_ms / 1000.0
        while self._started:
            try:
                await asyncio.sleep(interval)
                self._evac_round += 1
                if self.disk_budget is not None:
                    await self._disk_round(self._evac_round)
                if self.health is None:
                    continue
                level = self.health.evaluate()
                if level == SICK and self.opts.evacuate_on_sick:
                    await self._evacuate_leaders()
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — scoring must never die
                LOG.exception("health loop round failed")

    # -- disk-pressure survival: accounting + reaction ladder ----------------

    def _store_base(self) -> str:
        return (f"{self.opts.data_path}/"
                f"{self.server_id.ip}_{self.server_id.port}")

    async def _disk_round(self, round_no: int) -> None:
        """One disk-pressure round: periodic usage reconciliation
        (directory walk, off-loop), pressure fold, health floor
        (NEAR_FULL => DEGRADED stops PD leader placement; FULL => SICK
        engages the evacuation machinery), and rate-bounded urgent
        reclaim while under pressure."""
        from tpuraft_torch.util.health import (DEGRADED, HEALTHY, SICK,
                                         PRESSURE_FULL, PRESSURE_NEAR_FULL,
                                         PRESSURE_OK)

        b = self.disk_budget
        if round_no % max(1, self.opts.disk_reconcile_rounds) == 1:
            loop = asyncio.get_running_loop()
            base = self._store_base()
            if self.opts.disk_budget_bytes > 0:
                used = await loop.run_in_executor(
                    None, _dir_usage_bytes, base)
                b.reconcile(used)
            else:
                # no explicit budget: whole-filesystem statvfs view
                try:
                    sv = await loop.run_in_executor(None, os.statvfs, base)
                    b.reconcile((sv.f_blocks - sv.f_bavail) * sv.f_frsize,
                                sv.f_blocks * sv.f_frsize)
                except OSError:
                    pass
        level = b.evaluate()
        if self.health is not None:
            if level == PRESSURE_FULL:
                self.health.set_floor(SICK, "disk_full")
            elif level == PRESSURE_NEAR_FULL:
                self.health.set_floor(DEGRADED, "disk_near_full")
            else:
                self.health.set_floor(HEALTHY)
        if level != PRESSURE_OK:
            await self._reclaim_round(level)

    async def _reclaim_round(self, pressure: str) -> None:
        """Urgent reclaim under pressure: snapshot + log-compact up to
        ``disk_reclaim_rate`` led regions this round (cooldown-gated
        per region).  Triggered already at NEAR_FULL — i.e. inside the
        reserved headroom below full_frac — so the snapshot/compaction
        writes themselves still fit under the hard budget."""
        self.disk_reclaim_rounds += 1
        done = 0
        for rid in self.leader_region_ids():
            if done >= max(1, self.opts.disk_reclaim_rate):
                break
            if self._reclaim_cooldown.get(rid, 0) > self._evac_round:
                continue
            engine = self._regions.get(rid)
            if engine is None or engine.node is None:
                continue
            # cooldown on ATTEMPT: a save that bounces (EBUSY, or
            # ENOSPC inside the headroom) must not be hammered every
            # round
            self._reclaim_cooldown[rid] = (
                self._evac_round
                + max(1, self.opts.disk_reclaim_cooldown_rounds))
            try:
                st = await engine.node.snapshot()
            except Exception:  # noqa: BLE001 — reclaim must never die
                LOG.exception("pressure reclaim snapshot failed (region %d)",
                              rid)
                continue
            if st.is_ok():
                done += 1
                self.disk_reclaims += 1
                RECORDER.record("disk_reclaim", engine.group_id,
                                node=str(self.server_id), pressure=pressure)
                LOG.warning("disk-pressure reclaim: region %d snapshotted + "
                            "log-compacted (store %s is %s)", rid,
                            self.server_id, pressure)

    def should_shed_writes(self) -> tuple[bool, int]:
        """FULL-disk admission gate (kv_service): WRITE ops bounce with
        the retryable busy while reads keep serving — a full store
        stays a useful read replica while reclaim frees space.
        Returns (shed?, retry_after_ms)."""
        from tpuraft_torch.util.health import PRESSURE_FULL

        if self.disk_budget is None \
                or self.disk_budget.pressure() != PRESSURE_FULL:
            return False, 0
        return True, self.opts.shed_retry_after_ms

    async def _evacuate_leaders(self) -> int:
        """Proactive leadership evacuation: move up to
        ``evacuation_rate`` led groups to the healthiest caught-up
        voter this round.  Hysteretic by construction — only a SICK
        (not DEGRADED) score reaches here, and the tracker's
        recover_after rounds keep a recovering store from flapping
        between evacuating and re-acquiring."""
        done = 0
        self.evacuation_rounds += 1
        for rid in self.leader_region_ids():
            if done >= max(1, self.opts.evacuation_rate):
                break
            if self._evac_cooldown.get(rid, 0) > self._evac_round:
                continue
            engine = self._regions.get(rid)
            if engine is None or not engine.is_leader():
                continue
            target = self._pick_evacuation_target(engine)
            if target is None:
                continue
            # cooldown on ATTEMPT, not success: a transfer that bounces
            # (EBUSY mid-conf-change) must not be hammered every round
            self._evac_cooldown[rid] = (
                self._evac_round + max(1, self.opts.evacuation_cooldown_rounds))
            st = await engine.transfer_leadership_to(target)
            if st.is_ok():
                done += 1
                self.evacuations += 1
                RECORDER.record("evacuation", engine.group_id,
                                node=str(self.server_id),
                                target=str(target),
                                cause=self.health.cause)
                LOG.warning("gray-failure evacuation: region %d leadership "
                            "-> %s (store %s is SICK: %s)", rid, target,
                            self.server_id, self.health.cause)
        return done

    def _pick_evacuation_target(self, engine) -> Optional[PeerId]:
        """Healthiest caught-up voter: witness-aware (never a target),
        priority-aware (higher priority preferred), per-peer health
        scores first (a SICK peer is never a target — evacuating onto
        another gray store helps nobody), caught-up-ness required (the
        transfer protocol would stall on a lagging target)."""
        from tpuraft_torch.util.health import DEGRADED, HEALTHY, SICK

        node = engine.node
        if node is None or node.state.value != "leader" \
                or node._conf_ctx is not None:
            return None
        conf = node.conf_entry.conf
        if not node.conf_entry.old_conf.is_empty():
            return None  # mid-joint: let the change finish first
        witnesses = set(conf.witnesses)
        committed = node.ballot_box.last_committed_index
        rank = {HEALTHY: 0, DEGRADED: 1, SICK: 2}
        best = None
        for p in conf.peers:
            if p == node.server_id or p in witnesses:
                continue
            r = node.replicators.get(p)
            if r is None or not r._matched or r.match_index < committed:
                continue
            score = self.health.peer_score(p.endpoint)
            if score == SICK:
                continue
            key = (rank[score], -p.priority, -r.match_index)
            if best is None or key < best[0]:
                best = (key, p)
        return best[1] if best else None

    def should_shed(self) -> tuple[bool, int]:
        """Serving-plane degradation gate (kv_service.handle_batch):
        once this store is SICK and the propose/apply pipe already
        holds ``shed_backlog_items``, new batch items bounce with
        EBUSY + retry-after instead of queueing behind the dying disk.
        Returns (shed?, retry_after_ms)."""
        from tpuraft_torch.util.health import SICK

        if (self.health is None or self.opts.shed_backlog_items <= 0
                or self.health.score() != SICK):
            return False, 0
        if self.kv_processor.inflight_items < self.opts.shed_backlog_items:
            return False, 0
        return True, self.opts.shed_retry_after_ms

    # -- live metrics exposition ---------------------------------------------

    def metrics_counters(self) -> tuple[dict, dict]:
        """(counters, gauges) of everything this store knows: serving
        plane, PD reporting, hub/lease plane, read plane, health, trace
        plane.  Plain int/float reads only — safe from the exposition
        thread (best-effort consistency; no locks taken beyond the
        recorder's own)."""
        kp = self.kv_processor
        counters: dict = {
            "kv_batch_rpcs": kp.batch_rpcs,
            "kv_batch_items": kp.batch_items,
            "kv_batch_regions": kp.batch_regions,
            "kv_single_rpcs": kp.single_rpcs,
            "kv_shed_items": kp.shed_items,
            "kv_read_fences": kp.read_fences,
            "kv_fenced_reads": kp.fenced_reads,
            "pd_batches_sent": self.pd_batches_sent,
            "pd_deltas_sent": self.pd_deltas_sent,
            "pd_full_syncs": self.pd_full_syncs,
            "pd_hb_failures": self.pd_hb_failures,
            "pd_heat_rows_sent": self.pd_heat_rows_sent,
            "evacuations": self.evacuations,
            "evacuation_rounds": self.evacuation_rounds,
            "disk_reclaims": self.disk_reclaims,
            "disk_reclaim_rounds": self.disk_reclaim_rounds,
            "merges_led": self.merges_led,
            "regions_retired": self.regions_retired,
            "regions_absorbed": self.regions_absorbed,
            "moves_applied": self.moves_applied,
            "kv_disk_shed_items": self.disk_shed_items,
            "metrics_renders": self.metrics_renders,
            "metrics_cache_hits": self.metrics_cache_hits,
        }
        if self.heat is not None:
            counters.update(self.heat.counters())
        # per-region O(regions) aggregation (the pass metrics_text's
        # TTL cache bounds): apply/propose plane totals across every
        # hosted region — entries-per-batch amortization, live
        apply_batches = applied_entries = eager_acked = 0
        propose_drains = proposed_ops = lane_batches = 0
        for eng in list(self._regions.values()):
            node = eng.node
            if node is not None and node.fsm_caller is not None:
                apply_batches += node.fsm_caller.apply_batches
                applied_entries += node.fsm_caller.applied_entries
                eager_acked += node.fsm_caller.eager_acked
                lane_batches += node.fsm_caller.lane_batches
            if eng.raft_store is not None:
                propose_drains += eng.raft_store.propose_drains
                proposed_ops += eng.raft_store.proposed_ops
        counters.update({
            "fsm_apply_batches": apply_batches,
            "fsm_applied_entries": applied_entries,
            "fsm_eager_acked": eager_acked,
            "fsm_lane_batches": lane_batches,
            "propose_drains": propose_drains,
            "proposed_ops": proposed_ops,
        })
        if self.apply_lane is not None:
            counters["lane_jobs"] = self.apply_lane.jobs
        if self.read_batcher is not None:
            counters.update(self.read_batcher.counters())
        if self.append_batcher is not None:
            counters.update(self.append_batcher.counters())
        counters.update(self.node_manager.heartbeat_hub.counters())
        counters.update(TRACER.counters())
        counters.update(RECORDER.counters())
        # non-monotonic trace/recorder series render as gauges — a
        # Prometheus rate() over a value that can DROP (ring occupancy,
        # the enabled toggle, a two-way EMA) reads as counter resets
        trace_gauges = {**TRACER.gauges(), **RECORDER.gauges()}
        # read-plane + node counters aggregated across region groups
        agg: dict = {}
        for engine in list(self._regions.values()):
            node = engine.node
            if node is None:
                continue
            for k, v in node.read_only_service.counters().items():
                agg[k] = agg.get(k, 0) + v
            for k, v in node.metrics.counters_snapshot().items():
                agg[f"node_{k}"] = agg.get(f"node_{k}", 0) + v
        counters.update(agg)
        gauges: dict = {
            "regions": len(self._regions),
            "leader_regions": len(self._leader_regions),
            "kv_inflight_items": kp.inflight_items,
            "draining": int(self.draining),
            **trace_gauges,
        }
        if self.apply_lane is not None:
            gauges["lane_depth"] = self.apply_lane.depth()
        if self.health is not None:
            gauges.update(self.health.counters())
        if self.disk_budget is not None:
            gauges.update(self.disk_budget.counters())
        # clock plane rides the unconditional exposition path (like
        # health/disk above) — admin.py clocks must see the sentinel
        # even on stores that never enabled the opt-in KV registry
        gauges.update(self.clock_sentinel.gauges())
        counters.update({
            "clock_skew_samples": self.clock_sentinel.samples,
            "clock_anomalies": self.clock_sentinel.anomalies,
        })
        if self.heat is not None:
            gauges.update(self.heat.gauges())
        if self.multi_raft_engine is not None:
            # tick-plane occupancy lanes ([G] vectorized reductions —
            # no per-group Python) + tick counters
            eng = self.multi_raft_engine
            counters["engine_ticks"] = eng.ticks
            counters["engine_commit_advances"] = eng.commit_advances
            counters["engine_eager_commits"] = eng.eager_commits
            gauges.update({f"engine_{k}": v
                           for k, v in eng.lane_stats().items()})
        return counters, gauges

    def _render_metrics_text(self) -> str:
        """Uncached Prometheus render of :meth:`metrics_counters` plus
        the store registry's histograms (when KV metrics are on) and
        the engine tick-plane histograms (when engine-backed)."""
        counters, gauges = self.metrics_counters()
        hists: dict = {}
        if self.metrics.enabled:
            snap = self.metrics.snapshot()
            counters.update({f"reg_{k}": v
                             for k, v in snap["counters"].items()})
            gauges.update({f"reg_{k}": v
                           for k, v in snap["gauges"].items()})
            hists = snap["histograms"]
        if self.multi_raft_engine is not None:
            hists.update(self.multi_raft_engine.tick_histograms())
        return prometheus_text(counters, gauges, hists,
                               labels={"store": str(self.server_id)})

    def metrics_text(self) -> str:
        """Cached Prometheus text exposition.

        The per-region aggregation in :meth:`metrics_counters` is
        O(regions); at 1024 regions a tight scrape loop re-rendering
        per GET burns the serving thread.  Renders within
        ``metrics_cache_ttl_ms`` serve the cached body (stale-ok), and
        every response carries ``tpuraft_metrics_age_seconds`` — the
        staleness is visible and bounded by the TTL."""
        ttl = max(0.0, self.opts.metrics_cache_ttl_ms / 1000.0)
        with self._metrics_cache_lock:
            # graftcheck: allow(raw-clock) — scrape-cache TTL is against
            # the scraper's real cadence, not the store's time plane
            now = time.monotonic()
            body, t = self._metrics_cache
            if body is None or now - t >= ttl:
                body = self._render_metrics_text()
                t = now
                self._metrics_cache = (body, t)
                self.metrics_renders += 1
            else:
                self.metrics_cache_hits += 1
            age = now - t
        return body + prometheus_text(
            gauges={"metrics_age_seconds": round(age, 4)},
            labels={"store": str(self.server_id)})

    async def _handle_describe_metrics(self, req):
        """``cli_describe_metrics`` admin RPC: the wire-borne scrape
        (examples/admin.py metrics) — same text the HTTP listener
        serves, without needing a second listener or signals."""
        from tpuraft_torch.rpc.cli_messages import DescribeMetricsResponse

        return DescribeMetricsResponse(text=self.metrics_text())

    def _start_metrics_http(self) -> None:
        """Optional stdlib HTTP listener: GET /metrics on its own
        daemon thread (util/metrics_http — shared with the PD's
        listener).  Port 0 binds ephemerally (tests read
        ``metrics_http_port``)."""
        from tpuraft_torch.util.metrics_http import MetricsHttpServer

        self._metrics_httpd = MetricsHttpServer(
            self.opts.metrics_host, self.opts.metrics_port,
            self.metrics_text, name=f"metrics-http-{self.server_id}")
        self.metrics_http_port = self._metrics_httpd.port

    # -- PD heartbeats -------------------------------------------------------

    async def _heartbeat_loop(self) -> None:
        """Reference: ``rhea:StoreEngine``'s Store/Region heartbeat
        senders — now DELTA-BATCHED: one ``pd_store_heartbeat_batch``
        RPC per interval carrying only changed-region rows (idle PD
        traffic is O(stores), not O(regions)), executing returned
        Instructions.

        Hardening: every store used to beat on the same 1000 ms phase
        and drop failed rounds at LOG.debug — now each store starts at
        a seeded random phase with per-round jitter (the PD never sees
        the whole fleet in one burst), and consecutive failures back
        off exponentially (bounded by ``pd_backoff_max_ms``) with a
        WARNING once the PD looks actually down."""
        import random

        interval = self.opts.heartbeat_interval_ms / 1000.0
        rng = random.Random(zlib.crc32(str(self.server_id).encode())
                            ^ 0x5bd1e995)
        # per-store phase offset: spread the fleet over the interval
        await asyncio.sleep(rng.random() * interval)
        fails = 0
        while self._started:
            try:
                await self._heartbeat_once()
                fails = 0
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — PD may be down; keep trying
                fails += 1
                self.pd_hb_failures += 1
                log = LOG.warning if fails in (3, 10) or fails % 60 == 0 \
                    else LOG.debug
                log("pd heartbeat failed (%d consecutive)", fails,
                    exc_info=fails == 3)
            backoff = interval * (2 ** min(fails, 6)) if fails else interval
            backoff = min(backoff, self.opts.pd_backoff_max_ms / 1000.0)
            # ±10% per-round jitter: phase-locked fleets drift apart
            await asyncio.sleep(backoff * (0.9 + 0.2 * rng.random()))

    async def _approx_keys(self, start: bytes, end: bytes) -> int:
        """Range key-count probe — through the apply lane when one owns
        the store (a loop-side index rebuild would race lane applies)."""
        if self.apply_lane is not None:
            return await self.apply_lane.submit(
                self.raw_store.approximate_keys_in_range, start, end)
        return self.raw_store.approximate_keys_in_range(start, end)

    def _pd_fingerprint(self, region: Region) -> tuple:
        return (region.epoch.conf_ver, region.epoch.version,
                region.start_key, region.end_key, tuple(region.peers))

    async def _heartbeat_once(self) -> None:
        from tpuraft_torch.rheakv.pd_messages import Instruction

        full = self._pd_need_full
        deltas: list[tuple[Region, str, int]] = []
        fps: dict[int, tuple] = {}
        me = str(self.server_id)
        for rid in self.leader_region_ids():
            engine = self._regions.get(rid)
            if engine is None or not engine.is_leader():
                continue
            region = engine.region
            keys = await self._approx_keys(region.start_key, region.end_key)
            fp = self._pd_fingerprint(region)
            last = self._pd_reported.get(rid)
            # a keys move under ~12.5% (and < 64 abs) is noise, not a
            # delta — the PD's split threshold only needs coarse counts
            changed = (full or last is None or last[0] != fp
                       or rid in self._pd_dirty
                       or abs(keys - last[1]) * 8 >= max(last[1], 64))
            if changed:
                deltas.append((region.copy(), me, keys))
                fps[rid] = (fp, keys)
        # batch reporting: region rows ride as deltas, so build the
        # bare store identity directly — store_meta() would deep-copy
        # every region just for us to throw the list away each interval
        meta = StoreMeta(id=zlib.crc32(str(self.server_id).encode()),
                         endpoint=self.server_id.endpoint, regions=[],
                         zone=self.opts.zone)
        # health rides the heartbeat as a trailing wire field: the PD
        # stops placing leaders onto SICK stores and drains them (a
        # pre-health PD client override is probed at construction and
        # reported to without the kwarg — see _pd_health_kwarg)
        health = self.health.score() if self.health is not None else ""
        heat_rows = self._heat_report(full)
        kwargs: dict = {}
        if self._pd_health_kwarg:
            kwargs["health"] = health
        if self._pd_heat_kwarg:
            kwargs["heat"] = [row for row, _score in heat_rows]
            kwargs["occupancy"] = self.tick_occupancy()
        instructions, need_full = \
            await self.pd_client.store_heartbeat_batch(
                meta, deltas, full=full, **kwargs)
        # only now (RPC succeeded) do the fingerprints count as reported
        self.pd_batches_sent += 1
        self.pd_deltas_sent += len(deltas)
        if self._pd_heat_kwarg:
            self.pd_heat_rows_sent += len(heat_rows)
            # graftcheck: allow(raw-clock) — keepalive bookkeeping vs
            # the PD's REAL heat_stale_s expiry, not store time
            now = time.monotonic()
            self._pd_heat_reported.update(
                {row[0]: (score, now) for row, score in heat_rows})
        if full:
            self.pd_full_syncs += 1
        self._pd_reported.update(fps)
        self._pd_dirty.difference_update(fps)
        self._pd_need_full = bool(need_full)
        for ins in instructions:
            engine = self._regions.get(ins.region_id)
            if engine is None or not engine.is_leader():
                if ins.kind == Instruction.KIND_MERGE and \
                        self._retired_into.get(ins.region_id) == \
                        ins.new_region_id:
                    # re-issued merge for a region this store already
                    # retired: the completion reports were all lost
                    # (PD down/partitioned across the merge) — answer
                    # with a fresh one so the PD finalizes the pending
                    # pair instead of re-issuing forever
                    try:
                        await self.pd_client.report_merge(
                            ins.region_id, ins.new_region_id)
                    except Exception:  # noqa: BLE001 — next round
                        LOG.debug("retired-merge report %d -> %d "
                                  "failed; will answer the next "
                                  "re-issue", ins.region_id,
                                  ins.new_region_id, exc_info=True)
                continue
            if ins.kind == Instruction.KIND_SPLIT:
                st = await self.apply_split(ins.region_id,
                                            ins.new_region_id)
                if not st.is_ok():
                    LOG.info("pd-ordered split of region %d failed: %s",
                             ins.region_id, st)
                    # the PD only re-issues on a fresh report: force one
                    self._pd_dirty.add(ins.region_id)
            elif ins.kind == Instruction.KIND_TRANSFER_LEADER \
                    and ins.target_peer:
                await engine.transfer_leadership_to(
                    PeerId.parse(ins.target_peer))
            elif ins.kind == Instruction.KIND_MERGE:
                st = await self.apply_merge(ins.region_id,
                                            ins.new_region_id,
                                            ins.target_peer)
                if not st.is_ok():
                    # deferred (mid-conf-change) or bounced (target
                    # leader moved): a fresh report makes the PD
                    # re-issue from its replicated pending_merges map
                    LOG.info("pd-ordered merge of region %d into %d "
                             "deferred: %s", ins.region_id,
                             ins.new_region_id, st)
                    self._pd_dirty.add(ins.region_id)
            elif ins.kind == Instruction.KIND_MOVE and ins.target_peer:
                st = await self.apply_move(ins.region_id, ins.target_peer,
                                           ins.src_peer)
                if not st.is_ok():
                    LOG.info("pd-ordered move of region %d -> %s failed: "
                             "%s", ins.region_id, ins.target_peer, st)
                    self._pd_dirty.add(ins.region_id)

    def _heat_report(self, full: bool) -> list[tuple[tuple, float]]:
        """Fold the heat window and pick the led regions whose heat
        moved past the noise gate (util/heat.heat_changed), whose
        standing rate is due its keepalive refresh (``heat_refresh_s``
        — the PD expires silent rates after heat_stale_s, so steady
        heat must re-report, just slowly), or every led region with
        any heat when ``full`` (PD resync).  Returns
        [((region_id, w, r, bi, bo), score), ...]; the scores land in
        ``_pd_heat_reported`` only after the RPC succeeds."""
        if self.heat is None:
            return []
        from tpuraft_torch.util.heat import heat_changed

        self.heat.fold()
        # graftcheck: allow(raw-clock) — keepalive refresh races the
        # PD's REAL heat_stale_s expiry window
        now = time.monotonic()
        rows: list[tuple[tuple, float]] = []
        for rid in self.leader_region_ids():
            h = self.heat.heat(rid)
            score = h.score
            last, last_t = self._pd_heat_reported.get(rid, (0.0, 0.0))
            refresh = (score >= 0.5 and last_t > 0.0
                       and now - last_t >= self.opts.heat_refresh_s)
            if full and (score or last) or refresh \
                    or heat_changed(score, last):
                rows.append(((rid, h.writes_s, h.reads_s,
                              h.bytes_in_s, h.bytes_out_s), score))
        return rows

    def tick_occupancy(self) -> tuple[int, int]:
        """(replicas_hosted, replicas_quiescent) for the PD heartbeat's
        hibernation fraction — one vectorized reduce over the engine's
        [G] rows for engine-backed stores; (regions, 0) in timer mode
        (host timers have no quiescence)."""
        e = self.multi_raft_engine
        if e is None:
            return len(self._regions), 0
        return (int(e.has_ctrl.sum()),
                int((e.quiescent & e.has_ctrl).sum()))

    async def _start_region(self, region: Region) -> RegionEngine:
        engine = RegionEngine(region, self)
        await engine.start()
        self._regions[region.id] = engine
        return engine

    # -- region access -------------------------------------------------------

    def get_region_engine(self, region_id: int) -> Optional[RegionEngine]:
        return self._regions.get(region_id)

    def list_regions(self) -> list[Region]:
        return [e.region for e in self._regions.values()]

    def store_meta(self) -> StoreMeta:
        # stable across restarts/processes (builtin hash() is seeded)
        sid = zlib.crc32(str(self.server_id).encode())
        return StoreMeta(id=sid,
                         endpoint=self.server_id.endpoint,
                         regions=[r.copy() for r in self.list_regions()],
                         zone=self.opts.zone)

    # -- node options for a region's raft group ------------------------------

    def make_node_options(self, region: Region, fsm) -> NodeOptions:
        conf = Configuration.parse(",".join(region.peers))
        opts = NodeOptions(
            election_timeout_ms=self.opts.election_timeout_ms,
            initial_conf=conf,
            fsm=fsm,
        )
        # '/witness'-flagged own peer: this store hosts the region as a
        # WITNESS — metadata-only journal, null FSM, never campaigns
        opts.witness = conf.is_witness(self.server_id)
        if conf.witnesses and self.multi_raft_engine is not None:
            # the device plane is witness-aware since ISSUE 19 (the tick
            # carries a witness_mask and clamps the commit reduce to the
            # best DATA-replica match, mirroring ballot_box.commit_point)
            # — but only on a tick module that actually has those lanes.
            # A stale ops plane would count witness rows as plain data
            # matches on device, silently dropping the third safety
            # layer, so refuse LOUDLY rather than run witness regions
            # with weaker guarantees than documented.
            from tpuraft_torch.ops.tick import witness_lanes_available
            if not witness_lanes_available():
                raise ValueError(
                    f"region {region.id}: witness members "
                    f"{[str(p) for p in conf.witnesses]} on an "
                    f"engine-backed store, but this device tick plane "
                    f"predates the witness commit clamp (no "
                    f"witness_mask/fence_ok lanes) — upgrade tpuraft.ops "
                    f"or host witness regions on timer-mode stores (no "
                    f"MultiRaftEngine)")
        opts.raft_options.read_only_option = self.opts.read_only_option
        opts.raft_options.quiesce_after_rounds = \
            self.opts.quiesce_after_rounds
        # time discipline: every region node of this store runs on the
        # ONE store clock and consults the ONE skew sentinel before
        # trusting its leader lease (ISSUE 18)
        opts.clock = self.opts.clock
        opts.clock_sentinel = self.clock_sentinel
        opts.raft_options.clock_drift_bound = self.opts.clock_drift_bound
        # gray-failure plane: every region node of this store feeds (and
        # consults) the ONE store-level tracker — disk probe from its
        # LogManager, apply depth from its FSMCaller, election gate from
        # its _allow_launch_election
        opts.health = self.health
        # disk-pressure plane: every region node feeds the ONE
        # store-level capacity tracker (LogManager append bytes,
        # snapshot executor commit/prune deltas, ENOSPC observations)
        opts.disk_budget = self.disk_budget
        # apply worker lane: every region's FSMCaller submits committed
        # DATA runs to the ONE store-wide lane (total store order
        # preserved by the lane's FIFO; witness regions have a null FSM
        # with no apply_sync and stay on the loop)
        opts.apply_lane = self.apply_lane
        if self.opts.data_path:
            store_base = (f"{self.opts.data_path}/"
                          f"{self.server_id.ip}_{self.server_id.port}")
            base = f"{store_base}/r{region.id}"
            if self.opts.log_scheme == "multilog":
                # one shared journal engine for every region of this
                # store: cross-region group-commit fsync — and the SAME
                # treatment for {term, votedFor}: per-region file://
                # meta would pay one fsync per region per election,
                # which is the serial-fsync herd the shared meta
                # journal exists to absorb (storage/meta_multilog.py)
                opts.log_uri = f"multilog://{store_base}/mlog#r{region.id}"
                opts.raft_meta_uri = \
                    f"multimeta://{store_base}/meta#r{region.id}"
                if self._meta_journal is None:
                    # store-lifetime ref: per-region opens (migration
                    # below, node init) become refcount bumps instead
                    # of journal reopen+fsync cycles on the loop
                    from tpuraft_torch.storage.meta_multilog import get_journal

                    self._meta_journal = get_journal(f"{store_base}/meta")
                self._migrate_legacy_meta(store_base, base, region.id)
            else:
                opts.log_uri = f"{self.opts.log_scheme}://{base}/log"
                if self.opts.log_segment_max_bytes > 0:
                    opts.log_uri += \
                        f"?seg={self.opts.log_segment_max_bytes}"
                opts.raft_meta_uri = f"file://{base}/meta"
            opts.snapshot_uri = f"file://{base}/snapshot"
        else:
            opts.log_uri = "memory://"
            opts.raft_meta_uri = "memory://"
        opts.snapshot = SnapshotOptions(
            interval_secs=self.opts.snapshot_interval_secs)
        return opts

    @staticmethod
    def _migrate_legacy_meta(store_base: str, base: str, rid: int) -> None:
        """One-time upgrade: multilog-scheme stores used to keep
        per-region ``file://`` meta; seed the shared meta journal from
        it so a restarted store can never fall back to term 0 and vote
        twice in a term it already voted in.  The legacy file is
        renamed after seeding (the term guard makes a replayed
        migration a no-op regardless)."""
        legacy = os.path.join(base, "meta", "raft_meta")
        if not os.path.exists(legacy):
            return
        from tpuraft_torch.storage.meta_multilog import MultiRaftMetaStorage
        from tpuraft_torch.storage.meta_storage import RaftMetaStorage

        old = RaftMetaStorage(os.path.join(base, "meta"))
        old.init()
        new = MultiRaftMetaStorage(f"{store_base}/meta", f"r{rid}")
        new.init()
        try:
            if old.term > new.term:
                new.set_term_and_voted_for(old.term, old.voted_for)
        finally:
            new.shutdown()
        os.replace(legacy, legacy + ".migrated")

    def ballot_box_factory(self):
        if self.multi_raft_engine is None:
            return None
        return self.multi_raft_engine.ballot_box_factory()

    # -- leadership bookkeeping (PD heartbeat fodder) ------------------------

    def on_region_leader_start(self, region_id: int, term: int) -> None:
        self._leader_regions.add(region_id)

    def on_region_leader_stop(self, region_id: int) -> None:
        self._leader_regions.discard(region_id)

    def leader_region_ids(self) -> list[int]:
        return sorted(self._leader_regions)

    # -- split ---------------------------------------------------------------

    async def apply_split(self, region_id: int, new_region_id: int,
                          split_key: Optional[bytes] = None) -> Status:
        """Leader-side entry: replicate a RANGE_SPLIT through the region's
        raft group (reference: ``rhea:StoreEngine#applySplit``)."""
        engine = self._regions.get(region_id)
        if engine is None:
            return Status.error(RaftError.ENOENT, f"region {region_id} absent")
        if new_region_id in self._regions:
            return Status.error(RaftError.EEXISTS,
                                f"region {new_region_id} exists")
        region = engine.region
        if split_key is None:
            n = await self._approx_keys(region.start_key, region.end_key)
            if n < self.opts.least_keys_on_split:
                return Status.error(
                    RaftError.EBUSY,
                    f"region {region_id} too small to split ({n} keys)")
            if self.apply_lane is not None:
                split_key = await self.apply_lane.submit(
                    self.raw_store.jump_over,
                    region.start_key, region.end_key, n // 2)
            else:
                split_key = self.raw_store.jump_over(
                    region.start_key, region.end_key, n // 2)
        if split_key is None or not region.contains_key(split_key):
            return Status.error(RaftError.EINVAL,
                                f"bad split key {split_key!r}")
        try:
            await engine.raft_store.range_split(new_region_id, split_key)
        except Exception as e:  # noqa: BLE001
            return Status.error(RaftError.EINTERNAL, f"split failed: {e}")
        return Status.OK()

    def do_split(self, region_id: int, new_region_id: int,
                 split_key: bytes) -> None:
        """FSM-side application, invoked deterministically on EVERY replica
        when the RANGE_SPLIT entry commits.  Metadata mutates synchronously;
        the new region's raft node boots asynchronously."""
        engine = self._regions.get(region_id)
        if engine is None or new_region_id in self._regions \
                or new_region_id in self._pending_splits:
            return
        parent = engine.region
        if not parent.contains_key(split_key):
            return
        new_region = Region(
            id=new_region_id,
            start_key=split_key,
            end_key=parent.end_key,
            peers=list(parent.peers),
        )
        new_region.epoch.version = parent.epoch.version + 1
        parent.end_key = split_key
        parent.epoch.version += 1
        if self.heat is not None:
            # the parent's standing rates describe the PRE-split
            # keyspace — half that load now lands on the child.  Reset
            # and let both halves re-accumulate their true rates (the
            # PD-side mirror: mark_split_issued resets keys)
            self.heat.drop(region_id)
        self._pending_splits.add(new_region_id)

        async def boot():
            try:
                await self._start_region(new_region)
                if self.pd_client is not None:
                    await self.pd_client.report_split(parent, new_region)
            except Exception:  # noqa: BLE001
                LOG.exception("booting split region %d failed", new_region_id)
            finally:
                self._pending_splits.discard(new_region_id)

        asyncio.ensure_future(boot())

    # -- merge / move (the region lifecycle plane) ---------------------------

    async def apply_merge(self, region_id: int, target_region_id: int,
                          target_peer: str) -> Status:
        """Leader-side entry for a PD-ordered cold merge: replicate the
        seal barrier through the SOURCE group, hand the sealed keyspace
        to the TARGET group's leader (kv_merge_absorb), then retire the
        source group with a MERGE_COMMIT entry.

        Every step is retry-safe: the PD's replicated pending-merge map
        re-issues the instruction until the merge completes, and a
        resumed attempt skips the already-applied seal (``sealed_into``
        names the target) while absorb/extend apply idempotently."""
        engine = self._regions.get(region_id)
        if engine is None:
            return Status.error(RaftError.ENOENT, f"region {region_id} absent")
        node = engine.node
        if node is None or not engine.is_leader():
            return Status.error(RaftError.EPERM,
                                f"not leader of region {region_id}")
        already = getattr(engine.fsm, "sealed_into", -1)
        if already >= 0 and already != target_region_id:
            return Status.error(
                RaftError.EINVAL,
                f"region {region_id} already sealed into {already}")
        if already < 0 and (node._conf_ctx is not None
                            or not node.conf_entry.old_conf.is_empty()):
            # DEFER, don't wedge: a seal proposed while a joint conf
            # change is in flight would interleave two multi-step
            # protocols on one log — the PD re-issues after the change
            # completes (satellite 3's merge-vs-conf-change test)
            return Status.error(
                RaftError.EBUSY,
                f"region {region_id} mid-conf-change (merge deferred)")
        region = engine.region
        # leader-local barrier half: no NEW write is admitted once the
        # seal's log position is decided; the FSM's replicated
        # sealed_into takes over when the entry applies.  If the seal
        # never applies (propose failed, leadership lost mid-attempt)
        # the flag is cleared in the finally below — otherwise a
        # regained leadership would bounce every write ERR_STORE_BUSY
        # on a region that was never actually sealed.
        engine.sealing = True
        try:
            if already < 0:
                await engine.raft_store.merge_seal(target_region_id)
            # capture the range AFTER the seal applies: a split racing
            # the merge may have shrunk this region up to the seal's
            # log position (later splits bounce off the sealed guard) —
            # serializing the pre-split range would hand the target
            # keys a sibling region now owns
            src_start, src_end = region.start_key, region.end_key
            # the blob ALWAYS carries the data: target replicas on
            # stores that never hosted the source need it (replicas
            # sharing this raw store re-apply it as an idempotent
            # overwrite)
            if self.apply_lane is not None:
                blob = await self.apply_lane.submit(
                    self.raw_store.serialize_range, src_start, src_end)
            else:
                blob = self.raw_store.serialize_range(src_start, src_end)
            st = await self._absorb_into_target(
                target_region_id, target_peer, region_id,
                src_start, src_end, blob)
            if not st.is_ok():
                return st
            await engine.raft_store.merge_commit(target_region_id)
        except Exception as e:  # noqa: BLE001
            return Status.error(RaftError.EINTERNAL, f"merge failed: {e}")
        finally:
            if getattr(engine.fsm, "sealed_into", -1) < 0:
                engine.sealing = False
        self.merges_led += 1
        RECORDER.record("region_merge", engine.group_id,
                        node=str(self.server_id), into=target_region_id)
        LOG.info("region %d merged into %d (store %s)", region_id,
                 target_region_id, self.server_id)
        if self.pd_client is not None:
            try:
                await self.pd_client.report_merge(region_id,
                                                  target_region_id)
            except Exception:  # noqa: BLE001 — every replica's
                # MERGE_COMMIT apply (do_retire) also reports, and a
                # re-issued KIND_MERGE for the retired region is
                # answered with a fresh report — the PD hears about
                # the completion through one of those
                LOG.warning("report_merge(%d -> %d) failed; replica "
                            "retirement reports will finalize",
                            region_id, target_region_id, exc_info=True)
        return Status.OK()

    async def _absorb_into_target(self, target_region_id: int,
                                  target_peer: str, src_id: int,
                                  src_start: bytes, src_end: bytes,
                                  blob: bytes) -> Status:
        """Hand the sealed source range to the target group's leader —
        directly when this store leads the target, over the store-to-
        store ``kv_merge_absorb`` RPC otherwise."""
        from tpuraft_torch.rheakv.kv_service import MergeAbsorbRequest

        target_engine = self._regions.get(target_region_id)
        if target_engine is not None and target_engine.is_leader():
            try:
                await target_engine.raft_store.merge_absorb(
                    src_id, src_start, src_end, blob)
                return Status.OK()
            except Exception as e:  # noqa: BLE001
                return Status.error(RaftError.EINTERNAL,
                                    f"local absorb: {e}")
        if not target_peer:
            return Status.error(RaftError.EINVAL,
                                "no target peer for absorb")
        try:
            resp = await self.transport.call(
                PeerId.parse(target_peer).endpoint, "kv_merge_absorb",
                MergeAbsorbRequest(
                    target_region_id=target_region_id,
                    source_region_id=src_id,
                    source_start=src_start, source_end=src_end,
                    data_blob=blob),
                timeout_ms=max(5000, self.opts.election_timeout_ms * 3))
        except Exception as e:  # noqa: BLE001
            return Status.error(RaftError.EINTERNAL, f"absorb rpc: {e}")
        if resp.code != 0:
            # EPERM = stale target leader hint; the PD's next issue
            # carries the fresh leader from its cluster view
            return Status.error(RaftError.EBUSY,
                                f"target absorb bounced: {resp.code} "
                                f"{resp.msg}")
        return Status.OK()

    async def apply_move(self, region_id: int, target_peer: str,
                         src_peer: str) -> Status:
        """PD-ordered replica move: add the destination as a LEARNER
        (it catches up without voting), then one joint-consensus change
        promotes it and drops the source replica.  A move whose source
        is this leader itself hands leadership off first and defers —
        the joint change needs a leader that stays in the conf."""
        engine = self._regions.get(region_id)
        if engine is None:
            return Status.error(RaftError.ENOENT, f"region {region_id} absent")
        node = engine.node
        if node is None or not engine.is_leader():
            return Status.error(RaftError.EPERM,
                                f"not leader of region {region_id}")
        if not src_peer:
            return Status.error(RaftError.EINVAL, "move needs a source peer")
        dst = PeerId.parse(target_peer)
        src = PeerId.parse(src_peer)
        conf = node.conf_entry.conf
        if not conf.contains(src):
            # retried move whose removal already committed
            return Status.OK() if conf.contains(dst) else Status.error(
                RaftError.EINVAL, f"{src_peer} not in region {region_id}")
        if src == node.server_id:
            for p in conf.peers:
                if p != src and not conf.is_witness(p):
                    await engine.transfer_leadership_to(p)
                    break
            return Status.error(
                RaftError.EBUSY,
                f"region {region_id} leader is the move source; "
                f"transferring leadership first")
        if not conf.contains(dst) and dst not in conf.learners:
            st = await node.add_learners([dst])
            if not st.is_ok():
                return st
            conf = node.conf_entry.conf
        new_conf = conf.copy()
        if dst not in new_conf.peers:
            new_conf.peers.append(dst)
        new_conf.peers = [p for p in new_conf.peers if p != src]
        new_conf.learners = [l for l in new_conf.learners if l != dst]
        st = await node.change_peers(new_conf)
        if st.is_ok():
            self.moves_applied += 1
            self._pd_dirty.add(region_id)
            RECORDER.record("region_move", engine.group_id,
                            node=str(self.server_id), src=src_peer,
                            dst=target_peer)
            LOG.info("region %d replica moved %s -> %s", region_id,
                     src_peer, target_peer)
        return st

    def do_absorb(self, region_id: int, src_id: int, src_start: bytes,
                  src_end: bytes) -> None:
        """Loop-side metadata half of a MERGE_ABSORB apply (invoked on
        EVERY replica of the target group): extend the region over the
        absorbed range, fold lifecycle bookkeeping.  The absorbed data
        itself already landed via ``load_serialized`` in the store-
        owning context."""
        from tpuraft_torch.rheakv.state_machine import extend_region_over

        engine = self._regions.get(region_id)
        if engine is None:
            LOG.warning("absorb for unknown region %d (src %d) dropped",
                        region_id, src_id)
            return
        try:
            extend_region_over(engine.region, src_start, src_end)
        except RuntimeError:
            LOG.exception("region %d cannot absorb [%r, %r)", region_id,
                          src_start, src_end)
            return
        self.regions_absorbed += 1
        if self.heat is not None:
            # the source's standing rates now land on this region —
            # let them re-accumulate under the merged id
            self.heat.drop(src_id)
        self._pd_dirty.add(region_id)

    def do_retire(self, region_id: int, target_id: int) -> None:
        """Loop-side MERGE_COMMIT apply (every source replica): drop the
        merged-away region from the serving table and shut its raft
        group down asynchronously.  The absorbed keyspace is NEVER
        wiped — on a shared per-store raw store the target region (or
        its replica on another store) serves those rows now."""
        self._retired_into[region_id] = target_id
        engine = self._regions.pop(region_id, None)
        if engine is None:
            return  # idempotent: replayed commit entry after a restart
        self._leader_regions.discard(region_id)
        self._pd_reported.pop(region_id, None)
        self._pd_dirty.discard(region_id)
        self._pd_heat_reported.pop(region_id, None)
        self._evac_cooldown.pop(region_id, None)
        self._reclaim_cooldown.pop(region_id, None)
        if self.heat is not None:
            self.heat.drop(region_id)
        self.regions_retired += 1
        RECORDER.record("region_retired", engine.group_id,
                        node=str(self.server_id), into=target_id)
        LOG.info("region %d retired into %d (store %s)", region_id,
                 target_id, self.server_id)
        if self.pd_client is not None:
            # replica-side completion report: the source LEADER's
            # apply_merge report is lost if it crashes between the
            # MERGE_COMMIT committing and the RPC landing — and a fully
            # retired group stops heartbeating, so without this the
            # PD's pending pair would re-issue into the void forever.
            # Every replica reports at its own commit apply (the PD's
            # _CMD_MERGE is idempotent and counts once), with a few
            # paced retries to ride out a PD failover.
            async def _report():
                for delay in (0.0, 0.5, 2.0, 8.0):
                    try:
                        await asyncio.sleep(delay)
                        await self.pd_client.report_merge(region_id,
                                                          target_id)
                        return
                    except Exception:  # noqa: BLE001
                        continue
                LOG.warning(
                    "retirement report %d -> %d never landed; the PD "
                    "will hear it when a re-issued merge instruction "
                    "reaches this store", region_id, target_id)

            asyncio.ensure_future(_report())

        async def _stop():
            # propagation grace: the replica that applied MERGE_COMMIT
            # first is usually the LEADER — shutting its node down at
            # its own apply would strand followers before the advanced
            # commit index reaches them (each successor leader then
            # retires itself the same way until the last replica is
            # alone without a quorum, wedged un-retired forever).  Keep
            # the node voting/appending for a few election timeouts so
            # every replica hears the commit; the region is already out
            # of the serving table either way.
            try:
                await asyncio.sleep(
                    self.opts.election_timeout_ms * 3 / 1000.0)
                await engine.shutdown()
            except Exception:  # noqa: BLE001
                LOG.exception("retiring region %d shutdown failed",
                              region_id)

        asyncio.ensure_future(_stop())

    def on_region_conf_changed(self, region_id: int) -> None:
        """FSM hook: a committed conf entry changed the replica roster
        (move promotion/removal) — force a fresh PD report so the route
        plane and the placement policy see the new peers/conf_ver."""
        self._pd_dirty.add(region_id)
