"""Node: the per-group Raft state machine (host runtime).

Reference parity: ``core:core/NodeImpl`` (SURVEY.md §3.1 "Node lifecycle &
election", §4) — init/bootstrap, pre-vote + vote + become-leader/step-down,
apply pipeline, AppendEntries/RequestVote/TimeoutNow handlers, leader
lease + dead-quorum step-down, leadership transfer.  Membership change and
snapshotting hook in via ConfigurationCtx / SnapshotExecutor.

Concurrency model: everything runs on one asyncio loop; ``self._lock``
(FIFO asyncio.Lock) is the analog of NodeImpl's writeLock.  The lock is
held across follower-append fsync (durability ordering); the leader apply
path stages entries under the lock and fsyncs outside it.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import time
from typing import Awaitable, Callable, Optional

from tpuraft_torch.conf import Configuration, ConfigurationEntry
from tpuraft_torch.core.ballot_box import BallotBox
from tpuraft_torch.core.fsm_caller import FSMCaller
from tpuraft_torch.core.replicator import Replicator, ReplicatorGroup
from tpuraft_torch.core.state_machine import StateMachine
from tpuraft_torch.entity import (
    EMPTY_PEER,
    ElectionPriority,
    EntryType,
    LogEntry,
    LogId,
    PeerId,
    Task,
)
from tpuraft_torch.errors import RaftError, RaftException, Status
from tpuraft_torch.options import NodeOptions, ReadOnlyOption
from tpuraft_torch.rpc.messages import (
    AppendEntriesRequest,
    AppendEntriesResponse,
    ReadIndexRequest,
    ReadIndexResponse,
    RequestVoteRequest,
    RequestVoteResponse,
    TimeoutNowRequest,
    TimeoutNowResponse,
)
from tpuraft_torch.rpc.transport import RpcError
from tpuraft_torch.util import clock as clockmod
from tpuraft_torch.util import describer
from tpuraft_torch.util.trace import (RECORDER, TRACER, adopt_entry_ctx,
                                store_proc)
from tpuraft_torch.storage.log_manager import LogManager
from tpuraft_torch.storage.log_storage import create_log_storage
from tpuraft_torch.storage.meta_storage import MemoryRaftMetaStorage, RaftMetaStorage
from tpuraft_torch.util.metrics import MetricRegistry
from tpuraft_torch.util.timer import RepeatedTimer

LOG = logging.getLogger(__name__)


class State(enum.Enum):
    UNINITIALIZED = "uninitialized"
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"
    TRANSFERRING = "transferring"
    ERROR = "error"
    SHUTTING = "shutting"
    SHUTDOWN = "shutdown"


class _VoteCtx:
    """Vote tally for one (pre-)vote round — scalar mirror of
    ops.ballot.joint_vote_quorum."""

    def __init__(self, conf: Configuration, old_conf: Configuration):
        self.peers = set(conf.peers)
        self.old_peers = set(old_conf.peers)
        self.granted: set[PeerId] = set()

    def grant(self, peer: PeerId) -> None:
        self.granted.add(peer)

    def is_granted(self) -> bool:
        new_ok = len(self.granted & self.peers) >= len(self.peers) // 2 + 1
        if not self.old_peers:
            return new_ok
        old_ok = len(self.granted & self.old_peers) >= len(self.old_peers) // 2 + 1
        return new_ok and old_ok


# graftcheck: loop-confined
class TimerControl:
    """Reference-parity control plane: per-group RepeatedTimers + scalar
    tallies (``NodeImpl``'s electionTimer / voteTimer / stepDownTimer and
    the Replicator lastRpcSendTimestamp map behind ``checkDeadNodes``).

    Engine-backed nodes swap this for ``tpuraft.core.engine.
    EngineControl`` (via ``TpuBallotBox.make_control``): the same call
    surface, but deadlines/acks/votes live in the engine's ``[G, P]``
    mirrors and fire from the fused device tick's masks instead of
    O(groups) asyncio timers — the SURVEY §8.1 device plane.
    """

    drives_heartbeats = False   # per-replicator loops / hub clock beat

    def __init__(self, node: "Node"):
        self._node = node
        opts = node.options
        self._clock = clockmod.resolve(opts.clock)
        self._acks: dict[PeerId, float] = {}
        self._vote_ctx: Optional[_VoteCtx] = None
        self._election_timer = RepeatedTimer(
            f"election-{node.server_id}", opts.election_timeout_ms,
            node._handle_election_timeout, adjust=RepeatedTimer.random_adjust,
            clock=opts.clock)
        self._vote_timer = RepeatedTimer(
            f"vote-{node.server_id}", opts.election_timeout_ms,
            node._handle_vote_timeout, adjust=RepeatedTimer.random_adjust,
            clock=opts.clock)
        self._stepdown_timer = RepeatedTimer(
            f"stepdown-{node.server_id}", opts.election_timeout_ms // 2 or 1,
            node._check_dead_nodes, clock=opts.clock)

    # -- role transitions ----------------------------------------------------

    def start_follower(self) -> None:
        self._election_timer.start()

    def note_leader_contact(self) -> None:
        pass  # the election handler's lease check covers timer mode

    def note_activity(self) -> None:
        pass  # timer-mode nodes never quiesce (EngineControl wakes)

    def on_candidate(self) -> None:
        self._election_timer.stop()
        self._vote_timer.start()

    def stop_vote_wait(self) -> None:
        self._vote_timer.stop()

    def on_leader(self) -> None:
        self._vote_timer.stop()
        self._acks = {self._node.server_id: self._clock.monotonic()}
        self._stepdown_timer.start()

    def on_step_down(self, was_candidate: bool, was_leader: bool) -> None:
        if was_candidate:
            self._vote_timer.stop()
        if was_leader:
            self._stepdown_timer.stop()
        self._vote_ctx = None

    def on_follower(self) -> None:
        self._election_timer.restart()

    # -- vote tally ----------------------------------------------------------

    def start_vote_round(self) -> bool:
        """Open a vote round granted by self; True = already a quorum."""
        node = self._node
        ctx = _VoteCtx(node.conf_entry.conf, node.conf_entry.old_conf)
        ctx.grant(node.server_id)
        self._vote_ctx = ctx
        return ctx.is_granted()

    def grant_vote(self, peer: PeerId) -> bool:
        ctx = self._vote_ctx
        if ctx is None:
            return False
        ctx.grant(peer)
        return ctx.is_granted()

    # -- ack bookkeeping (leader lease / dead-quorum / alive peers) ----------

    def record_ack(self, peer: PeerId, when: float) -> None:
        if when > self._acks.get(peer, 0.0):
            self._acks[peer] = when

    def quorum_ack_age_s(self) -> float:
        """Age of the q-th newest voter ack (joint-consensus aware);
        self counts as acked now (NodeImpl#checkDeadNodes)."""
        node = self._node
        now = self._clock.monotonic()
        self._acks[node.server_id] = now
        conf, old_conf = node.conf_entry.conf, node.conf_entry.old_conf

        def q_ack(peers: list[PeerId]) -> float:
            acks = sorted((self._acks.get(p, 0.0) for p in peers),
                          reverse=True)
            return acks[len(peers) // 2] if peers else 0.0

        qa = q_ack(conf.peers)
        if not old_conf.is_empty():
            qa = min(qa, q_ack(old_conf.peers))
        return now - qa

    def lease_valid(self) -> bool:
        node = self._node
        ro = node.options.raft_options
        lease_s = (node.options.election_timeout_ms
                   * ro.leader_lease_time_ratio / 1000.0)
        # drift bound (ISSUE 18): the holder trusts its lease for
        # (1 - rho) of the granted window so a clock running up to rho
        # slow can never stretch the real window past the grant
        lease_s *= (1.0 - ro.clock_drift_bound)
        sentinel = node.options.clock_sentinel
        if sentinel is not None and not sentinel.lease_check():
            # the local clock is drift-suspect beyond rho: the bound's
            # premise is broken — fail closed (reads take SAFE)
            return False
        return self.quorum_ack_age_s() < lease_s

    def alive_peers(self) -> list[PeerId]:
        node = self._node
        horizon = (self._clock.monotonic()
                   - node.options.election_timeout_ms / 1000.0)
        return [p for p in node.list_peers()
                if p == node.server_id or self._acks.get(p, 0.0) > horizon]

    # -- lifecycle -----------------------------------------------------------

    def deactivate(self) -> None:
        self._stop_timers()

    def shutdown(self) -> None:
        self._stop_timers()

    def _stop_timers(self) -> None:
        for t in (self._election_timer, self._vote_timer,
                  self._stepdown_timer):
            t.stop()


class Node:
    def __init__(self, group_id: str, server_id: PeerId, options: NodeOptions,
                 transport, ballot_box_factory=None):
        self.group_id = group_id
        self.server_id = server_id
        self.options = options
        self.transport = transport
        # SPI seam (reference: DefaultJRaftServiceFactory / JRaftServiceLoader):
        # the MultiRaftEngine plugs TpuBallotBox in here; everything else in
        # the node is untouched by the device plane
        self._ballot_box_factory = ballot_box_factory or BallotBox
        self.metrics = MetricRegistry(options.enable_metrics)
        # injectable time plane (ISSUE 18): ONE store-level clock feeds
        # every lease/timer comparison this node makes; SYSTEM when none
        self._clock = clockmod.resolve(options.clock)

        # Protocol state below is guarded-by the node lock in WRITE mode
        # (graftcheck guarded-by): every rebind happens under
        # ``async with self._lock`` (or in a helper annotated
        # ``holds(_lock)``); single reads on the owning event loop are
        # safe without it — the lock serializes multi-await critical
        # sections, not loop-atomic reads.
        self.state = State.UNINITIALIZED        # guarded-by: _lock (writes)
        self.current_term = 0                   # guarded-by: _lock (writes)
        self.leader_id: PeerId = EMPTY_PEER     # guarded-by: _lock (writes)
        self.voted_for: PeerId = EMPTY_PEER     # guarded-by: _lock (writes)
        self.conf_entry = ConfigurationEntry()  # guarded-by: _lock (writes)

        self.log_manager: LogManager = None  # type: ignore[assignment]
        self.fsm_caller: FSMCaller = None  # type: ignore[assignment]
        self.ballot_box: BallotBox = None  # type: ignore[assignment]
        self.replicators = ReplicatorGroup(self)
        self.snapshot_executor = None  # set in init when snapshot_uri given
        self.read_only_service = None
        self.node_manager = None  # set by RaftGroupService (file service)
        # store-wide write plane (AppendBatcher): when the hosting store
        # attaches one, this node's replicators submit their windows to
        # it instead of the per-endpoint send-plane lane — one windowed
        # store_append round per destination carries every led group's
        # pending entries (the read plane's ReadConfirmBatcher mirror)
        self.append_batcher = None

        self._meta: RaftMetaStorage = None  # type: ignore[assignment]
        self._lock = asyncio.Lock()
        # control plane: TimerControl (per-group timers, reference
        # parity) or EngineControl (device-tick masks) — set in init()
        self._ctrl = None
        self._note_append_start = None  # replica-plane hooks (init())
        self._note_attested = None
        self._snapshot_timer: Optional[RepeatedTimer] = None
        self._last_leader_timestamp = self._clock.monotonic()  # guarded-by: _lock (writes)
        # index of the first entry appended in THIS leadership term (the
        # election no-op); reads are unsafe until it commits
        self._term_first_index: int = 0         # guarded-by: _lock (writes)
        self._conf_ctx: Optional["_ConfigurationCtx"] = None  # guarded-by: _lock (writes)
        # chaos-harness hook: called as listener(node, stage) on every
        # _ConfigurationCtx stage transition (catching_up/joint/stable/
        # aborted) — lets a nemesis land a seeded crash mid-stage
        self.conf_stage_listener: Optional[Callable[["Node", str], None]] = None
        self._transfer_deadline: float = 0.0    # guarded-by: _lock (writes)
        self._shutdown_event = asyncio.Event()
        self._wakeup_candidate: Optional[PeerId] = None
        # priority election [1.3+] (reference: NodeImpl targetPriority /
        # electionTimeoutCounter): a node whose priority is below the
        # current target skips election rounds; the target decays after
        # repeated skipped rounds so the group still converges when all
        # high-priority nodes are dead
        self.target_priority: int = ElectionPriority.DISABLED  # guarded-by: _lock (writes)
        self._election_round: int = 0           # guarded-by: _lock (writes)
        # priority RE-election (geo): consecutive stepdown-timer rounds a
        # healthy higher-priority voter has been caught up and acking
        self._priority_transfer_rounds: int = 0  # guarded-by: _lock (writes)
        # gray failures: election rounds this node skipped because its
        # own store scored SICK (options.health) — a slow store should
        # not WIN elections, but liveness demands it may still campaign
        # once every healthy peer had its chance
        self._sick_election_skips: int = 0      # guarded-by: _lock (writes)
        # trace plane: staged index -> (trace context, stage perf_counter)
        # for traced entries awaiting their quorum — _on_committed pops
        # and emits the quorum_commit span; only sampled/staged ops ever
        # enter, so the steady-state cost is one empty-dict branch
        self._trace_quorum: dict[int, tuple[int, float]] = {}
        self._trace_proc = store_proc(server_id)

    # ======================================================================
    # lifecycle
    # ======================================================================

    # graftcheck: allow(guarded-by) — init-time: completes before any RPC handler or timer can race it
    async def init(self) -> bool:
        opts = self.options
        if opts.initial_conf.is_witness(self.server_id):
            # the operator's conf string flags THIS node '/witness'
            # (e.g. --peers a,b,c/witness on a bare server): adopt the
            # role without a separate flag — the conf is the truth
            opts.witness = True
        if opts.witness:
            # a witness journals metadata only: whatever FSM the hosting
            # engine wired (a KV store's) must never see the payload-
            # stripped entries — shadow it with the null witness FSM
            from tpuraft_torch.core.state_machine import WitnessStateMachine

            opts.fsm = WitnessStateMachine()
        # meta
        if opts.raft_meta_uri.startswith("file://"):
            self._meta = RaftMetaStorage(opts.raft_meta_uri[len("file://"):],
                                         sync=opts.raft_options.sync_meta)
        elif opts.raft_meta_uri.startswith("multimeta://"):
            # shared fsynced meta journal: multimeta://<dir>#<group> —
            # every group of the process joins one group-commit round,
            # so an election herd's {term, votedFor} persists cost one
            # fsync, not G (storage/meta_multilog.py)
            rest = opts.raft_meta_uri[len("multimeta://"):]
            if "#" not in rest:
                raise ValueError(
                    "multimeta:// needs a group fragment: "
                    "multimeta://<dir>#<group>")
            mdir, mgroup = rest.rsplit("#", 1)
            from tpuraft_torch.storage.meta_multilog import MultiRaftMetaStorage

            self._meta = MultiRaftMetaStorage(mdir, mgroup)
        elif opts.raft_meta_uri in ("", "memory://"):
            self._meta = MemoryRaftMetaStorage()
        else:
            # NO silent fallthrough to volatile meta: a typo'd scheme
            # silently dropping {term, votedFor} durability is a
            # double-vote hazard, not a default
            raise ValueError(
                f"unknown raft_meta_uri scheme: {opts.raft_meta_uri!r} "
                "(expected file://, multimeta://, memory:// or empty)")
        self._meta.init()
        self.current_term = self._meta.term
        self.voted_for = self._meta.voted_for

        # log
        storage = create_log_storage(opts.log_uri)
        self.log_manager = LogManager(
            storage,
            sync=opts.raft_options.sync,
            max_flush_batch=opts.raft_options.max_entries_size,
            max_logs_in_memory=opts.raft_options.max_logs_in_memory,
            max_logs_in_memory_bytes=(
                opts.raft_options.max_logs_in_memory_bytes),
            health=opts.health,
            trace_proc=self._trace_proc,
            disk_budget=opts.disk_budget,
        )
        await self.log_manager.init()
        # storage-flush failure (ENOSPC, EIO) -> leader step-down with
        # retryable client errors, never process death (ISSUE 17 layer 4)
        self.log_manager.on_storage_error = self._on_log_storage_error

        # fsm pipeline
        self.ballot_box = self._ballot_box_factory(self._on_committed)
        # replica-plane boxes tap the log's durable-advance stream (their
        # row of the [R, G] collective commit plane IS this node's
        # stable index — no ack echo needed for co-located replicas) and
        # the attestation hooks that term-scope the row (plane SAFETY)
        attach = getattr(self.ballot_box, "attach_log_manager", None)
        if attach is not None:
            attach(self.log_manager)
        self._note_append_start = getattr(
            self.ballot_box, "note_append_start", None)
        self._note_attested = getattr(self.ballot_box, "note_attested", None)
        self.fsm_caller = FSMCaller(
            opts.fsm, self.log_manager,
            apply_batch=opts.raft_options.apply_batch,
            on_error=self._on_fsm_error,
            health=opts.health,
            trace_proc=self._trace_proc,
            apply_lane=opts.apply_lane)
        self.fsm_caller.on_configuration_applied = self._on_configuration_applied

        # snapshot subsystem
        bootstrap = LogId(0, 0)
        if opts.snapshot_uri:
            from tpuraft_torch.core.snapshot_executor import SnapshotExecutor

            self.snapshot_executor = SnapshotExecutor(self, opts.snapshot_uri)
            bootstrap = await self.snapshot_executor.init()
        await self.fsm_caller.init(bootstrap)
        if bootstrap.index > 0:
            self.ballot_box.last_committed_index = bootstrap.index

        # configuration: snapshot conf > log conf > initial conf
        last_conf = self.log_manager.conf_manager.last()
        if not last_conf.conf.is_empty():
            self.conf_entry = last_conf
        else:
            self.conf_entry = ConfigurationEntry(
                LogId(0, 0), opts.initial_conf.copy())

        if not opts.witness and (
                self.conf_entry.conf.is_witness(self.server_id)
                or self.conf_entry.old_conf.is_witness(self.server_id)):
            # restart of a runtime-adopted witness whose operator did
            # not pass the boot flag: the LOG's conf is the truth
            self._adopt_witness_mode()
        self.ballot_box.update_conf(self.conf_entry.conf,
                                    self.conf_entry.old_conf)
        self._refresh_target_priority()

        st = self.log_manager.check_consistency()
        if not st.is_ok():
            LOG.error("%s: log inconsistent: %s", self, st)
            return False

        from tpuraft_torch.core.read_only import ReadOnlyService

        self.read_only_service = ReadOnlyService(self)

        # control plane: the engine's ballot box hands out an
        # EngineControl (device-tick deadlines/votes/acks); every other
        # box type falls back to per-group timers
        make_ctrl = getattr(self.ballot_box, "make_control", None)
        self._ctrl = make_ctrl(self) if make_ctrl is not None else None
        if self._ctrl is None:
            self._ctrl = TimerControl(self)
        if self.snapshot_executor and opts.snapshot.interval_secs > 0 \
                and not getattr(self._ctrl, "drives_snapshots", False):
            # host timer only for timer-mode nodes: engine-backed nodes
            # get their cadence from the device tick's snap_due mask
            # (one [G] deadline row, jitter-staggered — no per-group
            # RepeatedTimer, no unstaggered snapshot herd at high G)
            self._snapshot_timer = RepeatedTimer(
                f"snapshot-{self.server_id}", opts.snapshot.interval_secs * 1000,
                self._handle_snapshot_timeout, clock=opts.clock)
            self._snapshot_timer.start()

        self.state = State.FOLLOWER
        self._last_leader_timestamp = self._clock.monotonic()
        self._ctrl.start_follower()
        LOG.info("%s initialized: term=%d conf=%s", self, self.current_term,
                 self.conf_entry.conf)

        describer.register(self)

        # single-voter group elects itself immediately (a witness never
        # self-elects — it never campaigns at all)
        if (self.conf_entry.conf.peers == [self.server_id]
                and self.conf_entry.old_conf.is_empty()
                and not opts.witness):
            async with self._lock:
                await self._elect_self()
        return True

    async def shutdown(self) -> None:
        async with self._lock:
            if self.state in (State.SHUTTING, State.SHUTDOWN):
                return
            prev_state = self.state
            self.state = State.SHUTTING
            if self._conf_ctx is not None:
                # an in-flight membership change must not wedge its
                # waiter (the admin RPC / nemesis driver) forever
                self._conf_ctx.fail(Status.error(
                    RaftError.ENODESHUTTING, "node is shutting down"))
                self._conf_ctx = None
            if self._ctrl is not None:
                self._ctrl.shutdown()
            if self._snapshot_timer:
                self._snapshot_timer.stop()
            self.replicators.stop_all()
            if prev_state in (State.LEADER, State.TRANSFERRING):
                self.fsm_caller.fail_pending_closures(
                    Status.error(RaftError.ENODESHUTTING, "node is shutting down"))
        if self.read_only_service:
            await self.read_only_service.shutdown()
        if self.snapshot_executor:
            await self.snapshot_executor.shutdown()
        await self.fsm_caller.shutdown()
        await self.log_manager.shutdown()
        self.ballot_box.close()
        self._meta.shutdown()
        describer.unregister(self)
        # SHUTTING (set under the lock above) already refuses every other
        # writer, and a shutdown must never queue behind a straggler
        # holding the lock (a wedged holder would wedge join() with it)
        self.state = State.SHUTDOWN  # graftcheck: allow(guarded-by) — terminal write; SHUTTING already excludes all other writers
        self._shutdown_event.set()

    async def join(self) -> None:
        """Block until shutdown completes (reference: Node#join)."""
        await self._shutdown_event.wait()

    # ======================================================================
    # public API (reference: Node interface — SURVEY.md §9)
    # ======================================================================

    def is_leader(self) -> bool:
        return self.state in (State.LEADER, State.TRANSFERRING)

    def get_leader_id(self) -> PeerId:
        return self.leader_id

    def describe(self) -> str:
        """Live-state text dump (reference [1.3+]: NodeImpl#describe)."""
        lm = self.log_manager
        lines = [
            f"{self}:",
            f"  state: {self.state.value}  term: {self.current_term}"
            f"  leader: {self.leader_id}",
            f"  conf: {self.conf_entry.conf}"
            + (f"  old_conf: {self.conf_entry.old_conf}"
               if not self.conf_entry.old_conf.is_empty() else ""),
            f"  log: [{lm.first_log_index()}, {lm.last_log_index()}]"
            f"  snapshot: {lm.last_snapshot_id()}",
            f"  commit: {self.ballot_box.last_committed_index}"
            f"  applied: {self.fsm_caller.last_applied_index}"
            f"  pending: {self.ballot_box.pending_index}",
            f"  target_priority: {self.target_priority}"
            + ("  witness: true" if self.options.witness else ""),
        ]
        rows = self.replicators.progress()
        if rows:
            lines.append("  replicators:")
            for peer, next_index, matched in rows:
                lines.append(
                    f"    {peer}: next={next_index} matched={matched}")
        if self.metrics.counters:
            lines.append(f"  counters: {dict(self.metrics.counters)}")
        return "\n".join(lines)

    def list_peers(self) -> list[PeerId]:
        return list(self.conf_entry.conf.peers)

    def list_learners(self) -> list[PeerId]:
        return list(self.conf_entry.conf.learners)

    async def apply(self, task: Task) -> None:
        """Replicate task.data; task.done(status) fires on commit/failure."""
        await self.apply_batch([task])

    async def apply_batch(self, tasks: list[Task]) -> None:
        """Stage a BATCH of tasks as consecutive log entries under ONE
        lock acquisition / flush wait (reference:
        ``NodeImpl#executeApplyingTasks`` — the apply Disruptor drains up
        to ``applyBatch=32`` tasks per event).  Each task still becomes
        its own entry with its own completion closure."""
        if not tasks:
            return
        async with self._lock:
            if self.state != State.LEADER:
                st = (Status.error(RaftError.EBUSY, "leadership transferring")
                      if self.state == State.TRANSFERRING
                      else Status.error(RaftError.EPERM,
                                        f"not leader (state={self.state.value})"))
                for task in tasks:
                    if task.done:
                        task.done(st)
                return
            good: list[Task] = []
            for task in tasks:
                if task.expected_term not in (-1, self.current_term):
                    if task.done:
                        task.done(Status.error(
                            RaftError.EPERM,
                            f"expected term {task.expected_term} != "
                            f"{self.current_term}"))
                    continue
                good.append(task)
            if not good:
                return
            entries = [LogEntry(type=EntryType.DATA, data=t.data,
                                trace_id=t.trace_id)
                       for t in good]
            self._ctrl.note_activity()  # a write instantly wakes a
            # hibernating leader group (quiescence)
            term = self.current_term
            last_id = self.log_manager.stage_leader_entries(entries, term)
            first_index = last_id.index - len(good) + 1
            if TRACER.enabled:
                now = time.perf_counter()
                for i, task in enumerate(good):
                    if task.trace_id:
                        self._trace_quorum[first_index + i] = (
                            task.trace_id, now)
            for i, task in enumerate(good):
                if task.done:
                    self.fsm_caller.append_pending_closure(
                        first_index + i, task.done,
                        ack_at_commit=task.ack_at_commit)
            self.replicators.wake_all()
        # fsync outside the lock; batched with concurrent appliers
        try:
            await self.log_manager.flush_staged(last_id.index)
        except RaftException:
            # flush failed (ENOSPC/EIO): the flush loop's
            # on_storage_error hook steps this leader down, failing the
            # pending closures with retryable ENEWLEADER — nothing here
            # may count toward commit
            return
        async with self._lock:
            if self.state in (State.LEADER, State.TRANSFERRING) \
                    and self.current_term == term:
                self._commit_at_self(last_id.index)

    def _commit_at_self(self, index: int) -> None:  # graftcheck: holds(_lock)
        self.ballot_box.commit_at(
            self.server_id, index, self.conf_entry.conf, self.conf_entry.old_conf)

    async def snapshot(self) -> Status:
        if not self.snapshot_executor:
            return Status.error(RaftError.EINVAL, "snapshot storage not configured")
        return await self.snapshot_executor.do_snapshot()

    async def read_index(self) -> int:
        """Linearizable read barrier: resolves to a safe read index once
        the local FSM has applied up to it (reference: Node#readIndex)."""
        return await self.read_only_service.read_index()

    def read_committed_user_log(self, index: int) -> LogEntry:
        """Fetch the first committed DATA entry at or after ``index``
        from the local log (reference: NodeImpl#readCommittedUserLog —
        same forward-skip over NO_OP/CONFIGURATION entries).  Raises
        RaftException: EINVAL for an index beyond the commit point,
        ENOENT when the range was compacted away or holds no user log.
        """
        committed = self.ballot_box.last_committed_index
        if index <= 0 or index > committed:
            raise RaftException(Status.error(
                RaftError.EINVAL,
                f"index {index} out of committed range [1, {committed}]"))
        first = self.log_manager.first_log_index()
        if index < first:
            raise RaftException(Status.error(
                RaftError.ENOENT,
                f"log at {index} compacted (first index {first})"))
        for i in range(index, committed + 1):
            entry = self.log_manager.get_entry(i)
            if entry is None:  # compacted under us
                raise RaftException(Status.error(
                    RaftError.ENOENT, f"log at {i} compacted concurrently"))
            if entry.type == EntryType.DATA:
                return entry
        raise RaftException(Status.error(
            RaftError.ENOENT,
            f"no user log in committed range [{index}, {committed}]"))

    async def transfer_leadership_to(self, peer: PeerId) -> Status:
        async with self._lock:
            if self.state != State.LEADER:
                return Status.error(RaftError.EPERM, "not leader")
            if peer == self.server_id:
                return Status.OK()  # already the leader
            if self._conf_ctx is not None:
                # a transfer mid-change would hand the (possibly joint)
                # conf to a leader with no ctx driving it to completion;
                # the change resumes it, but racing the two on purpose is
                # an operator error (reference: NodeImpl refuses too)
                return Status.error(RaftError.EBUSY,
                                    "membership change in progress")
            if not self.conf_entry.conf.contains(peer):
                return Status.error(RaftError.EINVAL, f"{peer} not in conf")
            if self.conf_entry.conf.is_witness(peer):
                # a witness can never lead (metadata-only journal, null
                # FSM) — refusing here keeps TimeoutNow from ever being
                # aimed at one
                return Status.error(
                    RaftError.EINVAL, f"{peer} is a witness (cannot lead)")
            r = self.replicators.get(peer)
            if r is None:
                return Status.error(RaftError.EINVAL, f"no replicator for {peer}")
            self.state = State.TRANSFERRING
            self._transfer_deadline = (
                self._clock.monotonic()
                + self.options.election_timeout_ms / 1000.0)
            r.transfer_leadership(self.log_manager.last_log_index())
            r.wake()
            LOG.info("%s transferring leadership to %s", self, peer)
            asyncio.ensure_future(
                self._transfer_watchdog(peer, self.current_term))
            return Status.OK()

    async def _transfer_watchdog(self, peer: PeerId, term: int) -> None:
        await asyncio.sleep(self.options.election_timeout_ms / 1000.0)
        async with self._lock:
            # the term pins the watchdog to ITS transfer: deposed and
            # re-elected within the sleep, a new transfer may be in
            # flight — a stale watchdog resuming LEADER for it would arm
            # change_peers while the new target's TimeoutNow is pending
            if self.state == State.TRANSFERRING and self.current_term == term:
                LOG.info("%s leadership transfer timed out; resuming", self)
                self.state = State.LEADER
                # cancel the pending TimeoutNow trigger: the target
                # catching up later must not depose the resumed leader
                r = self.replicators.get(peer)
                if r is not None:
                    r.stop_transfer_leadership()

    # ======================================================================
    # apply-side commit plumbing
    # ======================================================================

    def _on_committed(self, index: int) -> None:
        if self._trace_quorum:
            now = time.perf_counter()
            for idx in [i for i in self._trace_quorum if i <= index]:
                tid, t0 = self._trace_quorum.pop(idx)
                TRACER.span(tid, "quorum_commit", t0, now,
                            proc=self._trace_proc, index=idx)
        self.fsm_caller.on_committed(index)
        self.metrics.counter("commits", 1)

    def on_match_advanced(self, peer: PeerId, match_index: int) -> None:
        if not self.is_leader():
            return
        e = self.conf_entry
        if not (e.contains(peer) or peer in e.conf.learners
                or peer in e.old_conf.learners):
            # a RETIRING replicator (removed peer still being shipped its
            # removal entry) must not repopulate the ballot row that
            # update_conf just pruned — a later wipe+re-add of the same
            # peer would inherit the stale row and commit on a phantom ack
            return
        self.ballot_box.commit_at(peer, match_index, e.conf, e.old_conf)

    def on_peer_ack(self, peer: PeerId, when: float) -> None:
        self._ctrl.record_ack(peer, when)

    def list_alive_peers(self) -> list[PeerId]:
        """Peers heard from within one election timeout (leader only;
        reference: CliServiceImpl#getAlivePeers via Replicator lastRpcSendTimestamp)."""
        return self._ctrl.alive_peers()

    # ======================================================================
    # election machinery
    # ======================================================================

    def _leader_lease_valid(self) -> bool:
        if (self._clock.monotonic() - self._last_leader_timestamp
                < self.options.election_timeout_ms
                * self.options.raft_options.leader_lease_time_ratio / 1000.0):
            return True
        # quiescent follower: the per-group leader-contact timestamp
        # legitimately goes stale (beats are suppressed) — 'my leader is
        # alive' is delegated to its STORE's liveness lease, so the vote
        # guards and the election-timeout lease check stay closed exactly
        # as long as the store lease flows (hibernate-raft safety)
        q = getattr(self._ctrl, "quiescent_leader_alive", None)
        return q is not None and q()

    def _believes_leader_alive(self) -> bool:
        """Is there, from THIS node's view, a live leader right now?  On
        a follower that is the leader-contact lease; on the leader
        itself it is its own quorum-ack lease (the follower-side
        timestamp is not refreshed while leading)."""
        if self.is_leader():
            return self._ctrl.lease_valid()
        return not self.leader_id.is_empty() and self._leader_lease_valid()

    # -- priority election [1.3+] ------------------------------------------

    def _refresh_target_priority(self) -> None:  # graftcheck: holds(_lock)
        """Target = max priority among current DATA voters (incl. self).
        Reference: NodeImpl#getMaxPriorityOfNodes on conf / leader change.
        Witness voters are excluded: they never campaign, so their
        priority raising the bar would only delay real candidates."""
        witnesses = set(self.conf_entry.conf.witnesses) \
            | set(self.conf_entry.old_conf.witnesses)
        prios = [p.priority for p in
                 (set(self.conf_entry.conf.peers)
                  | set(self.conf_entry.old_conf.peers)
                  | {self.server_id}) - witnesses]
        self.target_priority = max(prios) if prios else ElectionPriority.DISABLED
        self._election_round = 0

    def _allow_launch_election(self) -> bool:  # graftcheck: holds(_lock)
        """Gate an election round by priority (reference:
        NodeImpl#allowLaunchElection).  Caller holds the lock."""
        if self.options.witness:
            # a witness NEVER campaigns (the NOT_ELECTED contract): it
            # holds no payloads, so leading would serve reads/commits
            # from a metadata-only journal.  Witness-majority partitions
            # therefore can never elect, hence never commit — the
            # witness-safety property tests/test_witness.py proves.
            return False
        from tpuraft_torch.util.health import SICK

        health = self.options.health
        if (health is not None and self.options.sick_election_rounds > 0
                and health.score() == SICK):
            # gray-failure election gate: a SICK store skips rounds so
            # a healthy peer wins instead — but only boundedly, or a
            # cluster whose every store is slow could never elect.
            # Mirrors the priority-decay shape below: defer, then
            # concede to liveness.
            self._sick_election_skips += 1
            if self._sick_election_skips <= self.options.sick_election_rounds:
                LOG.info("%s deferring election: local store is SICK "
                         "(round %d/%d)", self, self._sick_election_skips,
                         self.options.sick_election_rounds)
                return False
        else:
            self._sick_election_skips = 0
        prio = self.server_id.priority
        if prio == ElectionPriority.DISABLED:
            return True
        if prio == ElectionPriority.NOT_ELECTED:
            LOG.debug("%s priority NOT_ELECTED: never starts elections", self)
            return False
        if prio >= self.target_priority:
            self._election_round = 0
            return True
        self._election_round += 1
        if self._election_round > 1:
            # nobody higher won in time: decay the bar so the group
            # still converges with all high-priority nodes dead
            gap = max(self.options.raft_options.decay_priority_gap,
                      self.target_priority // 5)
            self.target_priority = max(ElectionPriority.MIN_VALUE,
                                       self.target_priority - gap)
            self._election_round = 0
            LOG.info("%s decayed target priority to %d", self,
                     self.target_priority)
            if prio >= self.target_priority:
                return True  # elect this round, not an extra timeout later
        return False

    async def _handle_election_timeout(self) -> None:
        async with self._lock:
            if self.state != State.FOLLOWER:
                return
            if not self.conf_entry.contains(self.server_id):
                return  # not a participant (e.g. learner or removed)
            if self._leader_lease_valid():
                return
            if not self._allow_launch_election():
                return
            prev_leader = self.leader_id
            self.leader_id = EMPTY_PEER
            if not prev_leader.is_empty():
                self.fsm_caller.on_stop_following(prev_leader, self.current_term)
            await self._pre_vote()

    async def _persist_meta(self, term: int, voted_for: PeerId) -> None:
        """Durably record {term, votedFor}.  File-backed meta fsyncs in
        an executor thread; volatile meta (memory://) writes two fields
        — the executor hop for it was pure overhead, and at high group
        counts an election herd paid tens of thousands of pointless
        thread round-trips."""
        if getattr(self._meta, "SYNC_CHEAP", False):
            self._meta.set_term_and_voted_for(term, voted_for)
            return
        save_async = getattr(self._meta, "save_async", None)
        if save_async is not None:
            # shared meta journal: stage inline, join the engine-wide
            # group-commit — concurrent groups' meta fsyncs coalesce
            await save_async(term, voted_for)
            return
        await asyncio.get_running_loop().run_in_executor(
            None, self._meta.set_term_and_voted_for, term, voted_for)

    def _send_vote(self, peer: PeerId, req: "RequestVoteRequest",
                   on_resp) -> None:
        """Dispatch one RequestVote through the batched send plane when
        a NodeManager is wired (one ``multi_vote`` RPC per endpoint per
        flush — election herds at high group counts coalesce instead of
        spawning O(G x P) tasks), else a direct transient RPC task.
        ``on_resp(resp, peer)`` runs only when a response arrives;
        errors are silence, like a dropped packet."""
        if self.node_manager is not None:
            self.node_manager.send_plane.sender(peer.endpoint).submit_vote(
                self, req, lambda resp, p=peer: on_resp(resp, p))
            return

        async def direct():
            try:
                resp = await self.transport.request_vote(
                    peer.endpoint, req,
                    timeout_ms=self.options.election_timeout_ms)
            except RpcError:
                return
            await on_resp(resp, peer)

        t = asyncio.ensure_future(direct())
        t.add_done_callback(lambda tt: tt.cancelled() or tt.exception())

    async def _pre_vote(self) -> None:  # graftcheck: holds(_lock)
        """Pre-vote: probe electability WITHOUT bumping term (symmetric-
        partition tolerance — reference: NodeImpl#preVote)."""
        if self.log_manager.last_snapshot_id().index > 0 and \
                self.snapshot_executor and self.snapshot_executor.installing:
            return
        conf, old_conf = self.conf_entry.conf, self.conf_entry.old_conf
        ctx = _VoteCtx(conf, old_conf)
        ctx.grant(self.server_id)
        last_id = self.log_manager.last_log_id()
        term = self.current_term
        if ctx.is_granted():
            await self._elect_self()
            return
        req_term = term + 1  # NOT persisted

        async def on_resp(resp: RequestVoteResponse, peer: PeerId):
            async with self._lock:
                if (self.state != State.FOLLOWER or self.current_term != term):
                    return  # world moved on
                if resp.term > self.current_term:
                    await self._step_down(resp.term, Status.error(
                        RaftError.EHIGHERTERMRESPONSE, "pre-vote response"))
                    return
                if resp.granted:
                    ctx.grant(peer)
                    if ctx.is_granted():
                        await self._elect_self()

        for p in set(conf.peers) | set(old_conf.peers):
            if p != self.server_id:
                req = RequestVoteRequest(
                    group_id=self.group_id, server_id=str(self.server_id),
                    peer_id=str(p), term=req_term,
                    last_log_index=last_id.index, last_log_term=last_id.term,
                    pre_vote=True)
                self._send_vote(p, req, on_resp)

    async def _elect_self(self) -> None:  # graftcheck: holds(_lock)
        """Real election: term+1, vote for self, solicit votes.
        Caller must hold the lock."""
        conf, old_conf = self.conf_entry.conf, self.conf_entry.old_conf
        if not self.conf_entry.contains(self.server_id):
            return
        LOG.info("%s starting election at term %d", self, self.current_term + 1)
        RECORDER.record("election_start", self.group_id,
                        node=str(self.server_id),
                        term=self.current_term + 1)
        self.state = State.CANDIDATE
        self._ctrl.on_candidate()
        self.current_term += 1
        self.voted_for = self.server_id
        self.leader_id = EMPTY_PEER
        try:
            await self._persist_meta(self.current_term, self.server_id)
        except Exception:
            # ENOSPC/EIO mid self-vote save: abort the campaign cleanly
            # (no votes were solicited; a full disk must not kill the
            # node or campaign on an unpersisted term).  In-memory term
            # stays bumped, which is safe — it can only refuse stale
            # traffic — and the retry timer fires the next attempt.
            LOG.exception("%s election aborted: meta persist failed", self)
            self.state = State.FOLLOWER
            self._ctrl.on_follower()
            return
        term = self.current_term
        last_id = self.log_manager.last_log_id()
        # tally: TimerControl checks quorum inline per grant; the
        # engine's device tick tallies the granted row and fires
        # _on_engine_elected (start_vote_round only short-circuits the
        # single-voter case)
        if self._ctrl.start_vote_round():
            await self._become_leader()
            return

        async def on_resp(resp: RequestVoteResponse, peer: PeerId):
            async with self._lock:
                if self.state != State.CANDIDATE or self.current_term != term:
                    return
                if resp.term > self.current_term:
                    await self._step_down(resp.term, Status.error(
                        RaftError.EHIGHERTERMRESPONSE, "vote response"))
                    return
                if resp.granted and self._ctrl.grant_vote(peer):
                    await self._become_leader()

        for p in set(conf.peers) | set(old_conf.peers):
            if p != self.server_id:
                req = RequestVoteRequest(
                    group_id=self.group_id, server_id=str(self.server_id),
                    peer_id=str(p), term=term,
                    last_log_index=last_id.index, last_log_term=last_id.term,
                    pre_vote=False)
                self._send_vote(p, req, on_resp)

    async def _handle_vote_timeout(self) -> None:
        async with self._lock:
            if self.state != State.CANDIDATE:
                return
            if self.options.raft_options.step_down_when_vote_timedout:
                self._ctrl.stop_vote_wait()
                await self._step_down(self.current_term, Status.error(
                    RaftError.ERAFTTIMEDOUT, "vote timed out"))
            else:
                await self._elect_self()  # retry

    # -- engine-scheduled slow paths (EngineControl event masks) -----------

    async def _on_election_due(self) -> None:
        """Engine path: one deadline serves both the follower election
        timeout and the candidate vote-round timeout; each handler
        re-checks state under the lock, so at most one acts."""
        await self._handle_election_timeout()
        await self._handle_vote_timeout()

    async def _on_engine_elected(self) -> None:
        """Device tick saw a vote quorum in the granted row."""
        async with self._lock:
            if self.state != State.CANDIDATE:
                return
            if not self._ctrl.vote_quorum_now():
                return  # conf changed under the round; let it time out
            await self._become_leader()

    async def _on_engine_quorum_dead(self) -> None:
        """Device tick saw the quorum-ack age exceed the election
        timeout (the stepDownTimer analog)."""
        await self._check_dead_nodes()

    async def _become_leader(self) -> None:  # graftcheck: holds(_lock)
        """Caller holds the lock; we are CANDIDATE with a vote quorum."""
        self.state = State.LEADER
        self.leader_id = self.server_id
        self._ctrl.on_leader()
        LOG.info("%s became LEADER at term %d", self, self.current_term)
        RECORDER.record("leader_elected", self.group_id,
                        node=str(self.server_id), term=self.current_term)
        for peer in self.conf_entry.list_peers():
            if peer != self.server_id:
                self.replicators.add(peer)
        for learner in set(self.conf_entry.conf.learners) | set(
                self.conf_entry.old_conf.learners):
            self.replicators.add(learner)
        if self._note_attested is not None:
            # the leader's log is trivially consistent with itself
            self._note_attested(self.current_term)
        self.ballot_box.reset_pending_index(
            self.log_manager.last_log_index() + 1)
        # commit a CONFIGURATION entry for the current conf: safely commits
        # all prior-term entries (Raft §5.4.2; reference: becomeLeader)
        conf_entry = LogEntry(
            type=EntryType.CONFIGURATION,
            peers=list(self.conf_entry.conf.peers),
            learners=list(self.conf_entry.conf.learners) or None,
            old_peers=list(self.conf_entry.old_conf.peers) or None,
            old_learners=list(self.conf_entry.old_conf.learners) or None,
            witnesses=list(self.conf_entry.conf.witnesses) or None,
            old_witnesses=list(self.conf_entry.old_conf.witnesses) or None,
        )
        term = self.current_term
        last_id = self.log_manager.stage_leader_entries([conf_entry], term)
        # readIndex safety gate: a fresh leader's lastCommittedIndex is
        # carried over from follower time and may LAG entries the old
        # leader committed and acked — serving reads against it loses
        # acked writes (found by the linearizability soak).  Reads are
        # refused until this no-op (the first entry of OUR term) commits
        # (reference: ReadOnlyServiceImpl's ERAFTTIMEDOUT until the
        # leader commits in its current term).
        self._term_first_index = last_id.index
        if not self.conf_entry.old_conf.is_empty():
            # elected while a joint configuration is in flight (the old
            # leader died mid-change): adopt the change and drive it to
            # completion — without this, the conf entry just committed
            # above finds no ctx to advance and the group is wedged in
            # joint forever (reference: ConfigurationCtx#flush at
            # becomeLeader)
            self._conf_ctx = _ConfigurationCtx.resume_joint(
                self, self.conf_entry.old_conf.copy(),
                self.conf_entry.conf.copy(), joint_index=last_id.index)
            LOG.info("%s resuming joint membership change %s -> %s", self,
                     self.conf_entry.old_conf, self.conf_entry.conf)
        self.replicators.wake_all()
        self.fsm_caller.on_leader_start(term)
        asyncio.ensure_future(self._flush_and_self_commit(term, last_id.index))

    async def _flush_and_self_commit(self, term: int, index: int) -> None:
        try:
            await self.log_manager.flush_staged(index)
        except RaftException:
            # storage flush failed: the on_storage_error hook handles
            # the step-down; this fire-and-forget task must not die
            # with an unhandled exception
            return
        async with self._lock:
            if self.is_leader() and self.current_term == term:
                self._commit_at_self(index)

    def _on_log_storage_error(self, exc: BaseException) -> None:
        """LogManager on_storage_error hook (runs in the flush loop's
        except path): a flush that failed ENOSPC/EIO already failed its
        waiters with retryable EIO — here the LEADERSHIP is surrendered
        so clients re-route while the store sheds/reclaims, instead of
        the process dying or the leader lying about durability."""
        t = asyncio.ensure_future(self._step_down_on_storage_error(str(exc)))
        t.add_done_callback(lambda tt: tt.cancelled() or tt.exception())

    async def _step_down_on_storage_error(self, msg: str) -> None:
        async with self._lock:
            if self.state not in (State.LEADER, State.TRANSFERRING):
                return
            # same-term step-down: deliberately NOT a term bump — a
            # bump would persist meta, i.e. another write on the disk
            # that just refused one
            await self._step_down(
                self.current_term,
                Status.error(RaftError.EIO, f"log storage failed: {msg}"))

    # graftcheck: holds(_lock)
    async def _step_down(self, term: int, status: Status,
                         new_leader: PeerId = EMPTY_PEER) -> None:
        """Caller holds the lock (reference: NodeImpl#stepDown)."""
        if self.state in (State.ERROR, State.SHUTTING, State.SHUTDOWN):
            # ERROR is sticky: a straggler RPC response (e.g. an
            # in-flight heartbeat seeing a higher term) must not
            # resurrect a failed node into FOLLOWER with live timers
            return
        LOG.info("%s step down at term %d -> %d: %s", self, self.current_term,
                 term, status)
        RECORDER.record("step_down", self.group_id,
                        node=str(self.server_id), was=self.state.value,
                        term=self.current_term, to_term=term,
                        reason=status.error_msg[:80])
        was_leader = self.state in (State.LEADER, State.TRANSFERRING)
        self._ctrl.on_step_down(self.state == State.CANDIDATE, was_leader)
        if was_leader:
            self.replicators.stop_all()
            self.ballot_box.clear_pending()
            self._trace_quorum.clear()  # their quorum never happened here
            self.fsm_caller.fail_pending_closures(
                Status.error(RaftError.ENEWLEADER,
                             "leader stepped down: " + status.error_msg))
            self.fsm_caller.on_leader_stop(status)
        self.state = State.FOLLOWER
        self.leader_id = new_leader
        self._last_leader_timestamp = self._clock.monotonic()
        self._refresh_target_priority()
        if term > self.current_term:
            self.current_term = term
            self.voted_for = EMPTY_PEER
            await self._persist_meta(term, EMPTY_PEER)
        if self._conf_ctx is not None:
            self._conf_ctx.fail(Status.error(
                RaftError.ENEWLEADER, "leader stepped down"))
            self._conf_ctx = None
        self._ctrl.on_follower()

    async def step_down_on_higher_term(self, term: int, reason: str) -> None:
        async with self._lock:
            if term > self.current_term:
                await self._step_down(term, Status.error(
                    RaftError.EHIGHERTERMRESPONSE, reason))

    async def _check_dead_nodes(self) -> None:
        """Leader: step down if a quorum hasn't acked within the election
        timeout (asymmetric-partition tolerance — NodeImpl#checkDeadNodes).
        Scheduling: TimerControl's stepdown timer, or the engine tick's
        step_down mask; the age itself is re-verified here in both."""
        async with self._lock:
            if not self.is_leader():
                return
            if (self._ctrl.quorum_ack_age_s()
                    >= self.options.election_timeout_ms / 1000.0):
                await self._step_down(
                    self.current_term,
                    Status.error(RaftError.ERAFTTIMEDOUT,
                                 "quorum unreachable within election timeout"))
                return
            self._maybe_priority_transfer()

    def _maybe_priority_transfer(self) -> None:  # graftcheck: holds(_lock)
        """Priority RE-election (geo): a leader elected via target-
        priority decay (its zone's high-priority nodes were dead) hands
        leadership BACK once a higher-priority voter is healthy again —
        alive, caught up through the commit point, for
        ``priority_transfer_rounds`` consecutive stepdown-timer rounds.
        Leadership returns to the preferred (traffic-local) zone after
        it heals instead of sticking wherever the decay left it."""
        rounds = self.options.raft_options.priority_transfer_rounds
        my = self.server_id.priority
        if (rounds <= 0 or my == ElectionPriority.DISABLED
                or self.state != State.LEADER
                or self._conf_ctx is not None
                or not self.conf_entry.old_conf.is_empty()):
            self._priority_transfer_rounds = 0
            return
        conf = self.conf_entry.conf
        witnesses = set(conf.witnesses)
        candidates = [p for p in conf.peers
                      if p != self.server_id and p.priority > my
                      and p not in witnesses]
        if not candidates:
            self._priority_transfer_rounds = 0
            return
        best = max(candidates, key=lambda p: p.priority)
        alive = set(self._ctrl.alive_peers())
        r = self.replicators.get(best)
        if (best not in alive or r is None
                or r.match_index < self.ballot_box.last_committed_index):
            self._priority_transfer_rounds = 0
            return
        self._priority_transfer_rounds += 1
        if self._priority_transfer_rounds < rounds:
            return
        self._priority_transfer_rounds = 0
        LOG.info("%s priority re-election: transferring leadership to "
                 "higher-priority %s", self, best)
        self.metrics.counter("priority-transfers")
        # transfer_leadership_to takes the node lock itself — schedule it
        # (it re-validates leadership/conf state under the lock)
        t = asyncio.ensure_future(self.transfer_leadership_to(best))
        t.add_done_callback(lambda tt: tt.cancelled() or tt.exception())

    def leader_lease_is_valid(self) -> bool:
        """For LEASE_BASED reads: a quorum acked within lease window."""
        if not self.is_leader():
            return False
        return self._ctrl.lease_valid()

    # ======================================================================
    # RPC handlers (server side)
    # ======================================================================

    async def handle_request_vote(self, req: RequestVoteRequest
                                  ) -> RequestVoteResponse:
        candidate = PeerId.parse(req.server_id)
        async with self._lock:
            if self.state in (State.SHUTTING, State.SHUTDOWN, State.ERROR,
                              State.UNINITIALIZED):
                return RequestVoteResponse(term=self.current_term, granted=False)
            # a vote solicitation is protocol activity: a hibernating
            # group (leader included) resumes its timers — a woken
            # leader's next beat then re-absorbs the soliciting
            # follower instead of leaving it pre-voting forever against
            # a lease-fresh quorum
            self._ctrl.note_activity()
            if req.pre_vote:
                return self._handle_pre_vote(req, candidate)
            # real vote
            if req.term < self.current_term:
                return RequestVoteResponse(term=self.current_term, granted=False)
            if (not self.conf_entry.contains(candidate)
                    and self._believes_leader_alive()):
                # removed-server disruption guard (Raft §4.2.3): a voter
                # removed from the conf may keep timing out and soliciting
                # votes with ever-higher terms; while we have a live
                # leader, a non-member's request must not depose it (the
                # term bump in _step_down below is exactly the storm).
                # Without a live leader the request is processed normally
                # — a behind-the-conf node must not block recovery.
                return RequestVoteResponse(term=self.current_term, granted=False)
            if req.term > self.current_term:
                await self._step_down(req.term, Status.error(
                    RaftError.EHIGHERTERMREQUEST,
                    f"vote request from {candidate}"))
            log_ok = self._candidate_log_up_to_date(req)
            if (log_ok and self.voted_for.is_empty()
                    and self.state == State.FOLLOWER):
                self.voted_for = candidate
                try:
                    await self._persist_meta(self.current_term, candidate)
                except Exception:
                    # ENOSPC/EIO mid vote-save: the on-disk {term, vote}
                    # pair is intact (tmp+rename / journal tail never
                    # acked) and no grant left this node — forget the
                    # tentative in-memory vote and refuse; the
                    # candidate simply retries elsewhere.  Acking
                    # without durability would be a double-vote hazard
                    # after a crash.
                    LOG.exception("%s vote persist failed; refusing grant",
                                  self)
                    self.voted_for = EMPTY_PEER
                    return RequestVoteResponse(term=self.current_term,
                                               granted=False)
                self._last_leader_timestamp = self._clock.monotonic()  # grant => reset
                self._ctrl.note_leader_contact()
                return RequestVoteResponse(term=self.current_term, granted=True)
            granted = log_ok and self.voted_for == candidate
            return RequestVoteResponse(term=self.current_term, granted=granted)

    def _handle_pre_vote(self, req: RequestVoteRequest, candidate: PeerId
                         ) -> RequestVoteResponse:
        """Pre-vote grant: candidate's log >= ours, req.term >= ours, and we
        haven't heard from a live leader within the lease."""
        if req.term < self.current_term:
            return RequestVoteResponse(term=self.current_term, granted=False)
        if (not self.conf_entry.contains(candidate)
                and self._believes_leader_alive()):
            # removed-server noise (reference: NodeImpl#handlePreVoteRequest
            # membership check) — but ONLY while a live leader exists,
            # mirroring the real-vote guard below: with no leader, a
            # node whose conf is STALE (the entry adding the candidate
            # hasn't reached it yet) must still let the candidate
            # through pre-vote, or a {A,B,D} group where only B lags at
            # {A,B,C} can never elect D after A dies
            return RequestVoteResponse(term=self.current_term, granted=False)
        # role-aware liveness: a follower consults its leader-contact
        # lease (store-delegated while quiescent), the LEADER consults
        # its own quorum-ack lease — the follower-side timestamp is not
        # refreshed while leading, so the bare _leader_lease_valid()
        # would have a long-lived (or hibernating) leader grant
        # pre-votes against itself
        if self._believes_leader_alive():
            return RequestVoteResponse(term=self.current_term, granted=False)
        granted = self._candidate_log_up_to_date(req)
        return RequestVoteResponse(term=self.current_term, granted=granted)

    def _candidate_log_up_to_date(self, req: RequestVoteRequest) -> bool:
        last = self.log_manager.last_log_id()
        return (req.last_log_term, req.last_log_index) >= (last.term, last.index)

    async def handle_append_entries(self, req: AppendEntriesRequest
                                    ) -> AppendEntriesResponse:
        server = PeerId.parse(req.server_id)
        # capability advertisement (VERDICT r2 #6): this endpoint serves
        # multi_heartbeat iff it runs a NodeManager
        mh = self.node_manager is not None
        async with self._lock:
            if self.state in (State.SHUTTING, State.SHUTDOWN, State.ERROR,
                              State.UNINITIALIZED):
                # NOT a protocol response: a success=False/last=0 reply
                # here reads as "my log is empty" and drives the leader
                # into a full-speed probe livelock at next_index=1.  An
                # RPC error takes the leader's paced-retry path instead.
                raise RpcError(Status.error(
                    RaftError.EHOSTDOWN, f"node not serviceable: "
                    f"{self.state.value}"))
            if req.term < self.current_term:
                return AppendEntriesResponse(
                    multi_hb=mh,
                    term=self.current_term, success=False,
                    last_log_index=self.log_manager.last_log_index())
            if req.term > self.current_term or self.state != State.FOLLOWER:
                await self._step_down(req.term, Status.error(
                    RaftError.EHIGHERTERMREQUEST,
                    f"append_entries from {server}"), new_leader=server)
            if self.leader_id.is_empty():
                self.leader_id = server
                self.fsm_caller.on_start_following(server, req.term)
            elif self.leader_id != server:
                # two leaders in one term: protocol violation
                LOG.error("%s: leader conflict %s vs %s at term %d", self,
                          self.leader_id, server, req.term)
                await self._step_down(req.term + 1, Status.error(
                    RaftError.ELEADERCONFLICT, "two leaders in one term"))
                return AppendEntriesResponse(
                    multi_hb=mh,
                    term=self.current_term, success=False,
                    last_log_index=self.log_manager.last_log_index())
            self._last_leader_timestamp = self._clock.monotonic()
            self._ctrl.note_leader_contact()
            # an incoming full-semantics append (entries, probe, or
            # classic beat) means the leader is ACTIVE: a quiescent
            # follower wakes — heals the asymmetric state left by an
            # aborted quiesce handshake within one beat instead of one
            # store-lease expiry
            self._ctrl.note_activity()

            lm = self.log_manager
            if not req.entries:
                # heartbeat / probe
                local_prev_term = lm.get_term(req.prev_log_index)
                if req.prev_log_index > lm.last_log_index() or (
                        req.prev_log_index >= lm.first_log_index() - 1
                        and local_prev_term != req.prev_log_term
                        and req.prev_log_index != lm.last_snapshot_id().index):
                    # term mismatch (not merely a short log): tell the
                    # leader where our conflicting term run starts
                    hint = 0
                    if (req.prev_log_index <= lm.last_log_index()
                            and local_prev_term != 0):
                        hint = lm.conflict_hint(req.prev_log_index,
                                                local_prev_term)
                    return AppendEntriesResponse(
                        multi_hb=mh,
                        term=self.current_term, success=False,
                        last_log_index=lm.last_log_index(),
                        conflict_index=hint)
                self.ballot_box.set_last_committed_index(
                    min(req.committed_index, req.prev_log_index))
                if self._note_attested is not None and \
                        req.prev_log_index >= lm.last_log_index():
                    # heartbeat AT our tail: whole log prefix-matches
                    # the leader's (replica-plane attestation)
                    self._note_attested(req.term)
                return AppendEntriesResponse(
                    multi_hb=mh,
                    term=self.current_term, success=True,
                    last_log_index=lm.last_log_index())

            if self._note_append_start is not None:
                self._note_append_start(req.term)
            entries = list(req.entries)
            if self.options.witness:
                # metadata-only journal: strip any payload that still
                # arrived full (a mixed-fleet leader that predates
                # witness-aware stripping) — CRC-verify the wire blob
                # FIRST so a corrupt frame can't journal bad metadata
                from tpuraft_torch.entity import strip_entry_payload

                entries = [strip_entry_payload(e) for e in entries]
            # trace plane: wire-borne contexts join the follower-side
            # append (incl. its fsync wait) to the originating trace
            tr0 = 0.0
            if TRACER.enabled and req.trace_ctx:
                adopt_entry_ctx(entries, req.trace_ctx)
                tr0 = time.perf_counter()
            try:
                ok = await lm.append_entries_follower(
                    req.prev_log_index, req.prev_log_term, entries)
            except RaftException as e:
                if e.status.code == RaftError.EIO:
                    # transient storage failure (ENOSPC/EIO flush): the
                    # entries were NOT journaled and NOT acked — reject
                    # the round so the leader backs off and retries.
                    # Once pressure clears (reclaim freed disk, burst
                    # healed) the retry lands; the replica must NOT be
                    # condemned to ERROR for a full volume.
                    return AppendEntriesResponse(
                        multi_hb=mh,
                        term=self.current_term, success=False,
                        last_log_index=lm.last_log_index())
                # conflict below the applied index: this replica's state
                # machine has diverged from the leader's committed log —
                # unrecoverable (only reachable through storage loss /
                # amnesiac restart, which Raft does not tolerate).  Fail
                # the node loudly (reference: NodeImpl#onError) instead
                # of rejecting this RPC forever.  The FSM hears about it
                # too (StateMachine#onError) via the caller queue; the
                # ERROR transition itself happens now, under the lock,
                # so no further RPC is served meanwhile.
                self._enter_error_locked(e.status)
                self.fsm_caller.poison(e.status)
                raise RpcError(Status.error(
                    RaftError.EHOSTDOWN,
                    f"node failed: {e.status}")) from e
            if tr0:
                t1 = time.perf_counter()
                for e in entries:
                    if e.trace_id:
                        TRACER.span(e.trace_id, "follower_append", tr0, t1,
                                    proc=self._trace_proc, ok=ok)
            if not ok:
                return AppendEntriesResponse(
                    multi_hb=mh,
                    term=self.current_term, success=False,
                    last_log_index=lm.last_log_index())
            self._refresh_conf_from_log()
            self.ballot_box.set_last_committed_index(
                min(req.committed_index,
                    req.prev_log_index + len(req.entries)))
            if self._note_attested is not None and \
                    lm.last_log_index() == req.prev_log_index + len(req.entries):
                # the append covered our tail: log is a verified prefix
                # of the leader's (replica-plane attestation)
                self._note_attested(req.term)
            return AppendEntriesResponse(
                multi_hb=mh,
                term=self.current_term, success=True,
                last_log_index=lm.last_log_index())

    def _refresh_conf_from_log(self) -> None:  # graftcheck: holds(_lock)
        last = self.log_manager.conf_manager.last()
        if last.conf.is_empty():
            # no conf anywhere in log/snapshot: if ours came from a log
            # entry that a conflict truncation just removed, roll back to
            # the boot conf instead of keeping a phantom membership
            if self.conf_entry.id.index > self.log_manager.last_log_index():
                self._apply_conf_entry(ConfigurationEntry(
                    LogId(0, 0), self.options.initial_conf.copy()))
            return
        if (last.id.index == self.conf_entry.id.index
                and last.id.term == self.conf_entry.id.term):
            return
        # forward: a newer conf entry was appended.  BACKWARD: the entry
        # our conf came from was truncated away (new-leader conflict
        # resolution) — the membership must follow the log both ways, or
        # a follower keeps voting under a conf that no longer exists.
        # SAME INDEX, different term: conflict resolution REPLACED our
        # conf entry with another leader's — adopt the replacement.
        self._apply_conf_entry(last)

    def _apply_conf_entry(self, entry: ConfigurationEntry) -> None:  # graftcheck: holds(_lock)
        self.conf_entry = entry
        self.ballot_box.update_conf(entry.conf, entry.old_conf)
        self._refresh_target_priority()
        if not self.options.witness and (
                entry.conf.is_witness(self.server_id)
                or entry.old_conf.is_witness(self.server_id)):
            self._adopt_witness_mode()

    def _adopt_witness_mode(self) -> None:  # graftcheck: holds(_lock)
        """The committed conf flags THIS node a witness but it was not
        booted as one (runtime ``add-witness`` against a plain-booted
        node): adopt the role now — swap in the null FSM and raise the
        flag every witness gate (campaign / TimeoutNow / reads)
        consults.  Whatever the real FSM applied during catch-up
        (payload-stripped entries) is quarantined: witness state is
        never served, and a witness can never be elected over, so the
        divergence is unobservable.  Prefer booting the process with
        the '/witness' conf suffix so the role holds from the first
        applied entry."""
        from tpuraft_torch.core.state_machine import WitnessStateMachine

        LOG.warning("%s adopting WITNESS mode from the committed conf "
                    "(boot flag was missing — start this node with a "
                    "'/witness' peer suffix)", self)
        self.options.witness = True
        self.options.fsm = WitnessStateMachine()
        self.fsm_caller.replace_fsm(self.options.fsm)

    async def handle_timeout_now(self, req: TimeoutNowRequest
                                 ) -> TimeoutNowResponse:
        """Leadership transfer target: elect immediately, skipping pre-vote
        (reference: NodeImpl#handleTimeoutNowRequest)."""
        async with self._lock:
            if req.term != self.current_term or self.state != State.FOLLOWER:
                return TimeoutNowResponse(term=self.current_term, success=False)
            if self.options.witness:
                # never campaigns — even on an explicit transfer nudge
                # (a mixed-fleet leader that missed the witness flag)
                return TimeoutNowResponse(term=self.current_term,
                                          success=False)
            from tpuraft_torch.util.health import SICK

            health = self.options.health
            if health is not None and health.score() == SICK:
                # gray-failure guard: a SICK store must not ACCEPT
                # leadership either — without this, two slow stores
                # evacuating at each other ping-pong every lease (the
                # mutual-evacuation storm the gray A/B bench caught).
                # Always safe: a refused transfer just times out and
                # the old leader's watchdog resumes.
                LOG.info("%s refusing TimeoutNow: local store is SICK",
                         self)
                return TimeoutNowResponse(term=self.current_term,
                                          success=False)
            await self._elect_self()
            return TimeoutNowResponse(term=self.current_term, success=True)

    async def handle_install_snapshot(self, req):
        from tpuraft_torch.rpc.messages import InstallSnapshotResponse

        if self.state in (State.SHUTTING, State.SHUTDOWN, State.ERROR,
                          State.UNINITIALIZED):
            # same contract as handle_append_entries: a failed node must
            # not load snapshots into its (poisoned) state machine
            raise RpcError(Status.error(
                RaftError.EHOSTDOWN, f"node not serviceable: "
                f"{self.state.value}"))
        if not self.snapshot_executor:
            return InstallSnapshotResponse(term=self.current_term, success=False)
        return await self.snapshot_executor.handle_install_snapshot(req)

    async def handle_read_index(self, req: ReadIndexRequest) -> ReadIndexResponse:
        """Follower-forwarded readIndex: only the leader serves it.  A
        rejection carries this node's current leader hint (trailing wire
        field) so the forwarder re-probes the real leader within its
        attempt instead of surfacing a terminal error."""
        if not self.is_leader():
            return ReadIndexResponse(index=0, success=False,
                                     term=self.current_term,
                                     leader_hint=str(self.leader_id)
                                     if not self.leader_id.is_empty()
                                     else "")
        try:
            idx = await self.read_only_service.leader_confirm_read_index()
            # LEASE mode serves the fence without any beat round, so the
            # forwarding follower may sit on the committed ENTRIES but
            # not the commit KNOWLEDGE until the next periodic beat (up
            # to one heartbeat interval — observed as ~1s forwarded-read
            # stalls in its local wait_applied).  Push one beat at it
            # now; the beat's prev-log check makes the commit transfer
            # safe where blindly adopting the bare index would not be
            # (a divergent-tail follower must never commit its own
            # stale entries at the leader's index).  SAFE mode skips
            # this: its confirmation round just beat every follower.
            if (self.options.raft_options.read_only_option
                    == ReadOnlyOption.LEASE_BASED):
                r = self.replicators.get(PeerId.parse(req.server_id))
                if r is not None and r.match_index >= idx:
                    t = asyncio.ensure_future(r.send_heartbeat())
                    t.add_done_callback(
                        lambda tt: tt.cancelled() or tt.exception())
            return ReadIndexResponse(index=idx, success=True,
                                     term=self.current_term)
        except Exception:
            return ReadIndexResponse(index=0, success=False,
                                     term=self.current_term)

    # ======================================================================
    # membership change (reference: ConfigurationCtx — SURVEY.md §3.1)
    # ======================================================================

    async def add_peer(self, peer: PeerId, witness: bool = False) -> Status:
        new_conf = self.conf_entry.conf.copy()
        if new_conf.contains(peer):
            return Status.error(RaftError.EEXISTS, f"{peer} already in conf")
        new_conf.peers.append(peer)
        if witness:
            new_conf.witnesses.append(peer)
        return await self.change_peers(new_conf)

    async def remove_peer(self, peer: PeerId) -> Status:
        new_conf = self.conf_entry.conf.copy()
        if not new_conf.contains(peer):
            return Status.error(RaftError.ENOENT, f"{peer} not in conf")
        new_conf.peers.remove(peer)
        if peer in new_conf.witnesses:
            new_conf.witnesses.remove(peer)
        return await self.change_peers(new_conf)

    def peer_is_witness(self, peer: PeerId) -> bool:
        """Is ``peer`` a witness in the current conf OR in an in-flight
        membership change's target conf?  The ctx check matters during
        CATCHING_UP: a freshly added witness is not in conf yet, but its
        catch-up stream must already be payload-stripped — shipping the
        full log to a metadata-only replica wastes exactly the WAN
        bytes witnesses exist to save."""
        e = self.conf_entry
        if e.conf.is_witness(peer) or e.old_conf.is_witness(peer):
            return True
        ctx = self._conf_ctx
        return ctx is not None and ctx.new_conf.is_witness(peer)

    async def add_learners(self, learners: list[PeerId]) -> Status:
        new_conf = self.conf_entry.conf.copy()
        for l in learners:
            if l not in new_conf.learners:
                new_conf.learners.append(l)
        return await self.change_peers(new_conf)

    async def remove_learners(self, learners: list[PeerId]) -> Status:
        new_conf = self.conf_entry.conf.copy()
        new_conf.learners = [l for l in new_conf.learners if l not in learners]
        return await self.change_peers(new_conf)

    async def reset_learners(self, learners: list[PeerId]) -> Status:
        """Replace the learner set atomically (reference: `[1.3+]`
        CliServiceImpl#resetLearners)."""
        new_conf = self.conf_entry.conf.copy()
        new_conf.learners = list(dict.fromkeys(learners))
        return await self.change_peers(new_conf)

    async def change_peers(self, new_conf: Configuration) -> Status:
        """Arbitrary configuration change via joint consensus."""
        async with self._lock:
            if self.state == State.TRANSFERRING:
                return Status.error(RaftError.EBUSY,
                                    "leadership transferring; retry")
            if self.state != State.LEADER:
                return Status.error(RaftError.EPERM, "not leader")
            if self._conf_ctx is not None:
                return Status.error(
                    RaftError.EBUSY,
                    f"another membership change in progress "
                    f"(stage={self._conf_ctx.stage}); retry")
            if not new_conf.is_valid():
                return Status.error(RaftError.EINVAL, f"invalid conf {new_conf}")
            cur = self.conf_entry.conf
            converted = [p for p in new_conf.peers if cur.contains(p)
                         and cur.is_witness(p) != new_conf.is_witness(p)]
            if converted:
                # in-place witness<->data conversion is UNSAFE both
                # ways: a witness promoted to data voter serves from a
                # payload-less journal; a data voter demoted to witness
                # keeps a stale full journal the commit clamp would
                # trust.  Remove, wipe, re-add in the new role.
                return Status.error(
                    RaftError.EINVAL,
                    f"in-place witness/data role conversion of "
                    f"{[str(p) for p in converted]}: remove the peer, "
                    f"wipe its storage, then re-add it in the new role")
            if new_conf == self.conf_entry.conf:
                return Status.OK()
            ctx = _ConfigurationCtx(self, self.conf_entry.conf.copy(), new_conf)
            self._conf_ctx = ctx
            await ctx.start()
        try:
            return await ctx.wait()
        finally:
            async with self._lock:
                if self._conf_ctx is ctx:
                    if ctx.stage in ("none", "catching_up"):
                        # caller CANCELLED (operator timeout) before any
                        # entry was appended: abort cleanly — detaching a
                        # live ctx would let a slow catch-up later append
                        # a joint entry nothing drives, while a second
                        # change starts concurrently
                        ctx.fail(Status.error(
                            RaftError.ECANCELED, "change_peers caller gone"))
                        # tear down the replicators provisioned for the
                        # catch-up peers (mirrors the ECATCHUP abort):
                        # a leaked one would keep shipping to a
                        # non-member, and — worse — a retry of the same
                        # change would reuse its stale match_index and
                        # pass catch-up instantly even if the peer was
                        # wiped meanwhile.  Safe here ONLY because
                        # _conf_ctx is still ctx under the lock: no
                        # concurrent change can own these peers yet.
                        ctx._teardown_added_replicators()
                        self._conf_ctx = None
                    elif ctx.stage in ("done", "aborted"):
                        self._conf_ctx = None
                    # joint/stable with the caller gone: the entries are
                    # in the log — leave the ctx attached to drive the
                    # change to completion; _finish clears the slot

    async def reset_peers(self, new_conf: Configuration) -> Status:
        """Unsafe manual override when quorum is permanently lost
        (reference: Node#resetPeers)."""
        async with self._lock:
            if self.state in (State.ERROR, State.SHUTTING, State.SHUTDOWN,
                              State.UNINITIALIZED):
                # a failed node can't be revived by conf surgery — and
                # the sticky-ERROR _step_down would silently skip the
                # term bump while conf had already mutated
                return Status.error(
                    RaftError.EHOSTDOWN,
                    f"cannot reset peers in state {self.state.value}")
            if not new_conf.is_valid():
                return Status.error(RaftError.EINVAL, str(new_conf))
            self.conf_entry = ConfigurationEntry(
                LogId(0, self.current_term), new_conf.copy())
            self.ballot_box.update_conf(new_conf, Configuration())
            await self._step_down(self.current_term + 1, Status.error(
                RaftError.ESETPEER, "reset_peers"))
            return Status.OK()

    async def _on_configuration_applied(self, entry: LogEntry) -> None:
        """A CONFIGURATION entry committed+applied: advance the change ctx."""
        async with self._lock:
            self._refresh_conf_from_log()
            if self._conf_ctx is not None:
                await self._conf_ctx.on_committed(entry)

    # ======================================================================
    # snapshot plumbing (filled by SnapshotExecutor)
    # ======================================================================

    async def install_snapshot_on(self, peer: PeerId, replicator: Replicator
                                  ) -> bool:
        if not self.snapshot_executor:
            LOG.error("%s: peer %s needs snapshot but none configured",
                      self, peer)
            return False
        return await self.snapshot_executor.send_install_snapshot(
            peer, replicator)

    async def _handle_snapshot_timeout(self) -> None:
        if self.snapshot_executor:
            await self.snapshot_executor.do_snapshot()

    async def _on_snapshot_due(self) -> None:
        """Engine path: the device tick's snap_due mask fired for this
        group (the snapshotTimer analog — SURVEY §3.1 Timers)."""
        await self._handle_snapshot_timeout()

    async def _on_fsm_error(self, status: Status) -> None:
        async with self._lock:
            self._enter_error_locked(status)

    def _enter_error_locked(self, status: Status) -> None:
        """Transition to ERROR state; caller holds the node lock."""
        if self.state in (State.SHUTTING, State.SHUTDOWN, State.ERROR):
            return
        LOG.error("%s entering ERROR state: %s", self, status)
        RECORDER.record("node_error", self.group_id,
                        node=str(self.server_id),
                        status=str(status)[:120])
        if self.is_leader():
            self.replicators.stop_all()
            self.fsm_caller.fail_pending_closures(status)
        self.state = State.ERROR
        self._ctrl.deactivate()
        if self._snapshot_timer:
            self._snapshot_timer.stop()

    def __str__(self) -> str:
        return f"Node<{self.group_id}/{self.server_id}>"


# graftcheck: loop-confined — every method runs under the node lock on
# the node's loop (see class docstring termination discipline)
# graftcheck: called-under(_lock) — the ctx is driven exclusively from
# node paths that already hold the node lock (change_peers, on_committed
# apply, step-down teardown), so its cross-object calls into
# holds-annotated Node methods inherit the held lock
class _ConfigurationCtx:
    """Membership-change state machine: CATCHING_UP -> JOINT -> STABLE.

    Reference: NodeImpl's inner ConfigurationCtx (SURVEY.md §3.1/§4.3).

    Termination discipline (chaos-hardened): every exit path —
    completion, catch-up timeout, step-down, shutdown — moves ``stage``
    to a terminal value ("stable" or "aborted") and resolves ``_done``
    exactly once.  ``fail()`` marking the stage terminal is load-bearing:
    a catch-up waiter resolving True *concurrently* with a step-down
    would otherwise re-enter ``_enter_joint`` on a node that is no
    longer leader and append a joint entry to a FOLLOWER's log.
    """

    def __init__(self, node: Node, old_conf: Configuration,
                 new_conf: Configuration):
        self._node = node
        self.old_conf = old_conf
        self.new_conf = new_conf
        self.stage = "none"
        self._done: asyncio.Future = asyncio.get_running_loop().create_future()
        self._joint_index = 0
        self._stable_index = 0
        self._added: list[PeerId] = []

    @classmethod
    def resume_joint(cls, node: Node, old_conf: Configuration,
                     new_conf: Configuration,
                     joint_index: int) -> "_ConfigurationCtx":
        """A freshly elected leader found a joint conf in its log: build
        a ctx already in the joint stage, keyed to the conf entry the
        leader just staged for its own term, so the commit of that entry
        advances the change to stable instead of wedging the group in
        joint forever (reference: ConfigurationCtx#flush)."""
        ctx = cls(node, old_conf, new_conf)
        ctx._set_stage("joint")
        ctx._joint_index = joint_index
        return ctx

    def _set_stage(self, stage: str) -> None:
        self.stage = stage
        RECORDER.record("conf_stage", self._node.group_id,
                        node=str(self._node.server_id), stage=stage)
        listener = self._node.conf_stage_listener
        if listener is not None:
            try:
                listener(self._node, stage)
            except Exception:
                LOG.exception("conf stage listener failed at %s", stage)

    async def start(self) -> None:
        """Called under node lock."""
        node = self._node
        added = [p for p in self.new_conf.peers
                 if not self.old_conf.contains(p)]
        added += [l for l in self.new_conf.learners
                  if l not in self.old_conf.learners
                  and not self.old_conf.contains(l)]
        if not added:
            await self._enter_joint()
            return
        self._set_stage("catching_up")
        self._added = list(added)
        waiters = []
        for peer in added:
            r = node.replicators.add(peer)  # replicate as learner during catch-up
            waiters.append(r.wait_caught_up(
                node.options.catchup_margin,
                node.options.election_timeout_ms * 10 / 1000.0))
        asyncio.ensure_future(self._wait_catchup(waiters))

    async def _wait_catchup(self, waiters) -> None:
        results = await asyncio.gather(*waiters, return_exceptions=True)
        node = self._node
        async with node._lock:
            if self.stage != "catching_up":
                return  # aborted (step-down/shutdown) while we gathered
            if not all(r is True for r in results):
                # clean abort: tear down the replicators provisioned for
                # the peers that never caught up, so the next change
                # starts from scratch instead of inheriting stuck state
                self._teardown_added_replicators()
                self.fail(Status.error(RaftError.ECATCHUP,
                                       "new peers failed to catch up"))
                if node._conf_ctx is self:
                    node._conf_ctx = None
                return
            await self._enter_joint()

    def _teardown_added_replicators(self) -> None:
        """Remove replicators added for catch-up peers that are not part
        of the committed configuration (under node lock)."""
        node = self._node
        for peer in self._added:
            if (not node.conf_entry.contains(peer)
                    and peer not in node.conf_entry.conf.learners
                    and peer not in node.conf_entry.old_conf.learners):
                node.replicators.remove(peer)

    async def _enter_joint(self) -> None:
        """Append the joint-consensus CONFIGURATION entry (under lock)."""
        node = self._node
        self._set_stage("joint")
        in_joint = self.old_conf.peers != self.new_conf.peers
        entry = LogEntry(
            type=EntryType.CONFIGURATION,
            peers=list(self.new_conf.peers),
            old_peers=list(self.old_conf.peers) if in_joint else None,
            learners=list(self.new_conf.learners) or None,
            old_learners=(list(self.old_conf.learners) or None)
            if in_joint else None,
            witnesses=list(self.new_conf.witnesses) or None,
            old_witnesses=(list(self.old_conf.witnesses) or None)
            if in_joint else None,
        )
        term = node.current_term
        last_id = node.log_manager.stage_leader_entries([entry], term)
        self._joint_index = last_id.index
        node.conf_entry = ConfigurationEntry(
            last_id, self.new_conf.copy(),
            self.old_conf.copy() if in_joint else Configuration())
        node.ballot_box.update_conf(node.conf_entry.conf,
                                    node.conf_entry.old_conf)
        node._refresh_target_priority()
        # new peers may now vote/commit; replicators for removed peers keep
        # running until the change commits
        node.replicators.wake_all()
        asyncio.ensure_future(node._flush_and_self_commit(term, last_id.index))

    async def on_committed(self, entry: LogEntry) -> None:
        """A conf entry applied (under node lock)."""
        node = self._node
        if self.stage == "joint" and entry.id.index == self._joint_index:
            if entry.old_peers:
                # leave joint: append the stable (new-conf-only) entry
                self._set_stage("stable")
                stable = LogEntry(
                    type=EntryType.CONFIGURATION,
                    peers=list(self.new_conf.peers),
                    learners=list(self.new_conf.learners) or None,
                    witnesses=list(self.new_conf.witnesses) or None,
                )
                term = node.current_term
                last_id = node.log_manager.stage_leader_entries([stable], term)
                self._stable_index = last_id.index
                node.conf_entry = ConfigurationEntry(
                    last_id, self.new_conf.copy())
                node.ballot_box.update_conf(node.conf_entry.conf,
                                            node.conf_entry.old_conf)
                node._refresh_target_priority()
                node.replicators.wake_all()
                asyncio.ensure_future(
                    node._flush_and_self_commit(term, last_id.index))
            else:
                await self._finish()
        elif self.stage == "stable" and entry.id.index == self._stable_index:
            await self._finish()

    async def _finish(self) -> None:
        node = self._node
        self._set_stage("done")
        # retire replicators for peers no longer in conf: keep shipping
        # until the removed peer has RECEIVED the conf entry that removes
        # it (so it learns its removal and stops starting elections
        # against the survivors), then stop — bounded by a timeout for
        # peers that are dead or partitioned away
        final_index = self._stable_index or self._joint_index
        for peer in list(node.replicators.peers()):
            if not node.conf_entry.contains(peer) and \
                    peer not in node.conf_entry.conf.learners:
                node.replicators.retire(
                    peer, final_index,
                    node.options.election_timeout_ms * 4 / 1000.0)
        if not self._done.done():
            self._done.set_result(Status.OK())
        # clear the slot HERE, not only in change_peers' finally: a
        # resumed ctx (joint adopted at election) has no change_peers
        # caller, and a dangling ctx means EBUSY forever
        if node._conf_ctx is self:
            node._conf_ctx = None
        # leader removed itself: step down
        if not node.conf_entry.conf.contains(node.server_id):
            await node._step_down(node.current_term, Status.error(
                RaftError.ELEADERREMOVED, "leader removed from configuration"))

    def fail(self, status: Status) -> None:
        if self.stage not in ("done", "aborted"):
            self._set_stage("aborted")
        if not self._done.done():
            self._done.set_result(status)

    async def wait(self) -> Status:
        return await self._done
