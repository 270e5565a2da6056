"""Options tree — nested dataclasses, the reference's builder/POJO options.

Reference parity (SURVEY.md §6 "Config / flag system"): ``NodeOptions``
(timeouts, storage URIs, state machine, initial conf) containing
``RaftOptions`` (engine tunables with the reference's defaults:
max_entries_size=1024, max_body_size=512KB, apply_batch=32,
max_inflight_msgs=256, pipelined replication, sync on write), plus
``ReadOnlyOption``.  TPU-specific knobs live in :class:`TickOptions`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, TYPE_CHECKING

from tpuraft_torch.conf import Configuration

if TYPE_CHECKING:
    from tpuraft_torch.core.state_machine import StateMachine


class ReadOnlyOption(enum.Enum):
    """Linearizable read mode (reference: ``ReadOnlyOption``)."""

    SAFE = "safe"               # quorum-confirmed ReadIndex round
    LEASE_BASED = "lease_based" # trust the leader lease (clock-dependent)


@dataclass
class RaftOptions:
    """Engine tunables; defaults mirror the reference's RaftOptions."""

    max_entries_size: int = 1024          # max entries per AppendEntries
    max_body_size: int = 512 * 1024       # max bytes per AppendEntries
    max_append_buffer_size: int = 256 * 1024  # log-storage flush batch bytes
    # Recent-entry window kept in RAM past stability/apply so replication
    # reads stay off disk (reference: maxLogsInMemory).  PER GROUP: a
    # process hosting G groups retains up to G x min(count, bytes) — the
    # bytes cap keeps thousand-group deployments bounded.
    max_logs_in_memory: int = 256
    max_logs_in_memory_bytes: int = 256 * 1024
    apply_batch: int = 32                 # tasks batched per apply event
    sync: bool = True                     # fsync log writes
    sync_meta: bool = True                # fsync term/votedFor changes
    replicator_pipeline: bool = True
    max_inflight_msgs: int = 256          # replication pipeline window
    max_election_delay_ms: int = 1000     # random election timeout jitter
    election_heartbeat_factor: int = 10   # heartbeat = election_timeout / factor
    # Coalesce leader heartbeats across ALL local raft groups into one
    # multi_heartbeat RPC per destination endpoint per interval (the
    # batched send-matrix plane — O(endpoints) instead of O(groups x
    # peers) idle RPCs).  Needs the node wired to a NodeManager.
    # None = AUTO (default): coalesce per peer once its AppendEntries
    # responses advertise the multi_heartbeat capability (the receiver
    # runs a NodeManager), direct beats otherwise — so a 1K-group idle
    # cluster's RPC rate is O(endpoints) out of the box.  True = always
    # (peers must serve multi_heartbeat), False = never.
    coalesce_heartbeats: Optional[bool] = None
    # Group quiescence ("hibernate raft"): an engine-driven leader group
    # that is fully replicated, has nothing pending, and sees this many
    # CONSECUTIVE fully-acked beat rounds hibernates — its beats and its
    # followers' election timeouts are suppressed on device, and liveness
    # is delegated to ONE store-level lease beat per endpoint pair
    # (HeartbeatHub), so an idle deployment's beat-plane RPC rate drops
    # from O(groups x peers) to O(stores^2).  Any apply / conf change /
    # incoming traffic instantly wakes the group; a store-lease expiry
    # wakes its dependent groups with randomized election timeouts.
    # 0 disables (the conservative default); 4-16 is a sensible range —
    # smaller = faster to hibernate, larger = more proof of idleness.
    # Engine-driven nodes only (TimerControl nodes never quiesce).
    quiesce_after_rounds: int = 0
    read_only_option: ReadOnlyOption = ReadOnlyOption.SAFE
    max_replicator_retry_times: int = 3
    step_down_when_vote_timedout: bool = True
    # priority election [1.3+]: minimum amount the target priority decays
    # by after a node skips consecutive election rounds (reference:
    # RaftOptions#decayPriorityGap)
    decay_priority_gap: int = 10
    # priority RE-election (geo): a leader whose own priority sits below
    # a healthy higher-priority voter's hands leadership back once that
    # voter has been caught up and acking for this many consecutive
    # step-down-timer rounds — so leadership returns to the preferred
    # zone after it heals instead of sticking where the decay left it.
    # 0 disables.  Only engages when the leader's priority is ENABLED.
    priority_transfer_rounds: int = 2
    # lease safety margin: leader lease = election_timeout * ratio
    leader_lease_time_ratio: float = 0.9
    # Assumed worst-case clock RATE error between any two stores
    # (rho): every lease the HOLDER trusts shrinks by (1 - rho), and
    # every lease a RECEIVER times against its own clock is padded the
    # same way, so sender and receiver disagreeing by up to rho per
    # second can never let a lease outlive its grant (ISSUE 18; see
    # docs/architecture.md "Lease safety under bounded drift").  Also
    # arms the ClockSentinel: a store whose clock deviates from the
    # peer median by MORE than rho fails lease checks closed (reads
    # fall back to the SAFE quorum path) until the estimate heals.
    # 0.0 = legacy zero-margin accounting, sentinel never fences.
    clock_drift_bound: float = 0.0


@dataclass
class TickOptions:
    """Device-plane knobs (no reference counterpart — TPU-native design).

    The multi-raft engine advances all groups on a tick cadence; each tick
    uploads one coalesced ``[G, P]`` delta and downloads one result batch
    (SURVEY.md §8 "host<->device latency budget").
    """

    max_groups: int = 1024        # G capacity of the state tensors
    max_peers: int = 8            # P: peer slots per group (voters+learners)
    # MAX idle interval between deadline scans.  The loop is adaptive:
    # a dirty mark (new acks/votes) fires a tick immediately, so commit
    # acks are not quantized to this cadence (VERDICT r1 weak #1).
    tick_interval_ms: int = 10
    # Pacing floor between CONSECUTIVE dirty-triggered ticks.  An ack
    # arriving while the engine is idle still fires its tick
    # immediately (sub-ms commit ack); the floor only bounds the
    # sustained tick rate so a busy engine batches instead of
    # monopolizing the event loop.  pace_factor x last tick's cost
    # additionally self-paces slow (tunneled) devices.
    min_tick_interval_ms: float = 1.0
    # Sleep pace_factor x (last tick duration) between consecutive
    # dirty ticks: cheap ticks run nearly back-to-back (sub-ms ack),
    # expensive ticks (tunneled device) batch more per dispatch.
    pace_factor: float = 0.5
    # Engine-driven protocol control plane: nodes whose ballot box comes
    # from this engine get elections / leases / step-down / heartbeat
    # scheduling from the fused device tick (tpuraft.ops.tick.raft_tick)
    # instead of per-group RepeatedTimers — the SURVEY §8.1 device
    # plane.  False = commit-reduce only (legacy: host timers).
    drive_protocol: bool = True
    # Event-driven commit advancement: an ack that completes a quorum
    # advances that group's commit point ON THE ACK PATH (one scalar
    # order statistic over the slot's [P] row — the same joint math the
    # device tick reduces) instead of waiting out the tick pace.  The
    # tick stays the batch plane and recomputes the same value as a
    # safety net.  False = tick-cadence commits (the pre-write-plane
    # behavior; also what the device-vs-oracle parity tests pin).
    eager_commit: bool = True
    # Density-aware timeout floors: the engine derives a minimum election
    # timeout from the REGISTERED group count and the measured tick
    # dispatch cost, and raises any group whose requested timeout sits
    # below it (hb/lease scale proportionally; the node's host-side
    # options adopt the raise).  Replaces the hand-tuned "60s at 16Kx3"
    # operating point: the floor keeps the idle beat plane under
    # ``beat_cpu_budget`` of one core at whatever density the process
    # actually reaches.  False = never raise (benchmarks of the raw
    # envelope; misconfigured densities then wedge exactly as before).
    density_aware_timeouts: bool = True
    # Estimated end-to-end cost of ONE beat row (sender build + RPC share
    # + receiver validate + ack bookkeeping), microseconds.  Seeded from
    # the measured beat-plane envelope (docs/operations.md "Scale
    # election timeouts with group density"); the engine additionally
    # folds its own measured tick cost into the floor, so a slow host
    # raises timeouts further than this constant alone would.
    beat_cost_us: float = 20.0
    # Fraction of one core the idle beat plane may consume before the
    # floor starts raising timeouts.
    beat_cpu_budget: float = 0.10
    # Injectable time source for the engine's tick deadlines / epoch
    # math (tpuraft.util.clock.Clock-shaped: .monotonic()/.wall()).
    # None = tpuraft.util.clock.SYSTEM (real time, zero-overhead path).
    clock: Optional[object] = None
    # Tick backend: "torch" runs raft_tick on ``device`` (on CUDA one
    # launch of the fused-tick kernel, on the CPU its plain torch
    # version); "numpy" is the engine's host twin (_np_tick), an
    # explicit caller choice and never a default.
    backend: str = "torch"        # "torch" | "numpy"
    # Torch device of the tick.  "cuda" needs a CUDA card: start() raises
    # without one (no silent CPU fallback); "cpu" runs the kernel's plain
    # torch version and is what the CPU tests ask for.  With
    # mesh_devices=N it may be a list of N devices, one per shard; a
    # list may name one card several times (N shards on one card).
    device: str | list = "cuda"
    # Shard the engine's [G, P] planes over N devices along the group
    # axis (0/1 = single device); max_groups must divide evenly.  Each
    # shard's rows go up, tick (one fused-tick launch on a card) and
    # come back on its own device, and the earliest-deadline scan is one
    # fold launch a shard.  With device="cuda" it means the first N
    # distinct cards, and start() raises when fewer exist: it never
    # shares a card unless the device list names it; with "cpu", N
    # logical shards of the host.
    mesh_devices: int = 0
    # Write a torch.profiler trace of the engine's device ticks into this
    # directory (a Chrome trace, viewable in Perfetto, exported at
    # shutdown).  "" = off.  Torch backend only (ignored with a warning
    # on backend="numpy"); one engine per process can trace at a time.
    profile_dir: str = ""


@dataclass
class SnapshotOptions:
    interval_secs: int = 3600           # periodic snapshot cadence (reference default)
    log_index_margin: int = 0           # keep this many entries behind snapshot
    max_chunk_size: int = 1 << 20       # InstallSnapshot file chunk bytes
    throttle_bytes_per_sec: int = 0     # 0 = unthrottled (ThroughputSnapshotThrottle)


@dataclass
class NodeOptions:
    """Per-node options (reference: ``core:option/NodeOptions``)."""

    election_timeout_ms: int = 1000
    snapshot: SnapshotOptions = field(default_factory=SnapshotOptions)
    initial_conf: Configuration = field(default_factory=Configuration)
    fsm: Optional["StateMachine"] = None
    log_uri: str = ""            # "memory://" or "file://<dir>" or "native://<dir>"
    raft_meta_uri: str = ""
    snapshot_uri: str = ""       # empty = snapshots disabled
    disable_cli: bool = False
    enable_metrics: bool = True
    # witness replica: this node votes and acks appends but stores log
    # METADATA only (payload-stripped entries, null FSM, never
    # campaigns, never serves reads).  Set automatically by StoreEngine
    # when the node's own peer is '/witness'-flagged in the region conf.
    witness: bool = False
    catchup_margin: int = 1000   # membership-change catch-up threshold (entries)
    raft_options: RaftOptions = field(default_factory=RaftOptions)
    tick: TickOptions = field(default_factory=TickOptions)
    # store-level gray-failure tracker (tpuraft.util.health.
    # HealthTracker), shared by every node the hosting store runs: the
    # LogManager feeds its disk probe, the FSMCaller its apply depth,
    # heartbeat paths their peer RTTs, and the node's election gate
    # consults the score.  None = no health scoring (bare nodes).
    health: Optional[object] = None
    # store-level disk-capacity tracker (tpuraft.util.health.
    # DiskBudget), shared by every node the hosting store runs: the
    # LogManager feeds append bytes + ENOSPC observations, the snapshot
    # executor feeds commit/prune deltas, and the store's health task
    # reconciles + folds pressure.  None = no capacity accounting.
    disk_budget: Optional[object] = None
    # a SICK store skips this many consecutive election rounds before
    # campaigning anyway (the liveness escape when every peer is worse
    # off) — the election-priority face of gray-failure mitigation
    sick_election_rounds: int = 2
    # Injectable time source (tpuraft.util.clock: .monotonic()/.wall())
    # shared by everything timing-sensitive this node runs — election
    # timers, _last_leader_timestamp, lease math, health hysteresis.
    # StoreEngine threads ONE clock to every node it hosts so a
    # per-store clock fault (ChaosClock) skews the whole store
    # coherently.  None = tpuraft.util.clock.SYSTEM (real time).
    clock: Optional[object] = None
    # store-level clock sentinel (tpuraft.util.clock.ClockSentinel),
    # shared like ``health``: the HeartbeatHub feeds it beat-ack skew
    # probes and lease checks consult it to fail closed when the local
    # clock is drift-suspect.  None = no detection.
    clock_sentinel: Optional[object] = None
    # store-level FSM apply lane (tpuraft.core.lanes.WorkerLane), shared
    # by every node the hosting store runs: when set AND the FSM exposes
    # a sync ``apply_sync``, committed DATA runs execute on the lane
    # thread instead of the event loop (StoreEngineOptions.apply_lane).
    # The lane then OWNS the state the FSM mutates — all other access
    # must be submitted through it.  None = apply on the loop.
    apply_lane: Optional[object] = None


@dataclass
class CliOptions:
    timeout_ms: int = 3000
    max_retry: int = 3
    retry_interval_ms: int = 100
    # EBUSY ("another membership change in flight") gets its own bounded
    # exponential backoff budget: busy is transient-by-contract, unlike a
    # leader redirect, so it neither consumes max_retry nor drops the
    # cached leader
    busy_max_retry: int = 8
    busy_backoff_ms: int = 200
    busy_backoff_max_ms: int = 2000


@dataclass
class ReadIndexOptions:
    timeout_ms: int = 2000
    batch: int = 32
