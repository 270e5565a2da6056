"""Chaos soak runner: boots a KV cluster in-process, drives paced
client load under a nemesis fault schedule, then PROVES the recorded
history linearizable.

The reference's chaos tests assert convergence latches; this tool
records real invoke/return windows and checks them against a register
model (tpuraft.util.linearizability) — the strongest black-box verdict
a consensus store can get.

    python -m examples.soak --duration 60 --seed 7
    python -m examples.soak --duration 120 --stores 5 --keys 8 \\
        --data /tmp/soak --verbose

Faults: rolling store kill/restart, one-way partitions, packet
drops+delays+duplication+bounded-reordering — and, with
``--power-loss``, storage-plane crashes: a store is killed at a random
instant and restarted from its durable-only on-disk image, with torn
writes / lost fsyncs / bit flips injected into the unsynced tails
(tpuraft/storage/fault.py).  Durable state dirs are required
implicitly — a voter restarted without its disk is amnesiac, which
Raft does not tolerate (the divergence detector would fail it loudly).

``--churn`` adds continuous elastic-membership churn (add/remove
voters, add/promote/remove learners, leadership transfers) running
CONCURRENTLY with the fault schedule, plus a stage-trap nemesis action
that lands seeded crashes inside each joint-consensus stage; after
every fault the committed conf of every live node must be one of
{old, joint, new} of an attempted change.

``--quiesce`` (with ``--engine``) lets idle groups hibernate
(RaftOptions.quiesce_after_rounds) and adds a
store-kill-while-quiescent nemesis action: a store leading hibernating
groups is killed, and its dependents must wake on store-lease expiry
and elect within the normal fault-detection envelope — with the
history still linearizable.

``--gray`` adds FAIL-SLOW faults: a store's fsyncs stall or crawl
(tpuraft/storage/fault.py latency injection), or one endpoint's links
limp (NetworkTopology.degrade_endpoint) — the victim stays alive to
every classic liveness check while everything it leads detonates in
latency.  Store health scoring (tpuraft/util/health.py) must detect it
from hot-path signals and EVACUATE leadership at a bounded rate; the
run record counts evacuations, and a long drive with zero of them
fails (gray_detection_ok).

``--disk-pressure`` adds CAPACITY faults: every store runs under a
standing ChaosDir byte quota (with a matching DiskBudget inside the
store), and the nemesis menu gains quota-shrink (clamp the victim's
quota to just above live usage) and seeded-ENOSPC-burst actions.  The
pressure ladder (tpuraft/util/health.DiskBudget + StoreEngine reclaim
/ shed) must snapshot-reclaim at NEAR_FULL, shed writes retryably at
FULL while reads keep serving, and RESUME writes after reclaim without
a restart — a long drive that never completes the whole arc fails
(disk_pressure_ok).

``--geo N`` shapes the fabric through a seeded NetworkTopology
(tpuraft/rpc/topology.py): stores tag round-robin into N zones,
inter-zone links get ASYMMETRIC WAN latency + jitter + loss, and the
nemesis menu gains zone-partition (one-way half the time),
wan-degrade (latency x6, +1% loss) and link-flap actions — which heal
via heal_topology() and so compose with (never stomp) the noise
actions' heal().  ``--witness`` additionally makes the last store a
WITNESS member of every region: it votes and acks payload-stripped
appends, never campaigns, never serves reads; after EVERY fault (and
at the end) the soak asserts witness safety — no witness ever led,
opened a ballot window, or journaled a payload byte.
"""

from __future__ import annotations

import argparse
import asyncio
import random
import tempfile
import time

import itertools

from tpuraft_torch.entity import PeerId
from tpuraft_torch.errors import RaftError
from tpuraft_torch.rheakv.client import RheaKVStore
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions
from tpuraft_torch.rpc.topology import build_geo_topology
from tpuraft_torch.rpc.transport import InProcNetwork, InProcTransport, RpcServer
from tpuraft_torch.util.linearizability import (History, check_history,
                                          check_stale_reads)
from tpuraft_torch.util.nemesis import (
    NemesisAction,
    SkipFault,
    StageTrap,
    run_nemesis,
)
from tpuraft_torch.util.quorum import joint_quorums_intersect as \
    _joint_quorums_intersect  # shared with tests/oracle.py — one oracle

# --disk-pressure: the standing per-store byte quota (ChaosDir) AND the
# store's own DiskBudget ceiling — kept equal so the budget's thresholds
# describe the same disk the fault plane enforces.  Sized so a few
# seconds of soak write load crosses NEAR_FULL (reclaim must then keep
# the store alive for the rest of the drive).
_DISK_QUOTA_BYTES = 384 * 1024


class _BaseSoakCluster:
    """Shared cluster shape for both fabrics: a stores map, the region
    layout, option plumbing, and leader lookup."""

    read_only_option = None   # set by run_soak for lease-read mode
    snapshot_interval_secs = 0  # set by run_soak (power-loss soaks
    #                             snapshot so compaction runs under crashes)

    def __init__(self, data_path: str):
        self.data_path = data_path
        self.endpoints: list[str] = []
        self.regions: list[Region] = []
        self.stores: dict[str, StoreEngine] = {}
        # extra StoreEngineOptions applied to EVERY store (restarts
        # included) — how scenario modes (--disk-pressure) retune
        # budgets/cadences without forking the option plumbing
        self.store_extra: dict = {}
        # --clock-chaos: endpoint -> injected ChaosClock.  Owned by the
        # CLUSTER, not the store: a killed store restarts on the SAME
        # skewed timebase (real machines do not reset their oscillator
        # on process restart)
        self.clocks: dict[str, object] = {}
        # counters of RETIRED engines: a killed/restarted store gets a
        # fresh StoreEngine, and summing only live engines would erase
        # e.g. every gray evacuation a later leader-kill happened to
        # land on — exactly the composition --gray exists to test
        self.retired_counters: dict[str, int] = {}

    def _retire_counters(self, store: StoreEngine) -> None:
        rc = self.retired_counters
        rc["evacuations"] = rc.get("evacuations", 0) + store.evacuations
        if store.append_batcher is not None:
            # write-plane rounds survive store kill/restart in the run
            # record (the PR 11 retired-counter lesson)
            for k, v in store.append_batcher.counters().items():
                rc[k] = rc.get(k, 0) + v
        eager = sum(re_.node.fsm_caller.eager_acked
                    for re_ in store._regions.values()
                    if re_.node is not None)
        if eager:
            rc["fsm_eager_acked"] = rc.get("fsm_eager_acked", 0) + eager
        rc["shed_items"] = rc.get("shed_items", 0) \
            + store.kv_processor.shed_items
        if store.health is not None:
            rc["health_evaluations"] = rc.get("health_evaluations", 0) \
                + store.health.evaluations
            rc["sick_rounds"] = rc.get("sick_rounds", 0) \
                + store.health.level_counts["sick"]
        sentinel = getattr(store, "clock_sentinel", None)
        if sentinel is not None:
            # clock-plane counters (anomalies, fenced leases) must
            # survive kill/restart in the run record too
            for k, v in sentinel.counters().items():
                rc[k] = rc.get(k, 0) + v
        for re_ in store._regions.values():
            if re_.node is not None:
                rc["lease_fallbacks"] = rc.get("lease_fallbacks", 0) \
                    + re_.node.read_only_service.lease_fallbacks
        if store.disk_budget is not None:
            # disk-pressure ladder counters must survive kill/restart
            # in the run record, same as evacuations above
            rc["disk_reclaims"] = rc.get("disk_reclaims", 0) \
                + store.disk_reclaims
            rc["disk_shed_items"] = rc.get("disk_shed_items", 0) \
                + store.disk_shed_items
            bc = store.disk_budget.counters()
            for k in ("disk_pressure_resumes", "disk_enospc_events",
                      "disk_full_rounds", "disk_near_full_rounds"):
                rc[k] = rc.get(k, 0) + bc[k]

    def _store_opts(self, ep: str, election_timeout_ms: int,
                    **extra) -> StoreEngineOptions:
        extra = {**self.store_extra, **extra}
        if ep in self.clocks:
            extra.setdefault("clock", self.clocks[ep])
        opts = StoreEngineOptions(
            server_id=ep,
            initial_regions=[r.copy() for r in self.regions],
            data_path=self.data_path,
            election_timeout_ms=election_timeout_ms,
            snapshot_interval_secs=self.snapshot_interval_secs,
            **extra)
        if self.read_only_option is not None:
            opts.read_only_option = self.read_only_option
        return opts

    def leader_endpoint(self, region_id: int = 1):
        for ep, s in self.stores.items():
            eng = s.get_region_engine(region_id)
            if eng is not None and eng.is_leader():
                return ep
        return None


class SoakCluster(_BaseSoakCluster):
    """In-proc fabric: InProcNetwork supplies partitions/drops/delays.

    n_regions > 1 splits the keyspace into that many raft groups per
    store (region k owns [k%06d, (k+1)%06d)); engine=True gives every
    store a MultiRaftEngine protocol plane + multilog shared journal —
    the configuration the G>=1K chaos soak (VERDICT r3 #6) runs.

    geo_zones > 0 tags stores round-robin into that many zones and
    shapes every link through a seeded NetworkTopology (intra-zone
    near-zero, inter-zone WAN latency+jitter+loss) — the CD-Raft
    regime.  witness=True makes the LAST store a witness member of
    every region (2 data + 1 witness at 3 stores)."""

    def __init__(self, n_stores: int, data_path: str, n_regions: int = 1,
                 engine: bool = False, election_timeout_ms: int = 400,
                 quiesce_after_rounds: int = 0, geo_zones: int = 0,
                 witness: bool = False, geo_seed: int = 0,
                 pd_endpoint: str = "",
                 heartbeat_interval_ms: int = 0,
                 device: str = "cuda"):
        super().__init__(data_path)
        self.net = InProcNetwork()
        self.endpoints = [f"127.0.0.1:{6300 + i}" for i in range(n_stores)]
        self.election_timeout_ms = election_timeout_ms
        self.engine = engine
        # where the engines tick: the card unless the caller asks for
        # the CPU
        self.device = device
        # --hotspot: stores heartbeat to a REAL in-proc PD at this
        # endpoint (heat rows + cluster view) instead of running PD-less
        self.pd_endpoint = pd_endpoint
        self.heartbeat_interval_ms = heartbeat_interval_ms
        # --lifecycle: splits mint NEW groups mid-run, so the engine's
        # [G] capacity must leave headroom beyond len(regions) (0 =
        # size from the static region count as before)
        self.engine_group_cap = 0
        self.quiesce_after_rounds = quiesce_after_rounds
        self.geo_zones = geo_zones
        self.witness = witness
        self.topology = None
        if geo_zones > 0:
            self.topology = build_geo_topology(
                self.endpoints, geo_zones, seed=geo_seed)
            self.net.set_topology(self.topology)
            from tpuraft_torch.util import describer

            describer.register(self.topology)
        peers = list(self.endpoints)
        if witness:
            # last store = witness voter of every region (metadata-only)
            peers = peers[:-1] + [peers[-1] + "/witness"]
        if n_regions <= 1:
            self.regions = [Region(id=1, peers=peers)]
        else:
            def bkey(k):
                return b"k%06d" % k

            self.regions = [
                Region(id=k + 1, start_key=bkey(k) if k else b"",
                       end_key=bkey(k + 1) if k + 1 < n_regions else b"",
                       peers=list(peers))
                for k in range(n_regions)]

    def zone_of(self, ep: str) -> str:
        if self.topology is None:
            return ""
        return self.topology.zone_of(ep)

    async def start_store(self, ep: str) -> None:
        server = RpcServer(ep)
        self.net.bind(server)
        self.net.start_endpoint(ep)
        transport = InProcTransport(self.net, ep)
        extra = {}
        if self.quiesce_after_rounds:
            extra["quiesce_after_rounds"] = self.quiesce_after_rounds
        if self.geo_zones:
            extra["zone"] = self.zone_of(ep)
        if self.heartbeat_interval_ms:
            extra["heartbeat_interval_ms"] = self.heartbeat_interval_ms
        pd_client = None
        if self.pd_endpoint:
            from tpuraft_torch.rheakv.pd_client import RemotePlacementDriverClient

            pd_client = RemotePlacementDriverClient(
                transport, [self.pd_endpoint])
        raft_engine = None
        if self.engine:
            from tpuraft_torch.core.engine import MultiRaftEngine
            from tpuraft_torch.options import TickOptions

            cap = self.engine_group_cap \
                or 1 << max(4, (len(self.regions) + 3).bit_length())
            raft_engine = MultiRaftEngine(TickOptions(
                max_groups=cap, max_peers=4, tick_interval_ms=20,
                device=self.device))
            extra["log_scheme"] = "multilog"
        store = StoreEngine(
            self._store_opts(ep, self.election_timeout_ms, **extra),
            server, transport, multi_raft_engine=raft_engine,
            pd_client=pd_client)
        await store.start()
        self.stores[ep] = store

    async def stop_store(self, ep: str) -> None:
        self.net.stop_endpoint(ep)
        store = self.stores.pop(ep, None)
        if store:
            self._retire_counters(store)
            self.net.unbind(ep)
            await store.shutdown()

    def client_transport(self):
        self._client_t = InProcTransport(self.net, "soak-client:0")
        return self._client_t

    # fault surface (same verbs on both fabrics)
    def one_way_partition(self, a: str, b: str) -> None:
        self.net.partition_one_way({a}, {b})

    def heal_partitions(self) -> None:
        self.net.heal()

    def set_noise(self, drop: float, delay_ms: float, dup: float = 0.0,
                  reorder: float = 0.0, reorder_ms: float = 8.0) -> None:
        self.net.set_drop_rate(drop)
        self.net.set_delay_ms(delay_ms)
        self.net.set_duplicate_rate(dup)
        self.net.set_reorder(reorder, reorder_ms)

    def heal_topology(self) -> None:
        self.net.heal_topology()


class NativeSoakCluster(_BaseSoakCluster):
    """Full native stack: C++ epoll sockets + C++ KV engines, faults
    injected at each store's FaultInjectingTransport."""

    def __init__(self, n_stores: int, data_path: str):
        from tpuraft_torch.rpc.native_tcp import ensure_built

        ensure_built()
        super().__init__(data_path)
        self.n = n_stores
        self._servers: dict[str, object] = {}
        self._faults: dict[str, object] = {}
        # active fault state survives store restarts (the in-proc fabric
        # gets this for free from its shared network object)
        self._noise: tuple[float, float, float, float, float] = (
            0.0, 0.0, 0.0, 0.0, 8.0)
        self._blocks: set[tuple[str, str]] = set()

    async def boot(self) -> None:
        from tpuraft_torch.rpc.native_tcp import NativeTcpRpcServer

        servers = []
        for _ in range(self.n):
            srv = NativeTcpRpcServer("127.0.0.1:0")
            await srv.start()
            srv.endpoint = f"127.0.0.1:{srv.bound_port}"
            servers.append(srv)
        self.endpoints = [s.endpoint for s in servers]
        self.regions = [Region(id=1, peers=list(self.endpoints))]
        for srv in servers:
            await self._start(srv.endpoint, srv)

    async def _start(self, ep: str, server=None) -> None:
        from tpuraft_torch.rheakv.native_store import NativeRawKVStore
        from tpuraft_torch.rpc.fault import FaultInjectingTransport
        from tpuraft_torch.rpc.native_tcp import (
            NativeTcpRpcServer,
            NativeTcpTransport,
        )

        if server is None:
            server = NativeTcpRpcServer(ep)
            await server.start()
        transport = FaultInjectingTransport(NativeTcpTransport(endpoint=ep))
        opts = self._store_opts(
            ep, 600,
            raw_store_factory=lambda ep=ep: NativeRawKVStore(
                f"{self.data_path}/nkv_{ep.replace(':', '_')}"))
        store = StoreEngine(opts, server, transport)
        await store.start()
        self.stores[ep] = store
        self._servers[ep] = server
        self._faults[ep] = transport
        # re-apply the fault state active at (re)start time
        transport.set_drop_rate(self._noise[0])
        transport.set_delay_ms(self._noise[1])
        transport.set_duplicate_rate(self._noise[2])
        transport.set_reorder(self._noise[3], self._noise[4])
        for src, dst in self._blocks:
            if src == ep:
                transport.block(dst)

    async def start_store(self, ep: str) -> None:
        await self._start(ep)

    async def stop_store(self, ep: str) -> None:
        store = self.stores.pop(ep, None)
        server = self._servers.pop(ep, None)
        ft = self._faults.pop(ep, None)
        if store:
            self._retire_counters(store)
            await store.shutdown()
        if server:
            await server.stop()
        if ft:
            await ft.close()

    def client_transport(self):
        from tpuraft_torch.rpc.fault import FaultInjectingTransport
        from tpuraft_torch.rpc.native_tcp import NativeTcpTransport

        # the client rides the SAME noise as the stores (in-proc mode
        # gets this for free from InProcNetwork): maybe-applied client
        # ops are exactly what the checker exists to exercise
        self._client_t = FaultInjectingTransport(NativeTcpTransport())
        self._faults["__client__"] = self._client_t
        return self._client_t

    def one_way_partition(self, a: str, b: str) -> None:
        self._blocks.add((a, b))
        ft = self._faults.get(a)
        if ft is not None:
            ft.block(b)

    def heal_partitions(self) -> None:
        self._blocks.clear()
        for ft in self._faults.values():
            ft.heal()

    def set_noise(self, drop: float, delay_ms: float, dup: float = 0.0,
                  reorder: float = 0.0, reorder_ms: float = 8.0) -> None:
        self._noise = (drop, delay_ms, dup, reorder, reorder_ms)
        for ft in self._faults.values():
            ft.set_drop_rate(drop)
            ft.set_delay_ms(delay_ms)
            ft.set_duplicate_rate(dup)
            ft.set_reorder(reorder, reorder_ms)


class MembershipChurn:
    """Continuous elastic-membership churn against one region of an
    in-proc soak cluster: add/remove voters, add/promote/remove
    learners, transfer leadership — running CONCURRENTLY with the
    nemesis schedule, so every seeded crash may land mid-joint-config,
    mid-catch-up, or mid-transfer.

    Tracks the committed-configuration history and asserts, after every
    fault heals, that each live node's conf is one of {old, joint, new}
    of some attempted change and that consecutive stable confs kept
    quorum intersection (through the joint's dual quorum).
    """

    def __init__(self, cluster, region_id: int, rng, say):
        self.c = cluster
        self.rid = region_id
        self.rng = rng
        self.say = say
        self.trap = StageTrap()
        self.completed = 0
        self.transfers = 0
        self.busy_retries = 0
        self.failures: dict[str, int] = {}
        self.stage_crashes: dict[str, int] = {}
        # committed stable voter sets, in completion order
        initial = frozenset(PeerId.parse(p) if isinstance(p, str) else p
                            for p in self._region_peers())
        self.conf_history: list[frozenset] = [initial]
        # every (old, new) pair ever attempted: lagging nodes may hold a
        # joint from a change several rounds back
        self.attempted: list[tuple[frozenset, frozenset]] = []
        self._stop = asyncio.Event()
        self._task = None

    def _region_peers(self) -> list:
        for r in self.c.regions:
            if r.id == self.rid:
                return list(r.peers)
        raise ValueError(f"region {self.rid} not in cluster layout")

    # -- plumbing ------------------------------------------------------------

    def _nodes(self):
        out = {}
        for ep, s in self.c.stores.items():
            eng = s.get_region_engine(self.rid)
            if eng is not None and eng.node is not None:
                out[ep] = eng.node
        return out

    def leader_node(self):
        for ep, node in self._nodes().items():
            if node.is_leader():
                return ep, node
        return None, None

    def _install_listeners(self) -> None:
        """(Re)hook the stage trap on every live node — idempotent, and
        repeated each round so restarted stores rejoin the trap."""
        for node in self._nodes().values():
            node.conf_stage_listener = self.trap.listener

    # -- the churn loop ------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _run(self) -> None:
        while not self._stop.is_set():
            try:
                await self._one_change()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # a churn-op crash must not stop churn
                self._note_failure(f"driver:{type(e).__name__}")
            await asyncio.sleep(0.05 + self.rng.random() * 0.15)

    def _note_failure(self, key: str) -> None:
        self.failures[key] = self.failures.get(key, 0) + 1

    async def _one_change(self) -> None:
        """Pick one membership op against the current conf and drive it
        through with bounded EBUSY backoff-retry (the operator loop)."""
        self._install_listeners()
        for attempt in range(12):
            if self._stop.is_set():
                return
            ep, node = self.leader_node()
            if node is None:
                await asyncio.sleep(0.2)
                continue
            plan = self._plan_op(node)
            if plan is None:
                await asyncio.sleep(0.2)
                continue
            op, coro, old_set, new_set = plan
            # record the attempt BEFORE the call: a crash window may
            # commit the change without us seeing the ack, and the
            # invariant check must know the pair was legal.  Definite
            # pre-append rejections un-record it below so the oracle's
            # allowed set doesn't silently widen with changes that
            # never touched any log.
            pair = (old_set, new_set)
            recorded = op != "transfer" and new_set != old_set
            if recorded:
                self.attempted.append(pair)

            def unrecord():
                if recorded and pair in self.attempted:
                    self.attempted.remove(pair)

            try:
                st = await asyncio.wait_for(coro, 20.0)
            except asyncio.TimeoutError:
                self._note_failure(f"{op}:timeout")
                return
            except Exception as e:
                # node shut down mid-call (a crash landed on it) — the
                # change may or may not complete; the invariant check
                # reconciles either way
                self._note_failure(f"{op}:{type(e).__name__}")
                return
            if st.is_ok():
                if op == "transfer":
                    self.transfers += 1
                else:
                    self.completed += 1
                    if new_set != self.conf_history[-1]:
                        self.conf_history.append(new_set)
                self.say(f"  churn: {op} ok "
                         f"(voters={len(new_set)})")
                return
            code = st.raft_error
            if code == RaftError.EBUSY:
                # rejected before anything was appended
                unrecord()
                self.busy_retries += 1
                await asyncio.sleep(0.15 + self.rng.random() * 0.1)
                continue
            if code in (RaftError.EINVAL, RaftError.EPERM):
                unrecord()  # rejected at propose time, nothing appended
            # transient outcomes under chaos (deposed leader, catch-up
            # against a killed store, shutdown): note and move on —
            # the invariant check decides whether the change took
            self._note_failure(f"{op}:{code.name}")
            return

    def _plan_op(self, node):
        """Build (op, coroutine, old_voters, new_voters) for one change
        against the leader's CURRENT conf."""
        voters = list(node.conf_entry.conf.peers)
        learners = list(node.conf_entry.conf.learners)
        all_peers = [PeerId.parse(e) for e in self.c.endpoints]
        spare = [p for p in all_peers
                 if p not in voters and p not in learners]
        menu: list[str] = []
        if spare:
            menu += ["add_voter", "add_learner"]
        if learners:
            menu += ["promote_learner", "remove_learner"]
        if len(voters) > 2:
            menu += ["remove_voter", "remove_voter"]
        if len(voters) > 1:
            menu += ["transfer"]
        if not menu:
            return None
        op = self.rng.choice(menu)
        old_set = frozenset(voters)
        new_conf = node.conf_entry.conf.copy()
        if op == "add_voter":
            new_conf.peers.append(self.rng.choice(spare))
        elif op == "add_learner":
            new_conf.learners.append(self.rng.choice(spare))
        elif op == "promote_learner":
            p = self.rng.choice(learners)
            new_conf.learners.remove(p)
            new_conf.peers.append(p)
        elif op == "remove_learner":
            new_conf.learners.remove(self.rng.choice(learners))
        elif op == "remove_voter":
            victim = self.rng.choice(voters)
            new_conf.peers.remove(victim)
        elif op == "transfer":
            target = self.rng.choice(
                [p for p in voters if p != node.server_id] or voters)
            return (op, node.transfer_leadership_to(target),
                    old_set, old_set)
        new_set = frozenset(new_conf.peers)
        return (op, node.change_peers(new_conf), old_set, new_set)

    # -- invariants (run as the nemesis post-heal check) ---------------------

    async def check_invariants(self) -> None:
        """After a fault heals: every live node's conf must be one of
        {old, joint, new} of some attempted change, and the stable-conf
        chain must keep quorum intersection.  An ok-status the driver
        missed (leader died after committing) is reconciled here."""
        history = set(self.conf_history)
        for ep, node in self._nodes().items():
            conf = frozenset(node.conf_entry.conf.peers)
            old = frozenset(node.conf_entry.old_conf.peers)
            if old:
                assert (old, conf) in self.attempted, (
                    f"{ep}: joint conf {sorted(map(str, old))} -> "
                    f"{sorted(map(str, conf))} matches no attempted "
                    f"change (history={self.conf_history})")
                # quorum intersection across the change, verified by
                # enumerating the joint's dual quorums against both
                # sides' majorities
                assert _joint_quorums_intersect(old, conf), (
                    f"{ep}: joint {sorted(map(str, old))} -> "
                    f"{sorted(map(str, conf))} lacks quorum intersection")
            else:
                if conf in history:
                    continue
                # a stable conf the driver never saw complete: legal iff
                # it is the target of an attempted change leaving a
                # known stable conf (the leader died between commit and
                # ack) — adopt it as completed
                adopted = False
                for o, n in self.attempted:
                    if n == conf and o in history:
                        self.conf_history.append(conf)
                        history.add(conf)
                        self.completed += 1
                        adopted = True
                        self.say(f"  churn: adopted conf completed "
                                 f"under crash (voters={len(conf)})")
                        break
                assert adopted, (
                    f"{ep}: stable conf {sorted(map(str, conf))} is "
                    f"neither a committed conf nor an attempted target "
                    f"(history={self.conf_history})")

    def summary(self) -> dict:
        return {
            "completed_conf_changes": self.completed,
            "transfers": self.transfers,
            "busy_retries": self.busy_retries,
            "stage_crashes": dict(self.stage_crashes),
            "failures": dict(self.failures),
            "conf_history_len": len(self.conf_history),
        }


async def run_soak(duration_s: float, n_stores: int, n_keys: int,
                   seed: int, data_path: str, verbose: bool,
                   transport: str = "inproc",
                   dump_history: str = "",
                   lease_reads: bool = False,
                   n_regions: int = 1,
                   engine: bool = False,
                   election_timeout_ms: int = 400,
                   power_loss: bool = False,
                   churn: bool = False,
                   quiesce: bool = False,
                   kv_batching: bool = False,
                   geo: int = 0,
                   witness: bool = False,
                   read_mix: float = 0.0,
                   read_from: str = "leader",
                   gray: bool = False,
                   write_burst: bool = False,
                   disk_pressure: bool = False,
                   clock_chaos: bool = False,
                   trace: str = "",
                   device: str = "cuda") -> dict:
    rng = random.Random(seed)
    if geo and transport != "inproc":
        raise ValueError(
            "--geo shapes the in-proc fabric's NetworkTopology; the "
            "native fabric takes per-store FaultInjectingTransport "
            "topologies (wire them explicitly)")
    if geo == 1:
        raise ValueError(
            "--geo needs at least 2 zones (zone partitions and "
            "link flaps are inter-zone faults)")
    if witness and not geo:
        raise ValueError("--witness rides the geo scenario (--geo N)")
    if witness and churn:
        raise ValueError(
            "--witness fixes the last store as a witness member; "
            "--churn's random add/remove would fight that placement — "
            "run them separately")
    if quiesce and (transport != "inproc" or not engine):
        raise ValueError(
            "--quiesce hibernates engine-driven groups (TimerControl "
            "nodes never quiesce): run with --engine on the in-proc "
            "fabric")
    if churn and transport != "inproc":
        raise ValueError(
            "--churn drives membership ops and stage traps through "
            "direct node access, so it runs on the in-proc fabric")
    if power_loss and (transport != "inproc" or engine):
        raise ValueError(
            "--power-loss interposes on the Python storage planes "
            "(per-region file:// log/meta/snapshot), so it runs on the "
            "in-proc fabric without --engine; the native multilog's "
            "fd-level I/O is crash-imaged by the dedicated harness "
            "(tests/test_storage_fault.py) instead")
    if gray and (transport != "inproc" or engine):
        raise ValueError(
            "--gray injects fail-slow disk faults through the same "
            "storage interposition as --power-loss: in-proc fabric, "
            "no --engine (the multilog's fd-level fsyncs are out of "
            "Python's reach)")
    if disk_pressure and (transport != "inproc" or engine):
        raise ValueError(
            "--disk-pressure drives capacity faults through the Python "
            "storage interposition (ChaosDir quotas): in-proc fabric, "
            "no --engine (the native multilog's quota mirror is "
            "exercised by tests/test_storage_fault.py via "
            "NativeJournalTracker.attach_quota)")
    if clock_chaos and (transport != "inproc" or engine):
        raise ValueError(
            "--clock-chaos installs per-store injected ChaosClocks "
            "through StoreEngineOptions.clock, which drives timer-mode "
            "nodes: in-proc fabric, no --engine (the engine's device "
            "TickClock takes its own TickOptions.clock — wire it "
            "explicitly for an engine-mode clock soak)")
    if transport == "native":
        if n_regions > 1 or engine:
            raise ValueError("region-density soak runs on the in-proc "
                             "fabric (--transport inproc)")
        c = NativeSoakCluster(n_stores, data_path)
    else:
        c = SoakCluster(n_stores, data_path, n_regions=n_regions,
                        engine=engine,
                        election_timeout_ms=election_timeout_ms,
                        quiesce_after_rounds=4 if quiesce else 0,
                        geo_zones=geo, witness=witness, geo_seed=seed,
                        device=device)
    if clock_chaos:
        from tpuraft_torch.util.clock import ChaosClock

        # every store gets its OWN seeded virtual clock, installed for
        # the whole drive (restarts keep it — see _BaseSoakCluster);
        # every store also pads its leases for a declared 5% worst-case
        # drift, the bound the nemesis menu deliberately exceeds so the
        # sentinel fence / SAFE fallback paths must carry safety
        for i, ep in enumerate(c.endpoints):
            c.clocks[ep] = ChaosClock(seed=seed * 1000 + i)
        c.store_extra.setdefault("clock_drift_bound", 0.05)
    chaos = {}
    try:
        if power_loss or gray or disk_pressure:
            import os as _os

            from tpuraft_torch.storage.fault import ChaosDir

            if power_loss or disk_pressure:
                # snapshots on: prefix compaction + snapshot commit must
                # run UNDER the crash schedule, not just appends (and
                # they are the disk-pressure reclaim unit)
                c.snapshot_interval_secs = 10
            for ep in c.endpoints:
                ip, port = ep.rsplit(":", 1)
                chaos[ep] = ChaosDir(
                    _os.path.join(data_path, f"{ip}_{port}")).install()
            if disk_pressure:
                # every store lives under a standing byte quota, and its
                # OWN DiskBudget gets the same ceiling; small segments +
                # a fast health cadence make reclaim prompt at soak scale
                for cd in chaos.values():
                    cd.set_quota(_DISK_QUOTA_BYTES)
                c.store_extra.update(
                    disk_budget_bytes=_DISK_QUOTA_BYTES,
                    health_eval_interval_ms=100,
                    log_segment_max_bytes=32 * 1024,
                    disk_reclaim_cooldown_rounds=4)
        if gray and getattr(c, "topology", None) is None:
            # slow-endpoint events need a topology even zoneless: a
            # bare one shapes nothing until degrade_endpoint fires
            from tpuraft_torch.rpc.topology import NetworkTopology

            c.topology = NetworkTopology(seed=seed)
            c.net.set_topology(c.topology)
        return await _run_soak_inner(
            duration_s, n_keys, verbose, transport, dump_history,
            lease_reads, n_regions, rng, c, chaos, churn, quiesce,
            kv_batching, geo, witness, read_mix, read_from,
            gray=gray, power_loss=power_loss, write_burst=write_burst,
            disk_pressure=disk_pressure, clock_chaos=clock_chaos,
            trace=trace)
    finally:
        # uninstall on EVERY exit path, startup failures included: a
        # leaked install leaves builtins.open/os.fsync patched process-
        # wide, turning later fsyncs under the roots into silent no-ops
        for cd in chaos.values():
            cd.uninstall()


async def _run_soak_inner(duration_s, n_keys, verbose, transport,
                          dump_history, lease_reads, n_regions, rng, c,
                          chaos, churn=False, quiesce=False,
                          kv_batching=False, geo=0, witness=False,
                          read_mix=0.0, read_from="leader", gray=False,
                          power_loss=False, write_burst=False,
                          disk_pressure=False, clock_chaos=False,
                          trace="") -> dict:
    if trace:
        # sampled product tracing through the whole drive; exported as
        # perfetto-loadable JSON next to the result
        from tpuraft_torch.util.trace import TRACER

        TRACER.configure(enabled=True, sample_rate=0.05, seed=0)
    if lease_reads:
        from tpuraft_torch.options import ReadOnlyOption

        c.read_only_option = ReadOnlyOption.LEASE_BASED
    if transport == "native":
        await c.boot()
    else:
        for ep in c.endpoints:
            await c.start_store(ep)
    pd = FakePlacementDriverClient([r.copy() for r in c.regions])
    # --kv-batching: the store-grouped kv_command_batch serving plane —
    # the oracle history must stay linearizable with ops riding batches
    # (each batched op acks individually, applies atomically per item)
    from tpuraft_torch.rheakv.client import BatchingOptions

    kv = RheaKVStore(pd, c.client_transport(), max_retries=1,
                     batching=BatchingOptions(enabled=True)
                     if kv_batching else None,
                     read_from=read_from,
                     jitter_seed=rng.randrange(1 << 30))
    await kv.start()

    def say(*a):
        if verbose:
            print(*a, flush=True)

    h = History()
    stop = asyncio.Event()
    if n_regions > 1:
        # sample keys from n_keys DISTINCT regions spread over the
        # range: linearizability is checked per key, so each sampled
        # key exercises its own raft group under the shared faults
        step = max(1, n_regions // n_keys)
        sampled = [min(i * step, n_regions - 1) for i in range(n_keys)]
        keys = [b"k%06d/s" % j for j in sampled]
        sampled_regions = [j + 1 for j in sampled]
    else:
        keys = [b"soak-%d" % i for i in range(n_keys)]
        sampled_regions = [1]

    # read-mix mode (--read-mix FRAC): reads with probability FRAC,
    # writes carry per-key MONOTONE sequence values with exactly ONE
    # writer per key issuing in order — the shape the targeted
    # no-stale-read assertion (check_stale_reads) requires on top of
    # the full linearizability check
    n_workers = 5
    seq_counters = {k: itertools.count(1) for k in keys}
    key_owner = {k: i % n_workers for i, k in enumerate(keys)}

    def _seq_of(value) -> int:
        if isinstance(value, bytes) and value[:1] == b"s":
            try:
                return int(value[1:])
            except ValueError:
                return -1
        return -1

    async def worker(cid: int):
        n = 0
        own_keys = [k for k in keys if key_owner[k] == cid]
        while not stop.is_set():
            n += 1
            if write_burst:
                # write-heavy shape (ISSUE 15): a burst of 4 concurrent
                # puts — the store-wide append rounds and ack-at-commit
                # path run loaded while the nemeses fire — plus ~10%
                # reads so acked-at-commit writes are read back under
                # the same history
                if rng.random() < 0.1:
                    key = rng.choice(keys)
                    tok = h.invoke(cid, "r", (key,))
                    try:
                        v = await asyncio.wait_for(kv.get(key), 4.0)
                        h.complete(tok, v)
                    except Exception:
                        pass
                else:
                    async def one_put(j: int):
                        key = rng.choice(keys)
                        val = b"c%d-%d-%d" % (cid, n, j)
                        tok = h.invoke(cid, "w", (key, val))
                        try:
                            await asyncio.wait_for(kv.put(key, val), 4.0)
                            h.complete(tok, True)
                        except Exception:
                            pass        # pending: maybe applied
                    await asyncio.gather(*(one_put(j) for j in range(4)))
                await asyncio.sleep(0.005)
                continue
            if read_mix > 0:
                do_read = not own_keys or rng.random() < read_mix
                key = rng.choice(keys if do_read else own_keys)
            else:
                do_read = n % 2 == 1
                key = rng.choice(keys)
            if not do_read:
                val = (b"s%08d" % next(seq_counters[key])
                       if read_mix > 0 else b"c%d-%d" % (cid, n))
                tok = h.invoke(cid, "w", (key, val))
                try:
                    await asyncio.wait_for(kv.put(key, val), 4.0)
                    h.complete(tok, True)
                except Exception:
                    pass            # pending: maybe applied
            else:
                tok = h.invoke(cid, "r", (key,))
                try:
                    v = await asyncio.wait_for(kv.get(key), 4.0)
                    h.complete(tok, v)
                except Exception:
                    pass
            await asyncio.sleep(0.005)

    # -- nemesis menu -------------------------------------------------------
    killed: list[str] = []

    async def kill_leader():
        ep = c.leader_endpoint(rng.choice(sampled_regions))
        if ep is None:
            raise SkipFault
        killed.append(ep)
        await c.stop_store(ep)

    async def restart_killed():
        while killed:
            await c.start_store(killed.pop())

    async def one_way():
        a, b = rng.sample(c.endpoints, 2)
        c.one_way_partition(a, b)

    async def heal_net():
        c.heal_partitions()

    async def noise_on():
        # drops + delays + the two other classic network faults:
        # duplication (receiver executes twice) and bounded reordering
        c.set_noise(0.05, 2, dup=0.03, reorder=0.05, reorder_ms=8.0)

    async def noise_off():
        c.set_noise(0.0, 0)

    # power loss: capture the durable-only on-disk image at the crash
    # instant (torn/lost/bit-flipped unsynced tails included), shut the
    # store down, discard everything the shutdown wrote by materializing
    # the captured image, and restart FROM that image — the recovery
    # path must come back clean or the check aborts the drive
    power_lost: list[str] = []
    dead_after_power_loss: list[str] = []

    async def power_loss_kill():
        up = [ep for ep in c.endpoints if ep in c.stores]
        if not up:
            raise SkipFault
        ep = rng.choice(up)
        plan = chaos[ep].capture_crash(rng)   # the instant power dies
        power_lost.append(ep)
        await c.stop_store(ep)
        chaos[ep].apply_crash(plan)

    async def power_loss_restart():
        while power_lost:
            ep = power_lost.pop()
            try:
                await c.start_store(ep)
            except Exception:
                dead_after_power_loss.append(ep)
                raise

    async def power_loss_ok():
        assert not dead_after_power_loss, \
            f"stores failed power-loss recovery: {dead_after_power_loss}"

    # store-kill-while-quiescent (--quiesce): wait for hibernation to
    # actually take hold on some store, then kill THAT store — its
    # dependent quiescent follower groups (on other stores) must wake on
    # store-lease expiry and elect within the normal fault-detection
    # envelope, and the history must stay linearizable
    quiesce_killed: list[str] = []
    quiesce_kill_counts: list[int] = []

    def _quiescent_leader_count(ep: str) -> int:
        store = c.stores.get(ep)
        if store is None or store.multi_raft_engine is None:
            return 0
        from tpuraft_torch.ops.tick import ROLE_LEADER

        eng = store.multi_raft_engine
        return int((eng.quiescent & (eng.role == ROLE_LEADER)).sum())

    async def quiescent_store_kill():
        # give hibernation a moment to take hold, then pick the store
        # leading the most QUIESCENT groups
        deadline = asyncio.get_running_loop().time() + 6.0
        victim, best = None, 0
        while asyncio.get_running_loop().time() < deadline:
            counts = {ep: _quiescent_leader_count(ep)
                      for ep in list(c.stores)}
            victim = max(counts, key=counts.get) if counts else None
            best = counts.get(victim, 0)
            if best > 0:
                break
            await asyncio.sleep(0.2)
        if victim is None or best == 0:
            raise SkipFault   # the workload kept everything awake
        say(f"  nemesis: killing store {victim} with {best} "
            f"quiescent leader groups")
        quiesce_kill_counts.append(best)
        quiesce_killed.append(victim)
        await c.stop_store(victim)

    async def quiescent_store_restart():
        while quiesce_killed:
            await c.start_store(quiesce_killed.pop())

    # -- membership churn (--churn): continuous conf changes under the
    # fault schedule + a stage-trap action that lands seeded crashes
    # INSIDE each _ConfigurationCtx stage ------------------------------------
    churn_driver = None
    crash_stage_cycle = itertools.cycle(["catching_up", "joint", "stable"])
    churn_lost: list[str] = []
    churn_dead: list[str] = []

    async def churn_crash():
        """Arm the stage trap for the next target stage; when a change
        enters it, crash THAT node's store mid-stage (power-loss image
        when --power-loss is on, plain kill otherwise)."""
        target = next(crash_stage_cycle)
        churn_driver.trap.arm(target)
        try:
            hit = await churn_driver.trap.wait(12.0)
        finally:
            churn_driver.trap.disarm()
        if not hit:
            raise SkipFault
        node = churn_driver.trap.node
        ep = node.server_id.endpoint
        if ep not in c.stores:
            raise SkipFault
        churn_driver.stage_crashes[target] = \
            churn_driver.stage_crashes.get(target, 0) + 1
        say(f"  nemesis: churn-crash landing in stage={target} on {ep}")
        if chaos and power_loss:
            plan = chaos[ep].capture_crash(rng)
            churn_lost.append(ep)
            await c.stop_store(ep)
            chaos[ep].apply_crash(plan)
        else:
            churn_lost.append(ep)
            await c.stop_store(ep)

    async def churn_crash_restart():
        while churn_lost:
            ep = churn_lost.pop()
            try:
                await c.start_store(ep)
            except Exception:
                churn_dead.append(ep)
                raise

    async def churn_ok():
        assert not churn_dead, \
            f"stores failed churn-crash recovery: {churn_dead}"
        await churn_driver.check_invariants()

    def with_conf_check(existing):
        """Compose an action's own recovery probe with the membership
        invariant check — under churn, EVERY fault's heal must leave
        each node's conf in {old, joint, new}."""
        if churn_driver is None:
            return existing

        async def _check():
            if existing is not None:
                await existing()
            await churn_driver.check_invariants()
        return _check

    # -- geo fault surface (--geo): topology-shaped events that compose
    # with (and heal independently of) the nemesis noise above ----------------
    topo = getattr(c, "topology", None)

    async def zone_partition():
        """Cut one whole zone off (one-way half the time — the classic
        asymmetric WAN failure)."""
        zone = rng.choice(topo.zones())
        one_way = rng.random() < 0.5
        say(f"  nemesis: zone-partition {zone} "
            f"({'one-way' if one_way else 'both ways'})")
        topo.partition_zone(zone, one_way=one_way)

    async def wan_degrade():
        """Brown out every inter-zone link: latency x6, +1% loss."""
        topo.degrade_wan(latency_x=6.0, extra_loss=0.01, bandwidth_x=1.0)

    async def link_flap():
        zones = topo.zones() if topo is not None else []
        if len(zones) < 2:
            raise SkipFault
        za, zb = rng.sample(zones, 2)
        topo.flap(za, zb, period_s=0.4, duty=0.6)

    async def heal_topology():
        c.heal_topology()

    def witness_nodes():
        if not witness:
            return []
        wep = c.endpoints[-1]
        store = c.stores.get(wep)
        if store is None:
            return []
        return [eng.node for eng in
                (store.get_region_engine(r.id) for r in c.regions)
                if eng is not None and eng.node is not None]

    async def witness_safety_check():
        """After every fault heals: a witness must never have led or
        advanced a ballot of its own — the witness-majority-must-not-
        commit invariant, asserted live through the whole drive."""
        for node in witness_nodes():
            assert not node.is_leader(), \
                f"witness {node} became leader under chaos"
            assert node.ballot_box.pending_index == 0, \
                f"witness {node} opened a leader ballot window"

    def with_witness_check(existing):
        if not witness:
            return existing

        async def _check():
            if existing is not None:
                await existing()
            await witness_safety_check()
        return _check

    # -- gray-failure fault surface (--gray): fail-slow, never fail-stop.
    # One store's disk stalls / limps, or one endpoint's links crawl,
    # while the store stays "alive" to every classic check — detection
    # (HealthTracker) must score it, evacuation must move its leases,
    # and the history must stay linearizable through it all. -----------------
    gray_slowed: list[str] = []       # stores with an active disk fault
    gray_limped: list[str] = []       # endpoints with an active limp

    def _gray_victim():
        up = [ep for ep in c.endpoints if ep in c.stores]
        if not up:
            raise SkipFault
        # prefer a store that currently LEADS something — slowing an
        # idle follower proves nothing about evacuation
        leaders = [ep for ep in up
                   if c.stores[ep].leader_region_ids()]
        return rng.choice(leaders or up)

    async def gray_disk_stall():
        """Burst disk stall: every fsync pays 60-150ms on its thread."""
        ep = _gray_victim()
        say(f"  nemesis: gray disk-stall on {ep}")
        chaos[ep].set_slow(fsync_ms=60, write_ms=5, jitter_ms=90,
                           seed=rng.randrange(1 << 30))
        gray_slowed.append(ep)

    async def gray_slow_store():
        """Sustained slow store: moderate disk latency + limping links
        (the saturated-CPU shape — everything it does is a bit slow)."""
        ep = _gray_victim()
        say(f"  nemesis: gray slow-store on {ep}")
        chaos[ep].set_slow(fsync_ms=25, write_ms=4, jitter_ms=20,
                           seed=rng.randrange(1 << 30))
        c.topology.degrade_endpoint(ep, latency_ms=20, jitter_ms=15)
        gray_slowed.append(ep)
        gray_limped.append(ep)

    async def gray_stalled_fsync():
        """Full fsync hang: nothing durably completes on the victim
        until heal — the worst gray failure."""
        ep = _gray_victim()
        say(f"  nemesis: gray stalled-fsync on {ep}")
        chaos[ep].stall_fsync()
        gray_slowed.append(ep)

    async def gray_slow_endpoint():
        """One store's links limp while its zone stays healthy."""
        up = [ep for ep in c.endpoints if ep in c.stores]
        if not up:
            raise SkipFault
        ep = rng.choice(up)
        say(f"  nemesis: gray slow-endpoint on {ep}")
        c.topology.degrade_endpoint(ep, latency_ms=60, jitter_ms=40,
                                    loss=0.01)
        gray_limped.append(ep)

    async def gray_heal():
        while gray_slowed:
            cd = chaos.get(gray_slowed.pop())
            if cd is not None:
                cd.heal_slow()
        while gray_limped:
            c.topology.heal_endpoint(gray_limped.pop())

    # -- disk-pressure fault surface (--disk-pressure): capacity faults.
    # The standing per-store quota (installed by run_soak) already makes
    # the budget/reclaim machinery work for a living; these actions push
    # a store over the edge — clamping its quota to just above live
    # usage, or bursting seeded ENOSPC into its writes — and the ladder
    # must shed writes retryably, reclaim, and RESUME with no restart. --------
    disk_squeezed: list[str] = []
    disk_bursting: list[str] = []

    def _disk_victim():
        up = [ep for ep in c.endpoints if ep in c.stores]
        if not up:
            raise SkipFault
        # prefer a store that currently LEADS something — a full
        # follower sheds nothing and reclaims nothing
        leaders = [ep for ep in up
                   if c.stores[ep].leader_region_ids()]
        return rng.choice(leaders or up)

    async def disk_quota_shrink():
        """Clamp the victim's quota to live usage + a sliver: the next
        seconds of appends hit the wall, ENOSPC latches the budget FULL,
        and reclaim has just enough headroom to free its way out."""
        ep = _disk_victim()
        limit, used = chaos[ep].quota_state()
        if limit is None:
            raise SkipFault
        target = used + 24 * 1024
        if target >= limit:
            raise SkipFault        # already squeezed near usage
        chaos[ep].shrink_quota(limit - target)
        # the store SEES the resize (its DiskBudget ceiling follows the
        # emulated volume, as statvfs capacity would on a real disk) —
        # used/target lands in NEAR_FULL territory, so the reclaim
        # ladder fires inside the reserved headroom instead of riding
        # blind into the hard wall
        st = c.stores.get(ep)
        if st is not None and st.disk_budget is not None:
            st.disk_budget.set_budget(target)
        disk_squeezed.append(ep)
        say(f"  nemesis: disk-quota-shrink on {ep} -> {target}b")

    async def disk_quota_restore():
        while disk_squeezed:
            ep = disk_squeezed.pop()
            cd = chaos.get(ep)
            if cd is not None:
                cd.set_quota(_DISK_QUOTA_BYTES)
            st = c.stores.get(ep)
            if st is not None and st.disk_budget is not None:
                st.disk_budget.set_budget(_DISK_QUOTA_BYTES)

    async def disk_enospc_burst():
        """Intermittent ENOSPC: ~25% of the victim's writes/renames fail
        while real usage sits under quota — the flaky-filesystem shape;
        flush failures must fail pending writes retryably (leader steps
        down, nothing acks) and never wedge the store."""
        ep = _disk_victim()
        say(f"  nemesis: disk-enospc-burst on {ep}")
        chaos[ep].set_enospc_burst(0.25, seed=rng.randrange(1 << 30))
        disk_bursting.append(ep)

    async def disk_burst_heal():
        while disk_bursting:
            cd = chaos.get(disk_bursting.pop())
            if cd is not None:
                cd.set_enospc_burst(0.0)

    # -- time-chaos fault surface (--clock-chaos): per-store injected
    # clocks drift/jump/freeze — composed with the leader kills and
    # partitions above — while lease reads keep flowing.  Safety must
    # come from the drift-bound lease shrink and the sentinel fence
    # (SAFE fallbacks), never from the clocks behaving. ------------------------
    clock_frozen: list[object] = []

    async def clock_chaos_step():
        """One seeded fault (drift / forward jump / freeze) on a random
        store's clock; a frozen clock unfreezes on the next hit."""
        clocks = list(getattr(c, "clocks", {}).items())
        if not clocks:
            raise SkipFault
        ep, ck = rng.choice(clocks)
        what = ck.chaos_step()
        say(f"  nemesis: clock {what} on {ep}")
        if ck.frozen:
            clock_frozen.append(ck)

    async def clock_leader_fast():
        """The classic lease hazard, aimed: the LEADER's clock runs 25%
        fast — past the declared 5% bound — so its unshrunk lease would
        outlive what followers granted in real time.  The shrunk window
        plus the sentinel fence must keep every lease read honest."""
        ep = c.leader_endpoint(rng.choice(sampled_regions))
        ck = getattr(c, "clocks", {}).get(ep)
        if ck is None:
            raise SkipFault
        say(f"  nemesis: clock leader-fast x1.25 on {ep}")
        if ck.frozen:
            ck.unfreeze()
        ck.set_rate(1.25)

    async def clock_unfreeze():
        # heal only LIVENESS faults: frozen clocks park election/beat
        # timers, so they thaw after the dwell — but accumulated drift
        # and jumps PERSIST across faults (real skew does not heal
        # itself), which is the regime the drift bound must survive
        while clock_frozen:
            ck = clock_frozen.pop()
            if ck.frozen:
                ck.unfreeze()

    if churn:
        churn_driver = MembershipChurn(c, sampled_regions[0], rng, say)

    actions = [
        NemesisAction("leader-kill", kill_leader, restart_killed,
                      dwell_s=0.7, weight=1.5,
                      check=with_conf_check(None)),
        NemesisAction("one-way-partition", one_way, heal_net, dwell_s=0.5,
                      check=with_conf_check(None)),
        NemesisAction("drops+delays", noise_on, noise_off, dwell_s=0.8,
                      check=with_conf_check(None)),
    ]
    if chaos and power_loss:
        actions.append(
            NemesisAction("power-loss", power_loss_kill,
                          power_loss_restart, dwell_s=0.6, weight=1.5,
                          check=with_conf_check(power_loss_ok)))
    if gray:
        # dwell long enough for the whole arc: EMAs cross thresholds,
        # hysteresis worsens to SICK (~eval_interval x worsen_after),
        # evacuation transfers fire, the client re-routes — all while
        # the fault still holds
        actions += [
            NemesisAction("gray-disk-stall", gray_disk_stall, gray_heal,
                          dwell_s=4.0, weight=1.5,
                          check=with_conf_check(None)),
            NemesisAction("gray-slow-store", gray_slow_store, gray_heal,
                          dwell_s=4.0, weight=1.0,
                          check=with_conf_check(None)),
            NemesisAction("gray-stalled-fsync", gray_stalled_fsync,
                          gray_heal, dwell_s=4.0, weight=1.0,
                          check=with_conf_check(None)),
            NemesisAction("gray-slow-endpoint", gray_slow_endpoint,
                          gray_heal, dwell_s=3.0, weight=1.0,
                          check=with_conf_check(None)),
        ]
    if disk_pressure:
        # dwell spans the whole arc at the 100ms health cadence: fill ->
        # FULL (writes shed) -> pressure-triggered snapshot reclaim ->
        # usage drops -> hysteresis folds back -> writes RESUME — all
        # while the fault still holds
        actions += [
            NemesisAction("disk-quota-shrink", disk_quota_shrink,
                          disk_quota_restore, dwell_s=6.0, weight=1.5,
                          check=with_conf_check(None)),
            NemesisAction("disk-enospc-burst", disk_enospc_burst,
                          disk_burst_heal, dwell_s=2.5, weight=1.0,
                          check=with_conf_check(None)),
        ]
    if clock_chaos:
        # high weight: clock faults should land MORE often than any
        # single network/kill fault so skew states overlap with them
        actions += [
            NemesisAction("clock-chaos", clock_chaos_step,
                          clock_unfreeze, dwell_s=1.2, weight=2.0,
                          check=with_conf_check(None)),
            NemesisAction("clock-leader-fast", clock_leader_fast,
                          clock_unfreeze, dwell_s=1.5, weight=1.5,
                          check=with_conf_check(None)),
        ]
    if churn_driver is not None:
        actions.append(
            NemesisAction("churn-crash", churn_crash, churn_crash_restart,
                          dwell_s=0.6, weight=1.5, check=churn_ok))
        churn_driver.start()
    if quiesce:
        # dwell past the store-lease expiry + randomized election spread
        # (~3x eto) so fail-over actually runs while the store is down
        eto_s = getattr(c, "election_timeout_ms", 400) / 1000.0
        actions.append(
            NemesisAction("store-kill-quiescent", quiescent_store_kill,
                          quiescent_store_restart,
                          dwell_s=max(2.5, 3.0 * eto_s), weight=1.5,
                          check=with_conf_check(None)))
    if topo is not None and geo:
        eto_s = getattr(c, "election_timeout_ms", 400) / 1000.0
        actions += [
            # dwell past fail-over so elections actually run ACROSS the
            # shaped WAN while a zone is dark
            NemesisAction("zone-partition", zone_partition, heal_topology,
                          dwell_s=max(1.2, 3.0 * eto_s), weight=1.5),
            NemesisAction("wan-degrade", wan_degrade, heal_topology,
                          dwell_s=1.0, weight=1.0),
            NemesisAction("link-flap", link_flap, heal_topology,
                          dwell_s=0.8, weight=1.0),
        ]
    if witness:
        # EVERY fault's post-heal probe also asserts witness safety
        for a in actions:
            a.check = with_witness_check(a.check)

    workers = [asyncio.ensure_future(worker(i)) for i in range(5)]
    try:
        await run_nemesis(actions, duration_s, rng,
                          on_tick=lambda n: say("  nemesis:", n))
        stop.set()
        if churn_driver is not None:
            await churn_driver.stop()
        await asyncio.gather(*workers)
        ops = h.ops()
        completed = sum(1 for o in ops if o.ret is not None)
        say(f"workload done: {len(ops)} ops ({completed} completed); "
            f"checking linearizability…")
        t0 = time.monotonic()
        rep = check_history(h)
        check_s = time.monotonic() - t0
        result = {
            "linearizable": rep.ok,
            "ops": len(ops),
            "completed": completed,
            "maybe_applied": len(ops) - completed,
            "faults": {a.name: a.applied for a in actions},
            "checker_s": round(check_s, 1),
        }
        if read_mix > 0:
            # targeted no-stale-read assertion (a read must observe
            # every write acked before it was issued) on top of the
            # full linearizability proof
            stale = check_stale_reads(ops, _seq_of)
            result["read_mix"] = read_mix
            result["read_from"] = read_from
            result["reads"] = sum(1 for o in ops if o.kind == "r")
            result["stale_reads"] = len(stale)
            if stale:
                result["linearizable"] = False
                result["stale_violations"] = stale[:5]
        # read-plane counters: store-wide confirm batching, per-batch
        # fence dedupe, lease vs SAFE vs forwarded serve counts, and
        # (when spread) the client's fan-out distribution
        read_plane: dict[str, int] = {}

        def _acc(d: dict) -> None:
            for k, v in d.items():
                read_plane[k] = read_plane.get(k, 0) + v

        for store in c.stores.values():
            if getattr(store, "read_batcher", None) is not None:
                _acc(store.read_batcher.counters())
            _acc({"kv_read_fences": store.kv_processor.read_fences,
                  "kv_fenced_reads": store.kv_processor.fenced_reads})
            for re_ in store._regions.values():
                node = re_.node
                if node is not None:
                    _acc(node.read_only_service.counters())
        if any(read_plane.values()):
            result["read_plane"] = read_plane
        # write-plane counters (ISSUE 15): store-wide append rounds +
        # ack-at-commit, live stores + everything retired by kill/restart
        write_plane: dict[str, int] = dict(
            (k, v) for k, v in c.retired_counters.items()
            if k.startswith("append_") or k == "fsm_eager_acked")
        for store in c.stores.values():
            ab = getattr(store, "append_batcher", None)
            if ab is not None:
                for k, v in ab.counters().items():
                    write_plane[k] = write_plane.get(k, 0) + v
            for re_ in store._regions.values():
                node = re_.node
                if node is not None:
                    write_plane["fsm_eager_acked"] = (
                        write_plane.get("fsm_eager_acked", 0)
                        + node.fsm_caller.eager_acked)
        if any(write_plane.values()):
            result["write_plane"] = write_plane
        if read_from != "leader":
            result["read_serves"] = dict(kv.read_serves)
        if chaos:
            injected: dict[str, int] = {}
            for cd in chaos.values():
                for k, v in cd.injected.items():
                    injected[k] = injected.get(k, 0) + v
            result["power_loss_crashes"] = sum(
                cd.crash_count for cd in chaos.values())
            result["storage_injections"] = injected
        if gray:
            # gray-failure plane: injection counts + the detection /
            # mitigation counters the acceptance criteria key on —
            # >0 evacuations proves the SICK score fired AND moved
            # leadership while the fault held
            slow_inj: dict[str, int] = {}
            for cd in chaos.values():
                for k, v in cd.slow_counts.items():
                    slow_inj[k] = slow_inj.get(k, 0) + v
            # live engines + everything retired by kill/restart: a
            # leader-kill landing on a store AFTER it evacuated must
            # not erase the evacuations from the run record
            rc = c.retired_counters
            evac = rc.get("evacuations", 0) \
                + sum(s.evacuations for s in c.stores.values())
            shed = rc.get("shed_items", 0) \
                + sum(s.kv_processor.shed_items
                      for s in c.stores.values())
            health_evals = rc.get("health_evaluations", 0) + sum(
                s.health.evaluations for s in c.stores.values()
                if s.health is not None)
            sick_rounds = rc.get("sick_rounds", 0) + sum(
                s.health.level_counts["sick"] for s in c.stores.values()
                if s.health is not None)
            result["gray"] = {
                "slow_injections": slow_inj,
                "health_evaluations": health_evals,
                "sick_rounds": sick_rounds,
                "evacuations": evac,
                "shed_items": shed,
            }
            # a long gray drive that never evacuated means detection or
            # mitigation is broken — fail the run, don't just log it
            result["gray_detection_ok"] = (evac > 0
                                           or duration_s < 120)
        if disk_pressure:
            # pressure-ladder counters: live stores + everything retired
            # by kill/restart (the gray retired-counter lesson), plus
            # the fault plane's own injection counts
            rc = c.retired_counters
            bsum: dict[str, int] = {}
            for s in c.stores.values():
                if s.disk_budget is not None:
                    for k, v in s.disk_budget.counters().items():
                        bsum[k] = bsum.get(k, 0) + v
            reclaims = rc.get("disk_reclaims", 0) \
                + sum(s.disk_reclaims for s in c.stores.values())
            sheds = rc.get("disk_shed_items", 0) \
                + sum(s.disk_shed_items for s in c.stores.values())
            resumes = rc.get("disk_pressure_resumes", 0) \
                + bsum.get("disk_pressure_resumes", 0)
            enospc_inj: dict[str, int] = {}
            for cd in chaos.values():
                for k, v in cd.enospc_counts.items():
                    enospc_inj[k] = enospc_inj.get(k, 0) + v
            result["disk"] = {
                "quota_bytes": _DISK_QUOTA_BYTES,
                "enospc_injections": enospc_inj,
                "enospc_observed": rc.get("disk_enospc_events", 0)
                + bsum.get("disk_enospc_events", 0),
                "near_full_rounds": rc.get("disk_near_full_rounds", 0)
                + bsum.get("disk_near_full_rounds", 0),
                "full_rounds": rc.get("disk_full_rounds", 0)
                + bsum.get("disk_full_rounds", 0),
                "reclaims": reclaims,
                "shed_writes": sheds,
                "resumes": resumes,
            }
            # acceptance gate: a long drive must show the WHOLE ladder
            # — >=1 pressure-triggered reclaim, >=1 FULL shed, and >=1
            # FULL->resume WITHOUT a restart — or the run fails
            result["disk_pressure_ok"] = (
                (reclaims > 0 and sheds > 0 and resumes > 0)
                or duration_s < 120)
        if clock_chaos:
            # clock plane: what the nemesis injected vs what the stores
            # detected (sentinel) and refused to serve on (fenced
            # leases + SAFE fallbacks) — live stores plus everything
            # retired by kill/restart (the gray retired-counter lesson)
            rc = c.retired_counters
            clock_inj: dict[str, int] = {}
            for ck in getattr(c, "clocks", {}).values():
                for k, v in ck.faults.items():
                    clock_inj[k] = clock_inj.get(k, 0) + v
            sent = {k: rc.get(k, 0)
                    for k in ("clock_skew_samples", "clock_anomalies",
                              "clock_lease_fenced")}
            for s in c.stores.values():
                for k, v in s.clock_sentinel.counters().items():
                    if k in sent:
                        sent[k] += v
            fallbacks = rc.get("lease_fallbacks", 0)
            for s in c.stores.values():
                for re_ in s._regions.values():
                    if re_.node is not None:
                        fallbacks += \
                            re_.node.read_only_service.lease_fallbacks
            result["clock"] = {
                "injections": clock_inj,
                **sent,
                "lease_fallbacks": fallbacks,
                "peer_skews": {ep: s.clock_sentinel.peers()
                               for ep, s in sorted(c.stores.items())},
            }
            # acceptance gate: with every clock broken on purpose past
            # the declared bound, at least one lease check must have
            # refused the fast path (sentinel fence) or fallen back to
            # a SAFE quorum round — a long drive where every lease
            # check still passed means the hardening never engaged
            result["clock_detection_ok"] = (
                sent["clock_lease_fenced"] + fallbacks > 0
                or duration_s < 120)
        if churn_driver is not None:
            result["membership"] = churn_driver.summary()
        # beat-plane + quiescence counters (HeartbeatHub.counters() via
        # each live store's NodeManager) — the soak stats line's view of
        # how much idle traffic hibernation actually removed
        hub_totals: dict[str, int] = {}
        for store in c.stores.values():
            for k, v in store.node_manager.heartbeat_hub.counters().items():
                hub_totals[k] = hub_totals.get(k, 0) + v
        if hub_totals:
            result["hub"] = hub_totals
        if quiesce:
            result["store_kills_while_quiescent"] = len(quiesce_kill_counts)
            result["quiescent_groups_at_kill"] = quiesce_kill_counts
        if topo is not None:
            result["geo_zones"] = geo
            result["topology"] = dict(topo.counters)
        if witness:
            await witness_safety_check()   # final sweep, aborts on breach
            result["witness_safe"] = True
            stripped = 0
            for node in witness_nodes():
                for i in range(node.log_manager.first_log_index(),
                               node.log_manager.last_log_index() + 1):
                    e = node.log_manager.get_entry(i)
                    assert e is None or e.data == b"" or e.type.value == 2, \
                        f"witness journaled a payload at index {i}"
                    stripped += 1
            result["witness_journal_entries_checked"] = stripped
        if not rep.ok:
            result["violation"] = str(rep)
        if dump_history and not rep.ok:
            import json as _json
            with open(dump_history, "w") as f:
                for o in ops:
                    f.write(_json.dumps({
                        "id": o.op_id, "client": o.client, "kind": o.kind,
                        "args": [a.hex() if isinstance(a, bytes) else a
                                 for a in o.args],
                        "invoke": o.invoke, "ret": o.ret,
                        "result": (o.result.hex()
                                   if isinstance(o.result, bytes)
                                   else o.result)}) + "\n")
            result["history_dump"] = dump_history
        if trace:
            from tpuraft_torch.util.trace import TRACER

            result["trace"] = TRACER.stats()
            result["trace_file"] = trace
            result["trace_spans"] = TRACER.export_chrome(trace)
        # flight recorder: a failing run carries the protocol-event
        # lead-up in its OWN report — no re-run with prints needed.
        # note_anomaly snapshots the ring so later teardown events
        # can't churn the incident context away.
        if not result["linearizable"] \
                or not result.get("gray_detection_ok", True) \
                or not result.get("disk_pressure_ok", True) \
                or not result.get("clock_detection_ok", True):
            from tpuraft_torch.util.trace import RECORDER

            RECORDER.note_anomaly(
                "soak_failure",
                ("oracle: " + result.get("violation", ""))[:200]
                if not result["linearizable"]
                else ("gray detection never fired"
                      if not result.get("gray_detection_ok", True)
                      else ("disk-pressure ladder never completed"
                            if not result.get("disk_pressure_ok", True)
                            else "clock hardening never engaged")))
            result["flight_recorder"] = RECORDER.dump(256)
            result["recorder_anomalies"] = [
                {"ts": a["ts"], "reason": a["reason"],
                 "detail": a["detail"]}
                for a in RECORDER.anomaly_report()]
        return result
    finally:
        # also on checker errors / cancellation: no leaked workers or
        # still-running stores
        stop.set()
        if churn_driver is not None:
            await churn_driver.stop()
        for w in workers:
            w.cancel()
        await asyncio.gather(*workers, return_exceptions=True)
        await kv.shutdown()
        for ep in list(c.stores):
            await c.stop_store(ep)
        ct = getattr(c, "_client_t", None)
        if ct is not None and hasattr(ct, "close"):
            await ct.close()
        # chaos uninstall happens in run_soak's outer finally (it must
        # cover startup failures before this block exists too)


async def run_hotspot_soak(duration_s: float, n_stores: int,
                           n_regions: int, seed: int, data_path: str,
                           verbose: bool) -> dict:
    """Zipfian-hotspot telemetry soak (fleet observability plane).

    Boots a REAL in-proc PD alongside the stores, drives a skewed
    workload (80% of ops into a 3-region hot set, the rest uniform),
    SHIFTS the hot set mid-run, and asserts the PD ClusterView's top-K
    identifies the new hot regions within 3 heartbeat rounds of the
    shift — the end-to-end accuracy contract for the heat plane
    (store intake -> EWMA fold -> noise-gated heartbeat rows -> PD
    stats -> cluster view)."""
    import os as _os

    from tpuraft_torch.rheakv.pd_client import RemotePlacementDriverClient
    from tpuraft_torch.rheakv.pd_server import (PlacementDriverOptions,
                                          PlacementDriverServer)

    rng = random.Random(seed)
    hb_ms = 500
    c = SoakCluster(n_stores, data_path, n_regions=n_regions,
                    pd_endpoint="127.0.0.1:7100",
                    heartbeat_interval_ms=hb_ms)

    def say(*a):
        if verbose:
            print(*a, flush=True)

    # PD first (single-node metadata group on the same fabric): stores
    # attach via heartbeats, the first batch full-syncs every region
    pd_ep = c.pd_endpoint
    server = RpcServer(pd_ep)
    c.net.bind(server)
    c.net.start_endpoint(pd_ep)
    pd_transport = InProcTransport(c.net, pd_ep)
    pd = PlacementDriverServer(
        PlacementDriverOptions(
            endpoints=[pd_ep], election_timeout_ms=300,
            data_path=_os.path.join(data_path, "pd")),
        pd_ep, server, pd_transport)
    await pd.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if pd.node is not None and pd.node.is_leader():
            break
        await asyncio.sleep(0.05)
    else:
        raise TimeoutError("PD never elected")

    for ep in c.endpoints:
        await c.start_store(ep)
    kv = RheaKVStore(FakePlacementDriverClient(
        [r.copy() for r in c.regions]), c.client_transport(),
        max_retries=1, jitter_seed=rng.randrange(1 << 30))
    await kv.start()
    pd_view = RemotePlacementDriverClient(
        InProcTransport(c.net, "hotspot-admin:0"), [pd_ep])

    hot_n = 3
    hot_a = sorted(rng.sample(range(n_regions), hot_n))
    hot_b = sorted(rng.sample(
        [r for r in range(n_regions) if r not in hot_a], hot_n))
    hot_now = list(hot_a)
    payload = b"h" * 64

    def hot_key() -> bytes:
        # region k+1 owns [k%06d, (k+1)%06d)
        if rng.random() < 0.8:
            k = rng.choice(hot_now)
        else:
            k = rng.randrange(n_regions)
        return b"k%06d/h%02d" % (k, rng.randrange(8))

    stop = asyncio.Event()
    ops = [0]
    errs = [0]

    async def driver() -> None:
        while not stop.is_set():
            key = hot_key()
            try:
                if rng.random() < 0.5:
                    await kv.put(key, payload)
                else:
                    await kv.get(key)
                ops[0] += 1
            except Exception:
                errs[0] += 1
            await asyncio.sleep(0.001)

    drivers = [asyncio.ensure_future(driver()) for _ in range(4)]
    half = max(4.0, duration_s / 2.0)
    await asyncio.sleep(half)

    # phase A sanity: the PD already ranks the current hot set on top
    view = await pd_view.cluster_describe(top_k=8)
    top_a = [r["region"] for r in (view or {}).get("hot", [])]
    phase_a_ok = all((k + 1) in top_a for k in hot_a)
    say(f"phase A top-K {top_a} (true {[k + 1 for k in hot_a]})")

    # the shift: re-aim the hot set, then count heartbeat rounds until
    # the view's top-K contains every NEW hot region
    hot_now[:] = hot_b
    true_b = [k + 1 for k in hot_b]
    detect_rounds = -1
    rounds_slept = 0
    top_b: list = []
    for rnd in range(1, 9):
        await asyncio.sleep(hb_ms / 1000.0)
        rounds_slept = rnd
        view = await pd_view.cluster_describe(top_k=8)
        top_b = [r["region"] for r in (view or {}).get("hot", [])]
        say(f"round {rnd}: top-K {top_b} (want {true_b})")
        if all(r in top_b for r in true_b):
            detect_rounds = rnd
            break
    # credit the rounds already slept, detected or not — a failing run
    # must not overshoot the requested duration
    await asyncio.sleep(max(0.0, duration_s - half - rounds_slept
                            * hb_ms / 1000.0))
    stop.set()
    for d in drivers:
        d.cancel()

    view = await pd_view.cluster_describe(top_k=8) or {}
    # the hot_region detector (the flight-recorder signal the split/
    # move policy will consume) must also have flagged the new hot set
    flag_ok = all(r in view.get("hot_flagged", []) for r in true_b)
    hotspot_ok = phase_a_ok and 0 < detect_rounds <= 3 and flag_ok
    result = {
        "mode": "hotspot",
        "duration_s": duration_s,
        "regions": n_regions,
        "stores": n_stores,
        "ops": ops[0],
        "errors": errs[0],
        "heartbeat_ms": hb_ms,
        "true_hot_a": [k + 1 for k in hot_a],
        "true_hot_b": true_b,
        "phase_a_topk_ok": phase_a_ok,
        "detect_rounds": detect_rounds,
        "hot_flag_ok": flag_ok,
        "pd_top_hot": top_b,
        "pd_hot_flagged": view.get("hot_flagged", []),
        "pd_heat_rows": pd.hb_heat_rows,
        "zone_rates": view.get("zone_rates", {}),
        "hotspot_ok": hotspot_ok,
        # the linearizability key so main()'s exit gate composes
        "linearizable": True,
    }
    await kv.shutdown()
    for ep in list(c.stores):
        await c.stop_store(ep)
    await pd.shutdown()
    return result


async def run_lifecycle_soak(duration_s: float, n_stores: int,
                             n_regions: int, seed: int, data_path: str,
                             verbose: bool, device: str = "cuda") -> dict:
    """Region-lifecycle soak (ISSUE 20): a lifecycle-enabled PD runs
    the full actuation loop against a live fleet under a SHIFTING
    zipfian hotspot.

    Exit gates: >0 heat-driven splits, >0 cold merges, >0 cross-store
    moves; the PD's region set still tiles the keyspace (the
    coverage oracle); the single-writer-per-key workload observed no
    lost ack / stale read through all the churn; and the post-shift
    cold keyspace hibernated (engine quiescence on idle groups).

    Stores 1..3 host every region initially and store 4 hosts none —
    the imbalance the move actuator must fix (add-learner -> catch up
    -> joint promote+remove onto the empty store)."""
    import os as _os

    from tpuraft_torch.rheakv.keyspace import coverage_errors
    from tpuraft_torch.rheakv.pd_client import RemotePlacementDriverClient
    from tpuraft_torch.rheakv.pd_server import (ClusterStatsManager,
                                          PlacementDriverOptions,
                                          PlacementDriverServer)

    rng = random.Random(seed)
    hb_ms = 300
    n_stores = max(4, n_stores)
    c = SoakCluster(n_stores, data_path, n_regions=n_regions,
                    engine=True, pd_endpoint="127.0.0.1:7200",
                    heartbeat_interval_ms=hb_ms,
                    quiesce_after_rounds=3, device=device)
    # heat splits mint groups mid-run: leave engine [G] headroom
    c.engine_group_cap = 1 << max(6, (n_regions * 2 + 8).bit_length())
    home = c.endpoints[:3]
    for r in c.regions:
        r.peers = list(home)   # store 4+: move destination only

    def say(*a):
        if verbose:
            print(*a, flush=True)

    pd_ep = c.pd_endpoint
    server = RpcServer(pd_ep)
    c.net.bind(server)
    c.net.start_endpoint(pd_ep)
    pd = PlacementDriverServer(
        PlacementDriverOptions(
            endpoints=[pd_ep], election_timeout_ms=300,
            data_path=_os.path.join(data_path, "pd"),
            lifecycle=True,
            lifecycle_heat_split_min_keys=16,
            lifecycle_merge_cooldown_s=1.0,
            # never merge under the regions the hot detector needs
            # reporting heat: below them no region is flagged, and no
            # heat split can follow
            lifecycle_min_regions=max(4, n_regions // 2,
                                      ClusterStatsManager.hot_min_population),
            lifecycle_move_cooldown_s=1.0,
            lifecycle_move_imbalance=2),
        pd_ep, server, InProcTransport(c.net, pd_ep))
    await pd.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if pd.node is not None and pd.node.is_leader():
            break
        await asyncio.sleep(0.05)
    else:
        raise TimeoutError("PD never elected")

    for ep in c.endpoints:
        await c.start_store(ep)
    kv = RheaKVStore(
        RemotePlacementDriverClient(
            InProcTransport(c.net, "lifecycle-pdc:0"), [pd_ep]),
        c.client_transport(), timeout_ms=4000, max_retries=12,
        jitter_seed=rng.randrange(1 << 30))
    await kv.start()

    # wait until the PD learned the whole fleet from heartbeats
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        # learned = the PD's regions tile the keyspace; a count of
        # n_regions races the PD's own cold merges, which may absorb a
        # region before the last one's leader reports
        if not coverage_errors(pd.fsm.regions.values()):
            break
        await asyncio.sleep(0.1)
    else:
        raise TimeoutError("PD never learned the initial region set")

    hot_n = min(3, max(1, n_regions // 4))
    hot_a = sorted(rng.sample(range(n_regions), hot_n))
    hot_b = sorted(rng.sample(
        [k for k in range(n_regions) if k not in hot_a], hot_n))
    hot_now = list(hot_a)

    # single-writer-per-key linearizability proxy: every key is owned
    # by ONE driver task; a read must never return a sequence older
    # than the last ACKED write (lost ack) nor a missing value after
    # one was acked (lost keyspace — the merge-bug signature)
    acked: dict = {}
    issued: dict = {}
    seqs: dict = {}
    violations: list = []
    ops = [0]
    errs = [0]
    stop = asyncio.Event()
    n_drivers = 3

    def _key(k: int, j: int) -> bytes:
        # region k+1 owns [k%06d, (k+1)%06d)
        return b"k%06d/%03d" % (k, j)

    async def driver(t: int) -> None:
        while not stop.is_set():
            if rng.random() < 0.85:
                k = rng.choice(hot_now)
                j = rng.randrange(64)
            else:
                k = rng.randrange(n_regions)
                j = rng.randrange(12)
            j = (j - j % n_drivers) + t     # task t owns its j-slice
            key = _key(k, j)
            try:
                if rng.random() < 0.55:
                    seq = seqs.get(key, 0) + 1
                    seqs[key] = seq
                    issued[key] = seq
                    if await kv.put(key, b"s%010d" % seq):
                        acked[key] = seq
                    ops[0] += 1
                else:
                    got = await kv.get(key)
                    floor = acked.get(key, -1)
                    if got is None:
                        if floor >= 0:
                            violations.append(
                                f"{key!r}: acked seq {floor} vanished")
                    else:
                        seen = int(got[1:])
                        if seen < floor:
                            violations.append(
                                f"{key!r}: read seq {seen} < acked "
                                f"{floor}")
                    ops[0] += 1
            except Exception:
                errs[0] += 1
            await asyncio.sleep(0.001)

    drivers = [asyncio.ensure_future(driver(t)) for t in range(n_drivers)]
    half = max(5.0, duration_s / 2.0)
    await asyncio.sleep(half)
    say(f"shift: hot {hot_a} -> {hot_b}; pd regions="
        f"{len(pd.fsm.regions)} splits={pd.heat_splits_ordered} "
        f"merges={pd.merges_completed} moves={pd.moves_ordered}")
    hot_now[:] = hot_b
    await asyncio.sleep(max(0.0, duration_s - half))
    stop.set()
    for d in drivers:
        d.cancel()

    # quiet tail: let in-flight merges finalize and idle groups (the
    # merged-away cold keyspace's survivors) hibernate
    await asyncio.sleep(max(3.0, hb_ms / 1000.0 * 6))
    moves_applied = sum(s.moves_applied for s in c.stores.values())
    merges_led = sum(s.merges_led for s in c.stores.values())
    occ = [s.tick_occupancy() for s in c.stores.values()]
    hibernated = sum(q for _, q in occ)
    coverage = coverage_errors(pd.fsm.regions.values())
    coverage_detail = {}
    if coverage:
        # PD-view corruption forensics: the PD's record (with epochs)
        # next to every store's live truth for the same ids, so a
        # stale-wide record is attributable to the exact epoch race
        coverage_detail["pd"] = {
            rid: [r.start_key.decode("latin1"), r.end_key.decode("latin1"),
                  r.epoch.version, r.epoch.conf_ver]
            for rid, r in sorted(pd.fsm.regions.items())}
        coverage_detail["stores"] = {
            ep: {e.region.id: [e.region.start_key.decode("latin1"),
                               e.region.end_key.decode("latin1"),
                               e.region.epoch.version,
                               e.region.epoch.conf_ver]
                 for e in s._regions.values()}
            for ep, s in c.stores.items()}
    view = await RemotePlacementDriverClient(
        InProcTransport(c.net, "lifecycle-adm:0"),
        [pd_ep]).cluster_describe(top_k=8) or {}
    lifecycle_ok = (
        pd.heat_splits_ordered > 0
        and pd.merges_completed > 0 and merges_led > 0
        and moves_applied > 0
        and not coverage
        and not violations)
    hibernate_ok = hibernated > 0
    result = {
        "mode": "lifecycle",
        "duration_s": duration_s,
        "regions_initial": n_regions,
        "regions_final": len(pd.fsm.regions),
        "stores": n_stores,
        "ops": ops[0],
        "errors": errs[0],
        "heartbeat_ms": hb_ms,
        "true_hot_a": [k + 1 for k in hot_a],
        "true_hot_b": [k + 1 for k in hot_b],
        "heat_splits_ordered": pd.heat_splits_ordered,
        "merges_ordered": pd.merges_ordered,
        "merges_completed": pd.merges_completed,
        "merges_led": merges_led,
        "moves_ordered": pd.moves_ordered,
        "moves_applied": moves_applied,
        "coverage_errors": coverage,
        "coverage_detail": coverage_detail,
        "lin_violations": violations[:8],
        "hibernated_replicas": hibernated,
        "hibernate_ok": hibernate_ok,
        "pd_lifecycle_view": view.get("lifecycle"),
        "lifecycle_ok": lifecycle_ok and hibernate_ok,
        "linearizable": not violations,
    }
    await kv.shutdown()
    for ep in list(c.stores):
        await c.stop_store(ep)
    await pd.shutdown()
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=30)
    ap.add_argument("--stores", type=int, default=3)
    ap.add_argument("--keys", type=int, default=6,
                    help="distinct keys (fewer = more contention; "
                         "checker cost grows with ops/key)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="",
                    help="durable state dir (default: a temp dir)")
    ap.add_argument("--transport", choices=["inproc", "native"],
                    default="inproc",
                    help="'native': C++ epoll sockets + C++ KV engines, "
                         "faults injected per-store")
    ap.add_argument("--lease-reads", action="store_true",
                    help="LEASE_BASED readIndex (no per-read quorum "
                         "round; assumes bounded clock drift)")
    ap.add_argument("--dump-history", default="",
                    help="on violation, write the full op history "
                         "(JSON lines) here for offline analysis")
    ap.add_argument("--regions", type=int, default=1,
                    help=">1: split the keyspace into this many raft "
                         "groups per store (in-proc fabric only) — the "
                         "G>=1K chaos configuration")
    ap.add_argument("--engine", action="store_true",
                    help="MultiRaftEngine protocol plane + multilog "
                         "journal per store (required reading at "
                         "region density)")
    ap.add_argument("--election-timeout-ms", type=int, default=400)
    ap.add_argument("--power-loss", action="store_true",
                    help="add power-loss crashes to the nemesis menu: "
                         "a store is killed at a random instant and "
                         "restarted from its durable-only on-disk image "
                         "(torn writes / lost fsyncs / bit flips in the "
                         "unsynced tails; tpuraft/storage/fault.py)")
    ap.add_argument("--churn", action="store_true",
                    help="continuous membership churn while faults fly: "
                         "add/remove voters, add/promote/remove "
                         "learners, leadership transfers — plus a "
                         "stage-trap nemesis action that lands seeded "
                         "crashes inside each joint-consensus stage "
                         "(catching_up / joint / stable); conf "
                         "invariants asserted after every fault")
    ap.add_argument("--quiesce", action="store_true",
                    help="enable group quiescence (hibernate-raft, "
                         "quiesce_after_rounds=4; requires --engine) and "
                         "add a store-kill-while-quiescent nemesis "
                         "action: a store leading quiescent groups is "
                         "killed, and its dependents must elect via "
                         "store-lease expiry within the normal "
                         "fault-detection envelope")
    ap.add_argument("--geo", type=int, default=0, metavar="ZONES",
                    help="geo scenario: tag stores round-robin into this "
                         "many zones and shape every link through a "
                         "seeded NetworkTopology (asymmetric WAN latency "
                         "+ jitter + loss); adds zone-partition, "
                         "wan-degrade and link-flap to the nemesis menu")
    ap.add_argument("--witness", action="store_true",
                    help="(with --geo) the last store joins every region "
                         "as a WITNESS: votes + metadata-only journal, "
                         "never leads; witness safety (never leader, "
                         "never a ballot window, no payload journaled) "
                         "is asserted after every fault")
    ap.add_argument("--gray", action="store_true",
                    help="gray-failure (fail-slow) nemesis menu: "
                         "disk-stall, slow-store, stalled-fsync and "
                         "slow-endpoint faults — the victim stays "
                         "'alive' while limping; store health scoring "
                         "must detect it and evacuate leadership "
                         "(in-proc fabric, no --engine)")
    ap.add_argument("--disk-pressure", action="store_true",
                    help="capacity-fault nemesis menu: every store runs "
                         "under a standing ChaosDir byte quota (matched "
                         "by its DiskBudget ceiling), plus quota-shrink "
                         "and seeded-ENOSPC-burst faults; the pressure "
                         "ladder must reclaim at NEAR_FULL, shed writes "
                         "retryably at FULL (reads keep serving), and "
                         "resume after reclaim without a restart "
                         "(in-proc fabric, no --engine)")
    ap.add_argument("--clock-chaos", action="store_true",
                    help="time-chaos nemesis menu: every store runs on "
                         "its own injected ChaosClock (survives "
                         "restarts) with seeded drift / forward-jump / "
                         "freeze faults plus a targeted leader-fast "
                         "fault, composed with leader kills and "
                         "partitions; stores declare a 5%% drift bound "
                         "and the run fails unless the shrunk lease "
                         "window / clock sentinel forced at least one "
                         "clock-independent serve (in-proc fabric, no "
                         "--engine); combine with --lease-reads "
                         "--read-mix for the stale-read oracle")
    ap.add_argument("--kv-batching", action="store_true",
                    help="drive load through the batching client: ops "
                         "coalesce into store-grouped kv_command_batch "
                         "RPCs; linearizability is checked per op as "
                         "usual (batched items ack/apply atomically)")
    ap.add_argument("--write-burst", action="store_true",
                    help="write-heavy load shape (ISSUE 15): each worker "
                         "issues bursts of 4 concurrent puts (~10%% "
                         "reads) so the store-wide append rounds + "
                         "ack-at-commit pipeline run saturated under "
                         "the nemesis menu; write-plane counters land "
                         "in the report")
    ap.add_argument("--read-mix", type=float, default=0.0, metavar="FRAC",
                    help="read-dominant workload: reads with this "
                         "probability (e.g. 0.95), writes carry per-key "
                         "monotone sequence values (one writer per key) "
                         "so the checker additionally asserts NO STALE "
                         "READ — a read must observe every write acked "
                         "before it was issued — under the full nemesis "
                         "menu")
    ap.add_argument("--read-from",
                    choices=["leader", "follower", "learner", "any"],
                    default="leader",
                    help="route GETs to this replica class (client "
                         "read fan-out; follower/learner serve locally "
                         "after a forwarded-ReadIndex fence)")
    ap.add_argument("--trace", default="",
                    help="enable sampled product tracing (5%% of ops) "
                         "and export a perfetto-loadable Chrome trace "
                         "JSON to this path at the end")
    ap.add_argument("--hotspot", action="store_true",
                    help="zipfian-hotspot telemetry soak: real in-proc "
                         "PD, skewed load with a mid-run hot-set "
                         "shift; asserts the PD ClusterView top-K "
                         "identifies the new hot regions within 3 "
                         "heartbeat rounds (fleet observability)")
    ap.add_argument("--lifecycle", action="store_true",
                    help="region-lifecycle soak: lifecycle-enabled PD "
                         "(heat splits + cold merges + cross-store "
                         "moves) under a shifting zipfian hotspot; "
                         "gates on >0 of each actuation, keyspace "
                         "coverage, per-key linearizability and cold-"
                         "group hibernation")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    data = args.data or tempfile.mkdtemp(prefix="tpuraft-soak-")
    if args.lifecycle:
        import json

        n_regions = args.regions if args.regions > 1 else 12
        result = asyncio.run(run_lifecycle_soak(
            args.duration, args.stores, n_regions, args.seed, data,
            args.verbose))
        print(json.dumps(result))
        raise SystemExit(0 if result["lifecycle_ok"] else 1)
    if args.hotspot:
        import json

        n_regions = args.regions if args.regions > 1 else 24
        result = asyncio.run(run_hotspot_soak(
            args.duration, args.stores, n_regions, args.seed, data,
            args.verbose))
        print(json.dumps(result))
        raise SystemExit(0 if result["hotspot_ok"] else 1)
    result = asyncio.run(run_soak(args.duration, args.stores, args.keys,
                                  args.seed, data, args.verbose,
                                  transport=args.transport,
                                  dump_history=args.dump_history,
                                  lease_reads=args.lease_reads,
                                  n_regions=args.regions,
                                  engine=args.engine,
                                  election_timeout_ms=args.election_timeout_ms,
                                  power_loss=args.power_loss,
                                  churn=args.churn,
                                  quiesce=args.quiesce,
                                  kv_batching=args.kv_batching,
                                  geo=args.geo,
                                  witness=args.witness,
                                  read_mix=args.read_mix,
                                  read_from=args.read_from,
                                  gray=args.gray,
                                  write_burst=args.write_burst,
                                  disk_pressure=args.disk_pressure,
                                  clock_chaos=args.clock_chaos,
                                  trace=args.trace))
    import json

    print(json.dumps(result))
    ok = result["linearizable"] \
        and result.get("gray_detection_ok", True) \
        and result.get("disk_pressure_ok", True) \
        and result.get("clock_detection_ok", True)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
