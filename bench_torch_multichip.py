#!/usr/bin/env python3
"""Mesh-mode engine ladder of the port: one MultiRaftEngine whose [G]
lanes are sharded over N devices, driven with every protocol lane
active; and the single-device tick-rate shape.  The counterpart of
``bench_multichip.py``.

    python3 bench_torch_multichip.py --smoke         # 1,024 groups, 8 shards
    python3 bench_torch_multichip.py --scale         # 65,536 groups, 8 shards
    python3 bench_torch_multichip.py --engine-shape  # 1,024 groups, 1 card
    python3 bench_torch_multichip.py --cpu ...       # on the CPU

``--smoke`` and ``--scale`` boot one engine over ``--devices`` shards
(each its own card where the machine has that many, else all on
``cuda:0``; ``--cpu`` gives N logical CPU shards) and drive it with stub
controls that count the handler deliveries the tick schedules: the
witness commit clamp on adversarial rows, the stepdown, read-fence and
election lanes.  They assert every lane, that each engine tick is one
fused-tick launch a shard and each deadline fold (one a round, as the
engine's loop folds) one fold launch a shard and equal to the host scan.

``--engine-shape`` starts one engine of G groups (P = 4, half leaders)
on ``cuda:0``, lays the reference's standing state into it and runs
``tick_once`` in a tight loop: the best of three engines' ticks/s, each
engine's launches equal to its ticks.

Each mode prints one ``RESULT {...}`` line and merges its record into
``--out`` (default ``chiprun_out/bench_torch_multichip.json``) under its
mode's name; it exits non-zero when a check fails.  Without a card and
without ``--cpu`` it exits with the engine's own CUDA device error.
"""

import argparse
import asyncio
import json
import os
import resource
import sys
import time

from bench_torch_scale import device_record, write_out

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench_torch_multichip.json")


# ---------------------------------------------------------------------------
# stub control plane: counts what the tick delivers, owns nothing else
# ---------------------------------------------------------------------------

class StubReplicators:
    def all(self):
        return []


class StubNode:
    """The handlers the tick schedules, by reference; never run."""

    replicators = StubReplicators()

    def is_leader(self):
        return True

    def _check_dead_nodes(self):
        pass

    def _on_election_due(self):
        pass

    def _on_engine_elected(self):
        pass

    def _on_engine_quorum_dead(self):
        pass

    def _on_snapshot_due(self):
        pass


class StubCtrl:
    """An EngineControl stand-in: the surface the engine's apply pass
    touches, counting the deliveries it schedules."""

    def __init__(self, engine, slot: int, counts: dict):
        self.engine, self.slot, self.counts = engine, slot, counts
        self.node = StubNode()

    def _adopt_eto(self, eff_eto_ms: int) -> None:
        pass

    def push_election_deadline(self, now_ms=None) -> None:
        e = self.engine
        now = e.now_ms() if now_ms is None else now_ms
        e.elect_deadline[self.slot] = now + int(e.eto_ms[self.slot])

    def schedule(self, name: str, handler) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def maybe_quiesce(self, now: int) -> None:
        pass

    def wake_from_quiescence(self, reason: str = "activity", *a, **kw):
        pass


class StubFence:
    __slots__ = ("done",)

    def __init__(self):
        self.done = False

    def note_quorum(self):
        self.done = True


def mesh_devices(cpu: bool, n: int) -> list:
    """N shard devices: each its own card where the machine has N, else
    N shards sharing cuda:0 (named in the list: the engine never picks a
    shared card itself); N logical CPU shards with ``cpu``."""
    if cpu:
        return ["cpu"] * n
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def host_next_deadline(e) -> int:
    """MultiRaftEngine._next_deadline's host scan, on the engine's rows."""
    hc = e.has_ctrl & ~e.quiescent
    ec, ld = hc & (e.role <= 1), hc & (e.role == 2)
    nxt = 1 << 60
    if ec.any():
        nxt = min(nxt, int(e.elect_deadline[ec].min()))
    if ld.any():
        nxt = min(nxt, int(e.hb_deadline[ld].min()),
                  int(e.stepdown_deadline[ld].min()))
    return nxt


# ---------------------------------------------------------------------------
# mesh-mode drive (smoke + scale)
# ---------------------------------------------------------------------------

async def drive_mesh(groups: int, devices: list, duration_s: float,
                     seed: int) -> dict:
    import numpy as np

    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import ROLE_FOLLOWER, MultiRaftEngine
    from tpuraft_torch.ops import deadline_fold, tick
    from tpuraft_torch.options import TickOptions

    n = len(devices)
    rng = np.random.default_rng(seed)
    tick.LAUNCHES = deadline_fold.LAUNCHES = 0  # the run's counts
    eng = MultiRaftEngine(TickOptions(
        max_groups=groups, max_peers=4, mesh_devices=n, device=devices,
        tick_interval_ms=20, eager_commit=False,
        density_aware_timeouts=False))
    t_boot = time.monotonic()
    await eng.start()
    if n > 1 and eng._deadline_fold is None:
        raise RuntimeError("mesh mode did not engage")
    fold_calls = [0]
    fold = eng._deadline_fold
    if fold is not None:
        def counted(*rows):
            fold_calls[0] += 1
            return fold(*rows)

        eng._deadline_fold = counted

    G = eng.G
    factory = eng.ballot_box_factory()
    counts: dict = {}
    commits = [0]
    confs = {
        # 3 data voters: the witness-free steady state
        "data": Configuration.parse(
            "10.0.0.1:80,10.0.0.2:80,10.0.0.3:80"),
        # 2 data + 1 witness: the geo shape (one copy + one metadata ack
        # commits)
        "witness": Configuration.parse(
            "10.0.0.1:80,10.0.0.2:80,10.0.0.3:80/witness"),
        # witness-majority rows: refused as a conf node-side, but the
        # degenerate state the commit clamp guards against
        "probe": Configuration.parse(
            "10.0.0.1:80,10.0.0.2:80/witness,10.0.0.3:80/witness"),
    }
    self_peer = confs["data"].peers[0]
    empty = Configuration()

    boxes = []
    kinds = np.zeros(G, dtype=np.int8)   # 0=data 1=witness 2=probe
    for s in range(G):
        box = factory(lambda idx, _c=commits: _c.__setitem__(
            0, _c[0] + 1))
        # probe slots on EVEN slots, the leader half: the clamp check
        # then measures committing groups
        kind = "probe" if s % 64 == 62 else (
            "witness" if s % 4 == 3 else "data")
        kinds[s] = {"data": 0, "witness": 1, "probe": 2}[kind]
        box.update_conf(confs[kind], empty)
        eng.register_ctrl(StubCtrl(eng, s, counts), self_peer,
                          eto_ms=500, hb_ms=100, lease_ms=450)
        boxes.append(box)

    now = eng.now_ms()
    leaders = np.arange(G) % 2 == 0
    L = np.nonzero(leaders)[0]
    for s in L:
        boxes[s].reset_pending_index(1)
    eng.role[~leaders] = ROLE_FOLLOWER
    # the election lane: a seeded sample of followers falls due in the
    # window, everyone else far out
    eng.elect_deadline[:] = now + 3_600_000
    sample = rng.choice(np.nonzero(~leaders)[0],
                        size=min(64, int((~leaders).sum())), replace=False)
    eng.elect_deadline[sample] = now + 50
    # the stubs have no replicators to beat: park the hb lane
    eng.hb_deadline[:] = now + 3_600_000
    # the stepdown lane: first fires staggered over half an eto
    eng.stepdown_deadline[:] = now + rng.integers(1, 250, G)
    boot_s = time.monotonic() - t_boot

    # probe slots: the data column at 3, the witness columns at 9; the
    # unclamped quorum says 9, the clamp must pin 3
    probe = kinds == 2
    Pn = np.nonzero(probe)[0]
    lead_probe = probe & leaders
    eng.match_abs[np.ix_(Pn, [1, 2])] = 9
    eng.match_abs[Pn, 0] = 3

    t0 = time.monotonic()
    rounds = 0
    fold_mismatch = []
    drive = L[~probe[L]]
    while time.monotonic() - t0 < duration_s:
        rounds += 1
        now = eng.now_ms()
        # fresh voter acks for every leader (columns 0..2 are the voters)
        eng.last_ack[np.ix_(L, [0, 1, 2])] = now
        # the replicated tail: self and one follower move, the second
        # follower lags a round
        eng.match_abs[np.ix_(drive, [0, 1])] = rounds
        eng.match_abs[drive, 2] = max(0, rounds - 1)
        # a read-fence wave on a rotating slice of leaders
        for s in L[(rounds % 8)::16][:256]:
            eng.arm_read_fence(int(s), StubFence())
        eng.tick_once()
        # the engine's loop folds once an iteration: so does the drive
        nxt = eng._next_deadline()
        if nxt != host_next_deadline(eng):
            fold_mismatch.append(rounds)
    elapsed = time.monotonic() - t0
    # one settle tick so the last fence wave sees a covering q_ack
    eng.last_ack[np.ix_(L, [0, 1, 2])] = eng.now_ms()
    eng.tick_once()
    await eng.shutdown()
    launches, fold_launches = tick.LAUNCHES, deadline_fold.LAUNCHES

    # the witness clamp: every probe leader's commit at the best data
    # match (3), never the unclamped quorum (9)
    probe_commits = eng.commit_abs[lead_probe]
    clamp_ok = bool((probe_commits <= 3).all())
    clamp_engaged = bool((probe_commits == 3).all())
    # plain witness groups commit through the clamp lane
    wit_lead = (kinds == 1) & leaders
    wit_commit_ok = bool((eng.commit_abs[wit_lead] >= rounds - 1).all())
    stats = eng.lane_stats()
    hist = eng.tick_histograms()
    on_card = any(str(d).startswith("cuda") for d in devices)
    res = {
        "groups": G,
        "peers": 4,
        "mesh_devices": n,
        "devices": [str(d) for d in eng._mesh],
        "platform": "cuda" if on_card else "cpu",
        "boot_s": round(boot_s, 1),
        "duration_s": round(elapsed, 2),
        "ticks": eng.ticks,
        "ticks_per_sec": round(eng.ticks / elapsed, 1),
        "drive_rounds": rounds,
        "commits": commits[0],
        "commits_per_sec": round(commits[0] / elapsed, 1),
        "witness_groups": stats["witness_groups"],
        "witness_commit_ok": wit_commit_ok,
        "clamp_probe_groups": int(lead_probe.sum()),
        "clamp_held": clamp_ok,
        "clamp_engaged": clamp_engaged,
        "stepdown_ticks": stats["stepdown_ticks"],
        "stepdown_handler_calls": counts.get("stepdown_tick", 0),
        "election_due_handled": counts.get("election_due", 0),
        "fence_armed": stats["fence_lane_armed"],
        "fence_resolved": stats["fence_lane_resolves"],
        "fences_pending": stats["fences_pending"],
        "fused_tick_launches": launches,
        "fold_calls": fold_calls[0],
        "fold_launches": fold_launches,
        "tick_device_ms_p50": hist["tick_device_ms"]["p50"],
        "tick_device_ms_p99": hist["tick_device_ms"]["p99"],
        "tick_total_ms_p50": hist["tick_total_ms"]["p50"],
        "tick_total_ms_p99": hist["tick_total_ms"]["p99"],
        "rss_mb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
    }
    failures = []
    if not int(lead_probe.sum()):
        failures.append("no clamp probe groups on the leader half")
    if not clamp_ok:
        failures.append(
            f"witness clamp BREACHED: probe commits {probe_commits[:8]}")
    if not clamp_engaged:
        failures.append("witness clamp never engaged on probe rows")
    if not wit_commit_ok:
        failures.append("witness-conf groups failed to commit")
    if res["stepdown_ticks"] <= 0 or res["stepdown_handler_calls"] <= 0:
        failures.append("stepdown/priority lane never fired")
    if res["fence_resolved"] <= 0:
        failures.append("device fence lane never resolved a round")
    if res["fences_pending"] != 0:
        failures.append(f"{res['fences_pending']} fences left pending")
    if res["election_due_handled"] <= 0:
        failures.append("election lane never delivered")
    if commits[0] <= 0:
        failures.append("no commits advanced through the device tick")
    if fold_mismatch:
        failures.append(f"the fold differs from the host scan in rounds "
                        f"{fold_mismatch[:5]}")
    if on_card:
        if launches != eng.ticks * n:
            failures.append(f"{eng.ticks} engine ticks made {launches} "
                            f"fused-tick launches ({n} each expected)")
        if fold_launches != fold_calls[0] * (n if n > 1 else 0):
            failures.append(f"{fold_calls[0]} folds made {fold_launches} "
                            f"fold launches ({n} each expected)")
    res["ok"] = not failures
    res["failures"] = failures
    return res


# ---------------------------------------------------------------------------
# --engine-shape: the single-device tick rate
# ---------------------------------------------------------------------------

def standing_state(eng, seed: int) -> None:
    """The reference's standing state (``bench_multichip.py``'s
    engine-shape): half leaders, half followers, 3 voters, no controls
    (the tick plane alone), a fresh quorum, every deadline far out, and
    seeded matches."""
    import numpy as np

    from tpuraft_torch.core.engine import ROLE_FOLLOWER, ROLE_LEADER

    rng = np.random.default_rng(seed)
    g = eng.G
    now = eng.now_ms()
    eng.role[:] = np.where(np.arange(g) % 2 == 0, ROLE_LEADER,
                           ROLE_FOLLOWER)
    eng.voter_mask[:, :3] = True
    eng.self_col[:] = 0
    eng.has_ctrl[:] = False
    eng.last_ack[:, :3] = now
    eng.elect_deadline[:] = now + 3_600_000
    eng.hb_deadline[:] = now + 3_600_000
    eng.stepdown_deadline[:] = now + 3_600_000
    eng.match_abs[:, :3] = rng.integers(1, 50, size=(g, 3))
    eng.pending_rel[:] = 1


async def engine_shape_once(groups: int, peers: int, duration_s: float,
                            seed: int, device: str) -> dict:
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.ops import tick
    from tpuraft_torch.options import TickOptions

    tick.LAUNCHES = 0  # this engine's launches, its warm tick included
    eng = MultiRaftEngine(TickOptions(max_groups=groups, max_peers=peers,
                                      tick_interval_ms=20, device=device))
    # the port's engine ticks only once started on its device: the tight
    # loop below never yields, so the engine's own loop does not run
    await eng.start()
    standing_state(eng, seed)
    t0 = time.perf_counter()
    ticks = 0
    while time.perf_counter() - t0 < duration_s:
        eng.tick_once()
        ticks += 1
    rate = ticks / (time.perf_counter() - t0)
    await eng.shutdown()
    hist = eng.tick_histograms()
    return {"ticks_per_sec": rate, "ticks": eng.ticks,
            "fused_tick_launches": tick.LAUNCHES,
            "tick_device_ms_p50": hist["tick_device_ms"]["p50"],
            "tick_device_ms_p99": hist["tick_device_ms"]["p99"],
            "tick_total_ms_p50": hist["tick_total_ms"]["p50"],
            "tick_total_ms_p99": hist["tick_total_ms"]["p99"]}


def run_engine_shape(args) -> int:
    groups = args.groups or 1024
    device = "cpu" if args.cpu else "cuda:0"
    runs = [asyncio.run(engine_shape_once(groups, 4, args.duration or 2.0,
                                          args.seed, device))
            for _ in range(3)]
    card = device_record(args)["card"]  # after the engines: their error
    want = [0 if args.cpu else r["ticks"] for r in runs]
    ok = [r["fused_tick_launches"] for r in runs] == want
    res = {"engine_ticks_per_sec": round(max(r["ticks_per_sec"]
                                             for r in runs), 1),
           "groups": groups, "device": device, "card": card,
           "runs": runs, "ok": ok}
    print("RESULT " + json.dumps(res), flush=True)
    write_out(args.out, {"engine_shape": res})
    if not ok:
        print("FAIL: fused-tick launches differ from engine ticks: "
              f"{[r['fused_tick_launches'] for r in runs]} for "
              f"{[r['ticks'] for r in runs]}", file=sys.stderr)
        return 1
    return 0


def run_mesh(args) -> int:
    groups = args.groups or (1024 if args.smoke else 65536)
    duration = args.duration or (1.5 if args.smoke else 6.0)
    devices = mesh_devices(args.cpu, args.devices)
    res = asyncio.run(drive_mesh(groups, devices, duration, args.seed))
    res["card"] = device_record(args)["card"]  # after the engine's error
    mode = "smoke" if args.smoke else "scale"
    print("RESULT " + json.dumps(res), flush=True)
    write_out(args.out, {mode: res})
    if not res["ok"]:
        print("FAIL: " + "; ".join(res["failures"]), file=sys.stderr)
        return 1
    print(f"multichip {mode} OK: {res['groups']} groups / "
          f"{res['mesh_devices']} shards, {res['ticks_per_sec']} ticks/s",
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--smoke", action="store_true",
                      help="1,024 groups over the shards, every lane "
                           "asserted")
    mode.add_argument("--scale", action="store_true",
                      help="65,536 groups over the shards, every lane "
                           "asserted")
    mode.add_argument("--engine-shape", action="store_true",
                      help="the single-device tick rate")
    ap.add_argument("--cpu", action="store_true",
                    help="shards (or the engine) on the CPU: the plain "
                         "tick, no device figure")
    ap.add_argument("--groups", type=int, default=0,
                    help="override G (default: 1024 smoke and engine "
                         "shape, 65536 scale)")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--duration", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (never a committed file)")
    args = ap.parse_args()
    if args.engine_shape:
        return run_engine_shape(args)
    return run_mesh(args)


if __name__ == "__main__":
    sys.exit(main())
