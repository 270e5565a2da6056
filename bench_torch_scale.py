#!/usr/bin/env python3
"""Scale ladder of the port's protocol plane on one CUDA card: 1K, 4K
and 16K raft groups per process under a paced write load, the
counterpart of ``bench_scale.py``.

    python3 bench_torch_scale.py [--rungs 1024,4096,16384] [--out FILE]
    python3 bench_torch_scale.py --idle-probe [--rungs 4096]
    python3 bench_torch_scale.py --cpu ...      # the engines on the CPU

One process hosts the R replica endpoints of every group (in-process
RPC), each endpoint with its own ``MultiRaftEngine`` (P = 4, 20 ms
tick) on ``cuda:0`` and its own ``multilog://`` journal (a real fsync
every append round).  Leadership spreads by election priority; the
elections are held through boot, then released over a spread; each
group's writes are paced so the rung measures capacity, not collapse.
Every engine tick is one fused-tick launch on the card: each rung
counts its engines' launches against their ticks and fails when they
differ.

Each rung runs in a fresh subprocess and ends in one ``RESULT {...}``
row: every key of the reference's row, and the device, the card's name
and power limit, each engine's ticks, launches and ``tick_device_ms`` /
``tick_total_ms`` p50 and p99.  ``--idle-probe`` measures the idle beat
plane at ``--rungs[0]`` with quiescence off, then on.  The parent
prints each row and writes them to ``--out`` (default
``chiprun_out/bench_torch_scale.json``), and exits non-zero if a rung
failed.  Without a card and without ``--cpu`` it exits with the
engine's own "no CUDA device" error.
"""

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench_torch_scale.json")
# after the drive, how long every replica may take to apply the
# acknowledged writes before applied_total is read
APPLY_SETTLE_S = 10.0


def count_launches(engine, counts: dict) -> None:
    """Count the fused-tick launches of one engine's ticks in
    ``counts["launches"]``: the engines of a process share one event
    loop, so each tick's launches are the module counter's rise across
    it.  Installed before ``start()``, so the warm tick counts too."""
    from tpuraft_torch.ops import tick

    counts["launches"] = 0
    inner = engine.tick_once

    def tick_once():
        before = tick.LAUNCHES
        try:
            return inner()
        finally:
            counts["launches"] += tick.LAUNCHES - before

    engine.tick_once = tick_once


def engine_record(engines, counts) -> dict:
    """Each engine's ticks, fused-tick launches and tick times."""
    hists = [e.tick_histograms() for e in engines]
    return {
        "ticks_by_engine": [e.ticks for e in engines],
        "fused_tick_launches": [c["launches"] for c in counts],
        "tick_device_ms_p50": [h["tick_device_ms"]["p50"] for h in hists],
        "tick_device_ms_p99": [h["tick_device_ms"]["p99"] for h in hists],
        "tick_total_ms_p50": [h["tick_total_ms"]["p50"] for h in hists],
        "tick_total_ms_p99": [h["tick_total_ms"]["p99"] for h in hists],
    }


def launches_ok(args, row: dict) -> bool:
    """On the card every engine tick is one fused-tick launch; on the
    CPU the plain tick launches nothing."""
    want = [0] * len(row["ticks_by_engine"]) if args.cpu \
        else row["ticks_by_engine"]
    return row["fused_tick_launches"] == want


def device_record(args) -> dict:
    """The engines' device and the card's name and power limit."""
    if args.cpu:
        return {"device": "cpu", "card": None}
    import torch

    from bench_torch_plane import card_record

    return {"device": "cuda:0", "card": card_record(torch)}


async def probe_engine(args) -> None:
    """Start one small engine on the device and stop it: builds and
    loads the kernel library once before any child starts (and raises
    the engine's own error where the device does not exist)."""
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.options import TickOptions

    eng = MultiRaftEngine(TickOptions(
        max_groups=16, max_peers=4, device="cpu" if args.cpu else "cuda:0"))
    await eng.start()
    await eng.shutdown()


async def run_rung(args) -> dict:
    import random
    import resource

    import numpy as np

    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.core.node import Node
    from tpuraft_torch.core.node_manager import NodeManager
    from tpuraft_torch.core.state_machine import StateMachine
    from tpuraft_torch.entity import PeerId, Task
    from tpuraft_torch.ops.tick import ROLE_LEADER
    from tpuraft_torch.options import NodeOptions, TickOptions
    from tpuraft_torch.rpc.transport import (InProcNetwork, InProcTransport,
                                             RpcServer)

    G, R = args.groups, args.replicas
    device = "cpu" if args.cpu else "cuda:0"
    net = InProcNetwork()
    eps = [PeerId.parse(f"127.0.0.1:{7800 + i}") for i in range(R)]

    class CountFSM(StateMachine):
        applied = 0

        async def on_apply(self, it):
            while it.valid():
                CountFSM.applied += 1
                it.next()

    cap = 1 << max(4, (G + 3).bit_length())
    engines, counts, factories, managers, transports = [], [], [], [], []
    for ep in eps:
        server = RpcServer(ep.endpoint)
        manager = NodeManager(server)
        net.bind(server)
        engine = MultiRaftEngine(TickOptions(
            max_groups=cap, max_peers=4, tick_interval_ms=20,
            device=device))
        counts.append({})
        count_launches(engine, counts[-1])
        await engine.start()
        engines.append(engine)
        factories.append(engine.ballot_box_factory())
        managers.append(manager)
        transports.append(InProcTransport(net, ep.endpoint))
    dev = device_record(args)  # after the engines: their error comes first

    t_boot = time.monotonic()
    nodes: list[list[Node]] = [[] for _ in range(R)]

    async def boot_group(k: int) -> None:
        gid = f"g{k}"
        peers = [PeerId(ep.ip, ep.port, 0, 100 if k % R == i else 10)
                 for i, ep in enumerate(eps)]
        for i in range(R):
            opts = NodeOptions(
                election_timeout_ms=args.election_timeout_ms,
                initial_conf=Configuration(list(peers)),
                fsm=CountFSM(),
                log_uri=f"multilog://{args.dir}/store{i}/mlog#{gid}",
                raft_meta_uri=(
                    f"multimeta://{args.dir}/store{i}/meta#{gid}"
                    if args.meta == "multimeta" else "memory://"),
                enable_metrics=False)
            opts.raft_options.quiesce_after_rounds = args.quiesce
            node = Node(gid, peers[i], opts, transports[i],
                        ballot_box_factory=factories[i])
            node.node_manager = managers[i]
            managers[i].add(node)
            if not await node.init():
                raise RuntimeError(f"init failed {gid}@{i}")
            # hold this group's first election past the boot: the booted
            # groups' elections and beats would slow the remaining inits
            eng = engines[i]
            eng.elect_deadline[node._ctrl.slot] = eng.now_ms() + 3_600_000
            nodes[i].append(node)

    # inits in bounded concurrent batches
    boot_batch = 256
    for k0 in range(0, G, boot_batch):
        await asyncio.gather(*(boot_group(k)
                               for k in range(k0, min(G, k0 + boot_batch))))
    # release the held elections, jittered over the spread (default four
    # election timeouts); the device tick's election_due mask fires them
    rng = np.random.default_rng(0)
    spread_ms = (int(float(args.elect_spread_s) * 1000)
                 or 4 * args.election_timeout_ms)
    for eng in engines:
        now = eng.now_ms()
        jit = rng.integers(0, spread_ms, eng.G)
        eng.elect_deadline[:] = now + args.election_timeout_ms // 4 + jit
        eng.mark_dirty()
    boot_s = time.monotonic() - t_boot

    # leadership by priority: wait for --converge of the groups
    deadline = time.monotonic() + 120 + G * 0.05
    led: list[Node] = []
    last_print = 0.0
    while time.monotonic() < deadline:
        led = [n for row in nodes for n in row if n.is_leader()]
        if len(led) >= int(G * args.converge):
            break
        if time.monotonic() - last_print > 15:
            last_print = time.monotonic()
            print(f"PROGRESS leaders={len(led)}/{G} "
                  f"t={time.monotonic() - t_boot - boot_s:.0f}s",
                  flush=True)
        await asyncio.sleep(0.5)
    elect_s = time.monotonic() - t_boot - boot_s

    def eff_eto_ms() -> int:
        return int(max(int(e.eto_ms[e.has_ctrl].max())
                       for e in engines if e.has_ctrl.any()))

    def rss_mb() -> float:
        return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                     / 1024, 1)

    if args.idle_window > 0:
        # the idle beat plane: one committed write a group puts every
        # group at a fully matched tail, quiescence (if on) takes hold,
        # then the hubs' RPC counters are read over a quiet window
        async def seed(node: Node) -> None:
            fut = asyncio.get_running_loop().create_future()

            def done_cb(st, fut=fut):
                if not fut.done():
                    fut.set_result(st)

            await node.apply(Task(data=b"s", done=done_cb))
            await asyncio.wait_for(fut, 60)

        for k0 in range(0, len(led), 256):
            await asyncio.gather(*(seed(n) for n in led[k0:k0 + 256]))
        # quiesce_after_rounds fully acked beat rounds and the handshake
        # round at the (possibly floor-raised) beat interval
        hb_s = max(float(e.hb_ms[e.has_ctrl].max()) for e in engines
                   if e.has_ctrl.any()) / 1000.0
        settle = min(120.0, (args.quiesce + 3) * hb_s + 2.0)
        print(f"PROGRESS idle-probe settling {settle:.0f}s "
              f"(hb={hb_s * 1000:.0f}ms)", flush=True)
        await asyncio.sleep(settle)
        hubs = [m.heartbeat_hub for m in managers]

        def beat_counters():
            return {
                "rpcs": sum(h.rpcs_sent for h in hubs),
                "beats": sum(h.beats_sent + h.fast_beats_sent
                             for h in hubs),
                "lease_rpcs": sum(h.lease_rpcs_sent for h in hubs),
            }

        c0 = beat_counters()
        await asyncio.sleep(args.idle_window)
        c1 = beat_counters()
        w = args.idle_window
        res = {
            "groups": G,
            "replicas": R,
            "leaders": len(led),
            "quiesce_after_rounds": args.quiesce,
            "idle_window_s": w,
            "beat_rpcs_per_s": round((c1["rpcs"] - c0["rpcs"]) / w, 2),
            "beats_per_s": round((c1["beats"] - c0["beats"]) / w, 2),
            "lease_rpcs_per_s": round(
                (c1["lease_rpcs"] - c0["lease_rpcs"]) / w, 2),
            "idle_rpcs_per_s": round(
                (c1["rpcs"] - c0["rpcs"]
                 + c1["lease_rpcs"] - c0["lease_rpcs"]) / w, 2),
            "quiescent_groups": sum(int(e.quiescent.sum())
                                    for e in engines),
            "quiescent_leaders": sum(
                int((e.quiescent & (e.role == ROLE_LEADER)).sum())
                for e in engines),
            "groups_quiesced": sum(h.groups_quiesced for h in hubs),
            "groups_woken": sum(h.groups_woken for h in hubs),
            "lease_expiries": sum(h.lease_expiries for h in hubs),
            # the [G]-lane gauges: each engine's hibernation fraction
            # agrees with the raw quiescent count above
            "lane_stats": [e.lane_stats() for e in engines],
            "tick_p99_ms": round(max(
                e.tick_hists["tick_total_ms"].percentile(99)
                for e in engines), 3),
            "eto_floor_ms": max(e._floor_applied_ms for e in engines),
            "eff_eto_ms": eff_eto_ms(),
            "rss_mb": rss_mb(),
            "engine_ticks": sum(e.ticks for e in engines),
            **engine_record(engines, counts),
            **dev,
        }
        return res

    ok = [0]
    errs = [0]
    errs_by: dict[str, int] = {}
    lats: list[tuple[float, float]] = []  # (completion time, latency)
    t_drive0 = time.monotonic()
    stop_at = time.monotonic() + args.duration
    payload = b"x" * 16

    # every group's replicas, so a writer follows leadership the way a
    # routing client does instead of writing to a stale leader
    by_group: dict[str, list[Node]] = {}
    for row in nodes:
        for n in row:
            by_group.setdefault(n.group_id, []).append(n)

    async def drive(node: Node) -> None:
        await asyncio.sleep(random.random() * args.pace_ms / 1e3)
        while time.monotonic() < stop_at:
            if not node.is_leader():
                cur = next((n for n in by_group[node.group_id]
                            if n.is_leader()), None)
                if cur is None:
                    await asyncio.sleep(args.pace_ms / 1e3)  # electing
                    continue
                node = cur
            fut = asyncio.get_running_loop().create_future()
            left = [args.batch]
            t0 = time.perf_counter()

            def cb(st, left=left, t0=t0):
                if st.is_ok():
                    ok[0] += 1
                else:
                    errs[0] += 1
                    name = st.raft_error.name
                    errs_by[name] = errs_by.get(name, 0) + 1
                left[0] -= 1
                if left[0] == 0:
                    lats.append((time.monotonic() - t_drive0,
                                 time.perf_counter() - t0))
                    if not fut.done():
                        fut.set_result(None)

            await node.apply_batch(
                [Task(data=payload, done=cb) for _ in range(args.batch)])
            try:
                await asyncio.wait_for(fut, 30)
            except asyncio.TimeoutError:
                pass
            await asyncio.sleep(args.pace_ms / 1e3)

    t0 = time.monotonic()
    await asyncio.gather(*(drive(n) for n in led))
    elapsed = time.monotonic() - t0
    # the followers learn the last commits on their next beat
    t_settle = time.monotonic()
    while (CountFSM.applied < R * ok[0]
           and time.monotonic() - t_settle < APPLY_SETTLE_S):
        await asyncio.sleep(0.05)
    apply_settle_s = time.monotonic() - t_settle
    # the steady-state view: samples completing in the second half of
    # the window, after the boot-adjacent stragglers
    half = elapsed / 2
    late = sorted(lt for (ts, lt) in lats if ts >= half)
    lats_v = sorted(lt for (_ts, lt) in lats)

    def pct(s, p):
        return round(s[min(len(s) - 1, int(p * len(s)))] * 1e3, 2) \
            if s else None

    return {
        "groups": G,
        "replicas": R,
        "leaders": len(led),
        "boot_s": round(boot_s, 1),
        "elect_s": round(elect_s, 1),
        "commits_per_sec": round(ok[0] / elapsed, 1),
        "ok": ok[0],
        "errors": errs[0],
        "errors_by_class": dict(sorted(errs_by.items())),
        "ack_p50_ms": pct(lats_v, 0.50),
        "ack_p99_ms": pct(lats_v, 0.99),
        "ack_p50_ms_steady": pct(late, 0.50),
        "ack_p99_ms_steady": pct(late, 0.99),
        "rss_mb": rss_mb(),
        "asyncio_tasks": len(asyncio.all_tasks()),
        "applied_total": CountFSM.applied,
        "apply_settle_s": round(apply_settle_s, 3),
        "leaders_at_end": len({n.group_id for row in nodes for n in row
                               if n.is_leader()}),
        "pace_ms": args.pace_ms,
        "batch": args.batch,
        "meta": args.meta,
        "engine_ticks": sum(e.ticks for e in engines),
        # the density-aware floors: the operating point the engines
        # derived from the requested timeout
        "eto_floor_ms": max(e._floor_applied_ms for e in engines),
        "eff_eto_ms": eff_eto_ms(),
        "requested_eto_ms": args.election_timeout_ms,
        **engine_record(engines, counts),
        **dev,
    }


def rung_main(args) -> None:
    row = asyncio.run(run_rung(args))
    print("RESULT " + json.dumps(row), flush=True)
    # no teardown of 3G nodes (minutes at 48K): the row is out, and the
    # process ends here
    os._exit(0 if launches_ok(args, row) else 1)


def run_child(args, g: int, workdir: str, extra: list) -> tuple[dict, int]:
    """One rung in a fresh subprocess: its RESULT row and exit code."""
    cmd = [sys.executable, os.path.join(ROOT, "bench_torch_scale.py"),
           "--rung", "--groups", str(g), "--dir", workdir,
           "--replicas", str(args.replicas), "--meta", args.meta,
           "--election-timeout-ms", str(args.election_timeout_ms),
           "--converge", str(args.converge), *extra]
    if args.cpu:
        cmd.append("--cpu")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env)
    row = None
    for line in p.stdout:
        line = line.decode().strip()
        if line.startswith("RESULT "):
            row = json.loads(line[len("RESULT "):])
        elif line.startswith("PROGRESS"):
            print(line, flush=True)
    rc = p.wait()
    return row or {"groups": g, "error": "rung produced no result"}, rc


def write_out(path: str, key_rows: dict) -> None:
    """Merge keys into the --out file (the ladder and the idle probe
    share one file, as they do in the reference's record)."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out.update(key_rows)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def run_idle_probe(args) -> int:
    """The idle beat plane at one (G, R): quiescence off, then on."""
    import tempfile

    g = int(args.rungs.split(",")[0])
    window = args.duration if args.duration > 0 else 30.0
    pair, failed = {}, False
    for label, quiesce in (("quiesce_off", 0),
                           ("quiesce_on", args.quiesce or 8)):
        workdir = tempfile.mkdtemp(prefix=f"tpuraft_torch_idle_{g}_")
        row, rc = run_child(args, g, workdir, [
            "--elect-spread-s", str(args.elect_spread_s).split(",")[0],
            "--duration", "0", "--idle-window", str(window),
            "--quiesce", str(quiesce)])
        subprocess.run(["rm", "-rf", workdir])
        row["rc"] = rc
        failed |= rc != 0 or "error" in row
        pair[label] = row
        print(label, json.dumps(row), flush=True)
    off, on = pair["quiesce_off"], pair["quiesce_on"]
    if "idle_rpcs_per_s" in off and "idle_rpcs_per_s" in on:
        pair["rpc_reduction_x"] = round(
            off["idle_rpcs_per_s"] / max(on["idle_rpcs_per_s"], 0.01), 1)
    write_out(args.out, {"idle_beat_plane": pair})
    print(json.dumps({"idle_probe": "done" if not failed else "failed",
                      "rpc_reduction_x": pair.get("rpc_reduction_x")}))
    return 1 if failed else 0


def run_ladder(args) -> int:
    import tempfile

    rows, failed = [], False
    rung_list = [int(x) for x in args.rungs.split(",")]
    offered_list = [float(x) for x in args.offered.split(",")]
    if len(offered_list) == 1:
        offered_list *= len(rung_list)
    spread_list = [float(x) for x in str(args.elect_spread_s).split(",")]
    if len(spread_list) == 1:
        spread_list *= len(rung_list)
    if len(offered_list) != len(rung_list) or \
            len(spread_list) != len(rung_list):
        raise SystemExit("--offered/--elect-spread-s list lengths must "
                         "match --rungs (or be a single value)")
    for g, offered, spread in zip(rung_list, offered_list, spread_list):
        # pace = G * batch / offered, so ack latency is service time, not
        # queue growth; the window stretches so every group gets >= ~2
        # turns when the pace exceeds the duration
        pace_ms = max(200.0, g * args.batch / offered * 1000.0)
        rung_duration = max(args.duration, pace_ms * 2.0 / 1000.0)
        workdir = tempfile.mkdtemp(prefix=f"tpuraft_torch_scale_{g}_")
        t0 = time.monotonic()
        row, rc = run_child(args, g, workdir, [
            "--elect-spread-s", str(spread),
            "--duration", str(rung_duration), "--batch", str(args.batch),
            "--pace-ms", str(pace_ms)])
        subprocess.run(["rm", "-rf", workdir])
        row["wall_s"] = round(time.monotonic() - t0, 1)
        row["rc"] = rc
        if "error" not in row:
            row["offered_per_sec"] = round(
                g * args.batch / (pace_ms / 1000.0), 1)
        failed |= rc != 0 or "error" in row
        rows.append(row)
        print(json.dumps(row), flush=True)
        complete = [r for r in rows if "error" not in r]
        write_out(args.out, {
            "metric": "protocol_plane_scale_ladder",
            "rows": rows,
            "per_g_overhead": {
                str(r["groups"]): {
                    "rss_kb_per_group": round(
                        r["rss_mb"] * 1024 / r["groups"], 1),
                    "tasks_per_group": round(
                        r["asyncio_tasks"] / r["groups"], 2),
                } for r in complete},
            "stack": "in-proc RPC x3 replica endpoints, multilog "
                     "shared-journal fsync per store, one engine an "
                     "endpoint (fused tick on the device), priority "
                     "placement, paced offered load",
            "note": "one PROCESS hosts all three replicas of every group; "
                    "the 3-process loopback-TCP variant is "
                    "bench_torch_e2e.py",
        })
    print(json.dumps({"rungs": len(rows),
                      "ok": len([r for r in rows if r.get("rc") == 0])}))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the engines' tick on the CPU (the plain "
                         "version; no device figure)")
    ap.add_argument("--rungs", default="1024,4096,16384")
    ap.add_argument("--offered", default="3000",
                    help="offered entries/s; one value or a comma list "
                         "matched to --rungs")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--election-timeout-ms", type=int, default=10000)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (never a committed file)")
    ap.add_argument("--rung", action="store_true",
                    help="internal: run one rung in this process")
    ap.add_argument("--groups", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--pace-ms", type=float, default=0.0)
    ap.add_argument("--elect-spread-s", default="0",
                    help="window over which the held elections release "
                         "(0 = 4x the election timeout); one value or a "
                         "comma list matched to --rungs")
    ap.add_argument("--converge", type=float, default=0.98,
                    help="fraction of the groups that must have a leader "
                         "before the drive starts (the reference's 0.98; "
                         "1.0 waits for every group)")
    ap.add_argument("--meta", default="memory",
                    choices=["memory", "multimeta"],
                    help="raft meta storage: memory:// or multimeta:// "
                         "(fsynced {term, votedFor} on the shared "
                         "group-commit journal)")
    ap.add_argument("--dir", default="")
    ap.add_argument("--quiesce", type=int, default=0,
                    help="RaftOptions.quiesce_after_rounds: > 0 lets idle "
                         "groups hibernate")
    ap.add_argument("--idle-window", type=float, default=0.0,
                    help="rung-internal: measure the idle beat plane over "
                         "this window instead of driving writes")
    ap.add_argument("--idle-probe", action="store_true",
                    help="quiescence off against on at --rungs[0] x "
                         "--replicas; the pair goes to --out as "
                         "'idle_beat_plane'")
    args = ap.parse_args()

    if args.rung:
        rung_main(args)
        return 0
    from tpuraft_torch.storage.multilog import ensure_built

    ensure_built()
    asyncio.run(probe_engine(args))
    if args.idle_probe:
        return run_idle_probe(args)
    return run_ladder(args)


if __name__ == "__main__":
    sys.exit(main())
