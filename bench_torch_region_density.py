#!/usr/bin/env python3
"""RheaKV at region density on one CUDA card: >= 1K regions on a
3-store cluster through the full KV stack (region engines, KV state
machines, the native C++ data engine, the multilog shared journal, the
engine protocol plane and the batching RheaKV client) under mixed
load, with PD heartbeat volume counted.  The counterpart of
``bench_region_density.py``.

    python3 bench_torch_region_density.py [--regions 1024] [--workers 24]
        [--read-frac F] [--out FILE] [...the reference's flags]
    python3 bench_torch_region_density.py --cpu ...  # the engines on the CPU

Topology: one process hosts all three stores over in-process RPC, each
store with its own ``MultiRaftEngine`` (P = 4, 20 ms tick) on
``cuda:0``, its own ``native://`` KV engine and its own multilog
journal.  Regions split a 6-hex-digit keyspace evenly; elections are
held through boot, then released jittered over 4 election timeouts.
Every engine tick is one fused-tick launch on the card.

The parent builds the native libraries and starts one small engine on
the device (so the kernels build once, before any store boots; without
a card and without ``--cpu`` that engine's "no CUDA device" error ends
the run), then runs the configuration in a child, which prints one
``RESULT {...}`` row: every key of the reference's row, plus the
device, the card's name and power limit, each engine's ticks, fused-tick
launches and ``tick_device_ms`` / ``tick_total_ms`` p50 and p99,
``leaders_at_end`` and ``row``, the key the reference files the row
under (``row``, ``row_<R>``, ``_w<N>``, ``_r<pct>``, ``_lease``, ...).
The parent merges the row under that key into ``--out`` (default
``chiprun_out/bench_torch_region_density.json``), prints it, and exits
non-zero when the child gives no row, a region is left without a
leader, or an engine's launches differ from its ticks.
"""

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

from bench_torch_scale import (count_launches, device_record, engine_record,
                               launches_ok, probe_engine)

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out",
                           "bench_torch_region_density.json")


def row_key(args) -> str:
    """The key the reference files a row under: ``row`` is the 1,024-region
    headline, other densities ``row_<regions>``, then one suffix a
    non-default load shape or A/B knob."""
    key = "row" if args.regions == 1024 else f"row_{args.regions}"
    if args.workers != 24:
        key += f"_w{args.workers}"
    if args.read_frac >= 0:
        key += f"_r{int(round(args.read_frac * 100))}"
    for flag, suffix in (("lease_reads", "_lease"), ("quiesce", "_quiesce"),
                         ("no_heat", "_noheat"), ("no_disk_guard", "_nodg"),
                         ("chaos_clock", "_ck"), ("no_write_batch", "_nowb"),
                         ("lifecycle_pd", "_lcpd")):
        if getattr(args, flag):
            key += suffix
    return key


async def run_config(args) -> None:
    import random
    import resource

    import numpy as np

    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.options import TickOptions
    from tpuraft_torch.rheakv.client import BatchingOptions, RheaKVStore
    from tpuraft_torch.rheakv.metadata import Region
    from tpuraft_torch.rheakv.native_store import NativeRawKVStore
    from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
    from tpuraft_torch.rheakv.store_engine import (StoreEngine,
                                                   StoreEngineOptions)
    from tpuraft_torch.rpc.transport import (InProcNetwork, InProcTransport,
                                             RpcServer)

    R, S = args.regions, args.stores
    device = "cpu" if args.cpu else "cuda:0"
    net = InProcNetwork()
    endpoints = [f"127.0.0.1:{6600 + i}" for i in range(S)]

    # R regions split a 6-hex keyspace: region k owns [hex(k), hex(k+1))
    def bkey(k: int) -> bytes:
        return b"%06x" % k

    regions = [Region(id=k + 1, start_key=bkey(k) if k else b"",
                      end_key=bkey(k + 1) if k + 1 < R else b"",
                      peers=list(endpoints))
               for k in range(R)]

    class CountingPD(FakePlacementDriverClient):
        store_hbs = 0      # legacy per-store RPCs
        region_hbs = 0     # legacy per-region RPCs
        batch_hbs = 0      # pd_store_heartbeat_batch RPCs
        delta_rows = 0     # changed-region rows carried inside batches
        heat_rows = 0      # noise-gated heat rows carried inside batches

        async def store_heartbeat(self, meta) -> None:
            CountingPD.store_hbs += 1
            await super().store_heartbeat(meta)

        async def region_heartbeat(self, region, leader, *a, **kw):
            CountingPD.region_hbs += 1
            return await super().region_heartbeat(region, leader, *a, **kw)

        async def store_heartbeat_batch(self, meta, deltas, full=False,
                                        health="", heat=None,
                                        occupancy=None):
            # what a real PD would see: one RPC and its delta rows
            CountingPD.batch_hbs += 1
            CountingPD.delta_rows += len(deltas)
            CountingPD.heat_rows += len(heat or [])
            return [], False

    # --lifecycle-pd: a real single-member placement driver running the
    # region-lifecycle policy loop with every actuator held idle, in
    # place of the counting fake
    pd_server = None
    pd_ep = "127.0.0.1:7600"
    if args.lifecycle_pd:
        from tpuraft_torch.rheakv.pd_server import (PlacementDriverOptions,
                                                    PlacementDriverServer)

        os.makedirs(f"{args.dir}/pd", exist_ok=True)
        pd_rpc = RpcServer(pd_ep)
        net.bind(pd_rpc)
        pd_server = PlacementDriverServer(
            PlacementDriverOptions(
                endpoints=[pd_ep],
                election_timeout_ms=args.election_timeout_ms,
                data_path=f"{args.dir}/pd",
                initial_regions=[r.copy() for r in regions],
                lifecycle=True,
                # actuation-idle: the policy evaluates every heartbeat
                # round but no decision can fire
                lifecycle_heat_split_min_keys=1 << 30,
                lifecycle_min_regions=R + 1,
                lifecycle_move_imbalance=1 << 30,
            ),
            pd_ep, pd_rpc, InProcTransport(net, pd_ep))
        await pd_server.start()
        deadline = time.monotonic() + 30
        while not (pd_server.node and pd_server.node.is_leader()):
            if time.monotonic() > deadline:
                raise RuntimeError("lifecycle PD failed to elect")
            await asyncio.sleep(0.05)

    t0 = time.monotonic()
    engines, counts, stores = [], [], []
    cap = 1 << max(4, (R + 3).bit_length())
    for i, ep in enumerate(endpoints):
        # the native kv engine's open mkdirs one level only
        os.makedirs(f"{args.dir}/store{i}", exist_ok=True)
        server = RpcServer(ep)
        net.bind(server)
        transport = InProcTransport(net, ep)
        engine = MultiRaftEngine(TickOptions(
            max_groups=cap, max_peers=4, tick_interval_ms=20,
            # --no-write-batch: tick-cadence commits
            eager_commit=not args.no_write_batch, device=device))
        counts.append({})
        count_launches(engine, counts[-1])  # before the store starts it
        engines.append(engine)
        opts = StoreEngineOptions(
            server_id=ep,
            initial_regions=[r.copy() for r in regions],
            data_path=f"{args.dir}/store{i}",
            election_timeout_ms=args.election_timeout_ms,
            log_scheme="multilog",
            raw_store_factory=lambda i=i: NativeRawKVStore(
                f"{args.dir}/store{i}/kv", sync=False),
            heartbeat_interval_ms=1000,
            heat_tracking=not args.no_heat,
            disk_guard=not args.no_disk_guard,
            # --no-write-batch: stop-and-wait appends, ack after apply
            append_batching=not args.no_write_batch,
            ack_at_commit=not args.no_write_batch,
        )
        if args.chaos_clock:
            # every timing read through the injected clock (rate 1.0 =
            # real time): the row prices the indirection alone
            from tpuraft_torch.util.clock import ChaosClock

            opts.clock = ChaosClock(seed=i)
        if args.lease_reads:
            from tpuraft_torch.options import ReadOnlyOption

            opts.read_only_option = ReadOnlyOption.LEASE_BASED
        if args.quiesce:
            opts.quiesce_after_rounds = 4
        if args.lifecycle_pd:
            from tpuraft_torch.rheakv.pd_client import \
                RemotePlacementDriverClient

            pd_client = RemotePlacementDriverClient(transport, [pd_ep])
        else:
            pd_client = CountingPD([r.copy() for r in regions])
        store = StoreEngine(opts, server, transport,
                            multi_raft_engine=engine,
                            pd_client=pd_client)
        # hold elections past boot: the engines' deadlines move together
        # once every store is up
        orig_start_region = store._start_region

        async def deferred(region, store=store, engine=engine,
                           orig=orig_start_region):
            eng_region = await orig(region)
            node = eng_region.node
            engine.elect_deadline[node._ctrl.slot] = \
                engine.now_ms() + 3_600_000
            return eng_region

        store._start_region = deferred
        await store.start()
        stores.append(store)
    dev = device_record(args)  # after the engines: their error comes first
    # release elections jittered over ~4 timeouts
    rng = np.random.default_rng(0)
    for engine in engines:
        now = engine.now_ms()
        jit = rng.integers(0, 4 * args.election_timeout_ms, engine.G)
        engine.elect_deadline[:] = now + args.election_timeout_ms // 4 + jit
        engine.mark_dirty()
    boot_s = time.monotonic() - t0

    # leadership convergence: --converge of the regions
    t1 = time.monotonic()
    deadline = time.monotonic() + 120 + R * 0.05
    led = 0
    while time.monotonic() < deadline:
        led = sum(1 for s in stores for re in s._regions.values()
                  if re.is_leader())
        if led >= int(R * args.converge):
            break
        await asyncio.sleep(0.5)
    elect_s = time.monotonic() - t1

    pd = FakePlacementDriverClient([r.copy() for r in regions])
    client = RheaKVStore(pd, InProcTransport(net, "kvclient:0"),
                         batching=BatchingOptions(
                             enabled=True,
                             max_store_inflight=args.store_inflight),
                         read_from=args.read_from)
    hb0 = (CountingPD.store_hbs, CountingPD.region_hbs,
           CountingPD.batch_hbs, CountingPD.delta_rows,
           CountingPD.heat_rows)

    ok = [0]
    errs = [0]
    lats: list[float] = []
    payload = b"v" * 32

    # --read-frac >= 0: reads with that probability, writes otherwise;
    # negative = the 75/25 put/get mix
    read_frac = args.read_frac if args.read_frac >= 0 else 0.25
    quiesced_before = woken_before = 0
    if args.quiesce:
        # one committed entry a region, then hibernation takes hold
        # before the window
        for k in range(0, R, max(1, R // 64)):
            try:
                await client.put(b"%06x/seed" % k, payload)
            except Exception:
                pass
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            quiesced_before = sum(int(e.quiescent.sum()) for e in engines)
            if quiesced_before >= int(R * S * 0.9):
                break
            await asyncio.sleep(0.5)
        woken_before = sum(
            s.node_manager.heartbeat_hub.groups_woken for s in stores)

    if args.trace_sample > 0:
        # sampled product tracing through the measured window (seeded:
        # the same sampled op sequence run to run)
        from tpuraft_torch.util.trace import TRACER

        TRACER.configure(enabled=True, sample_rate=args.trace_sample,
                         seed=0)

    if args.profile_ticks > 0:
        # each of the first engine's next N ticks records its build,
        # device and apply phase spans
        engines[0].profile_ticks(args.profile_ticks)

    stop_at = time.monotonic() + args.duration

    async def worker(wid: int) -> None:
        r = random.Random(wid)
        while time.monotonic() < stop_at:
            k = b"%06x" % r.randrange(R)
            key = k + b"/%04d" % r.randrange(100)
            t = time.perf_counter()
            try:
                if r.random() < read_frac:
                    await client.get(key)
                else:
                    await client.put(key, payload)
                ok[0] += 1
                lats.append(time.perf_counter() - t)
            except Exception:
                errs[0] += 1
            await asyncio.sleep(args.pace_ms / 1e3)

    t2 = time.monotonic()
    await asyncio.gather(*(worker(i) for i in range(args.workers)))
    elapsed = time.monotonic() - t2
    hb1 = (CountingPD.store_hbs, CountingPD.region_hbs,
           CountingPD.batch_hbs, CountingPD.delta_rows,
           CountingPD.heat_rows)
    # hibernation state before the stage probes: the write probe wakes
    # its target group
    quiesced_after = sum(int(e.quiescent.sum()) for e in engines) \
        if args.quiesce else 0
    woken_after = sum(s.node_manager.heartbeat_hub.groups_woken
                      for s in stores) if args.quiesce else 0
    # every region led after the drive: a leadership handover in flight
    # (an evacuation, a lease step-down) gets two election timeouts
    t_led = time.monotonic()
    while True:
        leaders_at_end = sum(1 for s in stores
                             for re in s._regions.values() if re.is_leader())
        if leaders_at_end >= R or time.monotonic() - t_led > \
                2 * args.election_timeout_ms / 1e3:
            break
        await asyncio.sleep(0.05)
    leaders_settle_s = time.monotonic() - t_led
    lats.sort()

    stage = await stage_probe(client, stores, R)
    read_stage = await read_stage_probe(client, stores) \
        if read_frac > 0 else {}

    # read-plane counters: store-wide confirm batching, fence dedupe,
    # lease vs SAFE vs forwarded serves, the engine's lease lane
    read_plane: dict = {}

    def _acc(d: dict) -> None:
        for k, v in d.items():
            read_plane[k] = read_plane.get(k, 0) + v

    for s in stores:
        if s.read_batcher is not None:
            _acc(s.read_batcher.counters())
        _acc({"kv_read_fences": s.kv_processor.read_fences,
              "kv_fenced_reads": s.kv_processor.fenced_reads})
        for re in s._regions.values():
            if re.node is not None:
                _acc(re.node.read_only_service.counters())
    _acc({"lease_lane_hits": sum(e.lease_lane_hits for e in engines),
          "lease_lane_misses": sum(e.lease_lane_misses for e in engines)})

    ls = [e.lane_stats() for e in engines]
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    coalesced_flushes = sum(re.fsm.coalesced_flushes
                            for s in stores for re in s._regions.values())
    coalesced_ops = sum(re.fsm.coalesced_ops
                        for s in stores for re in s._regions.values())
    res = {
        "regions": R,
        "stores": S,
        # client and every store on one loop in one process
        "topology": "single-process",
        "leaders": led,
        "boot_s": round(boot_s, 1),
        "elect_s": round(elect_s, 1),
        "ops_per_sec": round(ok[0] / elapsed, 1),
        "ok": ok[0],
        "errors": errs[0],
        "ack_p50_ms": round(lats[len(lats) // 2] * 1e3, 2) if lats else None,
        "ack_p99_ms": round(lats[int(len(lats) * 0.99)] * 1e3, 2)
        if lats else None,
        "rss_mb": round(rss_mb, 1),
        "rss_kb_per_region": round(rss_mb * 1024 / (R * S), 1),
        "pd_store_hb_per_s": round((hb1[0] - hb0[0]) / elapsed, 2),
        "pd_region_hb_per_s": round((hb1[1] - hb0[1]) / elapsed, 2),
        "pd_batch_hb_per_s": round((hb1[2] - hb0[2]) / elapsed, 2),
        "pd_delta_rows_per_s": round((hb1[3] - hb0[3]) / elapsed, 2),
        "pd_rpcs_per_s": round(
            (hb1[0] - hb0[0] + hb1[1] - hb0[1] + hb1[2] - hb0[2])
            / elapsed, 2),
        "asyncio_tasks": len(asyncio.all_tasks()),
        "workers": args.workers,
        "pace_ms": args.pace_ms,
        "read_frac": round(read_frac, 2),
        "read_from": args.read_from,
        "lease_reads": bool(args.lease_reads),
        "kv_batch_rpcs_per_s": round(client.batch_rpcs / elapsed, 1),
        "kv_batch_items_per_rpc": round(
            client.batch_items / max(1, client.batch_rpcs), 2),
        "kv_batch_fallbacks": client.batch_fallbacks,
        "kv_batch_retry_codes": {str(k): v
                                 for k, v in client.batch_retries.items()},
        "srv_batch_rpcs": sum(s.kv_processor.batch_rpcs for s in stores),
        "srv_single_rpcs": sum(s.kv_processor.single_rpcs for s in stores),
        "fsm_coalesced_flushes": coalesced_flushes,
        "fsm_coalesced_ops": coalesced_ops,
        # stage marks of one probe put after the window (ms from its
        # start): queue, rpc, validate, propose, submit, quorum, apply,
        # ack, flush and the first follower's append and flush
        "stage_marks_ms": stage,
        "write_plane": {
            "enabled": not args.no_write_batch,
            **{k: sum(s.append_batcher.counters()[k] for s in stores
                      if s.append_batcher is not None)
               for k in (stores[0].append_batcher.counters()
                         if stores[0].append_batcher is not None else {})},
            "engine_eager_commits": sum(e.eager_commits for e in engines),
            "fsm_eager_acked": sum(
                re.node.fsm_caller.eager_acked
                for s in stores for re in s._regions.values()
                if re.node is not None),
        },
        # one probe get: queue, rpc, read fence, local serve, done
        "read_stage_marks_ms": read_stage,
        "read_plane": read_plane,
        "tick_plane": {
            "groups": sum(ls[i]["groups"] for i in range(S)),
            "leaders": sum(ls[i]["leaders"] for i in range(S)),
            "quiescent": sum(ls[i]["quiescent"] for i in range(S)),
            "tick_hists": engines[0].tick_histograms(),
        },
        "heat": {
            "enabled": not args.no_heat,
            "rows_per_s": round((hb1[4] - hb0[4]) / elapsed, 2),
            "writes_noted": sum(
                s.heat.writes_noted for s in stores if s.heat),
            "reads_noted": sum(
                s.heat.reads_noted for s in stores if s.heat),
        },
        "leaders_at_end": leaders_at_end,
        "leaders_settle_s": round(leaders_settle_s, 3),
        "row": row_key(args),
    }
    if args.lifecycle_pd and pd_server is not None:
        # a real PD saw the whole fleet and ran the policy every round,
        # yet ordered no actuation
        res["lifecycle_pd"] = {
            "regions_known": len(pd_server.fsm.regions),
            "heat_splits_ordered": pd_server.heat_splits_ordered,
            "merges_ordered": pd_server.merges_ordered,
            "merges_completed": pd_server.merges_completed,
            "moves_ordered": pd_server.moves_ordered,
        }
    if args.quiesce:
        res["quiescent_replicas_before"] = quiesced_before
        res["quiescent_replicas_after"] = quiesced_after
        res["groups_woken_during_load"] = woken_after - woken_before
    if args.trace_sample > 0 or args.trace:
        from tpuraft_torch.util.trace import TRACER

        res["trace"] = TRACER.stats()
        if args.trace:
            # the probe put/get traces and any window-sampled ops still
            # in the ring, perfetto-loadable
            res["trace_file"] = args.trace
            res["trace_spans"] = TRACER.export_chrome(args.trace)
    if args.profile_ticks > 0:
        # the N-tick window: root tick spans and their phase spans
        out = args.profile_ticks_out or os.path.join(
            args.dir, "tick_timeline.json")
        res["tick_timeline_file"] = out
        res["tick_timeline_spans"] = engines[0].export_tick_timeline(out)
    # the launches and ticks last, in one step of the loop: no tick runs
    # between the two reads
    res.update(engine_record(engines, counts))
    res["engine_ticks"] = sum(e.ticks for e in engines)
    res.update(dev)
    print("RESULT " + json.dumps(res), flush=True)
    os._exit(0)  # 3R region engines: teardown is not the measurement


# span name -> (start mark, end mark): the trace plane's stage spans as
# the stage_marks_ms shape (ms from the probe op's start)
_SPAN_MARKS = {
    "client_queue": ("queue_s", "sent"),
    "kv_batch_rpc": ("rpc_s", "rpc_e"),
    "kv_rpc": ("rpc_s", "rpc_e"),
    "srv_validate": ("validate_s", "validate_e"),
    "srv_propose": ("propose_s", "ack"),
    "quorum_commit": ("submit", "quorum_e"),
    "fsm_apply": ("apply_s", "apply_e"),
    "srv_read_fence": ("fence_s", "fence_e"),
    "srv_read_serve": ("serve_s", "serve_e"),
}


def _marks_from_spans(spans: list) -> dict:
    """Fold one trace's spans into the stage-marks dict.  Leader-side
    stages key off the proc that served the propose or fence; the flush
    and follower stages land as flush_s/flush_e (leader store) and
    fol_append_s/fol_append_e (first follower)."""
    roots = [s for s in spans if s["name"] == "kv_op"]
    if not roots:
        return {}
    root = roots[-1]
    tid, t0 = root["trace_id"], root["ts_s"]
    mine = [s for s in spans if s["trace_id"] == tid]

    def rel(x: float) -> float:
        return round((x - t0) * 1e3, 3)

    marks = {"queue_s": 0.0, "done": rel(root["ts_s"] + root["dur_s"])}
    leader_proc = next((s["proc"] for s in mine
                        if s["name"] in ("srv_propose", "srv_read_fence")),
                       None)
    for s in mine:
        name = s["name"]
        if name == "log_flush":
            pfx = "flush" if s["proc"] == leader_proc else "fol_flush"
            marks.setdefault(f"{pfx}_s", rel(s["ts_s"]))
            marks.setdefault(f"{pfx}_e", rel(s["ts_s"] + s["dur_s"]))
        elif name == "follower_append":
            marks.setdefault("fol_append_s", rel(s["ts_s"]))
            marks.setdefault("fol_append_e", rel(s["ts_s"] + s["dur_s"]))
        elif name == "fsm_apply" and s["proc"] != leader_proc:
            continue  # follower applies happen off the ack path
        elif name in _SPAN_MARKS:
            a, b = _SPAN_MARKS[name]
            marks.setdefault(a, rel(s["ts_s"]))
            marks.setdefault(b, rel(s["ts_s"] + s["dur_s"]))
    return marks


async def _traced_probe(client, stores, op: str) -> dict:
    """One fully sampled probe op after the measured window, attributed
    by the port's trace plane (tpuraft_torch/util/trace.py)."""
    from tpuraft_torch.util.trace import TRACER

    target = None
    for s in stores:
        for re in s._regions.values():
            if re.is_leader():
                target = re
                break
        if target is not None:
            break
    if target is None:
        return {}
    # no reset: _marks_from_spans keys off the newest kv_op root, so
    # window-sampled spans (--trace-sample) survive into the export
    was_enabled, was_rate = TRACER.enabled, TRACER.sample_rate
    TRACER.configure(enabled=True, sample_rate=1.0, seed=0)
    key = target.region.start_key + b"/stage-probe"
    try:
        if op == "put":
            await asyncio.wait_for(client.put(key, b"p"), 30.0)
        else:
            await asyncio.wait_for(client.get(key), 30.0)
    except Exception:
        return {}
    finally:
        TRACER.enabled = was_enabled
        TRACER.sample_rate = was_rate
    return _marks_from_spans(TRACER.spans())


async def stage_probe(client, stores, R: int) -> dict:
    """One traced put after the measured window: client queue, rpc,
    validate, propose, flush and quorum, apply, ack (and the follower's
    append and flush)."""
    return await _traced_probe(client, stores, "put")


async def read_stage_probe(client, stores) -> dict:
    """One traced get after the measured window: client queue, rpc,
    read fence (the store-wide batched confirmation), local serve,
    ack."""
    return await _traced_probe(client, stores, "get")


def write_out(path: str, key: str, row: dict) -> None:
    """Merge the row into --out under its key (the reference's record
    shape: one file, one key a configuration)."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out.setdefault("metric", "rheakv_region_density")
    out["stack"] = ("3 StoreEngines in-proc, native C++ KV engine per "
                    "store, multilog shared journal, engine protocol "
                    "plane (fused tick on the device), batching RheaKV "
                    "client, counting PD")
    out[key] = row
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def failures(args, row: dict) -> list[str]:
    """Why the run failed: no row, a region left without a leader, or an
    engine whose launches differ from its ticks."""
    if "error" in row:
        return [row["error"]]
    out = []
    if row["leaders_at_end"] < row["regions"]:
        out.append(f"{row['leaders_at_end']} of {row['regions']} regions "
                   f"led at the end of the drive")
    if not launches_ok(args, row):
        out.append(f"launches {row['fused_tick_launches']} for ticks "
                   f"{row['ticks_by_engine']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the engines' tick on the CPU (the plain "
                         "version; no device figure)")
    ap.add_argument("--regions", type=int, default=1024)
    ap.add_argument("--stores", type=int, default=3)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--workers", type=int, default=24)
    ap.add_argument("--pace-ms", type=float, default=2.0)
    ap.add_argument("--election-timeout-ms", type=int, default=10000)
    ap.add_argument("--converge", type=float, default=0.98,
                    help="fraction of the regions that must have a leader "
                         "before the drive (the reference's 0.98; 1.0 "
                         "waits for every region)")
    ap.add_argument("--store-inflight", type=int, default=4,
                    help="concurrent kv_command_batch RPCs per store "
                         "(BatchingOptions.max_store_inflight)")
    ap.add_argument("--read-frac", type=float, default=-1.0,
                    help="read/write-mix shape: GET with this probability "
                         "(0.95 = the 95/5 row, 0.5 = 50/50, 1.0 = pure "
                         "read); negative (default) = the 75/25 put/get "
                         "mix")
    ap.add_argument("--read-from",
                    choices=["leader", "follower", "learner", "any"],
                    default="leader",
                    help="client read fan-out target (RheaKVStore "
                         "read_from)")
    ap.add_argument("--lease-reads", action="store_true",
                    help="LEASE_BASED readIndex on the region groups "
                         "(no per-read quorum round)")
    ap.add_argument("--quiesce", action="store_true",
                    help="enable group quiescence and report the wake "
                         "counters under the load")
    ap.add_argument("--trace", default="",
                    help="export a Chrome trace-event JSON "
                         "(perfetto-loadable) of the traced ops to this "
                         "path (the stage-probe put/get at minimum; with "
                         "--trace-sample also the window's sampled ops)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="product tracing through the measured window at "
                         "this sample rate (0 = off)")
    ap.add_argument("--no-heat", action="store_true",
                    help="disable per-region heat tracking (A/B knob)")
    ap.add_argument("--chaos-clock", action="store_true",
                    help="a per-store injected ChaosClock at rate 1.0 "
                         "(real time through the virtual-clock "
                         "indirection; A/B knob)")
    ap.add_argument("--no-disk-guard", action="store_true",
                    help="disable the disk budget and pressure plane "
                         "(A/B knob)")
    ap.add_argument("--lifecycle-pd", action="store_true",
                    help="a real placement driver (lifecycle policy loop "
                         "on, every actuator held idle) in place of the "
                         "counting fake (A/B knob)")
    ap.add_argument("--no-write-batch", action="store_true",
                    help="disable the write plane (store-wide append "
                         "rounds, eager commits, ack-at-commit; A/B knob)")
    ap.add_argument("--profile-ticks", type=int, default=0,
                    help="arm an N-tick profiling window on the first "
                         "store's engine; exports a perfetto tick "
                         "timeline (build/device/apply phases)")
    ap.add_argument("--profile-ticks-out", default="",
                    help="tick timeline output path (default: "
                         "<workdir>/tick_timeline.json)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (never a committed file)")
    ap.add_argument("--config", action="store_true",
                    help="internal: run one configuration in this process")
    ap.add_argument("--dir", default="")
    args = ap.parse_args()

    if args.config:
        asyncio.run(run_config(args))
        return 0

    import tempfile

    from tpuraft_torch.rheakv.native_store import ensure_built as kv_built
    from tpuraft_torch.storage.multilog import ensure_built

    ensure_built()
    kv_built()
    # one engine on the device before the child's three: the kernels
    # build here, once, and a machine without a card stops here
    asyncio.run(probe_engine(args))
    workdir = tempfile.mkdtemp(
        prefix=f"tpuraft_torch_regions_{args.regions}_")
    cmd = [sys.executable, os.path.join(ROOT, "bench_torch_region_density.py"),
           "--config", "--regions", str(args.regions),
           "--stores", str(args.stores), "--dir", workdir,
           "--duration", str(args.duration),
           "--workers", str(args.workers),
           "--pace-ms", str(args.pace_ms),
           "--election-timeout-ms", str(args.election_timeout_ms),
           "--converge", str(args.converge),
           "--store-inflight", str(args.store_inflight),
           "--read-frac", str(args.read_frac),
           "--read-from", args.read_from,
           "--trace-sample", str(args.trace_sample)]
    if args.trace:
        cmd += ["--trace", os.path.abspath(args.trace)]
    for flag in ("cpu", "lease_reads", "quiesce", "no_heat",
                 "no_disk_guard", "chaos_clock", "no_write_batch",
                 "lifecycle_pd"):
        if getattr(args, flag):
            cmd.append("--" + flag.replace("_", "-"))
    if args.profile_ticks > 0:
        cmd += ["--profile-ticks", str(args.profile_ticks)]
        if args.profile_ticks_out:
            cmd += ["--profile-ticks-out",
                    os.path.abspath(args.profile_ticks_out)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.monotonic()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env)
    row = None
    for line in p.stdout:
        line = line.decode().strip()
        if line.startswith("RESULT "):
            row = json.loads(line[len("RESULT "):])
    rc = p.wait()
    if row is None:
        row = {"regions": args.regions, "error": "no result"}
    row["wall_s"] = round(time.monotonic() - t0, 1)
    row["rc"] = rc
    write_out(args.out, row_key(args), row)
    print(json.dumps(row), flush=True)
    subprocess.run(["rm", "-rf", workdir])
    failed = failures(args, row) + ([f"the child exited {rc}"] if rc else [])
    for why in failed:
        print(f"bench_torch_region_density: {why}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
