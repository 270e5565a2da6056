#!/usr/bin/env python3
"""Commit and ack latency against geo topology on the port: the
counterpart of ``bench_geo.py``, a host-plane A/B (no engine).

Each row boots the port's soak KV cluster (``tpuraft_torch.examples.
soak.SoakCluster``) under a seeded ``NetworkTopology`` shape and
measures, through a warmed leader:

- **commit** latency: a direct raft ``apply`` on the region leader,
  clocked to its commit closure (one quorum round over the shaped WAN,
  no client stack);
- **ack** latency: a full KV client ``put`` (routing, RPC, quorum, FSM
  apply, response): the number a user sees.

Rows: 3 zones (3 full replicas), 5 zones (5 full replicas), 3 zones
under a degraded WAN (latency x6, +1 % loss), and 3 zones with 2 data
replicas and a witness, over the same link shape as the first.

    python3 bench_torch_geo.py [--ops 150] [--out FILE]

Writes ``--out`` (default ``chiprun_out/bench_torch_geo.json``), with
``device: null`` and the card's name and power limit beside the rows.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import tempfile
import time

from tpuraft_torch.entity import Task
from tpuraft_torch.examples.soak import SoakCluster
from tpuraft_torch.rheakv.client import RheaKVStore
from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench_torch_geo.json")


def _pct(xs: list[float], q: float) -> float:
    # the bench family's pct, so p99 rows compare across records
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def _stats(xs: list[float]) -> dict:
    return {
        "p50_ms": round(_pct(xs, 0.50), 2),
        "p99_ms": round(_pct(xs, 0.99), 2),
        "mean_ms": round(statistics.fmean(xs), 2) if xs else 0.0,
        "n": len(xs),
    }


async def run_shape(name: str, n_stores: int, zones: int, witness: bool,
                    degrade: bool, ops: int, seed: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="tpuraft-torch-geo-") as tmp:
        c = SoakCluster(n_stores, tmp, geo_zones=zones, witness=witness,
                        geo_seed=seed, election_timeout_ms=1000)
        kv = None
        try:
            for ep in c.endpoints:
                await c.start_store(ep)
            if degrade:
                c.topology.degrade_wan(latency_x=6.0, extra_loss=0.01,
                                       bandwidth_x=1.0)
            pd = FakePlacementDriverClient([r.copy() for r in c.regions])
            kv = RheaKVStore(pd, c.client_transport(), max_retries=3)
            await kv.start()
            # warm: a leader elected, routes cached
            deadline = time.monotonic() + 20.0
            while c.leader_endpoint(1) is None:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{name}: no leader")
                await asyncio.sleep(0.05)
            await kv.put(b"warm", b"1")
            leader_node = \
                c.stores[c.leader_endpoint(1)].get_region_engine(1).node

            commit_ms: list[float] = []
            for i in range(ops):
                fut = asyncio.get_running_loop().create_future()
                # an encoded KV put: the region FSM applies it (raw bytes
                # would poison a KV state machine)
                blob = KVOperation(KVOp.PUT, b"geo", b"%d" % i).encode()
                t0 = time.perf_counter()
                await leader_node.apply(Task(
                    data=blob,
                    done=lambda st, f=fut: f.done() or f.set_result(st)))
                st = await asyncio.wait_for(fut, 30.0)
                if st.is_ok():
                    commit_ms.append((time.perf_counter() - t0) * 1e3)

            ack_ms: list[float] = []
            for i in range(ops):
                t0 = time.perf_counter()
                await asyncio.wait_for(
                    kv.put(b"k%03d" % (i % 16), b"v%d" % i), 30.0)
                ack_ms.append((time.perf_counter() - t0) * 1e3)

            return {
                "topology": name,
                "stores": n_stores,
                "zones": zones,
                "witness": witness,
                "degraded_wan": degrade,
                "ops": ops,
                "commit": _stats(commit_ms),
                "ack": _stats(ack_ms),
                "topology_counters": dict(c.topology.counters),
            }
        finally:
            if kv is not None:
                await kv.shutdown()
            for ep in list(c.stores):
                await c.stop_store(ep)
            ct = getattr(c, "_client_t", None)
            if ct is not None and hasattr(ct, "close"):
                await ct.close()


SHAPES = [
    # (name, stores, zones, witness, degrade)
    ("3-zone", 3, 3, False, False),
    ("5-zone", 5, 5, False, False),
    ("3-zone-degraded-wan", 3, 3, False, True),
    ("3-zone-witness-2+1", 3, 3, True, False),
]


async def main_async(args) -> dict:
    from bench_torch_plane import host_record

    machine = host_record()
    rows = []
    for name, stores, zones, witness, degrade in SHAPES:
        ops = max(10, args.ops // (6 if degrade else 1))
        row = await run_shape(name, stores, zones, witness, degrade,
                              ops, args.seed)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {
        "bench": "geo",
        "seed": args.seed,
        "ops_per_row": args.ops,
        "link_shape": {"intra_ms": 0.2, "base_wan_ms": 3.0,
                       "jitter_ms": 1.0, "loss": 0.001,
                       "degrade": "latency x6, +1% loss"},
        "rows": rows,
        "note": ("commit = raft apply->commit closure at the leader "
                 "(one shaped-WAN quorum round); ack = full KV client "
                 "put.  witness row: 2 data + 1 witness: the quorum "
                 "ack may come from the witness's metadata append, so "
                 "commit cost matches the 3-full-replica row without a "
                 "third data copy."),
        **machine,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ops", type=int, default=150,
                    help="ops per row (degraded rows run 1/6th)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (never a committed file)")
    args = ap.parse_args()
    result = asyncio.run(main_async(args))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
