#!/usr/bin/env python3
"""Chip smoke for tpuraft_torch: drives the port on one CUDA card.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --quick    # build (-Xptxas -v), compare, stop
    python3 chip_smoke.py --cpu      # rehearsal at tiny sizes on the CPU

Phases (any failure exits non-zero; none is caught):
  1. the card (nvidia-smi name and power limit), the build of the
     kernel library (fused quorum, fused tick, replica quorum and
     deadline fold, one nvcc per source)
     and the build of the native engines from tpuraft_torch/native
     (logstore, multilog, kvstore, the epoll transport; make, g++, zlib);
  2. the fused-quorum CUDA kernel against its plain torch version on the
     card at G=16,384 (P=8, 5 and 32), G=16,421 (P=16, ragged), the
     cluster's G=1,028 (P=8), the KV store's G=2,048 (P=4) and the
     lifecycle's and leg D's G=64, 256 and 512 (P=4): bit-exact, and
     timed with CUDA events;
  3. the fused tick (raft_tick on CUDA, one launch) against the plain
     tick on the CPU: 50 rounds of random full state at G=16,384 P=8
     and G=2,048 P=4, and rounds of edge rows at G=16,421 P=16, G=1,028
     P=5, G=2,048 P=4, the ragged G=2,053 P=5 and G=64, 256 and 512 P=4;
     all 11 outputs and 15 state fields bit-exact;
     then the fused tick timed beside the plain tick on the card;
  4. the engine plane at 16,384 groups: MultiRaftEngine on CUDA and its
     numpy backend fed one ballot-box trace (3 voters; 5 voters with
     half the groups stalled at 2 acks) give identical commit callbacks;
  5. end to end (the main path): 3 endpoints x 1,024 engine-backed raft
     groups on the card elect, commit 8 writes per group read back from
     all three replicas, lose one endpoint, re-elect, and commit again on
     the two survivors; every engine tick of this phase must be exactly
     one fused-tick launch;
  6. the KV store on the card (the main path as users run it), durable
     under a temporary directory, every engine tick one fused-tick
     launch:
     A. 3 stores x 1,024 pre-split regions, one MultiRaftEngine each
        (G=2,048, P=4, 20 ms tick), every store's regions on one multilog
        journal and one multimeta journal, its data on the native KV
        engine, file:// snapshots (snap_due every 30 s), a 10 s election
        timeout with elections released over four timeouts once every
        store is up, SAFE reads, a batching client: 16,384
        1,000-byte records loaded, 4,096 operations of YCSB-A (50/50
        read/update, zipfian 0.99) from 64 workers, one store stopped (its regions re-elect
        and take a write) and restarted from its directory (log replay
        and snapshot installs); every record read back equal on all 3
        replicas, the recorded history linearizable, device fences and
        snap_due snapshots taken;
     B. 3 stores x 256 regions with lease reads and quiescence: reads
        equal to the loaded values, lease-lane hits, hibernation after
        an idle spell;
     C. the entry point: 3 `python -m tpuraft_torch.examples.rheakv_server
        --engine --store native --log-scheme multilog` processes over TCP,
        64 regions, 1,024 keys written and read back, then SIGTERM: each
        drains clean and exits 0;
     D. the PD deployment: `python -m tpuraft_torch.examples.pd_server
        --split-keys 48` and 3 `rheakv_server --engine --transport native
        --store native --log-scheme multilog --pd EP --regions 64`
        processes; leg A's 16,384 records of 1,000 bytes written through a
        PD-routed client over the native transport; PD-ordered splits
        take every store past its engine's 128 rows, so each server's
        engine grows on the card; every record read back equal, then
        SIGTERM: every process drains clean and exits 0;
  7. the engine soak (the repo's headline chaos soak, BENCH_SOAK.json):
     the port's examples/soak.py with --regions 1024 --engine, seed 1,
     10 s election timeout, for SOAK_SECS under the default nemesis
     (leader kills, one-way partitions, drops and delays): 3 stores of
     1,024 regions on the multilog journal, each engine G=2,048 P=4 on
     the card; the history linearizable, every engine tick one
     fused-tick launch;
  8. the region lifecycle (BENCH_SOAK.json's run_lifecycle), in a
     process of its own: the port's examples/soak.py with --lifecycle
     --regions 12, seed 11, for LIFECYCLE_SECS: 4 stores (the fourth
     empty), a lifecycle-enabled PD in-process, a shifting zipfian
     hotspot; heat splits, cold merges and cross-store moves
     (add-learner, catch-up, joint promote+remove), the keyspace
     covered, no lost ack, cold groups hibernated; every engine tick one
     fused-tick launch on the card, and some ticks with a group in a
     joint configuration; the PD's picture logged every 10 s;
  9. the supervised fleet: the port's proc_supervisor (ProcSupervisor
     over 3 StoreProcess children from server_argv: `rheakv_server
     --engine --transport native --store native --log-scheme multilog
     --regions 64`, engines of G=128 P=4 on the card); leg C's 1,024 keys,
     then a 50/50 read/update mix from 8 workers; the store that leads
     region 1 is SIGKILLed and the supervisor's restart brings it back
     READY from its directory; every acknowledged write read back, the
     history linearizable, every server's engine ticked (its metrics
     RPC), SIGTERM drains every process clean with exit 0;
 10. the storage fault plane, in a process of its own started beside
     phases 2-5 (it needs no card) and read after phase 9: the port's
     examples/soak.py with --disk-pressure --power-loss, seed 2, for
     FAULT_SOAK_SECS (BENCH_SOAK.json's run_disk_pressure), host only:
     ChaosDir quotas, ENOSPC bursts and power-loss crash images under
     the default nemesis; exit 0, disk_pressure_ok, linearizable, and
     power-loss crashes;
 11. the replica plane (the JAX package's replica-axis commit plane,
     tpuraft/parallel/, on one card):
     a. the replica-quorum CUDA kernel against its plain torch version
        and torch.kthvalue on the card, bit for bit, at R=3 G=16,384 (the
        north star), R=5 G=1,024, R=3 G=1,024 (11(b)'s shape) and R in
        {1, 2, 4, 7, 8, 9, 32, 33, 64, 65} at G=1,000 (every edge of the
        kernel's layouts), on edge planes (all-zero columns, ties, one row
        ahead, values up to 2^28 - 1, unattested rows at 0), then timed;
        and on an extremes plane at each shape (INT32_MIN and INT32_MAX,
        all-equal columns, grants of 0-255);
     b. in a process of its own after phase 8, beside no other phase:
        ReplicaPlaneCluster(3, 1024, device="cuda") with
        memory:// logs, the in-process transport and a 2 s election
        timeout: every group elects, takes 3 waves of 2 writes, loses the
        replica that leads the fewest groups, re-elects and takes one
        more write; every surviving replica's log equals the acknowledged
        writes, and every plane tick is one replica-quorum launch;
 12. group-axis mesh sharding (the JAX package's tpuraft/parallel/mesh.py
     and the engine's mesh mode), after 11(b), alone; each shard on its
     own card where the machine has enough, else the shards share
     cuda:0 (the script names the list; a line records it):
     a. the sharded tick at 2, 4 and 8 shards against the single-device
        fused tick at G=16,384 P=8 and G=65,536 P=4, 8 rounds with state
        carried, bit for bit, one launch a shard; the deadline-fold
        kernel against its plain version and the host scan (8 trials and
        the sentinel) at G=65,536 over 8 shards, the 9 back to back on
        one work buffer, then timed, and right again after its timed
        graphs; the replica
        quorum over a 2 x 4 grid against one device at R=4 G=16,384;
     b. bench_multichip.py's mesh lanes: one engine of 65,536 groups,
        P=4, over 8 shards, 10 s of stub controls: the witness clamp
        holds and engages, the stepdown, fence and election lanes fire,
        no fence stays pending, fused-tick launches = engine ticks x 8,
        fold launches = folds x 8;
     c. phase 5's fabric (3 x 256 groups, cut from 1,024) with every
        engine over 4 shards: elect, write, read back, stop the endpoint
        leading the fewest groups, re-elect, write again; launches =
        ticks x 4, fold launches = folds x 4;
     d. the replica plane over a 2 x 4 grid (4 replicas x 8 groups, 3
        waves of 5 writes, one replica stopped, one more write): every
        log equals the acknowledged writes, launches = plane ticks x 4;
 13. the driver's entry points and bench.py's device plane
     (tpuraft_torch/graft_entry.py and device_plane.py), after phase 10's
     child has ended, beside no other phase:
     a. entry(): the fused tick at 1,024 x 8 against the plain tick,
        bit for bit, one launch;
     b. dryrun_multichip(8) over 8 shards (sharing cuda:0 on one card):
        the sharded tick against the plain tick on the whole state, the
        replica quorum over a 2 x 4 grid against its plain version and
        the sort oracle, and a 4 x 8 replica-plane cluster over the grid
        committing two waves; one launch a shard, one replica-quorum
        launch a groups-shard a plane tick;
     c. bench.py's loop at 16,384 x 8 (3 voters, 400 ticks after 40
        warm-up ticks, pinned staging ring, window sized from the link),
        then one profiled pass: every tick's commit row against the
        plain tick's over the same acks on the card, launches = ticks;
        the median pass's commits/s, ticks/s, ack p50/p99, dispatch
        cost, window, completion RTT and the card's busy share logged;
 14. the bench family (bench_torch_scale.py, bench_torch_e2e.py and
     bench_torch_multichip.py, each in its own processes as a user runs
     it; (a) and (b) beside (c)), after phase 13, beside no other phase:
     a. one ladder rung: 1,024 groups x 3 endpoints in one process, each
        endpoint's engine on the card and its own multilog journal, a
        2 s election timeout released over 3 s, every group led, 4 s of
        paced writes:
        no error, every acknowledged write applied on all 3 replicas,
        each engine's launches = its ticks;
     b. 3 store processes over the native transport at 64 groups (1 s
        warm-up, 3 s measured, LAT and BRK): every store exits 0,
        commits and no error, every leader placed, launches = ticks in
        every store;
     c. --smoke over 8 shards of cuda:0 at 1,024 groups, every lane
        assertion holding, launches = ticks x 8 and fold launches =
        folds x 8; --engine-shape at 1,024 groups, launches = ticks and
        the tick rate logged;
 15. the KV store bench at region density and the host-plane A/Bs, each
     script in its own process group as a user runs it, all four at
     once, after phase 14:
     a. bench_torch_region_density.py: 256 regions x 3 stores in one
        process (engines of G=512, P=4 on the card, native KV engines,
        multilog journals, the counting PD), a 1.5 s election timeout
        released over four timeouts, every region led, 3 s of the 75/25
        put/get mix from 24 workers, then one traced put and one traced
        get: exit 0, every region led after the drive, acks and no error,
        both probes' stage marks, each engine's launches = its ticks;
     b. bench_torch_multiproc.py: 3 rheakv_server processes (no engine,
        the native transport, store and journal) at 64 regions, 24
        workers for 2 s; c. bench_torch_gray.py: both arms (detection on
        and off) at 16 regions, 8 workers, 2 s healthy and 4 s slow-disk
        phases; d. bench_torch_geo.py's four topologies at 20 ops a row:
        exit 0, every key of the reference's record, work in every row
        and arm, geo's commit and ack counts equal to its ops; gray's
        ratios logged, not gated.
With --cpu the server processes of legs C and D and of phase 9 run
their engines on the CPU. The last four lines are the native libraries,
the card, the kernel table and the result, the last two JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import bisect
import dataclasses
import itertools
import json
import os
import re
import struct
import subprocess
import sys
import time

import numpy as np

NEG = -(2**30)
SEED = 0                   # every input of every phase comes from it
TIMED_LAUNCHES = 2000      # kernel and plain launches timed per shape
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# the engine of a 1,024-region, 3-store KV store sized by the server's rule
# (tpuraft_torch/examples/rheakv_server.py): G = 1 << max(4, (1024 + 3)
# .bit_length()), P = max(4, 3 + 1)
KV_SHAPE = (2048, 4)
# the engines of phase 8 (4 stores, P=4, sized 64 rows for the lifecycle's
# splits) and of leg D's servers, which their splits grow from 128 rows to
# 256 and then 512
LIFECYCLE_SHAPES = [(64, 4), (256, 4), (512, 4)]


def log(*a) -> None:
    print(*a, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 1: the card and the build -----------------------------------------

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tpuraft_torch", "native")


def native_modules():
    """The loaders of the four native libraries the port builds."""
    from tpuraft_torch.rheakv import native_store
    from tpuraft_torch.rpc import native_tcp
    from tpuraft_torch.storage import multilog, native_log

    return {"logstore": native_log, "multilog": multilog,
            "kvstore": native_store, "transport": native_tcp}


def phase_native() -> float:
    """Build the native storage engines from the checkout's sources
    (ensure_built runs make in tpuraft_torch/native) and load each."""
    t0 = time.perf_counter()
    for mod in native_modules().values():
        mod.ensure_built()
        mod._load()
    build_s = time.perf_counter() - t0
    log(f"[1] native engines built and loaded from {NATIVE_DIR} in "
        f"{build_s:.3f} s")
    return build_s


def native_paths() -> dict:
    """name -> resolved path of each loaded native library; each must
    lie in tpuraft_torch/native (no TPURAFT_NATIVE_*_LIB override, no
    library of the JAX package's native/)."""
    paths = {}
    for name, mod in native_modules().items():
        check(mod._lib is not None, f"{name}: library never loaded")
        paths[name] = os.path.realpath(mod._lib._name)
        check(os.path.dirname(paths[name]) == os.path.realpath(NATIVE_DIR),
              f"{name}: loaded {paths[name]}, not from {NATIVE_DIR}")
    return paths


def ptxas_entry(line: str) -> str:
    """The kernel and layout a ptxas "Compiling entry function" line names
    (the fused kernels' segment width S; the replica quorum's S and
    replicas a lane V, or its wide path), or "" for any other kernel."""
    m = re.search(r"(fused_quorum|fused_tick)_kernelILi(\d+)EE", line)
    if m:
        return f"{m[1]} S={m[2]}"
    m = re.search(r"replica_quorum_kernelILi(\d+)ELi(\d+)EE", line)
    if m:
        return f"replica_quorum S={m[1]} V={m[2]}"
    return "replica_quorum wide" if "replica_quorum_wide_kernel" in line \
        else ""


def phase_card(args, torch, quorum_cuda) -> tuple[str, float | None]:
    if args.cpu:
        log("[1] rehearsal on the CPU: no card, no kernel build")
        return "", None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so, out = quorum_cuda.build(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"[1] built {so.name} in {build_s:.3f} s")
    entry = ""
    for line in out.splitlines():  # -Xptxas -v for every kernel's layout
        if "Compiling entry function" in line:
            entry = ptxas_entry(line)
        elif entry and ("Used" in line or "spill" in line):
            log(f"    ptxas {entry}: {line.strip()}")
    quorum_cuda.load()
    return card, build_s


# -- phase 2: kernel vs plain --------------------------------------------------

def quorum_inputs(rng, g, p):
    """Seeded [G, P] planes with empty, single-voter, joint and NEG-ack
    rows (and a NEG-valued match)."""
    match = rng.integers(0, 1 << 20, (g, p)).astype(np.int32)
    ack = rng.integers(0, 1 << 29, (g, p)).astype(np.int32)
    ack[rng.random((g, p)) < 0.1] = NEG             # not acked yet
    match[rng.random((g, p)) < 0.01] = NEG
    granted = rng.random((g, p)) < 0.5
    vm = rng.random((g, p)) < 0.6
    kind = rng.random(g)
    vm[kind < 0.05] = False                          # empty rows
    single = (kind >= 0.05) & (kind < 0.1)
    vm[single] = False
    vm[single, 0] = True                             # single voter
    ovm = (rng.random((g, p)) < 0.5) & (rng.random((g, 1)) < 0.25)  # joint
    return match, granted, ack, vm, ovm


def bound_ms(g, p) -> float:
    """Least time for the work: each input read once (2 int32 + 3 bool
    planes), each output written once (2 int32 + 1 bool rows)."""
    return (11 * g * p + 9 * g) / HBM_BYTES_PER_S * 1e3


def time_events(torch, fn, n) -> float:
    """ms per call of n back-to-back eager calls (host launch included)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_graph(torch, fn, per_graph=100, replays=20) -> float:
    """ms per call on the device: per_graph calls captured in one CUDA
    graph and replayed, so host launch cost drops out."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (per_graph * replays)


def phase_kernel(args, torch, quorum_cuda, dev) -> list[dict]:
    shapes = [(37, 16), (30, 5), (64, 8), (48, 4)] if args.cpu else \
        [(16384, 8), (16384 + 37, 16), (16384, 5), (16384, 32), (1028, 8),
         KV_SHAPE, *LIFECYCLE_SHAPES]
    rng = np.random.default_rng(SEED)
    rows = []
    for g, p in shapes:
        case = [torch.from_numpy(a).to(dev) for a in quorum_inputs(rng, g, p)]
        got = quorum_cuda.fused_quorum(*case)
        want = quorum_cuda.fused_quorum_reference(*case)
        if not args.cpu:
            torch.cuda.synchronize()
        err = 0
        for name, t, w in zip(("quorum_idx", "elected", "q_ack"), got, want):
            check(t.device == w.device and t.dtype == w.dtype
                  and t.shape == (g,), f"{name}: wrong result layout")
            check(torch.equal(t, w),
                  f"fused_quorum {name} differs from plain at G={g} P={p}")
            err = max(err, int((t.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
        row = {"G": g, "P": p, "max_abs_err": err,
               "bound_ms": bound_ms(g, p)}
        if args.cpu or args.quick:
            row.update(ms=None, plain_ms=None, eager_ms=None)
        else:
            n = TIMED_LAUNCHES
            row["eager_ms"] = time_events(
                torch, lambda: quorum_cuda.fused_quorum(*case), n)
            row["ms"] = time_graph(
                torch, lambda: quorum_cuda.fused_quorum(*case),
                replays=max(1, n // 100))
            row["plain_ms"] = time_graph(
                torch, lambda: quorum_cuda.fused_quorum_reference(*case),
                replays=max(1, n // 100))
            row["plain_eager_ms"] = time_events(
                torch, lambda: quorum_cuda.fused_quorum_reference(*case), n)
        rows.append(row)
        log(f"[2] fused_quorum G={g} P={p}: bit-exact vs plain; "
            + ", ".join(f"{k}={v}" for k, v in row.items()
                        if k.endswith("ms")))
    return rows


# -- phase 3: the tick, CUDA vs CPU ---------------------------------------------

def rand_tick_fields(rng, g, p) -> dict:
    """Every GroupState field populated (the distribution of the JAX
    package's sharded-tick differential)."""
    return {
        "role": rng.integers(0, 4, g).astype(np.int32),
        "commit_rel": rng.integers(0, 40, g).astype(np.int32),
        "pending_rel": rng.integers(1, 20, g).astype(np.int32),
        "match_rel": rng.integers(0, 100, (g, p)).astype(np.int32),
        "granted": rng.random((g, p)) < 0.4,
        "voter_mask": rng.random((g, p)) < 0.7,
        "old_voter_mask": np.where((rng.random(g) < 0.2)[:, None],
                                   rng.random((g, p)) < 0.5, False),
        "elect_deadline": rng.integers(0, 2500, g).astype(np.int32),
        "hb_deadline": rng.integers(0, 2500, g).astype(np.int32),
        "last_ack": np.where(rng.random((g, p)) < 0.8,
                             rng.integers(0, 1500, (g, p)),
                             NEG).astype(np.int32),
        "snap_deadline": rng.integers(0, 3000, g).astype(np.int32),
        "quiescent": rng.random(g) < 0.3,
        "witness_mask": rng.random((g, p)) < 0.2,
        "stepdown_deadline": rng.integers(0, 2500, g).astype(np.int32),
        "fence_start": np.where(rng.random(g) < 0.4,
                                rng.integers(0, 1500, g),
                                NEG).astype(np.int32),
    }


INT32_MAX = 2**31 - 1


def edge_tick_fields(rng, g, p) -> dict:
    """rand_tick_fields with edge rows mixed in, the rows a kernel can get
    wrong bit by bit: witness confs whose data slots all hold negative
    matches; matches and acks below -2^30 (down to -2^31); acks just above
    -2^30 (so now - q_ack wraps when now is near 2^31 - 1); deadlines
    near 2^31 - 1 (so now + interval wraps); joint, empty and
    single-voter rows."""
    f = rand_tick_fields(rng, g, p)
    kind = rng.integers(0, 7, g)
    vm, wit, match = f["voter_mask"], f["witness_mask"], f["match_rel"]
    ack = f["last_ack"]
    w = kind == 0                     # witness conf, negative data matches
    vm[w] = True
    wit[w] = False
    wit[w, rng.integers(0, p, int(w.sum()))] = True
    match[w] = -rng.integers(1, 50, (int(w.sum()), p))
    low = kind == 1                   # below the -2^30 sentinel
    pick = low[:, None] & (rng.random((g, p)) < 0.5)
    match[pick] = rng.choice([NEG - 1, -(2**31), NEG - 7], int(pick.sum()))
    ack[pick] = rng.choice([NEG - 1, -(2**31)], int(pick.sum()))
    near = kind == 2                  # acks just above the sentinel
    ack[near] = NEG + rng.integers(1, 6, (int(near.sum()), p))
    late = kind == 3                  # deadlines that make now + x wrap
    for k in ("elect_deadline", "hb_deadline", "snap_deadline",
              "stepdown_deadline"):
        f[k][late] = INT32_MAX - rng.integers(0, 3000, int(late.sum()))
    joint = kind == 4
    f["old_voter_mask"][joint] = rng.random((int(joint.sum()), p)) < 0.6
    empty = kind == 5                 # no voters; or a single voter
    vm[empty] = False
    one = empty & (rng.random(g) < 0.5)
    vm[one, 0] = True
    return f


def edge_tick_params(rng, g):
    """[G] parameter rows with odd and negative election timeouts (floor
    division), intervals that make now + x wrap, and disabled or
    negative snapshot intervals."""
    eto = rng.integers(300, 1200, g)
    odd = rng.random(g) < 0.2
    eto[odd] = rng.choice([-3, -1, 0, 1, 3, 7], int(odd.sum()))
    hb = rng.integers(50, 200, g)
    hb[rng.random(g) < 0.1] = INT32_MAX - 5
    lease = rng.integers(200, 1000, g)
    snap = rng.choice([0, 700, -5, INT32_MAX], g)
    return eto, hb, lease, snap


def edge_now(rng) -> int:
    """A tick time: mostly ordinary, sometimes near either int32 end."""
    return int(rng.choice([int(rng.integers(0, 3000)),
                           INT32_MAX - int(rng.integers(0, 3000)),
                           -(2**31) + int(rng.integers(0, 3000))],
                          p=[0.6, 0.3, 0.1]))


def tick_bound_ms(tick, state, params, with_state=False) -> float:
    """Least time for the fused tick: every state field and parameter
    read once, the packed outputs written once (and, for raft_tick, the
    three advanced deadline rows)."""
    g = state.role.shape[0]
    n = sum(getattr(obj, f.name).nbytes for obj in (state, params)
            for f in dataclasses.fields(obj))
    n += tick.packed_nbytes(g) + (12 * g if with_state else 0)
    return n / HBM_BYTES_PER_S * 1e3


# a G not a multiple of 16, so the last block is part full, with P=5
# (three dead lanes a segment), [G] parameter rows, joint and witness
# rows (edge_tick_fields)
RAGGED_TICK_G = 2053


def tick_cases(args):
    """(name, G, P, fields generator, params, rounds) of phase 3."""
    if args.cpu:
        return [("random", 256, 8, rand_tick_fields, "rows", 5),
                ("edge", 101, 16, edge_tick_fields, "rows", 5),
                ("edge", 64, 5, edge_tick_fields, "scalars", 5),
                ("random", 48, 4, rand_tick_fields, "rows", 5),
                ("edge", 48, 4, edge_tick_fields, "rows", 5)]
    rounds = 3 if args.quick else 50
    g, p = KV_SHAPE
    return [("random", 16384, 8, rand_tick_fields, "rows", rounds),
            ("edge", 16384 + 37, 16, edge_tick_fields, "rows", rounds),
            ("edge", 1028, 5, edge_tick_fields, "scalars", rounds),
            ("random", g, p, rand_tick_fields, "rows", rounds),
            ("edge", g, p, edge_tick_fields, "rows", rounds),
            ("edge", RAGGED_TICK_G, 5, edge_tick_fields, "rows", rounds),
            *(("edge", lg, lp, edge_tick_fields, "rows", rounds)
              for lg, lp in LIFECYCLE_SHAPES)]


def phase_tick(args, torch, dev) -> list[dict]:
    from tpuraft_torch.ops import tick

    rng = np.random.default_rng(SEED + 1)
    fired = 0
    for name, g, p, gen, kind, rounds in tick_cases(args):
        fields = gen(rng, g, p)
        if kind == "scalars":
            prm = (999, 100, 900, 700)  # 0-d params; an odd timeout
        elif name == "edge":
            prm = edge_tick_params(rng, g)
        else:
            prm = (rng.integers(300, 1200, g), rng.integers(50, 200, g),
                   rng.integers(200, 1000, g), rng.integers(0, 2, g) * 700)
        pd = tick.tick_params_from_numpy(*prm, device=dev)
        pc = tick.tick_params_from_numpy(*prm, device="cpu")
        sd = tick.group_state_from_numpy(fields, device=dev)
        sc = tick.group_state_from_numpy(fields, device="cpu")
        before = tick.LAUNCHES
        for r in range(rounds):
            now = edge_now(rng) if name == "edge" else \
                int(rng.integers(0, 3000))
            sd, od = tick.raft_tick(sd, now, pd)
            sc, oc = tick.raft_tick(sc, now, pc)
            for what, a, b in (("output", od, oc), ("state", sd, sc)):
                an, bn = tick.outputs_to_numpy(a), tick.outputs_to_numpy(b)
                for k in bn:
                    check(np.array_equal(an[k], bn[k]),
                          f"{name} G={g} P={p} round {r}: {what} {k} "
                          f"differs {dev} vs cpu")
            fired += int(tick.outputs_to_numpy(oc)["elected"].sum())
            keep = tick.outputs_to_numpy(sc)
            fresh = gen(rng, g, p)
            for k in ("match_rel", "last_ack", "granted", "role",
                      "fence_start"):
                keep[k] = fresh[k]
            sd = tick.group_state_from_numpy(keep, device=dev)
            sc = tick.group_state_from_numpy(keep, device="cpu")
        if not args.cpu:
            check(tick.LAUNCHES - before == rounds,
                  f"{rounds} CUDA ticks made {tick.LAUNCHES - before} "
                  f"fused-tick launches")
        log(f"[3] raft_tick {dev} vs cpu: {rounds} rounds of {name} rows "
            f"at G={g} P={p} ({kind} params), all 11 outputs and 15 state "
            f"fields bit-exact")
    check(fired > 0, "tick phase never elected a candidate")

    rows = []
    for g, p in ([(64, 8), (48, 4)] if args.cpu else
                 [(16384, 8), (16384 + 37, 16), (1028, 8), KV_SHAPE,
                  *LIFECYCLE_SHAPES]):
        fields = rand_tick_fields(rng, g, p)
        prm = (rng.integers(300, 1200, g), rng.integers(50, 200, g),
               rng.integers(200, 1000, g), rng.integers(0, 2, g) * 700)
        pd = tick.tick_params_from_numpy(*prm, device=dev)
        sd = tick.group_state_from_numpy(fields, device=dev)
        now = int(rng.integers(0, 3000))
        buf = torch.empty(tick.packed_nbytes(g), dtype=torch.uint8,
                          device=dev)
        got = tick.raft_tick_outputs(sd, now, pd, out=buf)
        want = tick.raft_tick_reference(sd, now, pd)[1]
        err = max(int((getattr(got, f.name).to(torch.int64)
                       - getattr(want, f.name).to(torch.int64)).abs().max())
                  for f in dataclasses.fields(want))
        check(err == 0, f"fused tick differs from plain at G={g} P={p}")
        row = {"G": g, "P": p, "max_abs_err": err,
               "bound_ms": tick_bound_ms(tick, sd, pd),
               "bound_ms_with_state": tick_bound_ms(tick, sd, pd, True),
               "ms": None, "plain_ms": None, "eager_ms": None,
               "plain_eager_ms": None}
        if not (args.cpu or args.quick):
            n = TIMED_LAUNCHES

            def fused():
                tick.raft_tick_outputs(sd, now, pd, out=buf)

            def plain():
                tick.raft_tick_reference(sd, now, pd)

            row["eager_ms"] = time_events(torch, fused, n)
            row["ms"] = time_graph(torch, fused, replays=max(1, n // 100))
            row["plain_ms"] = time_graph(torch, plain,
                                         replays=max(1, n // 100))
            row["plain_eager_ms"] = time_events(torch, plain, n // 10)
        rows.append(row)
        log(f"[3] fused_tick G={g} P={p}: " + ", ".join(
            f"{k}={v}" for k, v in row.items() if k.endswith("ms")
            or "bound" in k))
    return rows


# -- phase 4: the engine plane, CUDA vs numpy ----------------------------------

async def phase_engine(args, torch, dev) -> None:
    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.entity import PeerId
    from tpuraft_torch.options import TickOptions

    G = 512 if args.cpu else 16384
    peers = [PeerId.parse(f"127.0.0.1:{7500 + i}") for i in range(5)]

    async def run(n_voters, backend):
        conf = Configuration(peers[:n_voters])
        kw = dict(device=str(dev)) if backend == "torch" else {}
        eng = MultiRaftEngine(TickOptions(
            max_groups=G, max_peers=8, eager_commit=False, backend=backend,
            **kw))
        await eng.start()
        commits = []
        try:
            factory = eng.ballot_box_factory()
            rng = np.random.default_rng(SEED + n_voters)
            boxes = []
            for g in range(G):
                box = factory(lambda idx, g=g: commits.append((g, idx)))
                box.update_conf(conf, Configuration())
                box.reset_pending_index(1)
                boxes.append(box)
            for _ in range(3):
                for g, box in enumerate(boxes):
                    # 5 voters: half the groups stall at 2 acks
                    ackers = peers[:2] if n_voters == 5 and g % 2 else \
                        peers[:n_voters]
                    for p in ackers:
                        if rng.random() < 0.8:
                            box.commit_at(p, int(rng.integers(1, 1000)),
                                          conf, Configuration())
                eng.tick_once()
        finally:
            await eng.shutdown()
        return commits

    for n_voters in (3, 5):
        t0 = time.perf_counter()
        dev_commits = await run(n_voters, "torch")
        np_commits = await run(n_voters, "numpy")
        check(dev_commits == np_commits,
              f"{n_voters} voters: engine commits differ {dev} vs numpy")
        groups = {g for g, _ in dev_commits}
        if n_voters == 5:
            check(all(g % 2 == 0 for g in groups),
                  "a group stalled at 2 of 5 acks committed")
        check(len(groups) > G // 4, "the engine trace committed too little")
        log(f"[4] engine G={G} {n_voters} voters: {len(dev_commits)} commit "
            f"callbacks identical {dev} vs numpy "
            f"({time.perf_counter() - t0:.3f} s)")


# -- phase 5: end to end -------------------------------------------------------

def make_fsm_class():
    from tpuraft_torch.core.state_machine import StateMachine

    class LogFSM(StateMachine):
        """Records every applied payload in order."""

        def __init__(self):
            self.logs: list[bytes] = []

        async def on_apply(self, it) -> None:
            while it.valid():
                self.logs.append(it.data())
                it.next()

    return LogFSM


async def phase_e2e(args, torch, quorum_cuda, tick, dev, shards=0,
                    tag="5", groups=1024) -> dict:
    """Phase 5 (and, with ``shards``, phase 12(c): every engine in mesh
    mode over that many shards, and the endpoint leading the fewest
    groups is the one stopped)."""
    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.core.node import Node, State
    from tpuraft_torch.core.node_manager import NodeManager
    from tpuraft_torch.entity import PeerId, Task
    from tpuraft_torch.options import NodeOptions, TickOptions
    from tpuraft_torch.rpc.transport import (InProcNetwork, InProcTransport,
                                             RpcServer)

    n_groups = (args.groups or 16) if args.cpu else groups
    n_writes, eto_ms = 8, 2000
    loop = asyncio.get_running_loop()
    rng = np.random.default_rng(SEED + 7)
    eps = [PeerId.parse(f"127.0.0.1:{6000 + i}") for i in range(3)]
    conf = Configuration(list(eps))
    groups = [f"region-{k}" for k in range(n_groups)]
    LogFSM = make_fsm_class()
    net = InProcNetwork()
    engines, nodes, fsms = {}, {}, {}

    from tpuraft_torch.ops import deadline_fold

    fold_calls = [0]

    def counted(fold):
        def run(*rows):
            fold_calls[0] += 1
            return fold(*rows)
        return run

    tick.LAUNCHES = 0  # the main path's counts start here
    quorum_cuda.LAUNCHES = 0
    deadline_fold.LAUNCHES = 0
    t0 = time.perf_counter()
    for ep in eps:
        server = RpcServer(ep.endpoint)
        manager = NodeManager(server)
        net.bind(server)
        transport = InProcTransport(net, ep.endpoint)
        opts = TickOptions(max_groups=n_groups + 4)
        if shards:
            opts.mesh_devices = shards
            opts.device = mesh_of(args, torch, shards)
        elif args.cpu:
            opts.device = "cpu"
        engine = MultiRaftEngine(opts)
        await engine.start()
        if shards:
            check(engine._deadline_fold is not None, "mesh mode off")
            engine._deadline_fold = counted(engine._deadline_fold)
        engines[ep.endpoint] = engine
        factory = engine.ballot_box_factory()
        for gid in groups:
            fsm = fsms[(gid, ep)] = LogFSM()
            node = Node(gid, ep, NodeOptions(
                election_timeout_ms=eto_ms, initial_conf=conf.copy(),
                fsm=fsm, log_uri="memory://", raft_meta_uri="memory://"),
                transport, ballot_box_factory=factory)
            node.node_manager = manager
            manager.add(node)
            check(await node.init(), f"{gid}@{ep} failed to init")
            nodes[(gid, ep)] = node
    boot_s = time.perf_counter() - t0
    all_engines = list(engines.values())

    async def leaders(timeout_s):
        deadline = loop.time() + timeout_s
        while True:
            found = {}
            for (g, _), n in nodes.items():
                if n.state == State.LEADER:
                    found.setdefault(g, []).append(n)
            if all(len(found.get(g, ())) == 1 for g in groups):
                return {g: found[g][0] for g in groups}
            check(loop.time() < deadline,
                  f"{sum(len(found.get(g, ())) == 1 for g in groups)}/"
                  f"{len(groups)} groups have one leader")
            await asyncio.sleep(0.05)

    async def write_all(leader_of, payloads):
        futs = []
        for g in groups:
            for data in payloads[g]:
                fut = loop.create_future()
                await leader_of[g].apply(Task(data=data, done=fut.set_result))
                futs.append((g, fut))
        sts = await asyncio.wait_for(
            asyncio.gather(*[f for _, f in futs]), 120)
        bad = [(g, str(st)) for (g, _), st in zip(futs, sts) if not st.is_ok()]
        check(not bad, f"{len(bad)} writes not acknowledged: {bad[:3]}")
        return len(futs)

    async def read_back(keys, want, timeout_s=60):
        deadline = loop.time() + timeout_s
        while True:
            behind = [k for k in keys if fsms[k].logs != want[k[0]]]
            if not behind:
                return
            for k in behind:
                check(fsms[k].logs[:len(want[k[0]])] == want[k[0]][
                    :len(fsms[k].logs)],
                      f"replica {k} log differs from the acked writes")
            check(loop.time() < deadline,
                  f"{len(behind)} replicas behind the acked writes")
            await asyncio.sleep(0.05)

    try:
        t0 = time.perf_counter()
        leader_of = await leaders(120)
        elect_s = time.perf_counter() - t0

        payloads = {g: [bytes(rng.integers(0, 256, 64, dtype=np.uint8))
                        for _ in range(n_writes)] for g in groups}
        t0 = time.perf_counter()
        acked = await write_all(leader_of, payloads)
        await read_back(list(fsms), payloads)
        write_s = time.perf_counter() - t0
        check(acked == n_groups * n_writes, "write count")
        log(f"[{tag}] {len(eps)} x {n_groups} groups elected in "
            f"{elect_s:.3f} s; "
            f"{acked} acked writes read back in order, once, from all 3 "
            f"replicas ({write_s:.3f} s)")

        # one endpoint stops: every group it led re-elects on the others
        dead = eps[0]
        if shards:  # the endpoint leading the fewest groups
            led = {ep: 0 for ep in eps}
            for n in leader_of.values():
                led[n.server_id] += 1
            dead = min(eps, key=led.__getitem__)
        lost = sum(1 for n in leader_of.values() if n.server_id == dead)
        t0 = time.perf_counter()
        net.stop_endpoint(dead.endpoint)
        for g in groups:
            await nodes.pop((g, dead)).shutdown()
            fsms.pop((g, dead))
        await engines.pop(dead.endpoint).shutdown()
        net.unbind(dead.endpoint)
        leader_of = await leaders(180)
        check(all(n.server_id != dead for n in leader_of.values()),
              "a group is still led by the stopped endpoint")
        more = {g: [bytes(rng.integers(0, 256, 64, dtype=np.uint8))]
                for g in groups}
        acked2 = await write_all(leader_of, more)
        want = {g: payloads[g] + more[g] for g in groups}
        await read_back(list(fsms), want)
        failover_s = time.perf_counter() - t0
        log(f"[{tag}] endpoint {dead.endpoint} stopped: {lost} groups lost "
            f"their leader, all {n_groups} groups re-elected and "
            f"committed {acked2} more writes on both survivors "
            f"({failover_s:.3f} s)")
    finally:
        for n in nodes.values():
            await n.shutdown()
        for e in engines.values():
            await e.shutdown()
    launches = tick.LAUNCHES  # read right after the main path
    quorum_launches = quorum_cuda.LAUNCHES
    fold_launches = deadline_fold.LAUNCHES
    hist = [e.tick_histograms()["tick_device_ms"] for e in all_engines]
    res = {
        "launches": launches,
        "fused_quorum_launches": quorum_launches,
        "engine_ticks": sum(e.ticks for e in all_engines),
        "commit_advances": sum(e.commit_advances for e in all_engines),
        "eager_commits": sum(e.eager_commits for e in all_engines),
        "shards": max(shards, 1), "fold_launches": fold_launches,
        "fold_calls": fold_calls[0], "victim_led": lost,
        "boot_s": boot_s, "elect_s": elect_s, "write_s": write_s,
        "failover_s": failover_s,
        "tick_device_ms_p50": [h["p50"] for h in hist],
        "tick_device_ms_p99": [h["p99"] for h in hist],
    }
    log(f"[{tag}] " + json.dumps(res))
    if not args.cpu:
        n = max(shards, 1)
        check(launches > 0 and launches == res["engine_ticks"] * n,
              f"{res['engine_ticks']} engine ticks made {launches} "
              f"fused-tick launches ({n} each expected)")
        check(fold_launches == fold_calls[0] * shards,
              f"{fold_calls[0]} deadline folds made {fold_launches} fold "
              f"launches ({shards} each expected)")
    if shards:
        check(fold_calls[0] > 0, "the mesh engines never folded a deadline")
    return res


# -- phase 6: the KV store on the card ----------------------------------------

KV_VALUE_BYTES = 1000      # YCSB's default record: 10 fields x 100 bytes
KV_KEYS_PER_REGION = 16
KV_WORKERS = 64
ZIPF_THETA = 0.99          # YCSB's zipfian constant
KV_ETO_MS = 2000           # election timeout of leg B's stores
# leg A's and phase 7's: the repo's own at 1,024 regions
# (bench_region_density.py --election-timeout-ms, BENCH_SOAK.json); at 2 s
# the event loop's lag in a failover of ~950 regions reached the timeout
# and leadership churned
DENSITY_ETO_MS = 10000
# snap_due fires within leg A; at 10 s the snapshot herd of 3,072
# replicas cut the mix from 423 to 40-57 ops/s (bench_torch_kv.py)
KV_SNAPSHOT_SECS = 30
KV_DISK_BUDGET = 4 << 30   # explicit: statvfs may read a shared disk FULL
# leg A's YCSB-A mix, in operations: a quarter of the records, cut from
# all of them to keep the script under 800 s with phase 11 (at 132-209
# ops/s the full mix took 78-124 s) and from half with phase 12 (8,192
# took 59.8-80.0 s)
KV_MIX_OPS = 4096


def engine_shape(n_regions: int, n_stores: int = 3) -> tuple[int, int]:
    """The server's engine sizing rule (examples/rheakv_server.py)."""
    return 1 << max(4, (n_regions + 3).bit_length()), max(4, n_stores + 1)


def kv_key(i: int, n_keys: int) -> bytes:
    """Record i of n_keys: a 4-byte big-endian prefix spreads the records
    evenly over the server's pre-split regions, then a YCSB-style name."""
    return struct.pack(">I", i * (1 << 32) // n_keys) + b"user%d" % i


class KVValues:
    """1,000-byte values made from the seed, each unique to its write (its
    op number leads it), so the checker can tell every write apart."""

    def __init__(self, rng):
        self.pool = rng.bytes(4 * KV_VALUE_BYTES)

    def __call__(self, op: int) -> bytes:
        head = b"%010d|" % op
        off = (op * 7919) % (3 * KV_VALUE_BYTES)
        return head + self.pool[off:off + KV_VALUE_BYTES - len(head)]


def zipf_keys(rng, n_keys: int, n: int) -> np.ndarray:
    """n record indices under YCSB's scrambled zipfian (theta 0.99): rank
    r has weight 1 / r^theta, and a seeded permutation scatters the hot
    ranks over the key space as YCSB's hash does."""
    w = 1.0 / np.arange(1, n_keys + 1) ** ZIPF_THETA
    ranks = rng.choice(n_keys, size=n, p=w / w.sum())
    return rng.permutation(n_keys)[ranks]


class KVFabric:
    """3 StoreEngines in this process over the in-process transport (the
    fabric of phase 5), each driving all its regions from one
    MultiRaftEngine sized by the server's rule, durable under data_path."""

    def __init__(self, args, n_regions: int, data_path: str,
                 native: bool = False, eto_ms: int = KV_ETO_MS,
                 **store_kw):
        """native: every store's regions on one multilog journal (and one
        multimeta journal), its data on the native KV engine, as the
        region-density configuration runs them
        (bench_region_density.py)."""
        from tpuraft_torch.examples.rheakv_server import derive_regions
        from tpuraft_torch.rpc.transport import InProcNetwork

        self.args = args
        self.native = native
        self.eto_ms = eto_ms
        self.endpoints = [f"127.0.0.1:{6100 + i}" for i in range(3)]
        self.regions = derive_regions(self.endpoints, n_regions)
        self.n_regions = n_regions
        self.data_path = data_path
        self.store_kw = store_kw
        self.net = InProcNetwork()
        self.stores = {}
        self.engines = []  # every engine this fabric started, stopped too

    async def start_store(self, ep: str, hold_elections: bool = False):
        from tpuraft_torch.core.engine import MultiRaftEngine
        from tpuraft_torch.options import TickOptions
        from tpuraft_torch.rheakv.store_engine import (StoreEngine,
                                                       StoreEngineOptions)
        from tpuraft_torch.rpc.transport import InProcTransport, RpcServer

        server = RpcServer(ep)
        self.net.bind(server)
        self.net.start_endpoint(ep)
        g, p = engine_shape(self.n_regions)
        topts = TickOptions(max_groups=g, max_peers=p, tick_interval_ms=20)
        if self.args.cpu:
            topts.device = "cpu"
        engine = MultiRaftEngine(topts)
        self.engines.append(engine)
        opts = StoreEngineOptions(
            server_id=ep, initial_regions=[r.copy() for r in self.regions],
            data_path=self.data_path, election_timeout_ms=self.eto_ms,
            disk_budget_bytes=KV_DISK_BUDGET, **self.store_kw)
        if self.native:
            from tpuraft_torch.rheakv.native_store import NativeRawKVStore

            opts.log_scheme = "multilog"
            kv_dir = f"{self.data_path}/kv_{ep.replace(':', '_')}"
            os.makedirs(self.data_path, exist_ok=True)
            opts.raw_store_factory = lambda: NativeRawKVStore(kv_dir,
                                                              sync=False)
        store = StoreEngine(opts, server, InProcTransport(self.net, ep),
                            multi_raft_engine=engine)
        if hold_elections:  # start_all releases them
            start_region = store._start_region

            async def held(region):
                re_ = await start_region(region)
                engine.elect_deadline[re_.node._ctrl.slot] = \
                    engine.now_ms() + 3_600_000
                return re_

            store._start_region = held
        self.stores[ep] = store
        await store.start()
        return store

    async def start_all(self) -> None:
        """Boot every store with its regions' elections held, then
        release them jittered over four election timeouts from the seed,
        as the source configuration boots its stores
        (bench_region_density.py:181-201); otherwise the store booted
        first wins nearly every election."""
        for ep in self.endpoints:
            await self.start_store(ep, hold_elections=True)
        rng = np.random.default_rng(SEED)
        for engine in self.engines:
            engine.elect_deadline[:] = engine.now_ms() + self.eto_ms // 4 \
                + rng.integers(0, 4 * self.eto_ms, engine.G)
            engine.mark_dirty()

    async def stop_store(self, ep: str) -> None:
        self.net.stop_endpoint(ep)
        store = self.stores.pop(ep)
        self.net.unbind(ep)
        await store.shutdown()

    async def stop_all(self) -> None:
        for ep in list(self.stores):
            await self.stop_store(ep)

    def client(self):
        from tpuraft_torch.rheakv.client import BatchingOptions, RheaKVStore
        from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
        from tpuraft_torch.rpc.transport import InProcTransport

        return RheaKVStore(
            FakePlacementDriverClient([r.copy() for r in self.regions]),
            InProcTransport(self.net, "kvclient:0"),
            batching=BatchingOptions(enabled=True))

    async def wait_leaders(self, timeout_s: float) -> dict:
        """region id -> the one store that leads it, once every region
        has exactly one leader among the live stores."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while True:
            led = {}
            for ep, s in self.stores.items():
                for rid in s.leader_region_ids():
                    led.setdefault(rid, []).append(ep)
            one = sum(len(led.get(r.id, ())) == 1 for r in self.regions)
            if one == self.n_regions:
                return {rid: eps[0] for rid, eps in led.items()}
            check(loop.time() < deadline,
                  f"{one}/{self.n_regions} regions have one leader")
            await asyncio.sleep(0.1)


async def run_kv_ops(kv, hist, ops, lats=None) -> None:
    """ops = [(kind, key, value)] ("w" put, "r" get) from KV_WORKERS
    concurrent workers, each op recorded in the history around its call;
    an op that raises stays pending there and fails the phase."""
    todo = iter(ops)
    errors = []

    async def worker(w):
        for kind, key, val in todo:
            tok = hist.invoke(w, kind, (key, val) if kind == "w" else (key,))
            t0 = time.perf_counter()
            try:
                res = await (kv.put(key, val) if kind == "w"
                             else kv.get(key))
            except Exception as exc:  # recorded as pending, then failed
                errors.append(f"{kind} {key!r}: {exc!r}")
                continue
            if lats is not None:
                lats.append(time.perf_counter() - t0)
            hist.complete(tok, res)
            if kind == "w" and res is not True:
                errors.append(f"put {key!r} not acknowledged: {res!r}")

    await asyncio.gather(*(worker(w) for w in range(KV_WORKERS)))
    check(not errors, f"{len(errors)} KV ops failed: {errors[:3]}")


async def write_until_acked(kv, hist, key, new_value, deadline) -> int:
    """One write a client retries through a failover until it is
    acknowledged; each attempt is its own op in the history, with a value
    of its own, and one that fails stays pending there (it may or may not
    have applied).  Returns the attempts made."""
    from tpuraft_torch.rheakv.client import RheaKVError

    loop = asyncio.get_running_loop()
    for attempt in itertools.count(1):
        val = new_value()
        tok = hist.invoke(-1, "w", (key, val))
        try:
            if await kv.put(key, val) is True:
                hist.complete(tok, True)
                return attempt
        except RheaKVError:
            pass
        check(loop.time() < deadline, f"no write to {key!r} was "
              f"acknowledged in {attempt} attempts")
        await asyncio.sleep(0.2)


def snap_due_counter():
    """Count the snapshots the tick's snap_due lane takes: the engine
    schedules Node._on_snapshot_due for each due slot; a call after which
    the executor's snapshot id moved took a snapshot."""
    from tpuraft_torch.core.node import Node

    counts = {"due": 0, "taken": 0}
    orig = Node._on_snapshot_due

    async def counted(node):
        counts["due"] += 1
        ex = node.snapshot_executor
        before = ex.last_snapshot_id.index if ex else 0
        await orig(node)
        if ex is not None and ex.last_snapshot_id.index > before:
            counts["taken"] += 1

    Node._on_snapshot_due = counted
    return counts, lambda: setattr(Node, "_on_snapshot_due", orig)


def region_report(fab, rids, most: int = 8) -> None:
    """Log each replica's raft state for the first `most` regions of
    rids (what a failed convergence check needs to be read)."""
    log(f"[6A] {len(rids)} regions differ: {rids[:64]}")
    for rid in rids[:most]:
        for ep, s in fab.stores.items():
            re_ = s.get_region_engine(rid)
            node = re_.node if re_ is not None else None
            if node is None:
                log(f"    r{rid} {ep}: no node")
                continue
            lm = node.log_manager
            log(f"    r{rid} {ep}: {node.state.name} term "
                f"{node.current_term} leader {node.leader_id} log "
                f"[{lm.first_log_index()}, {lm.last_log_index()}] "
                f"committed {node.ballot_box.last_committed_index} applied "
                f"{node.fsm_caller.last_applied_index} snapshot "
                f"{node.snapshot_executor.last_snapshot_id.index}")


def reconcile_walks(fab) -> list[dict]:
    """What the disk guard's reconcile walk (_dir_usage_bytes over the
    store's directory, every disk_reconcile_rounds health rounds) costs
    once per live store: wall ms, files walked and bytes."""
    from tpuraft_torch.rheakv.store_engine import _dir_usage_bytes

    out = []
    for s in fab.stores.values():
        base = s._store_base()
        t0 = time.perf_counter()
        used = _dir_usage_bytes(base)
        ms = (time.perf_counter() - t0) * 1e3
        files = sum(len(names) for _, _, names in os.walk(base))
        out.append({"ms": ms, "files": files, "bytes": used})
    return out


def tick_hist(engines) -> dict:
    out = {}
    for name in ("tick_device_ms", "tick_total_ms"):
        hs = [e.tick_histograms()[name] for e in engines]
        out[name + "_p50"] = [h["p50"] for h in hs]
        out[name + "_p99"] = [h["p99"] for h in hs]
    return out


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else 0.0


async def kv_leg_store(args, quorum_cuda, tick, data_path) -> dict:
    """Leg A: 3 stores x 1,024 durable regions; YCSB-A over 16,384 keys;
    a store stopped and restarted from its directory."""
    from tpuraft_torch.util.linearizability import History, check_history

    n = (args.groups or 16) if args.cpu else 1024
    n_keys = n * KV_KEYS_PER_REGION
    rng = np.random.default_rng(SEED + 11)
    value = KVValues(rng)
    keys = [kv_key(i, n_keys) for i in range(n_keys)]
    fab = KVFabric(args, n, data_path, native=True, eto_ms=DENSITY_ETO_MS,
                   snapshot_interval_secs=KV_SNAPSHOT_SECS)
    hist, res, loop = History(), {"regions": n, "keys": n_keys}, \
        asyncio.get_running_loop()
    snaps, restore = snap_due_counter()
    tick.LAUNCHES = 0  # this path's counts start here
    quorum_cuda.LAUNCHES = 0
    kv = None
    try:
        t0 = time.perf_counter()
        await fab.start_all()
        res["boot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        await fab.wait_leaders(120)
        res["elect_s"] = time.perf_counter() - t0
        kv = fab.client()
        await kv.start()

        load = [("w", k, value(i)) for i, k in enumerate(keys)]
        op = len(load)
        t0 = time.perf_counter()
        await run_kv_ops(kv, hist, load)
        res["load_s"] = time.perf_counter() - t0

        mix = []
        n_mix = n_keys if args.cpu else KV_MIX_OPS
        for i, r in zip(zipf_keys(rng, n_keys, n_mix), rng.random(n_mix)):
            mix.append(("r", keys[i], None) if r < 0.5
                       else ("w", keys[i], value(op)))
            op += 1
        lats = []
        t0 = time.perf_counter()
        await run_kv_ops(kv, hist, mix, lats)
        res["mix_s"] = time.perf_counter() - t0
        res["mix_ops"] = len(mix)
        res["mix_ops_per_s"] = len(mix) / res["mix_s"]
        res["mix_ack_ms_p50"] = pct(lats, 50)
        res["mix_ack_ms_p99"] = pct(lats, 99)
        log(f"[6A] {n} regions x 3 stores elected in {res['elect_s']:.3f} s; "
            f"{n_keys} records loaded in {res['load_s']:.3f} s; YCSB-A "
            f"{len(mix)} ops in {res['mix_s']:.3f} s "
            f"({res['mix_ops_per_s']:.1f} ops/s, ack p50 "
            f"{res['mix_ack_ms_p50']:.3f} ms, p99 "
            f"{res['mix_ack_ms_p99']:.3f} ms)")

        # one store stops: every region it led re-elects and takes a write
        leader_of = await fab.wait_leaders(60)
        dead = fab.endpoints[0]
        lost = sorted(rid for rid, ep in leader_of.items() if ep == dead)
        res["regions_lost"] = len(lost)
        res["snapshots_taken_before_stop"] = snaps["taken"]
        t0 = time.perf_counter()
        await fab.stop_store(dead)
        res["stop_s"] = time.perf_counter() - t0
        leader_of = await fab.wait_leaders(180)
        res["reelect_s"] = time.perf_counter() - t0 - res["stop_s"]
        check(dead not in leader_of.values(), "a region is still led by "
              "the stopped store")
        starts = [r.start_key for r in fab.regions]  # region i + 1
        first_key = {}
        for k in keys:
            first_key.setdefault(bisect.bisect_right(starts, k), k)
        ops = itertools.count(op)
        res["failover_write_attempts"] = sum(await asyncio.gather(*(
            write_until_acked(kv, hist, first_key[rid],
                              lambda: value(next(ops)), loop.time() + 180)
            for rid in lost)))
        res["failover_s"] = time.perf_counter() - t0
        log(f"[6A] failover of {len(lost)} regions: stop "
            f"{res['stop_s']:.3f} s, re-election {res['reelect_s']:.3f} s, "
            f"all in {res['failover_s']:.3f} s")
        check(res["failover_s"] < 180, "failover over 180 s")
        log(f"[6A] store {dead} stopped: {len(lost)} regions lost their "
            f"leader, re-elected and took a write "
            f"({res['failover_write_attempts']} attempts, "
            f"{res['failover_s']:.3f} s)")

        # the survivors snapshot past those writes (snap_due), so the
        # restarted store must take snapshots for them
        t0 = time.perf_counter()
        deadline = loop.time() + 3 * KV_SNAPSHOT_SECS
        while True:
            behind = 0
            for rid in lost:
                node = fab.stores[leader_of[rid]] \
                    .get_region_engine(rid).node
                if node.snapshot_executor.last_snapshot_id.index < \
                        node.fsm_caller.last_applied_index:
                    behind += 1
            if not behind:
                break
            check(loop.time() < deadline, f"{behind} lost regions' leaders "
                  f"never snapshotted past the failover writes")
            await asyncio.sleep(0.2)
        res["snapshot_wait_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        back = await fab.start_store(dead)
        deadline = loop.time() + 180
        stores = list(fab.stores.values())
        shown = loop.time()
        while True:
            lag = [k for k in keys
                   if len({s.raw_store.get(k) for s in stores}) != 1]
            if not lag:
                break
            if loop.time() - shown >= 15:
                shown = loop.time()
                log(f"[6A] catching up: {len(lag)} keys differ after "
                    f"{time.perf_counter() - t0:.1f} s")
            if loop.time() >= deadline:
                region_report(fab, sorted({
                    bisect.bisect_right(starts, k) for k in lag}))
            check(loop.time() < deadline, f"{len(lag)} keys differ between "
                  f"replicas 180 s after the restart")
            await asyncio.sleep(0.5)
        res["catchup_s"] = time.perf_counter() - t0
        res["snapshot_installs"] = sum(
            re.node.metrics.counters.get("install-snapshot-received", 0)
            for re in back._regions.values())
        check(res["snapshot_installs"] > 0, "the restarted store caught up "
              "without a snapshot install")
        log(f"[6A] store {dead} restarted from its directory: caught up by "
            f"log replay and {res['snapshot_installs']} snapshot installs "
            f"({res['catchup_s']:.3f} s)")

        # read every record back through the fence; every replica holds it
        final = [("r", k, None) for k in keys]
        t0 = time.perf_counter()
        await run_kv_ops(kv, hist, final)
        res["final_read_s"] = time.perf_counter() - t0
        got = {o.args[0]: o.result for o in hist.ops()[-len(final):]}
        check(all(v is not None for v in got.values()), "a record is gone")
        for ep, s in fab.stores.items():
            bad = [k for k in keys if s.raw_store.get(k) != got[k]]
            check(not bad, f"{len(bad)} records differ on {ep}")
        res["device_fences"] = sum(s.read_batcher.device_fences
                                   for s in fab.stores.values())
        check(all(type(s.raw_store).__name__ == "NativeRawKVStore"
                  for s in fab.stores.values()), "a store is not on the "
              "native KV engine")
        res["reconcile_walk"] = reconcile_walks(fab)
    finally:
        if kv is not None:
            await kv.shutdown()
        await fab.stop_all()
        restore()
    res["launches"] = tick.LAUNCHES  # read right after the path
    res["fused_quorum_launches"] = quorum_cuda.LAUNCHES
    res["engine_ticks"] = sum(e.ticks for e in fab.engines)
    res.update(tick_hist(fab.engines))
    res["snap_due_fired"], res["snapshots_via_snap_due"] = \
        snaps["due"], snaps["taken"]
    t0 = time.perf_counter()
    report = check_history(hist)
    res["check_s"] = time.perf_counter() - t0
    res["history_ops"] = len(hist.ops())
    check(report.ok, str(report)[:2000])
    check(res["device_fences"] > 0, "no SAFE read was fenced on the device "
          "lane")
    check(res["snapshots_via_snap_due"] > 0, "snap_due took no snapshot")
    if not args.cpu:
        check(res["launches"] == res["engine_ticks"] > 0,
              f"{res['engine_ticks']} engine ticks made {res['launches']} "
              f"fused-tick launches (one each expected)")
    log(f"[6A] {report}; {res['device_fences']} device fences; "
        f"{res['snapshots_via_snap_due']} snapshots through snap_due; "
        f"{res['launches']} fused-tick launches in {res['engine_ticks']} "
        f"engine ticks")
    log("[6A] " + json.dumps(res))
    return res


async def kv_leg_lease(args, quorum_cuda, tick, data_path) -> dict:
    """Leg B: 3 stores x 256 regions, lease reads and hibernation."""
    from tpuraft_torch.options import ReadOnlyOption
    from tpuraft_torch.util.linearizability import History

    n = max(4, (args.groups or 16) // 4) if args.cpu else 256
    n_keys = n * KV_KEYS_PER_REGION
    rng = np.random.default_rng(SEED + 12)
    value = KVValues(rng)
    keys = [kv_key(i, n_keys) for i in range(n_keys)]
    fab = KVFabric(args, n, data_path,
                   read_only_option=ReadOnlyOption.LEASE_BASED,
                   quiesce_after_rounds=4)
    hist, res = History(), {"regions": n, "keys": n_keys}
    loop = asyncio.get_running_loop()
    tick.LAUNCHES = 0  # this path's counts start here
    quorum_cuda.LAUNCHES = 0
    kv = None
    try:
        await fab.start_all()
        t0 = time.perf_counter()
        await fab.wait_leaders(120)
        res["elect_s"] = time.perf_counter() - t0
        kv = fab.client()
        await kv.start()
        await run_kv_ops(kv, hist, [("w", k, value(i))
                                    for i, k in enumerate(keys)])
        reads = [("r", keys[i], None)
                 for i in rng.integers(0, n_keys, 2 * n_keys)]
        lats = []
        t0 = time.perf_counter()
        await run_kv_ops(kv, hist, reads, lats)
        res["read_s"] = time.perf_counter() - t0
        res["reads"] = len(reads)
        res["reads_per_s"] = len(reads) / res["read_s"]
        res["read_ack_ms_p50"] = pct(lats, 50)
        res["read_ack_ms_p99"] = pct(lats, 99)
        loaded = {k: value(i) for i, k in enumerate(keys)}
        bad = [o for o in hist.ops()[n_keys:]
               if o.result != loaded[o.args[0]]]
        check(not bad, f"{len(bad)} lease reads differ from the loaded "
              f"values")
        res["lease_lane_hits"] = sum(e.lease_lane_hits for e in fab.engines)
        res["lease_lane_misses"] = sum(e.lease_lane_misses
                                       for e in fab.engines)
        t0 = time.perf_counter()
        deadline = loop.time() + 30
        while True:  # idle until every replica hibernates, or 30 s
            q = sum(e.lane_stats()["quiescent"] for e in fab.engines)
            if q == 3 * n or loop.time() > deadline:
                break
            await asyncio.sleep(0.2)
        res["idle_s"] = time.perf_counter() - t0
        res["quiescent_replicas"] = q
        check(q > 0, "no group hibernated in 30 s idle")
    finally:
        if kv is not None:
            await kv.shutdown()
        await fab.stop_all()
    res["launches"] = tick.LAUNCHES  # read right after the path
    res["fused_quorum_launches"] = quorum_cuda.LAUNCHES
    res["engine_ticks"] = sum(e.ticks for e in fab.engines)
    res.update(tick_hist(fab.engines))
    check(res["lease_lane_hits"] > 0, "no read was served off the lease "
          "lane")
    if not args.cpu:
        check(res["launches"] == res["engine_ticks"] > 0,
              f"{res['engine_ticks']} engine ticks made {res['launches']} "
              f"fused-tick launches (one each expected)")
    log(f"[6B] {n} regions x 3 stores, lease reads: {len(reads)} reads "
        f"({res['reads_per_s']:.1f}/s) all equal to the loaded values, "
        f"{res['lease_lane_hits']} lease-lane hits; "
        f"{res['quiescent_replicas']}/{3 * n} replicas hibernated after "
        f"{res['idle_s']:.3f} s idle")
    log("[6B] " + json.dumps(res))
    return res


# With --cpu the server processes of legs C and D start through this
# launcher: the caller asks for the CPU, so every engine the module makes
# ticks there (TickOptions' device is the card by default), and every
# store gets the explicit disk budget the in-process legs use (statvfs
# may read a shared disk FULL, and a FULL store sheds writes).
CPU_LAUNCHER = """\
import runpy, sys
from tpuraft_torch import options
from tpuraft_torch.rheakv import store_engine
def default(cls, **kw0):
    init = cls.__init__
    def __init__(self, *a, **kw):
        init(self, *a, **{**kw0, **kw})
    cls.__init__ = __init__
default(options.TickOptions, device="cpu")
default(store_engine.StoreEngineOptions, disk_budget_bytes=int(sys.argv[1]))
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def module_cmd(args, module: str) -> list:
    """The argv that runs `python -m module` (with --cpu: its engines on
    the CPU, its stores on KV_DISK_BUDGET)."""
    if args.cpu:
        return [sys.executable, "-c", CPU_LAUNCHER, str(KV_DISK_BUDGET),
                module]
    return [sys.executable, "-m", module]


async def kv_leg_server(args, data_path) -> dict:
    """Leg C: the entry point, 3 server processes over TCP on loopback,
    each with its own --data and the engine on the card."""
    import signal
    import socket

    from tpuraft_torch.examples.rheakv_server import (client_for,
                                                      derive_regions)
    from tpuraft_torch.rheakv.client import BatchingOptions, RheaKVError
    from tpuraft_torch.rpc.tcp import TcpTransport

    n, n_keys = 64, 1024
    root = os.path.dirname(os.path.abspath(__file__))
    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    stores = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    procs, logs, res = [], [], {"regions": n, "keys": n_keys}
    transport = kv = None
    t0 = time.perf_counter()
    try:
        for i, ep in enumerate(stores):
            logs.append(open(os.path.join(data_path, f"server{i}.err"), "w+"))
            procs.append(await asyncio.create_subprocess_exec(
                *module_cmd(args, "tpuraft_torch.examples.rheakv_server"),
                "--serve", ep, "--stores", ",".join(stores),
                "--regions", str(n), "--engine", "--store", "native",
                "--log-scheme", "multilog",
                "--data", os.path.join(data_path, f"server{i}"),
                cwd=root, stdout=asyncio.subprocess.PIPE, stderr=logs[-1]))

        async def line_with(proc, word, timeout_s):
            while True:
                raw = await asyncio.wait_for(proc.stdout.readline(),
                                             timeout_s)
                if not raw:
                    raise AssertionError(
                        f"server exited (rc {await proc.wait()}) before "
                        f"printing {word}")
                if raw.startswith(word.encode()):
                    return json.loads(raw[len(word):])

        ready = [await line_with(p, "READY ", 180) for p in procs]
        res["ready_s"] = time.perf_counter() - t0
        check(all(r["regions"] == n for r in ready), "READY regions")
        transport = TcpTransport()
        kv = client_for(stores, n, transport=transport,
                        batching=BatchingOptions(enabled=True))
        await kv.start()
        rng = np.random.default_rng(SEED + 13)
        kvs = [(kv_key(i, n_keys), rng.bytes(100)) for i in range(n_keys)]
        starts = [r.start_key for r in derive_regions(stores, n)]
        first = {}
        for k, v in kvs:
            first.setdefault(bisect.bisect_right(starts, k), (k, v))
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 120

        async def first_put(k, v):  # waits out its region's election
            while True:
                try:
                    if await kv.put(k, v):
                        return
                except RheaKVError:
                    pass
                check(loop.time() < deadline,
                      f"the region of {k!r} took no write in 120 s")
                await asyncio.sleep(0.5)

        t0 = time.perf_counter()
        await asyncio.gather(*(first_put(k, v) for k, v in first.values()))
        res["first_writes_s"] = time.perf_counter() - t0
        rest = [kv_ for kv_ in kvs if kv_ not in first.values()]
        oks = await asyncio.gather(*(kv.put(k, v) for k, v in rest))
        check(all(oks), "a put over TCP was not acknowledged")
        got = await kv.multi_get([k for k, _ in kvs])
        check(got == dict(kvs), "a key read back over TCP differs")
        res["write_read_s"] = time.perf_counter() - t0
        for p in procs:
            p.send_signal(signal.SIGTERM)
        drained = [await line_with(p, "DRAINED ", 60) for p in procs]
        rcs = [await asyncio.wait_for(p.wait(), 60) for p in procs]
        check(all(d["clean"] for d in drained) and rcs == [0, 0, 0],
              f"drain {drained}, exit codes {rcs}")
    except BaseException:
        for f in logs:
            f.seek(0)
            log(f"[6C] {f.name}:\n" + f.read()[-3000:])
        raise
    finally:
        if kv is not None:
            await kv.shutdown()
        if transport is not None:
            await transport.close()
        for p in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        for f in logs:
            f.close()
    log(f"[6C] 3 server processes (python -m "
        f"tpuraft_torch.examples.rheakv_server --engine --store native "
        f"--log-scheme multilog, {n} regions) "
        f"ready in {res['ready_s']:.3f} s; {n_keys} keys written and read "
        f"back over TCP in {res['write_read_s']:.3f} s; SIGTERM: each "
        f"printed DRAINED {{\"clean\": true}} and exited 0")
    return res


async def phase_kv(args, quorum_cuda, tick) -> dict:
    import shutil
    import tempfile

    data = tempfile.mkdtemp(prefix="tpuraft_torch_kv_")
    try:
        st = os.statvfs(data)
        log(f"[6] data under {data}: {st.f_bavail * st.f_frsize / 2**30:.1f}"
            f" GiB free of {st.f_blocks * st.f_frsize / 2**30:.1f} GiB")
        out = {"store": await kv_leg_store(args, quorum_cuda, tick,
                                           f"{data}/a"),
               "lease": await kv_leg_lease(args, quorum_cuda, tick,
                                           f"{data}/b")}
        os.makedirs(f"{data}/c")
        out["server"] = await kv_leg_server(args, f"{data}/c")
        os.makedirs(f"{data}/d")
        out["pd"] = await kv_leg_pd(args, f"{data}/d")
        return out
    finally:
        shutil.rmtree(data, ignore_errors=True)


# -- phase 7: the engine soak ---------------------------------------------------

# BENCH_SOAK.json's top-level run is --duration 600; cut to fit the call
# with phases 9 and 10 (120 s until they came)
SOAK_SECS = 35
SOAK_SEED = 1


async def phase_soak(args, quorum_cuda, tick) -> dict:
    """The port's examples/soak.py as `python -m tpuraft_torch.examples.soak
    --regions 1024 --engine --duration SOAK_SECS --seed 1
    --election-timeout-ms 10000` runs it (the CLI's other defaults: 3
    stores, 6 keys, the in-process fabric), every engine on the card."""
    import shutil
    import tempfile

    from tpuraft_torch.examples import soak

    n = (args.groups or 16) if args.cpu else 1024
    secs = 10 if args.cpu else SOAK_SECS
    eto = 1000 if args.cpu else DENSITY_ETO_MS
    engines = []
    start_store = soak.SoakCluster.start_store

    async def counted(self, ep):  # every engine the soak starts
        await start_store(self, ep)
        engines.append(self.stores[ep].multi_raft_engine)

    soak.SoakCluster.start_store = counted
    data = tempfile.mkdtemp(prefix="tpuraft_torch_soak_")
    tick.LAUNCHES = 0  # this path's counts start here
    quorum_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        r = await soak.run_soak(
            secs, 3, 6, SOAK_SEED, data, False, n_regions=n, engine=True,
            election_timeout_ms=eto,
            device="cpu" if args.cpu else "cuda")
    finally:
        soak.SoakCluster.start_store = start_store
        shutil.rmtree(data, ignore_errors=True)
    res = {"regions": n, "duration_s": secs, "wall_s": time.perf_counter()
           - t0, "launches": tick.LAUNCHES,  # read right after the path
           "fused_quorum_launches": quorum_cuda.LAUNCHES,
           "engine_ticks": sum(e.ticks for e in engines),
           "engines_started": len(engines)}
    res.update({k: r[k] for k in ("linearizable", "ops", "completed",
                                  "maybe_applied", "faults", "checker_s")})
    res.update(tick_hist(engines))
    check(all((e.G, e.P) == engine_shape(n) for e in engines),
          f"a soak engine is not G, P = {engine_shape(n)}")
    check(r["linearizable"], f"the engine soak's history is not "
          f"linearizable: {json.dumps(r)[:2000]}")
    check(r["completed"] > 0, "the engine soak acknowledged no op")
    check(sum(r["faults"].values()) > 0, "the nemesis injected no fault")
    if not args.cpu:
        check(res["launches"] == res["engine_ticks"] > 0,
              f"{res['engine_ticks']} engine ticks made {res['launches']} "
              f"fused-tick launches (one each expected)")
    log(f"[7] engine soak, {n} regions x 3 stores, {secs} s: "
        f"{r['ops']} ops ({r['completed']} acknowledged, "
        f"{r['maybe_applied']} maybe applied), faults {r['faults']}, "
        f"linearizable (check {r['checker_s']} s); {res['launches']} "
        f"fused-tick launches in {res['engine_ticks']} engine ticks of "
        f"{len(engines)} engines")
    log("[7] " + json.dumps(res))
    return res


# -- phase 8: the region lifecycle ----------------------------------------------

# BENCH_SOAK.json's run_lifecycle is --lifecycle --duration 300 --seed 11
# --regions 12; the duration is cut to fit the call (120 s until phase 12
# came; at 20 s it passed its gates 6 of 6 on the card)
LIFECYCLE_SECS = 60
LIFECYCLE_SEED = 11
LIFECYCLE_REGIONS = 12


# the child's time beyond the soak's own: start-up, the quiet tail, teardown
LIFECYCLE_CHILD_SLACK_S = 300
LIFECYCLE_SAMPLE_S = 10     # the soak's cluster picture, logged this often


def phase_lifecycle(args) -> dict:
    """Phase 8 in a process of its own (`chip_smoke.py --lifecycle-child
    OUT`): a fresh interpreter, so the soak's one event loop (4 stores,
    the PD and the client) shares no heap, thread or CUDA context with
    phases 5-7. The child drives the soak, holds it to its gates and
    writes its record to OUT; any failure there fails this phase."""
    import gc
    import tempfile
    import threading

    t0 = time.perf_counter()
    gc.collect()
    log(f"[8] before the child: this process holds "
        f"{len(gc.get_objects())} objects (a full collection took "
        f"{time.perf_counter() - t0:.3f} s) and "
        f"{threading.active_count()} threads")
    fd, out = tempfile.mkstemp(prefix="tpuraft_torch_lifecycle_",
                               suffix=".json")
    os.close(fd)
    secs = 20 if args.cpu else LIFECYCLE_SECS
    cmd = [sys.executable, os.path.abspath(__file__), "--lifecycle-child",
           out] + (["--cpu"] if args.cpu else [])
    try:
        # on a timeout the child is killed and the phase fails
        rc = subprocess.run(
            cmd, timeout=secs + LIFECYCLE_CHILD_SLACK_S).returncode
        check(rc == 0, f"the lifecycle child exited {rc}")
        with open(out) as f:
            return json.load(f)
    finally:
        os.unlink(out)


def lifecycle_sample(t, cluster, pd) -> list:
    """One row of the soak's cluster picture: [s since the start, PD
    regions, regions with live heat, hot threshold, hot flags, heat
    splits, merges, moves ordered, kv ops served by leaders, store
    health evaluations scored sick, evacuations, writes shed]."""
    stores = list(cluster.stores.values()) if cluster else []
    row = [round(t, 1)]
    if pd is not None:
        st = pd.stats
        thr = st._hot_threshold
        row += [len(pd.fsm.regions),
                sum(1 for e in st._stats.values() if e.heat_at > 0.0),
                None if thr is None else round(thr, 2), st.hot_count(),
                pd.heat_splits_ordered, pd.merges_completed,
                pd.moves_ordered]
    else:
        row += [None] * 7
    row.append(sum(s.heat.writes_noted + s.heat.reads_noted
                   for s in stores if s.heat is not None))
    row.append(sum(s.health.level_counts["sick"]
                   for s in stores if s.health is not None))
    row.append(sum(s.evacuations for s in stores))
    row.append(sum(s.kv_processor.shed_items + s.disk_shed_items
                   for s in stores))
    return row


async def lifecycle_run(args, quorum_cuda, tick) -> dict:
    """The port's examples/soak.py as `python -m tpuraft_torch.examples.soak
    --lifecycle --regions 12 --seed 11 --duration LIFECYCLE_SECS` runs it:
    4 stores (the fourth starts empty), a lifecycle-enabled PD in the same
    process, a shifting zipfian hotspot; heat splits mint groups, cold
    merges retire them and cross-store moves run add-learner, catch-up and
    a joint promote+remove, every engine on the card. Every
    LIFECYCLE_SAMPLE_S the cluster picture is logged (and kept for the
    record), with the event loop's worst lateness in that window."""
    import functools
    import shutil
    import tempfile

    from tpuraft_torch.examples import soak
    from tpuraft_torch.rheakv.keyspace import coverage_errors
    from tpuraft_torch.rheakv.pd_server import PlacementDriverServer

    secs = 20 if args.cpu else LIFECYCLE_SECS
    engines, joint, cluster, pds = [], [0], [], []
    start_store = soak.SoakCluster.start_store
    pd_start = PlacementDriverServer.start
    pd_pass = PlacementDriverServer._lifecycle_pass

    async def watched(self, ep):  # every engine the soak starts
        await start_store(self, ep)
        if not cluster:
            cluster.append(self)
        e = self.stores[ep].multi_raft_engine
        engines.append(e)
        tick_once = e.tick_once

        def tick_watched():
            # a group in a joint configuration: the launch this tick
            # makes reads its old voter row
            if e.old_voter_mask.any():
                joint[0] += 1
            return tick_once()

        e.tick_once = tick_watched

    async def pd_watched(self, *a, **kw):
        pds.append(self)
        return await pd_start(self, *a, **kw)

    firsts = {}  # s into the soak of the PD's first lifecycle pass and merge

    async def pd_pass_watched(self, *a, **kw):
        # the PD's merge grace starts at its first lifecycle pass
        firsts.setdefault("pass", time.perf_counter() - t0)
        out = await pd_pass(self, *a, **kw)
        if self.merges_ordered:
            firsts.setdefault("merge", time.perf_counter() - t0)
        return out

    samples, learned = [], []

    async def sampler(t0):
        late, last = 0.0, time.perf_counter()
        while True:
            await asyncio.sleep(0.05)
            now = time.perf_counter()
            late = max(late, now - last - 0.05)
            last = now
            if not learned and pds and not coverage_errors(
                    pds[0].fsm.regions.values()):
                # the soak gives its stores 15 s to report regions that
                # tile the keyspace
                learned.append(now - t0)
                log(f"[8] the PD's {len(pds[0].fsm.regions)} regions "
                    f"tiled the keyspace {now - t0:.3f} s into the soak; "
                    f"the PD's first lifecycle pass and merge order (s): "
                    f"{firsts.get('pass')}, {firsts.get('merge')}")
            if now - t0 >= LIFECYCLE_SAMPLE_S * (len(samples) + 1):
                row = lifecycle_sample(now - t0, cluster[0] if cluster
                                       else None, pds[0] if pds else None)
                row.append(round(late * 1e3, 1))
                samples.append(row)
                late = 0.0
                log("[8] " + json.dumps(row))

    opts_cls = soak.StoreEngineOptions
    soak.SoakCluster.start_store = watched
    PlacementDriverServer.start = pd_watched
    PlacementDriverServer._lifecycle_pass = pd_pass_watched
    soak.StoreEngineOptions = functools.partial(
        opts_cls, disk_budget_bytes=KV_DISK_BUDGET)
    data = tempfile.mkdtemp(prefix="tpuraft_torch_lifecycle_")
    tick.LAUNCHES = 0  # this path's counts start here
    quorum_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    samp = asyncio.ensure_future(sampler(t0))
    try:
        r = await soak.run_lifecycle_soak(
            secs, 4, LIFECYCLE_REGIONS, LIFECYCLE_SEED, data, False,
            device="cpu" if args.cpu else "cuda")
    except TimeoutError:
        if pds:  # what the PD held when the soak gave up waiting
            pd = pds[0]
            log(f"[8] at the timeout the PD held regions "
                f"{sorted(pd.fsm.regions)} with leaders "
                f"{sorted(pd.fsm.region_leaders)}, "
                f"{pd.merges_completed} merges done; coverage: "
                f"{coverage_errors(pd.fsm.regions.values())}")
        raise
    finally:
        samp.cancel()
        soak.SoakCluster.start_store = start_store
        PlacementDriverServer.start = pd_start
        PlacementDriverServer._lifecycle_pass = pd_pass
        soak.StoreEngineOptions = opts_cls
        shutil.rmtree(data, ignore_errors=True)
    res = {"regions": LIFECYCLE_REGIONS, "duration_s": secs,
           "wall_s": time.perf_counter() - t0,
           "pd_learned_s": learned[0] if learned else None,
           "pd_first_pass_s": firsts.get("pass"),
           "pd_first_merge_s": firsts.get("merge"),
           "launches": tick.LAUNCHES,  # read right after the path
           "fused_quorum_launches": quorum_cuda.LAUNCHES,
           "engine_ticks": sum(e.ticks for e in engines),
           "joint_ticks": joint[0], "engines_started": len(engines),
           "engine_groups_end": [e.G for e in engines],
           "engine_peers": [e.P for e in engines]}
    res.update({k: r[k] for k in (
        "lifecycle_ok", "linearizable", "ops", "errors", "regions_final",
        "heat_splits_ordered", "merges_completed", "moves_applied",
        "hibernated_replicas", "coverage_errors")})
    res.update(tick_hist(engines))
    res["samples"] = samples
    check(len(engines) == 4, f"{len(engines)} lifecycle engines, not 4")
    # the soak's record without its decision trail, then the samples: the
    # end of the message is what a short tail of stderr shows
    brief = {k: v for k, v in r.items() if k != "pd_lifecycle_view"}
    check(r["lifecycle_ok"], "the lifecycle soak failed its gates: "
          + json.dumps(brief, default=str) + "; samples [s, regions, "
          "heated, threshold, hot, splits, merges, moves, kv ops, sick "
          "rounds, evacuations, shed, loop late ms]: "
          + json.dumps(samples))
    check(r["heat_splits_ordered"] > 0 and r["merges_completed"] > 0
          and r["moves_applied"] > 0 and not r["coverage_errors"],
          "no split, merge or move, or the keyspace is not covered")
    check(res["joint_ticks"] > 0, "no engine tick ran with a group in a "
          "joint configuration (old_voter_mask all clear)")
    if not args.cpu:
        check(res["launches"] == res["engine_ticks"] > 0,
              f"{res['engine_ticks']} engine ticks made {res['launches']} "
              f"fused-tick launches (one each expected)")
    log(f"[8] lifecycle soak, {LIFECYCLE_REGIONS} regions x 4 stores, "
        f"{secs} s: {r['heat_splits_ordered']} heat splits, "
        f"{r['merges_completed']} merges, {r['moves_applied']} moves, "
        f"{r['regions_final']} regions at the end, {r['ops']} ops, "
        f"linearizable per key; {res['joint_ticks']} engine ticks with a "
        f"joint configuration; {res['launches']} fused-tick launches in "
        f"{res['engine_ticks']} engine ticks; G at the end "
        f"{res['engine_groups_end']}")
    log("[8] " + json.dumps(res))
    return res


# -- leg D: the PD deployment over the native transport ------------------------

PD_SPLIT_KEYS = 48          # tests/test_e2e_pd.py's --split-keys
PD_REGIONS = 64             # leg C's size
PD_RECORDS = 16384          # leg A's load


def parse_prom(text: str) -> dict:
    """name -> value of a Prometheus text exposition (quantile samples as
    name_p50 and name_p99; the tpuraft_ prefix and labels dropped)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, val = line.rpartition(" ")
        base, _, lbl = name.partition("{")
        base = base.removeprefix("tpuraft_")
        if 'quantile="0.5"' in lbl:
            base += "_p50"
        elif 'quantile="0.99"' in lbl:
            base += "_p99"
        out[base] = float(val)
    return out


async def server_metrics(transport, stores) -> dict:
    """endpoint -> its engine's ticks, groups, leaders and tick times,
    through the server's metrics admin RPC (legs D and phase 9)."""
    from tpuraft_torch.rpc.cli_messages import DescribeMetricsRequest

    out = {}
    for ep in stores:
        resp = await transport.call(ep, "cli_describe_metrics",
                                    DescribeMetricsRequest(),
                                    timeout_ms=10000)
        m = parse_prom(resp.text)
        out[ep] = {k: m.get(k) for k in (
            "engine_ticks", "engine_groups", "engine_leaders",
            "tick_device_ms_p50", "tick_device_ms_p99",
            "tick_total_ms_p50", "tick_total_ms_p99")}
    return out


async def kv_leg_pd(args, data_path) -> dict:
    """Leg D: `python -m tpuraft_torch.examples.pd_server --split-keys 48`
    and 3 `python -m tpuraft_torch.examples.rheakv_server --engine
    --transport native --store native --log-scheme multilog --pd EP
    --regions 64` processes on loopback, leg A's records written through
    a PD-routed client over the native transport; PD-ordered splits take
    every store past its engine's capacity, so each server's engine grows
    (MultiRaftEngine._grow) on the card."""
    import signal
    import socket

    from tpuraft_torch.examples.rheakv_server import derive_regions
    from tpuraft_torch.rheakv.client import (BatchingOptions, RheaKVError,
                                             RheaKVStore)
    from tpuraft_torch.rheakv.pd_client import RemotePlacementDriverClient
    from tpuraft_torch.rpc.native_tcp import NativeTcpTransport

    n = 16 if args.cpu else PD_REGIONS
    n_keys = 2048 if args.cpu else PD_RECORDS
    cap, _ = engine_shape(n)  # the servers' engine capacity at boot
    root = os.path.dirname(os.path.abspath(__file__))
    socks = [socket.socket() for _ in range(4)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    pd_ep, *stores = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    procs, logs = [], []
    res = {"regions": n, "records": n_keys, "split_keys": PD_SPLIT_KEYS,
           "engine_groups_boot": cap}
    transport = kv = pdc = None
    t_start = time.perf_counter()

    async def spawn(name, module, *argv):
        logs.append(open(os.path.join(data_path, f"{name}.err"), "w+"))
        procs.append(await asyncio.create_subprocess_exec(
            *module_cmd(args, module), *argv, cwd=root,
            stdout=asyncio.subprocess.PIPE, stderr=logs[-1]))
        return procs[-1]

    async def line_with(proc, word, timeout_s):
        while True:
            raw = await asyncio.wait_for(proc.stdout.readline(), timeout_s)
            if not raw:
                raise AssertionError(
                    f"a server exited (rc {await proc.wait()}) before "
                    f"printing {word}")
            if raw.startswith(word.encode()):
                return json.loads(raw[len(word):])

    try:
        pd_proc = await spawn(
            "pd", "tpuraft_torch.examples.pd_server", "--serve", pd_ep,
            "--pd", pd_ep, "--data", os.path.join(data_path, "pd"),
            "--split-keys", str(PD_SPLIT_KEYS))
        await line_with(pd_proc, "READY ", 180)
        for i, ep in enumerate(stores):
            await spawn(
                f"server{i}", "tpuraft_torch.examples.rheakv_server",
                "--serve", ep, "--stores", ",".join(stores), "--regions",
                str(n), "--engine", "--transport", "native", "--store",
                "native", "--log-scheme", "multilog", "--pd", pd_ep,
                "--data", os.path.join(data_path, f"server{i}"))
        ready = [await line_with(p, "READY ", 180) for p in procs[1:]]
        check(all(r["regions"] == n for r in ready), "READY regions")
        res["ready_s"] = time.perf_counter() - t_start
        transport = NativeTcpTransport()
        pdc = RemotePlacementDriverClient(transport, [pd_ep])
        loop = asyncio.get_running_loop()

        async def regions_per_store() -> dict:
            """store -> regions the PD lists with that store a peer."""
            counts = dict.fromkeys(stores, 0)
            for r in await pdc.list_regions() or []:
                for peer in r.peers:
                    if peer in counts:
                        counts[peer] += 1
            return counts

        deadline = loop.time() + 60
        while min((await regions_per_store()).values()) < n:
            check(loop.time() < deadline, "the PD did not learn every "
                  "store's regions from heartbeats in 60 s")
            await asyncio.sleep(0.5)
        kv = RheaKVStore(pdc, transport, timeout_ms=10000, max_retries=30,
                         batching=BatchingOptions(enabled=True))
        await kv.start()
        rng = np.random.default_rng(SEED + 17)
        values = KVValues(rng)
        kvs = [(kv_key(i, n_keys), values(i)) for i in range(n_keys)]
        starts = [r.start_key for r in derive_regions(stores, n)]
        first = {}
        for k, v in kvs:
            first.setdefault(bisect.bisect_right(starts, k), (k, v))
        deadline = loop.time() + 120

        async def first_put(k, v):  # waits out its region's election
            while True:
                try:
                    if await kv.put(k, v):
                        return
                except RheaKVError:
                    pass
                check(loop.time() < deadline,
                      f"the region of {k!r} took no write in 120 s")
                await asyncio.sleep(0.5)

        t0 = time.perf_counter()
        await asyncio.gather(*(first_put(k, v) for k, v in first.values()))
        res["first_writes_s"] = time.perf_counter() - t0
        rest = iter([kv_ for kv_ in kvs if kv_ not in first.values()])
        failed = []

        async def writer():
            for k, v in rest:
                if not await kv.put(k, v):
                    failed.append(k)

        t0 = time.perf_counter()
        await asyncio.gather(*(writer() for _ in range(KV_WORKERS)))
        res["load_s"] = time.perf_counter() - t0
        check(not failed, f"{len(failed)} puts not acknowledged")
        # the PD splits every region past --split-keys, one split per
        # region per heartbeat round, until each store holds more
        # regions than its engine had rows at boot
        trail, deadline = [], loop.time() + 180
        while True:
            counts = await regions_per_store()
            trail.append([round(time.perf_counter() - t0, 3),
                          min(counts.values())])
            if min(counts.values()) > cap:
                break
            check(loop.time() < deadline, f"stores hold {counts} regions "
                  f"after 180 s, not more than {cap}: {trail[-8:]}")
            await asyncio.sleep(1.0)
        res["past_capacity_s"] = time.perf_counter() - t0
        # let the splits already ordered land, then read everything back
        await asyncio.sleep(5.0)
        counts = await regions_per_store()
        res["regions_per_store"] = counts
        res["split_trail"] = trail
        t0 = time.perf_counter()
        got = {}
        for i in range(0, n_keys, 512):
            got.update(await kv.multi_get([k for k, _ in kvs[i:i + 512]]))
        res["read_back_s"] = time.perf_counter() - t0
        bad = [k for k, v in kvs if got.get(k) != v]
        check(not bad, f"{len(bad)} of {n_keys} records read back differ, "
              f"first {bad[:3]}")
        metrics = res["servers"] = await server_metrics(transport, stores)
        check(all(m["engine_groups"] > cap for m in metrics.values()),
              f"a server's engine holds no more than {cap} groups: "
              f"{metrics}")
        check(min(counts.values()) > cap,
              f"regions per store {counts}, not more than {cap}")
        for p in procs:
            p.send_signal(signal.SIGTERM)
        drained = [await line_with(p, "DRAINED ", 60) for p in procs[1:]]
        rcs = [await asyncio.wait_for(p.wait(), 60) for p in procs]
        check(all(d["clean"] for d in drained) and rcs == [0, 0, 0, 0],
              f"drain {drained}, exit codes {rcs}")
    except BaseException:
        for f in logs:
            f.seek(0)
            log(f"[6D] {f.name}:\n" + f.read()[-3000:])
        raise
    finally:
        if kv is not None:
            await kv.shutdown()
        if transport is not None:
            await transport.close()
        for p in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        for f in logs:
            f.close()
    res["wall_s"] = time.perf_counter() - t_start
    log(f"[6D] PD process (--split-keys {PD_SPLIT_KEYS}) and 3 server "
        f"processes (--engine --transport native --store native "
        f"--log-scheme multilog --pd, {n} regions) ready in "
        f"{res['ready_s']:.3f} s; {n_keys} records loaded in "
        f"{res['load_s']:.3f} s; stores past {cap} regions "
        f"{res['past_capacity_s']:.3f} s after the load began; regions per "
        f"store {counts}; engine groups "
        f"{[m['engine_groups'] for m in metrics.values()]}; every record "
        f"read back through the PD-routed client; SIGTERM: the 3 stores "
        f"drained clean and all 4 processes exited 0")
    log("[6D] " + json.dumps(res))
    return res


# -- phase 9: the supervised fleet --------------------------------------------

FLEET_REGIONS = 64          # leg C's size: engines of G=128, P=4
FLEET_KEYS = 1024           # leg C's load
FLEET_WORKERS = 8
FLEET_MIX_S = 10            # the mix before the SIGKILL, and after READY
FLEET_OP_TIMEOUT_S = 6.0    # an op past it stays pending (proc_supervisor)
FLEET_READY_S = 180         # a store's boot on the card: torch, CUDA, replay


def fleet_argv(args, ep, stores, n, data) -> list:
    """One store's command line from the port's server_argv (--engine
    --transport native --store native --log-scheme multilog, n regions);
    with --cpu its `-m MODULE` head goes through module_cmd's launcher."""
    from tpuraft_torch.examples.proc_supervisor import server_argv

    argv = server_argv(ep, stores, n, data, transport="native",
                       store="native", log_scheme="multilog", engine=True,
                       metrics_port=None)
    check(argv[1:3] == ["-m", "tpuraft_torch.examples.rheakv_server"],
          f"server_argv's head is {argv[:3]}")
    return module_cmd(args, argv[2]) + argv[3:]


async def phase_fleet(args) -> dict:
    """Phase 9: the supervised, SIGKILLed fleet, as proc_supervisor's
    --soak runs it but at leg C's size: ProcSupervisor over 3
    StoreProcess children (`rheakv_server --engine --transport native
    --store native --log-scheme multilog --regions 64`, each engine on
    the card), leg C's 1,024 keys loaded, then a 50/50 read/update mix
    from 8 workers; the store that leads region 1 is SIGKILLed, the
    supervisor restarts it from its directory and it prints READY again.
    Every acknowledged write is read back, the history is linearizable,
    every server's engine ticked, and SIGTERM drains every process."""
    import shutil
    import tempfile

    from tpuraft_torch.examples.proc_supervisor import (ProcSupervisor,
                                                        StoreProcess,
                                                        free_endpoints)
    from tpuraft_torch.examples.rheakv_server import (client_for,
                                                      derive_regions)
    from tpuraft_torch.rheakv.client import RheaKVError
    from tpuraft_torch.rpc.native_tcp import NativeTcpTransport
    from tpuraft_torch.util.linearizability import History, check_history

    n = 8 if args.cpu else FLEET_REGIONS
    n_keys = 128 if args.cpu else FLEET_KEYS
    mix_s = 5 if args.cpu else FLEET_MIX_S
    data = tempfile.mkdtemp(prefix="tpuraft_torch_fleet_")
    stores = free_endpoints(3)
    sup = ProcSupervisor([StoreProcess(ep, fleet_argv(args, ep, stores, n,
                                                      data))
                          for ep in stores])
    res = {"regions": n, "keys": n_keys, "workers": FLEET_WORKERS}
    transport = kv = None
    loop = asyncio.get_running_loop()
    hist = History()
    t_start = time.perf_counter()
    try:
        await sup.start(ready_timeout_s=FLEET_READY_S)
        sup.supervise()
        res["ready_s"] = time.perf_counter() - t_start
        transport = NativeTcpTransport()
        kv = client_for(stores, n, transport=transport, max_retries=12)
        await kv.start()
        starts = [r.start_key for r in derive_regions(stores, n)]

        def region_of(key: bytes) -> int:
            return bisect.bisect_right(starts, key)

        async def put_until_acked(cid, key, val, deadline) -> float:
            """A write retried (each attempt its own op in the history)
            until it is acknowledged; returns when it was."""
            while True:
                tok = hist.invoke(cid, "w", (key, val))
                try:
                    if await asyncio.wait_for(kv.put(key, val),
                                              FLEET_OP_TIMEOUT_S) is True:
                        hist.complete(tok, True)
                        return time.perf_counter()
                except (RheaKVError, asyncio.TimeoutError):
                    pass
                check(loop.time() < deadline,
                      f"region {region_of(key)} took no write")
                await asyncio.sleep(0.2)

        # the load: leg C's keys and values, each region's first write
        # waiting out its election
        rng = np.random.default_rng(SEED + 13)
        kvs = [(kv_key(i, n_keys), rng.bytes(100)) for i in range(n_keys)]
        first = {}
        for k, v in kvs:
            first.setdefault(region_of(k), (k, v))
        t0 = time.perf_counter()
        deadline = loop.time() + 120
        await asyncio.gather(*(put_until_acked(-1, k, v, deadline)
                               for k, v in first.values()))
        rest = [kv_ for kv_ in kvs if kv_ not in first.values()]
        await asyncio.gather(*(put_until_acked(-1, k, v, deadline)
                               for k, v in rest))
        res["load_s"] = time.perf_counter() - t0
        # key -> its last acknowledged value, and the values of its
        # writes never acknowledged (each may or may not have applied)
        acked = dict(kvs)
        unacked = {k: set() for k, _ in kvs}

        # the mix: worker w updates only its own keys (one writer a key,
        # so the last write of each is defined) and reads any key
        stop = asyncio.Event()
        lats, counts = [], {"ops": 0, "acked": 0, "pending": 0}

        async def worker(w):
            wrng = np.random.default_rng(SEED + 100 + w)
            own = [k for i, (k, _) in enumerate(kvs)
                   if i % FLEET_WORKERS == w]
            seq = 0
            while not stop.is_set():
                counts["ops"] += 1
                if wrng.random() < 0.5:
                    seq += 1
                    key = own[int(wrng.integers(len(own)))]
                    val = (b"w%d-%d " % (w, seq)).ljust(100, b".")
                    tok = hist.invoke(w, "w", (key, val))
                    t0 = time.perf_counter()
                    try:
                        ok = await asyncio.wait_for(kv.put(key, val),
                                                    FLEET_OP_TIMEOUT_S)
                    except (RheaKVError, asyncio.TimeoutError):
                        ok = None
                    if ok is True:
                        hist.complete(tok, True)
                        lats.append(time.perf_counter() - t0)
                        acked[key] = val
                        counts["acked"] += 1
                    else:
                        unacked[key].add(val)
                        counts["pending"] += 1
                else:
                    key = kvs[int(wrng.integers(n_keys))][0]
                    tok = hist.invoke(w, "r", (key,))
                    t0 = time.perf_counter()
                    try:
                        got = await asyncio.wait_for(kv.get(key),
                                                     FLEET_OP_TIMEOUT_S)
                    except (RheaKVError, asyncio.TimeoutError):
                        counts["pending"] += 1
                    else:
                        hist.complete(tok, got)
                        lats.append(time.perf_counter() - t0)
                        counts["acked"] += 1
                await asyncio.sleep(0.003)

        t_mix = time.perf_counter()
        workers = [asyncio.ensure_future(worker(w))
                   for w in range(FLEET_WORKERS)]
        await asyncio.sleep(mix_s)
        # SIGKILL the store the client believes leads region 1 (as
        # proc_supervisor's _soak): crash-stop, no drain
        def endpoint(peer: str) -> str:
            return ":".join(peer.split("/", 1)[0].split(":")[:2])

        peer = kv._leaders.get(1)
        check(peer is not None, "the client knows no leader of region 1")
        victim_ep = endpoint(peer)
        led = sorted(rid for rid, p in kv._leaders.items()
                     if p and endpoint(p) == victim_ep)
        victim = sup.by_endpoint(victim_ep)
        probes = {rid: (starts[rid - 1] or b"\x00") + b"-probe"
                  for rid in led}
        log(f"[9] SIGKILL {victim_ep} (pid {victim.pid}), which leads "
            f"{len(led)} of {n} regions by the client's cache")
        spawns = victim.spawns
        t_kill = time.perf_counter()
        victim.kill()
        deadline = loop.time() + FLEET_READY_S

        async def ready_at() -> float:
            # the supervised restart: respawned (which clears the READY
            # of the killed child), then READY again
            while victim.spawns == spawns:
                check(loop.time() < deadline, "the supervisor did not "
                      "restart the killed store")
                await asyncio.sleep(0.01)
            await victim.wait_ready(FLEET_READY_S)
            return time.perf_counter()

        ready = asyncio.ensure_future(ready_at())
        # the regions it led: the first write each takes after the kill
        failover = await asyncio.gather(*(
            put_until_acked(-2, key, b"failover", deadline)
            for key in probes.values()))
        res["victim_regions"] = len(led)
        res["failover_s"] = max(failover) - t_kill
        res["failover_s_p50"] = float(np.median(failover)) - t_kill
        t_ready = await ready
        res["restart_s"] = t_ready - t_kill
        replay = await asyncio.gather(*(
            put_until_acked(-3, key, b"replay", deadline)
            for key in probes.values()))
        res["replay_s"] = max(replay) - t_ready
        res["replay_s_p50"] = float(np.median(replay)) - t_ready
        await asyncio.sleep(mix_s)
        stop.set()
        await asyncio.gather(*workers)
        res["mix_s"] = time.perf_counter() - t_mix
        res.update(counts)
        res["ops_per_s"] = counts["ops"] / res["mix_s"]
        res["ack_p50_ms"], res["ack_p99_ms"] = pct(lats, 50), pct(lats, 99)

        # every acknowledged write read back: a key holds its last
        # acknowledged value or the value of a write never acknowledged
        got = {}
        for i in range(0, n_keys, 256):
            keys = [k for k, _ in kvs[i:i + 256]]
            toks = [hist.invoke(-4, "r", (k,)) for k in keys]
            vals = await kv.multi_get(keys)
            for k, tok in zip(keys, toks):
                hist.complete(tok, vals.get(k))
            got.update(vals)
        lost = [k for k, v in acked.items()
                if got.get(k) != v and got.get(k) not in unacked[k]]
        check(not lost, f"{len(lost)} of {n_keys} keys lost an acknowledged "
              f"write, first {lost[:3]}")
        t0 = time.perf_counter()
        report = check_history(hist)
        res["checker_s"] = time.perf_counter() - t0
        check(report.ok, f"the fleet's history is not linearizable: "
              f"{str(report)[:2000]}")
        res["linearizable"] = True
        res["restarts"] = sup.restarts
        res["failed_stores"] = dict(sup.failed)
        check(sup.restarts >= 1 and not sup.failed,
              f"restarts {sup.restarts}, failed stores {sup.failed}")
        res["servers"] = await server_metrics(transport, stores)
        check(all((m["engine_ticks"] or 0) > 0
                  for m in res["servers"].values()),
              f"a server's engine did not tick: {res['servers']}")
        await kv.shutdown()
        kv = None
        await transport.close()
        transport = None
        await sup.stop(drain_timeout_s=60)
        res["drained"] = {p.endpoint: p.drained for p in sup.procs}
        res["exit_codes"] = {p.endpoint: p.returncode() for p in sup.procs}
        check(all(d and d.get("clean") for d in res["drained"].values())
              and set(res["exit_codes"].values()) == {0},
              f"drain {res['drained']}, exit codes {res['exit_codes']}")
    except BaseException:
        for p in sup.procs:
            log(f"[9] {p.name} (spawns {p.spawns}, rc {p.returncode()}):\n"
                + "\n".join(list(p.tail)[-30:]))
        raise
    finally:
        if kv is not None:
            await kv.shutdown()
        if transport is not None:
            await transport.close()
        if any(p.alive() for p in sup.procs):  # a failed phase: stop all
            await sup.stop(drain_timeout_s=5)
        shutil.rmtree(data, ignore_errors=True)
    res["hist_ops"] = len(hist.ops())
    res["wall_s"] = time.perf_counter() - t_start
    log(f"[9] supervised fleet: 3 server processes (--engine --transport "
        f"native --store native --log-scheme multilog, {n} regions) ready "
        f"in {res['ready_s']:.3f} s; {n_keys} keys loaded; mix "
        f"{res['ops']} ops ({res['acked']} acknowledged) at "
        f"{res['ops_per_s']:.1f} ops/s, ack p50 {res['ack_p50_ms']:.3f} ms "
        f"p99 {res['ack_p99_ms']:.3f} ms; SIGKILL -> READY "
        f"{res['restart_s']:.3f} s; its {res['victim_regions']} regions "
        f"took a write {res['failover_s']:.3f} s after the kill and "
        f"{res['replay_s']:.3f} s after READY (the last of them); every "
        f"acknowledged write read back, "
        f"linearizable ({res['hist_ops']} ops, check "
        f"{res['checker_s']:.3f} s); engine ticks "
        f"{[m['engine_ticks'] for m in res['servers'].values()]}; SIGTERM: "
        f"every process drained clean and exited 0")
    log("[9] " + json.dumps(res))
    return res


# -- phase 10: the storage fault plane ----------------------------------------

# BENCH_SOAK.json's run_disk_pressure is --disk-pressure --power-loss
# --seed 2 --duration 300; the duration is cut to fit the call
FAULT_SOAK_SECS = 60
FAULT_SOAK_SEED = 2
FAULT_CHILD_SLACK_S = 300   # start-up, the history check, teardown


def start_fault_plane(args) -> dict:
    """Start phase 10: `python -m tpuraft_torch.examples.soak
    --disk-pressure --power-loss --seed 2 --duration FAULT_SOAK_SECS` in a
    process of its own: 3 stores, each store's directory under the
    port's ChaosDir (a standing byte quota matched by the store's disk
    budget, quota shrinks and ENOSPC bursts, power-loss crash images),
    composed with leader kills, one-way partitions and packet noise. It
    runs on the host only: the reference allows these modes only without
    the engine (the multilog's fd-level I/O is out of the interposer's
    reach), and this slice adds nothing the JAX package lacks. Needing
    no card, it runs beside phases 2-5 (one more busy core of the
    host's), and phase_fault_plane reads it after phase 9."""
    import tempfile
    import threading

    secs = 40 if args.cpu else FAULT_SOAK_SECS
    data = tempfile.mkdtemp(prefix="tpuraft_torch_faults_")
    child = {"secs": secs, "data": data, "t0": time.perf_counter(),
             "out": open(os.path.join(data, "soak.out"), "w+"),
             "err": open(os.path.join(data, "soak.err"), "w+")}
    child["proc"] = subprocess.Popen(
        [sys.executable, "-m", "tpuraft_torch.examples.soak",
         "--disk-pressure", "--power-loss", "--seed", str(FAULT_SOAK_SEED),
         "--duration", str(secs), "--data", os.path.join(data, "d")],
        stdout=child["out"], stderr=child["err"], text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))

    def reap():  # the child's own wall time, whenever it ends
        child["proc"].wait()
        child["wall_s"] = time.perf_counter() - child["t0"]

    child["reaper"] = threading.Thread(target=reap, daemon=True)
    child["reaper"].start()
    log(f"[10] the fault-plane soak started beside phases 2-5 (pid "
        f"{child['proc'].pid}, {secs} s)")
    return child


def stop_fault_plane(child) -> None:
    """Kill phase 10's child if it still runs, and remove its data."""
    import shutil

    if child["proc"].poll() is None:
        child["proc"].kill()
    child["reaper"].join(30)
    child["out"].close()
    child["err"].close()
    shutil.rmtree(child["data"], ignore_errors=True)


def phase_fault_plane(child) -> dict:
    """Phase 10's result: the child started by start_fault_plane, held
    to its gates: the exit code, disk_pressure_ok, a linearizable
    history and power-loss crashes."""
    secs = child["secs"]
    # on a timeout the child is killed (stop_fault_plane) and the phase
    # fails
    child["reaper"].join(max(0.0, child["t0"] + secs + FAULT_CHILD_SLACK_S
                             - time.perf_counter()))
    check(not child["reaper"].is_alive(), "the fault-plane soak did not "
          f"end within {secs + FAULT_CHILD_SLACK_S} s")
    child["out"].seek(0)
    lines = child["out"].read().strip().splitlines()
    child["err"].seek(0)
    tail = child["err"].read()[-3000:]
    rc = child["proc"].returncode
    check(rc == 0 and lines, f"the fault-plane soak exited {rc}: "
          f"{lines[-1:]}\n{tail}")
    r = json.loads(lines[-1])
    res = {"duration_s": secs, "seed": FAULT_SOAK_SEED,
           "wall_s": child["wall_s"]}
    res.update({k: r.get(k) for k in (
        "linearizable", "ops", "completed", "maybe_applied", "faults",
        "power_loss_crashes", "storage_injections", "disk",
        "disk_pressure_ok", "checker_s")})
    check(r["linearizable"] and r["disk_pressure_ok"]
          and r["power_loss_crashes"] > 0,
          f"the fault-plane soak failed its gates: {json.dumps(res)}")
    log(f"[10] fault-plane soak (--disk-pressure --power-loss, seed "
        f"{FAULT_SOAK_SEED}, {secs} s, host only): {r['ops']} ops "
        f"({r['completed']} acknowledged), faults {r['faults']}, "
        f"{r['power_loss_crashes']} power-loss crashes, ENOSPC observed "
        f"{r['disk']['enospc_observed']}, reclaims {r['disk']['reclaims']}, "
        f"shed writes {r['disk']['shed_writes']}, resumes "
        f"{r['disk']['resumes']}; linearizable (check {r['checker_s']} s)")
    log("[10] " + json.dumps(res))
    return res


# -- phase 11: the replica plane ----------------------------------------------

# 11(a): the north-star configuration (3 replicas x 16K groups,
# BASELINE.md), 5 replicas x 1K groups, 11(b)'s own shape, and each edge
# of the kernel's layouts (segment widths 1-32, two replicas a lane up to
# 64, one thread a group past it) at a ragged G
REPLICA_SHAPES = [(3, 16384), (5, 1024), (3, 1024), (1, 1000), (2, 1000),
                  (4, 1000), (7, 1000), (8, 1000), (9, 1000), (32, 1000),
                  (33, 1000), (64, 1000), (65, 1000)]
REPLICA_GROUPS = 1024       # 11(b): 3 replica endpoints x 1,024 groups
REPLICA_ETO_MS = 2000       # phase 5's election timeout
REPLICA_WAVES, REPLICA_WRITES = 3, 2
REPLICA_CHILD_SLACK_S = 600


def replica_inputs(rng, r, g):
    """Seeded [R, G] planes: match rows with all-zero columns, ties, one
    row far ahead, values up to 2^28 - 1 and unattested rows (masked to
    0 by the plane); grants at random."""
    rel = rng.integers(0, 1 << 20, (r, g)).astype(np.int32)
    kind = rng.random(g)
    rel[:, kind < 0.05] = 0                                 # all zero
    tie = (kind >= 0.05) & (kind < 0.2)
    rel[:, tie] = rel[0, tie]                               # ties
    ahead = (kind >= 0.2) & (kind < 0.3)
    rel[rng.integers(0, r), ahead] = (1 << 28) - 1          # one row ahead
    big = rng.random((r, g)) < 0.05
    rel[big] = rng.integers(0, 1 << 28, int(big.sum()))
    rel[rng.random((r, g)) < 0.1] = 0                       # unattested
    return rel, rng.random((r, g)) < 0.5


def replica_extremes(rng, r, g):
    """Seeded [R, G] planes at the int32 edges: columns of INT32_MIN and
    INT32_MAX mixed with small values, all-equal columns (INT32_MIN,
    INT32_MAX, 0), one INT32_MAX among INT32_MIN and the reverse, and a
    uint8 grant plane of 0, 1, 2 and 255."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    rel = rng.choice(np.array([lo, lo + 1, -1, 0, 1, hi - 1, hi], np.int64),
                     (r, g)).astype(np.int32)
    kind = rng.integers(0, 6, g)
    for k, fill in ((0, lo), (1, hi), (2, 0)):
        rel[:, kind == k] = fill                            # all equal
    one = rng.integers(0, r, g)
    for k, base, odd in ((3, lo, hi), (4, hi, lo)):
        cols = np.flatnonzero(kind == k)
        rel[:, cols] = base
        rel[one[cols], cols] = odd                          # one apart
    granted = rng.choice(np.array([0, 1, 2, 255], np.uint8), (r, g))
    return rel, granted


def replica_bound_ms(r, g) -> float:
    """Least time for the work: each input read once (an int32 and a
    byte plane of R x G), each output written once (two int32 rows)."""
    return (r * g * 4 + r * g + g * 8) / HBM_BYTES_PER_S * 1e3


def phase_replica_kernel(args, torch, dev) -> list[dict]:
    """11(a): the replica-quorum kernel against its plain version (and
    torch.kthvalue, the one PyTorch call that computes the commit half)
    on the same inputs on the card, bit for bit, on the edge planes and
    on an extremes plane, then timed on the edge planes."""
    from tpuraft_torch.parallel import collective

    shapes = [(3, 64), (5, 32), *((r, 10) for r in (1, 2, 4, 7, 8, 9, 32, 33,
                                                   64, 65))] \
        if args.cpu else REPLICA_SHAPES
    rng = np.random.default_rng(SEED + 11)
    rows = []
    for r, g in shapes:
        q = r // 2 + 1
        err = 0
        checked = []
        for planes in (replica_inputs(rng, r, g), replica_extremes(rng, r, g)):
            rel, granted = (torch.from_numpy(a).to(dev) for a in planes)
            checked.append((rel, granted))
            commit, votes = collective.replica_quorum(rel, granted, r)
            want_c = collective.replica_commit_point(rel, r)
            want_v = collective.replica_vote_count(granted)
            lib_c = torch.kthvalue(rel, r - q + 1, dim=0).values
            if not args.cpu:
                torch.cuda.synchronize()
            for name, t, w in (("commit", commit, want_c),
                               ("votes", votes, want_v),
                               ("kthvalue", lib_c, want_c)):
                check(t.device == w.device and t.dtype == w.dtype
                      and t.shape == (g,), f"{name}: wrong result layout")
                check(torch.equal(t, w), f"replica_quorum {name} differs "
                      f"from plain at R={r} G={g} ({granted.dtype} grants)")
            err = max(err, *(int((t.to(torch.int64) - w.to(torch.int64))
                                 .abs().max())
                             for t, w in ((commit, want_c), (votes, want_v))))
        rel, granted = checked[0]  # the edge planes are the timed ones
        row = {"R": r, "G": g, "max_abs_err": err,
               "bound_ms": replica_bound_ms(r, g)}
        if args.cpu or args.quick:
            row.update(ms=None, plain_ms=None, library_ms=None)
        else:
            reps = max(1, TIMED_LAUNCHES // 100)
            row["ms"] = time_graph(
                torch, lambda: collective.replica_quorum(rel, granted, r),
                replays=reps)
            row["plain_ms"] = time_graph(
                torch, lambda: (collective.replica_commit_point(rel, r),
                                collective.replica_vote_count(granted)),
                replays=reps)
            row["library_ms"] = time_graph(
                torch, lambda: torch.kthvalue(rel, r - q + 1, dim=0),
                replays=reps)
            row["eager_ms"] = time_events(
                torch, lambda: collective.replica_quorum(rel, granted, r),
                TIMED_LAUNCHES)
        rows.append(row)
        log(f"[11] replica_quorum R={r} G={g}: bit-exact vs plain and "
            f"torch.kthvalue, edge and extremes planes; " + ", ".join(
                f"{k}={v}" for k, v in row.items() if k.endswith("ms")))
    return rows


async def replica_plane_run(args) -> dict:
    """11(b): `ReplicaPlaneCluster(3, REPLICA_GROUPS, device="cuda")` as
    examples/replica_plane.py --chaos drives it: memory:// logs, the
    in-process transport, every commit decided by one replica-quorum
    launch a plane tick; every group elects, takes REPLICA_WAVES waves
    of REPLICA_WRITES writes, loses the replica that leads the fewest
    groups, re-elects and takes one more write; every surviving
    replica's log equals the acknowledged writes."""
    from tpuraft_torch.core.node import State
    from tpuraft_torch.entity import Task
    from tpuraft_torch.parallel import collective
    from tpuraft_torch.parallel.replica_cluster import ReplicaPlaneCluster

    n = (args.groups or 16) if args.cpu else REPLICA_GROUPS
    loop = asyncio.get_running_loop()
    rng = np.random.default_rng(SEED + 12)
    collective.LAUNCHES = 0  # the path's count starts here
    t0 = time.perf_counter()
    c = ReplicaPlaneCluster(3, n, device="cpu" if args.cpu else "cuda",
                            election_timeout_ms=REPLICA_ETO_MS)
    await c.start_all()
    boot_s = time.perf_counter() - t0
    acked = {g: [] for g in c.groups}

    async def leaders(timeout_s):
        deadline = loop.time() + timeout_s
        while True:
            found = {}
            for (g, _), node in c.nodes.items():
                if node.state == State.LEADER:
                    found.setdefault(g, []).append(node)
            if all(len(found.get(g, ())) == 1 for g in c.groups):
                return {g: found[g][0] for g in c.groups}
            check(loop.time() < deadline,
                  f"{sum(len(found.get(g, ())) == 1 for g in c.groups)}/"
                  f"{n} groups have one leader")
            await asyncio.sleep(0.05)

    async def write_all(leader_of, k):
        futs = []
        for g in c.groups:
            for _ in range(k):
                data = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
                fut = loop.create_future()
                await leader_of[g].apply(Task(data=data, done=fut.set_result))
                futs.append((g, data, fut))
        sts = await asyncio.wait_for(
            asyncio.gather(*[f for _, _, f in futs]), 120)
        bad = [(g, str(st)) for (g, _, _), st in zip(futs, sts)
               if not st.is_ok()]
        check(not bad, f"{len(bad)} writes not acknowledged: {bad[:3]}")
        for g, data, _ in futs:
            acked[g].append(data)
        return len(futs)

    async def read_back(timeout_s=60):
        deadline = loop.time() + timeout_s
        while True:
            behind = [k for k in c.nodes if c.fsms[k].logs != acked[k[0]]]
            if not behind:
                return
            for k in behind:
                logs = c.fsms[k].logs
                check(logs == acked[k[0]][:len(logs)],
                      f"replica {k} log differs from the acked writes")
            check(loop.time() < deadline,
                  f"{len(behind)} replicas behind the acked writes")
            await asyncio.sleep(0.05)

    try:
        t0 = time.perf_counter()
        leader_of = await leaders(120)
        elect_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        writes = 0
        for _ in range(REPLICA_WAVES):
            writes += await write_all(leader_of, REPLICA_WRITES)
        await read_back()
        write_s = time.perf_counter() - t0
        lead_count = {ep.endpoint: 0 for ep in c.endpoints}
        for node in leader_of.values():
            lead_count[node.server_id.endpoint] += 1
        victim = min(c.endpoints, key=lambda ep: lead_count[ep.endpoint])
        t0 = time.perf_counter()
        await c.stop_replica(victim)
        leader_of = await leaders(180)
        reelect_s = time.perf_counter() - t0
        writes += await write_all(leader_of, 1)
        await read_back()
        failover_s = time.perf_counter() - t0
    finally:
        await c.stop_all()
    # read together: the plane may tick while the nodes stop
    launches = collective.LAUNCHES  # read right after the path
    ticks, advances = c.plane.ticks, c.plane.commit_advances
    res = {"replicas": 3, "groups": n, "device": "cpu" if args.cpu
           else "cuda", "launches": launches, "plane_ticks": ticks,
           "commit_advances": advances, "acked_writes": writes,
           "victim_led": lead_count[victim.endpoint], "boot_s": boot_s,
           "elect_s": elect_s, "write_s": write_s, "reelect_s": reelect_s,
           "failover_s": failover_s}
    log("[11] " + json.dumps(res))
    check(writes == n * (REPLICA_WAVES * REPLICA_WRITES + 1), "write count")
    check(advances >= n, f"{advances} commit advances for {n} groups")
    check(elect_s < 120 and failover_s < 180,
          f"election {elect_s:.3f} s / failover {failover_s:.3f} s over "
          f"the limits (120 / 180 s)")
    if not args.cpu:
        check(launches > 0 and launches == ticks,
              f"{ticks} plane ticks made {launches} replica-quorum "
              f"launches (one each expected)")
    return res


def phase_replica_plane(args) -> dict:
    """11(b) in a process of its own (`chip_smoke.py --replica-child
    OUT`), after phase 8 and beside no other phase: its one event loop
    drives 3 x 1,024 raft nodes on their own timers and a launch and a
    device copy every plane tick. Beside phases 5-6 it slowed their
    single loops; beside phase 8's start-up it shared the host with the
    lifecycle soak's first elections, and one such run ended at the
    soak's 15 s wait for the region set. A fresh interpreter
    shares no heap with phases 5-8. The kernel library is built (phase
    1); the child loads it and holds 11(b)'s gates itself."""
    import tempfile

    fd, out = tempfile.mkstemp(prefix="tpuraft_torch_replica_",
                               suffix=".json")
    os.close(fd)
    cmd = [sys.executable, os.path.abspath(__file__), "--replica-child",
           out] + (["--cpu", "--groups", str(args.groups or 16)]
                   if args.cpu else [])
    t0 = time.perf_counter()
    try:
        # on a timeout the child is killed and the phase fails
        rc = subprocess.run(cmd, timeout=REPLICA_CHILD_SLACK_S).returncode
        check(rc == 0, f"the replica-plane child exited {rc}")
        with open(out) as f:
            res = json.load(f)
    finally:
        os.unlink(out)
    res["child_wall_s"] = time.perf_counter() - t0
    log(f"[11] replica plane: 3 x {res['groups']} groups elected in "
        f"{res['elect_s']:.3f} s, {res['acked_writes']} acked writes read "
        f"back from every surviving replica, the replica leading "
        f"{res['victim_led']} groups stopped and all re-elected in "
        f"{res['reelect_s']:.3f} s (failover {res['failover_s']:.3f} s); "
        f"{res['launches']} replica-quorum launches for "
        f"{res['plane_ticks']} plane ticks; the child took "
        f"{res['child_wall_s']:.3f} s")
    return res


# -- phase 12: group-axis mesh sharding -----------------------------------------

# 12(a): the sharded tick at S shards against the single-device fused tick
MESH_SHARD_COUNTS = (2, 4, 8)
MESH_TICK_SHAPES = [(16384, 8), (65536, 4)]
MESH_TICK_ROUNDS = 8
MESH_FOLD_G = 65536         # the fold: 8 trials at G = 65,536 split 8 ways
MESH_FOLD_TRIALS = 8
MESH_SHARDS = 8
MESH_REPLICA_SHAPE = (4, 16384)   # B5 over a 2 x 4 grid
MESH_GRID = (2, 4)
# 12(b): bench_multichip.py --scale's rung: 65,536 groups, P=4, 8 shards
MESH_ENGINE_GROUPS = 65536
MESH_ENGINE_SECS = 10
# 12(c): phase 5's fabric with every engine over 4 shards, cut from 1,024
# groups an endpoint to keep the script under 800 s (1,024 took 37-45 s)
MESH_E2E_SHARDS = 4
MESH_E2E_GROUPS = 256
# 12(d): tests/test_replica_plane.py's deployment on the 2 x 4 grid
MESH_PLANE_REPLICAS, MESH_PLANE_GROUPS = 4, 8
MESH_PLANE_WAVES, MESH_PLANE_WRITES = 3, 5


def mesh_of(args, torch, n) -> list:
    """The N shard devices this phase names: each its own card where
    the machine has N, else N shards sharing cuda:0 (the engine never
    picks a shared card itself: the list names it); N logical shards of
    the CPU in the rehearsal."""
    if args.cpu:
        return ["cpu"] * n
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def mesh_record(mesh) -> dict:
    devs = [str(d) for d in mesh]
    return {"shards": len(devs), "distinct_cards": len(
        {d for d in devs if d.startswith("cuda")}), "devices": devs}


def fold_rows(rng, g):
    """Seeded deadline-fold rows: every role, some quiescent and some
    uncontrolled slots, deadlines across the int32 range."""
    return (rng.integers(0, 4, g).astype(np.int32), rng.random(g) < 0.3,
            rng.random(g) < 0.7,
            rng.integers(-(2**31), 2**31 - 1, g, dtype=np.int64)
            .astype(np.int32),
            rng.integers(0, 1 << 30, g).astype(np.int32),
            rng.integers(0, 1 << 30, g).astype(np.int32))


def host_fold(role, quiescent, has_ctrl, elect, hb, stepdown) -> int:
    """The engine's host scan (MultiRaftEngine._next_deadline without a
    fold) in the fold's int32 domain."""
    awake = has_ctrl & ~quiescent
    ec, ld = awake & (role <= 1), awake & (role == 2)
    want = INT32_MAX
    if ec.any():
        want = min(want, int(elect[ec].min()))
    if ld.any():
        want = min(want, int(hb[ld].min()), int(stepdown[ld].min()))
    return want


def fold_bound_ms(g) -> float:
    """Least time for one fold: four int32 and two bool rows read once,
    the 4-byte result written once."""
    return (18 * g + 4) / HBM_BYTES_PER_S * 1e3


def phase_mesh_kernels(args, torch, dev) -> dict:
    """12(a): on the card, bit for bit: the sharded tick at 2, 4 and 8
    shards against the single-device fused tick (8 rounds, state
    carried, a seeded perturbation every second round); the fold kernel
    against its plain version and the host scan (8 trials and the
    all-uncontrolled sentinel) at G = 65,536 split 8 ways, then timed;
    the replica quorum over a 2 x 4 grid against one device."""
    from tpuraft_torch.ops import deadline_fold as dfold
    from tpuraft_torch.ops import tick
    from tpuraft_torch.parallel import collective
    from tpuraft_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(SEED + 20)
    res = {"mesh": mesh_record(pmesh.make_mesh(
        MESH_SHARDS, mesh_of(args, torch, MESH_SHARDS)))}
    log("[12] " + json.dumps(res["mesh"]))
    for g, p in ([(64, 8), (256, 4)] if args.cpu else MESH_TICK_SHAPES):
        for s in MESH_SHARD_COUNTS:
            mesh = pmesh.make_mesh(s, mesh_of(args, torch, s))
            prm = (rng.integers(300, 1200, g), rng.integers(50, 200, g),
                   rng.integers(200, 1000, g), rng.integers(0, 2, g) * 700)
            params = tick.tick_params_from_numpy(*prm, device=dev)
            sparams = pmesh.shard_params(params, mesh, g)
            local = tick.group_state_from_numpy(
                rand_tick_fields(rng, g, p), device=dev)
            state = pmesh.shard_group_state(local, mesh)
            run = pmesh.sharded_tick(mesh)
            now = int(rng.integers(0, 1000))
            for r in range(MESH_TICK_ROUNDS):
                now += int(rng.integers(120, 400))
                before = tick.LAUNCHES
                ns, out = run(state, now, sparams)
                launched = tick.LAUNCHES - before
                nl, ol = tick.raft_tick(local, now, params)
                for what, a, b in (("state", pmesh.gather_shards(ns), nl),
                                   ("output", pmesh.gather_shards(out), ol)):
                    an, bn = tick.outputs_to_numpy(a), tick.outputs_to_numpy(b)
                    for k in bn:
                        check(np.array_equal(an[k], bn[k]),
                              f"{s}-shard tick G={g} P={p} round {r}: "
                              f"{what} {k} differs from the single device")
                if not args.cpu:
                    check(launched == s, f"{s} shards made {launched} "
                          f"fused-tick launches")
                state, local = ns, nl
                if r % 2 == 1:
                    h = tick.outputs_to_numpy(nl)
                    h["match_rel"] = (h["match_rel"] + rng.integers(
                        0, 6, (g, p))).astype(np.int32)
                    h["last_ack"] = np.where(rng.random((g, p)) < 0.5, now,
                                             h["last_ack"]).astype(np.int32)
                    h["granted"] = rng.random((g, p)) < 0.4
                    h["fence_start"] = np.where(
                        rng.random(g) < 0.3, now - rng.integers(0, 200, g),
                        h["fence_start"]).astype(np.int32)
                    local = tick.group_state_from_numpy(h, device=dev)
                    state = pmesh.shard_group_state(local, mesh)
        log(f"[12] sharded tick G={g} P={p} at {MESH_SHARD_COUNTS} shards: "
            f"{MESH_TICK_ROUNDS} rounds, all 11 outputs and 15 state fields "
            f"bit-exact vs the single-device tick, one launch a shard")

    g = 512 if args.cpu else MESH_FOLD_G
    mesh = pmesh.make_mesh(MESH_SHARDS, mesh_of(args, torch, MESH_SHARDS))
    fold = pmesh.sharded_deadline_fold(mesh)
    err = 0
    trials = [fold_rows(rng, g) for _ in range(MESH_FOLD_TRIALS)]
    none = (np.full(g, 2, np.int32), np.zeros(g, bool), np.zeros(g, bool),
            *trials[0][3:])
    for i, rows in enumerate([*trials, none]):
        want = host_fold(*rows)
        before = dfold.LAUNCHES
        got = fold(*rows)
        check(args.cpu or dfold.LAUNCHES - before == MESH_SHARDS,
              f"the fold made {dfold.LAUNCHES - before} launches")
        check(got == want, f"fold trial {i}: {got} != host scan {want}")
        for sl in pmesh.group_slices(g, MESH_SHARDS):
            part = [torch.from_numpy(np.ascontiguousarray(x[sl])).to(dev)
                    for x in rows]
            k = dfold.deadline_fold(*part)
            plain = dfold.deadline_fold_reference(*part)
            err = max(err, abs(int(k) - int(plain)))
            check(int(k) == int(plain) == host_fold(*(x[sl] for x in rows)),
                  f"fold trial {i}: kernel {int(k)} vs plain {int(plain)}")
    check(fold(*none) == INT32_MAX, "the all-uncontrolled fold is not the "
          "sentinel")
    log(f"[12] deadline fold G={g} over {MESH_SHARDS} shards: "
        f"{MESH_FOLD_TRIALS} trials and the sentinel equal to the host scan; "
        f"every shard's kernel equal to its plain version")
    # the trials back to back on one work buffer, one stream, no wait in
    # between: each fold must leave the buffer's scratch at rest
    gs = g // MESH_SHARDS
    buf = dfold.fold_work_buffer(dev)
    got = torch.empty(len(trials) + 1, dtype=torch.int32, device=dev)
    parts = [[torch.from_numpy(np.ascontiguousarray(x[:gs])).to(dev)
              for x in rows] for rows in (*trials, none)]
    for i, part in enumerate(parts):
        got[i:i + 1].copy_(dfold.deadline_fold(*part, out=buf).view(1))
    want = [host_fold(*(x[:gs] for x in rows)) for rows in (*trials, none)]
    check(got.cpu().tolist() == want, f"back-to-back folds on one buffer: "
          f"{got.cpu().tolist()} != {want}")
    log(f"[12] deadline fold G={gs}: {len(parts)} folds back to back on one "
        f"work buffer equal to the host scan (the sentinel last)")
    rows = []
    for gs in ((g // MESH_SHARDS, g) if not args.cpu else (g // 8,)):
        part = [torch.from_numpy(np.ascontiguousarray(x[:gs])).to(dev)
                for x in trials[0]]
        buf = dfold.fold_work_buffer(dev)
        row = {"G": gs, "max_abs_err": err, "bound_ms": fold_bound_ms(gs),
               "ms": None, "plain_ms": None, "eager_ms": None}
        if not (args.cpu or args.quick):
            reps = max(1, TIMED_LAUNCHES // 100)
            row["ms"] = time_graph(
                torch, lambda: dfold.deadline_fold(*part, out=buf),
                replays=reps)
            row["plain_ms"] = time_graph(
                torch, lambda: dfold.deadline_fold_reference(*part),
                replays=reps)
            row["eager_ms"] = time_events(
                torch, lambda: dfold.deadline_fold(*part, out=buf),
                TIMED_LAUNCHES)
            # after the graphs of 100 folds on it, the buffer still folds
            # right
            check(int(dfold.deadline_fold(*part, out=buf)) == host_fold(
                *(x[:gs] for x in trials[0])), f"the fold at G={gs} after "
                f"its timed graphs differs from the host scan")
        rows.append(row)
        log(f"[12] deadline_fold G={gs}: " + ", ".join(
            f"{k}={v}" for k, v in row.items() if k.endswith("ms")))
    res["fold_rows"] = rows

    r, g = (4, 64) if args.cpu else MESH_REPLICA_SHAPE
    devs = mesh_of(args, torch, MESH_GRID[0] * MESH_GRID[1])
    grid = [devs[i * MESH_GRID[1]:(i + 1) * MESH_GRID[1]]
            for i in range(MESH_GRID[0])]
    match, granted = replica_inputs(rng, r, g)
    one_c, one_v = collective.replicated_tick(r, device=dev)(match, granted)
    before = collective.LAUNCHES
    grid_c, grid_v = collective.replicated_tick(r, device=grid)(match, granted)
    launched = collective.LAUNCHES - before
    check(torch.equal(torch.cat([c.cpu() for c in grid_c]), one_c.cpu())
          and torch.equal(torch.cat([v.cpu() for v in grid_v]), one_v.cpu()),
          f"the replica quorum over the {MESH_GRID} grid differs from one "
          f"device at R={r} G={g}")
    if not args.cpu:
        check(launched == MESH_GRID[1], f"the grid made {launched} "
              f"replica-quorum launches")
    log(f"[12] replica quorum R={r} G={g} over a {MESH_GRID[0]} x "
        f"{MESH_GRID[1]} grid: bit-exact vs one device, one launch a "
        f"groups-shard")
    return res


async def phase_mesh_engine(args, torch) -> dict:
    """12(b): bench_multichip.py's mesh lanes (`_drive_mesh`, the --scale
    rung) on the port, through bench_torch_multichip.py's drive_mesh: one
    engine of 65,536 groups, P=4, over 8 shards, driven for
    MESH_ENGINE_SECS by stub controls; the witness clamp holds and
    engages, the stepdown, fence and election lanes deliver, every fence
    resolves, every engine tick is one fused-tick launch a shard, and
    every deadline fold (one a round, as the engine's loop folds) one
    fold launch a shard and equal to the host scan."""
    from bench_torch_multichip import drive_mesh

    G = 1024 if args.cpu else MESH_ENGINE_GROUPS
    secs = 2 if args.cpu else MESH_ENGINE_SECS
    res = await drive_mesh(G, mesh_of(args, torch, MESH_SHARDS), secs,
                           SEED + 21)
    res["launches"] = res["fused_tick_launches"]
    log("[12b] " + json.dumps(res))
    check(res["ok"], f"12(b): {'; '.join(res['failures'])}")
    return res


async def phase_mesh_plane(args, torch) -> dict:
    """12(d): tests/test_replica_plane.py's deployment (4 replicas x 8
    groups, 3 waves of 5 writes) with its plane over a 2 x 4 grid, then
    the replica leading the fewest groups stopped and one more write a
    group; every replica's log equals the acknowledged writes and every
    plane tick is one replica-quorum launch a groups-shard."""
    from tpuraft_torch.core.node import State
    from tpuraft_torch.entity import Task
    from tpuraft_torch.parallel import collective
    from tpuraft_torch.parallel.replica_cluster import ReplicaPlaneCluster

    devs = mesh_of(args, torch, MESH_GRID[0] * MESH_GRID[1])
    grid = [devs[i * MESH_GRID[1]:(i + 1) * MESH_GRID[1]]
            for i in range(MESH_GRID[0])]
    loop = asyncio.get_running_loop()
    collective.LAUNCHES = 0  # the path's count starts here
    t0 = time.perf_counter()
    c = ReplicaPlaneCluster(MESH_PLANE_REPLICAS, MESH_PLANE_GROUPS,
                            device=grid)
    await c.start_all()
    acked = {g: [] for g in c.groups}

    async def leaders(timeout_s):
        deadline = loop.time() + timeout_s
        while True:
            found = {}
            for (g, _), node in c.nodes.items():
                if node.state == State.LEADER:
                    found.setdefault(g, []).append(node)
            if all(len(found.get(g, ())) == 1 for g in c.groups):
                return {g: found[g][0] for g in c.groups}
            check(loop.time() < deadline, "12(d): a group has no leader")
            await asyncio.sleep(0.02)

    async def write_all(leader_of, k, tag):
        futs = []
        for g in c.groups:
            for i in range(k):
                data = f"{g}-{tag}-{i}".encode()
                fut = loop.create_future()
                await leader_of[g].apply(Task(data=data, done=fut.set_result))
                futs.append((g, data, fut))
        sts = await asyncio.wait_for(
            asyncio.gather(*[f for _, _, f in futs]), 60)
        check(all(st.is_ok() for st in sts), "12(d): a write failed")
        for g, data, _ in futs:
            acked[g].append(data)

    async def read_back(timeout_s=30):
        deadline = loop.time() + timeout_s
        while any(c.fsms[k].logs != acked[k[0]] for k in c.nodes):
            for k in c.nodes:
                logs = c.fsms[k].logs
                check(logs == acked[k[0]][:len(logs)],
                      f"12(d): replica {k} log differs from the acked writes")
            check(loop.time() < deadline, "12(d): replicas behind")
            await asyncio.sleep(0.02)

    try:
        leader_of = await leaders(60)
        for wave in range(MESH_PLANE_WAVES):
            await write_all(leader_of, MESH_PLANE_WRITES, f"w{wave}")
        await read_back()
        led = {ep.endpoint: 0 for ep in c.endpoints}
        for node in leader_of.values():
            led[node.server_id.endpoint] += 1
        victim = min(c.endpoints, key=lambda ep: led[ep.endpoint])
        await c.stop_replica(victim)
        leader_of = await leaders(60)
        await write_all(leader_of, 1, "post")
        await read_back()
    finally:
        await c.stop_all()
    launches = collective.LAUNCHES  # read right after the path
    res = {"replicas": MESH_PLANE_REPLICAS, "groups": MESH_PLANE_GROUPS,
           "grid": list(MESH_GRID), **mesh_record(devs),
           "launches": launches, "plane_ticks": c.plane.ticks,
           "commit_advances": c.plane.commit_advances,
           "acked_writes": sum(len(v) for v in acked.values()),
           "victim_led": led[victim.endpoint],
           "wall_s": time.perf_counter() - t0}
    log("[12d] " + json.dumps(res))
    check(res["acked_writes"] == MESH_PLANE_GROUPS * (
        MESH_PLANE_WAVES * MESH_PLANE_WRITES + 1), "12(d): write count")
    if not args.cpu:
        check(launches > 0 and launches == c.plane.ticks * MESH_GRID[1],
              f"{c.plane.ticks} plane ticks made {launches} replica-quorum "
              f"launches ({MESH_GRID[1]} each expected)")
    return res


def phase_mesh(args, torch, quorum_cuda, tick, dev) -> dict:
    """Phase 12, after 11(b) and beside no other phase."""
    t0 = time.perf_counter()
    res = {"kernels": phase_mesh_kernels(args, torch, dev)}
    res["engine"] = asyncio.run(phase_mesh_engine(args, torch))
    res["e2e"] = asyncio.run(phase_e2e(args, torch, quorum_cuda, tick, dev,
                                       shards=MESH_E2E_SHARDS, tag="12c",
                                       groups=MESH_E2E_GROUPS))
    res["plane"] = asyncio.run(phase_mesh_plane(args, torch))
    res["wall_s"] = time.perf_counter() - t0
    log(f"[12] mesh phase done in {res['wall_s']:.3f} s")
    return res


# -- phase 13: the driver's entry points and the pipelined device plane -------

# bench.py:43-50: 16,384 groups of 8 peer slots, 3 voters, 32 entries a
# follower a tick, 400 ticks after 40 warm-up ticks
PLANE_SHAPE = (16384, 8)
PLANE_VOTERS = 3
PLANE_BATCH = 32
PLANE_TICKS = 400
PLANE_WARMUP = 40
DRYRUN_SHARDS = 8           # __graft_entry__.py's dryrun_multichip(8)


def on_device(obj, dev):
    """A GroupState or TickParams (any dataclass of tensors) on dev."""
    return type(obj)(**{f.name: getattr(obj, f.name).to(dev)
                        for f in dataclasses.fields(obj)})


def same_fields(got, want, what: str) -> None:
    """Every field of two GroupStates or TickOutputs equal, bit for bit."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        check(a.dtype == b.dtype and a.cpu().equal(b.cpu()),
              f"{what}: {f.name} differs from the plain version")


def phase_entry_points(args, torch, dev) -> dict:
    """13(a)-(b): the port's __graft_entry__ counterparts on the card."""
    from tpuraft_torch import graft_entry
    from tpuraft_torch.ops import tick
    from tpuraft_torch.parallel import collective

    # (a) entry(): the fused tick at 1,024 x 8 against the plain tick
    tick.LAUNCHES = 0  # the path's count starts here
    fn, fargs = graft_entry.entry(device=dev)
    new_state, out = fn(*fargs)
    entry_launches = tick.LAUNCHES
    want_state, want_out = tick.raft_tick_reference(*fargs)
    same_fields(out, want_out, "13(a) entry() outputs")
    same_fields(new_state, want_state, "13(a) entry() state")
    check(bool(out.commit_advanced.any()), "13(a): no commit advanced")
    if not args.cpu:
        check(entry_launches == 1, f"13(a): {entry_launches} launches")
    log(f"[13a] entry() on {dev}: 1,024 x 8, all 11 outputs and 15 state "
        f"fields bit-exact against the plain tick, {entry_launches} "
        f"fused-tick launch")

    # (b) dryrun_multichip(8) over a named device list
    devs = mesh_of(args, torch, DRYRUN_SHARDS)
    tick.LAUNCHES = collective.LAUNCHES = 0
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(DRYRUN_SHARDS, devs)
    wall = time.perf_counter() - t0
    sharded_launches, replica_launches = tick.LAUNCHES, collective.LAUNCHES
    state, params = graft_entry.sharded_plane_state(DRYRUN_SHARDS)
    ws, wo = tick.raft_tick_reference(on_device(state, dev), 1,
                                      on_device(params, dev))
    got_state, got_out = res["sharded"]
    same_fields(got_out, wo, "13(b) plane (a) outputs")
    same_fields(got_state, ws, "13(b) plane (a) state")
    match, granted = graft_entry.replica_plane_inputs(DRYRUN_SHARDS)
    r = match.shape[0]
    m, gr = torch.from_numpy(match).to(dev), torch.from_numpy(granted).to(dev)
    commit, votes = res["replica"]
    check(np.array_equal(commit, collective.replica_commit_point(
        m, r).cpu().numpy()), "13(b) plane (b) commit differs from plain")
    check(np.array_equal(votes, collective.replica_vote_count(
        gr).cpu().numpy()), "13(b) plane (b) votes differ from plain")
    check(np.array_equal(commit, np.sort(match, 0)[::-1][r // 2]),
          "13(b) plane (b) commit differs from the oracle")
    cluster = res["cluster"]
    g_dim = DRYRUN_SHARDS // 2
    if not args.cpu:
        check(sharded_launches == DRYRUN_SHARDS,
              f"13(b) plane (a): {sharded_launches} fused-tick launches for "
              f"{DRYRUN_SHARDS} shards")
        check(replica_launches == g_dim * (1 + cluster["plane_ticks"]),
              f"13(b): {replica_launches} replica-quorum launches for plane "
              f"(b) and {cluster['plane_ticks']} plane ticks x {g_dim}")
    rec = {"devices": [str(d) for d in devs], "wall_s": wall,
           "entry_launches": entry_launches,
           "sharded_launches": sharded_launches,
           "replica_launches": replica_launches, "cluster": cluster}
    log("[13b] dryrun_multichip(8): plane (a) bit-exact against the plain "
        "tick, plane (b) against the plain quorum and the oracle, (b') "
        "passed; " + json.dumps(rec))
    return rec


def plain_plane_rows(torch, dev, g, p, advances, warmup, n):
    """The plain tick on dev over run_plane's acks, one tick at a time
    with the state carried (the 5 link probes after the warm-up): each
    tick's commit row, stacked on dev."""
    from tpuraft_torch import device_plane
    from tpuraft_torch.ops import tick

    state = device_plane.leader_state(g, p, PLANE_VOTERS, dev)
    params = tick.TickParams.make(1000, 100, 900, device=dev)
    host = np.zeros((g, p), np.int32)
    rows = []
    for i in range(n):
        if i == warmup:
            for _ in range(device_plane.RTT_PROBES):
                state, _ = tick.raft_tick_reference(state, 0, params)
        host += advances[i]
        state = dataclasses.replace(
            state, match_rel=torch.from_numpy(host.copy()).to(dev))
        state, out = tick.raft_tick_reference(state, i, params)
        rows.append(out.commit_rel)
    return torch.stack(rows)


def phase_device_plane(args, torch, dev, tick_rows) -> dict:
    """13(c): bench.py's pipelined loop at its full shape, every tick's
    commit row against the plain tick's, launches = ticks."""
    from tpuraft_torch import device_plane
    from tpuraft_torch.ops import tick

    (g, p), ticks, warmup = (((256, 8), 60, 4) if args.cpu else
                             (PLANE_SHAPE, PLANE_TICKS, PLANE_WARMUP))
    tick.LAUNCHES = 0  # the path's count starts here
    t0 = time.perf_counter()
    res = device_plane.run_plane(g, p, PLANE_VOTERS, PLANE_BATCH, ticks,
                                 warmup, SEED, device=dev, record=True)
    run_s = time.perf_counter() - t0
    launches = tick.LAUNCHES
    if not args.cpu:
        check(launches == res["ticks_run"] == res["launches"],
              f"13(c): {launches} fused-tick launches for "
              f"{res['ticks_run']} ticks")
    n = res["submitted"]
    half = res["profiled_pass"]["ticks"]
    advances = device_plane.plane_advances(
        g, p, PLANE_VOTERS, PLANE_BATCH, warmup + ticks + half, SEED)
    t1 = time.perf_counter()
    want = plain_plane_rows(torch, dev, g, p, advances, warmup, n)
    got = torch.from_numpy(res.pop("rows")).to(dev)
    bad = (got != want).any(dim=1).nonzero().flatten()[:5].tolist()
    check(not bad, f"13(c): the commit rows of ticks {bad} differ from "
          f"the plain tick's")
    check(res["total_commits"] == int(want[-1].sum()),
          "13(c): total commits differ from the plain tick's")
    check_s = time.perf_counter() - t1
    prof = res["profiled_pass"]
    graph = next((r for r in tick_rows if (r["G"], r["P"]) == (g, p)), None)
    rec = {**res, "fused_tick_launches": launches, "run_s": run_s,
           "check_s": check_s,
           "tick_graph_ms": graph["ms"] if graph else None,
           # the busy share of the median pass: device time a tick (the
           # profiled pass) x its unprofiled ticks/s
           "busy_share_at_median": (
               prof["device_busy_us_per_tick"] * res["ticks_per_sec"] / 1e6
               if prof.get("device_busy_us_per_tick") else None)}
    log(f"[13c] device plane {g} x {p} on {dev}: {n} ticks submitted, "
        f"every commit row bit-exact against the plain tick "
        f"(check {check_s:.3f} s), {launches} fused-tick launches for "
        f"{res['ticks_run']} ticks; median pass "
        f"{res['commits_per_sec']:.1f} commits/s, "
        f"{res['ticks_per_sec']:.3f} ticks/s, ack p50 "
        f"{res['ack_p50_ms']:.4f} / p99 {res['ack_p99_ms']:.4f} ms, "
        f"dispatch {res['dispatch_ms']:.4f} ms, depth "
        f"{res['pipeline_depth']}, completion RTT "
        f"{res['completion_rtt_ms']:.4f} ms, busy share "
        f"{prof['busy_share']} (profiled pass), "
        f"{rec['busy_share_at_median']} (at the median's ticks/s)")
    log("[13c] " + json.dumps(rec))
    return rec


def phase_driver_entry(args, torch, dev, tick_rows) -> dict:
    """Phase 13, after phase 10's child has ended, beside no other phase."""
    t0 = time.perf_counter()
    res = {"entry": phase_entry_points(args, torch, dev),
           "plane": phase_device_plane(args, torch, dev, tick_rows)}
    res["wall_s"] = time.perf_counter() - t0
    log(f"[13] driver entry points and device plane done in "
        f"{res['wall_s']:.3f} s")
    return res


# -- phase 14: the bench family --------------------------------------------------

# 14(a): bench_scale.py's 1K rung (1,024 groups x 3 endpoints in one
# process, P=4, multilog) with a 2 s election timeout released over 3 s,
# every group led before the drive, and a short drive: offered 8,192
# entries/s in batches of 16 is a 2 s pace, so 4 s and two batches a
# group (cut from a 5.33 s drive and an 8 s release to keep the script
# near 800 s)
BENCH_SCALE_GROUPS = 1024
BENCH_SCALE_ETO_MS = 2000
BENCH_SCALE_SPREAD_S = 3
BENCH_SCALE_SECS = 4
BENCH_SCALE_OFFERED = 8192
# 14(b): bench_e2e.py's 3 store processes at 64 groups, 1 s warm-up, 3 s
BENCH_E2E_GROUPS = 64
BENCH_E2E_SECS = 3
# 14(c): bench_multichip.py --smoke (1,024 groups) over 8 shards, and
# --engine-shape (1,024 groups on one device, the best of 3 runs of 1 s)
BENCH_MESH_GROUPS = 1024
BENCH_MESH_SHARDS = 8
BENCH_SHAPE_SECS = 1
BENCH_CHILD_TIMEOUT_S = 300


class BenchChild:
    """One bench script in a process group of its own, its output in
    files; ``kill`` ends the whole group (an e2e parent's stores)."""

    def __init__(self, args, tag: str, work: str, script: str, *extra,
                 device: bool = True, env: dict | None = None):
        root = os.path.dirname(os.path.abspath(__file__))
        self.tag, self.out = tag, os.path.join(work, f"{tag}.json")
        self.stdout = os.path.join(work, f"{tag}.stdout")
        self.stderr = os.path.join(work, f"{tag}.stderr")
        # a host-plane script runs no engine and takes no --cpu
        cmd = [sys.executable, os.path.join(root, script), *extra,
               "--out", self.out] + (["--cpu"] if args.cpu and device
                                     else [])
        log(f"[{tag[:2]}] {tag}: {' '.join(cmd[1:])}")
        with open(self.stdout, "w") as so, open(self.stderr, "w") as se:
            self.proc = subprocess.Popen(
                cmd, stdout=so, stderr=se, cwd=root,
                start_new_session=True, env=dict(os.environ, **(env or {})))

    def wait(self) -> dict:
        """Its exit 0 and its --out record; on failure its error's tail."""
        try:
            rc = self.proc.wait(timeout=BENCH_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            with open(self.stderr) as f:
                tail = f.read()[-3000:]
            check(False, f"{self.tag}: exited {rc}\n{tail}")
        with open(self.out) as f:
            return json.load(f)

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def phase_bench_family(args) -> dict:
    """Phase 14, after phase 13, beside no other phase: the port's
    bench scripts as a user runs them, each in its own processes, (a)
    and (b) beside (c)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="tpuraft_torch_bench_")
    small = args.cpu
    groups = args.groups or 16
    children = []
    try:
        scale = BenchChild(
            args, "14a_scale", work, "bench_torch_scale.py",
            "--rungs", str(groups if small else BENCH_SCALE_GROUPS),
            "--duration", "2" if small else str(BENCH_SCALE_SECS),
            "--offered", str(BENCH_SCALE_OFFERED // 4 if small
                             else BENCH_SCALE_OFFERED),
            "--election-timeout-ms", "1000" if small
            else str(BENCH_SCALE_ETO_MS),
            "--elect-spread-s", "0.05" if small
            else str(BENCH_SCALE_SPREAD_S),
            "--converge", "1.0")
        children.append(scale)
        e2e = BenchChild(
            args, "14b_e2e", work, "bench_torch_e2e.py",
            "--groups", str(8 if small else BENCH_E2E_GROUPS),
            "--duration", str(BENCH_E2E_SECS), "--warmup", "1",
            "--converge", "1.0")
        children.append(e2e)
        mesh_groups = 1024 if small else BENCH_MESH_GROUPS
        smoke = BenchChild(
            args, "14c_smoke", work, "bench_torch_multichip.py", "--smoke",
            "--groups", str(mesh_groups), "--devices",
            str(BENCH_MESH_SHARDS))
        children.append(smoke)
        smoke_rec = smoke.wait()["smoke"]
        shape = BenchChild(
            args, "14c_engine_shape", work, "bench_torch_multichip.py",
            "--engine-shape", "--groups", str(mesh_groups),
            "--duration", str(BENCH_SHAPE_SECS))
        children.append(shape)
        shape_rec = shape.wait()["engine_shape"]
        scale_rec = scale.wait()
        e2e_rec = e2e.wait()
    finally:
        for c in children:
            c.kill()
        shutil.rmtree(work, ignore_errors=True)

    # (a) one rung: every group led, every acknowledged write applied on
    # all three replicas, each engine one launch a tick
    (row,) = scale_rec["rows"]
    log("[14a] " + json.dumps(row))
    check(row["rc"] == 0, f"14(a): the rung exited {row['rc']}")
    check(row["leaders"] == row["groups"] == row["leaders_at_end"],
          f"14(a): {row['leaders']} leaders at the drive, "
          f"{row['leaders_at_end']} after it, of {row['groups']} groups")
    check(row["errors"] == 0, f"14(a): errors {row['errors_by_class']}")
    check(row["ok"] > 0, "14(a): no write acknowledged")
    check(row["applied_total"] == row["replicas"] * row["ok"],
          f"14(a): {row['applied_total']} applies for {row['ok']} acks x "
          f"{row['replicas']} replicas")
    # (b) three store processes over the native transport
    extra = e2e_rec["extra"]
    log("[14b] " + json.dumps(e2e_rec))
    check(extra["store_exit_codes"] == [0] * extra["stores"],
          f"14(b): store exit codes {extra['store_exit_codes']}")
    check(e2e_rec["value"] > 0, "14(b): no commit")
    check(extra["errors"] == 0, f"14(b): {extra['errors']} errors")
    check(extra["leaders_placed"] == extra["groups"],
          f"14(b): {extra['leaders_placed']} leaders placed")
    # (c) the mesh lanes and the single-device shape
    log("[14c] smoke " + json.dumps(smoke_rec))
    log("[14c] engine shape " + json.dumps(shape_rec))
    check(smoke_rec["ok"], f"14(c): {smoke_rec['failures']}")
    check(smoke_rec["fences_pending"] == 0, "14(c): fences left pending")
    check(shape_rec["ok"], "14(c): engine shape launches differ from ticks")
    launches = {
        "phase14a_scale_rung": sum(row["fused_tick_launches"]),
        "phase14b_e2e_stores": sum(extra["fused_tick_launches_per_store"]),
        "phase14c_smoke_mesh": smoke_rec["fused_tick_launches"],
        "phase14c_engine_shape": sum(r["fused_tick_launches"]
                                     for r in shape_rec["runs"])}
    ticks = {
        "phase14a_scale_rung": sum(row["ticks_by_engine"]),
        "phase14b_e2e_stores": sum(extra["engine_ticks_per_store"]),
        "phase14c_smoke_mesh": smoke_rec["ticks"],
        "phase14c_engine_shape": sum(r["ticks"] for r in shape_rec["runs"])}
    if not args.cpu:
        check(row["fused_tick_launches"] == row["ticks_by_engine"],
              f"14(a): launches {row['fused_tick_launches']} for ticks "
              f"{row['ticks_by_engine']}")
        check(extra["fused_tick_launches_per_store"]
              == extra["engine_ticks_per_store"],
              f"14(b): launches {extra['fused_tick_launches_per_store']} "
              f"for ticks {extra['engine_ticks_per_store']}")
        check(launches["phase14c_smoke_mesh"]
              == smoke_rec["ticks"] * BENCH_MESH_SHARDS,
              f"14(c): {smoke_rec['fused_tick_launches']} launches for "
              f"{smoke_rec['ticks']} ticks x {BENCH_MESH_SHARDS}")
        check(smoke_rec["fold_launches"]
              == smoke_rec["fold_calls"] * BENCH_MESH_SHARDS,
              f"14(c): {smoke_rec['fold_launches']} fold launches for "
              f"{smoke_rec['fold_calls']} folds x {BENCH_MESH_SHARDS}")
        check(launches["phase14c_engine_shape"]
              == ticks["phase14c_engine_shape"],
              "14(c): engine shape launches differ from ticks")
    res = {"launches": launches, "ticks": ticks,
           "fold_launches": smoke_rec["fold_launches"],
           "fold_calls": smoke_rec["fold_calls"],
           "engine_ticks_per_sec": shape_rec["engine_ticks_per_sec"],
           "wall_s": time.perf_counter() - t0}
    log(f"[14] bench family done in {res['wall_s']:.3f} s: scale rung "
        f"{row['commits_per_sec']} commits/s (ack p50 {row['ack_p50_ms']} / "
        f"p99 {row['ack_p99_ms']} ms), e2e {e2e_rec['value']} commits/s, "
        f"mesh smoke {smoke_rec['ticks_per_sec']} ticks/s over "
        f"{BENCH_MESH_SHARDS} shards, engine shape "
        f"{shape_rec['engine_ticks_per_sec']} ticks/s; launches "
        f"{json.dumps(launches)} for ticks {json.dumps(ticks)}")
    return res


# -- phase 15: the KV store bench at region density and the host A/Bs ----------

# 15(a): bench_region_density.py's store at 256 regions x 3 (G = 512), a
# 1.5 s election timeout (from 10; released over 6 s), a 3 s drive (from
# 30), every region led first
BENCH_REGIONS = 256
BENCH_REGIONS_ETO_MS = 1500
BENCH_REGIONS_SECS = 3
# 15(b)-(d), host only, beside (a): bench_multiproc.py at 64 regions (from
# 1,024), 24 workers for 2 s (from 30), a 2 s election timeout (from 10);
# bench_gray.py's two arms at 16 regions and 8 workers (from 128 and 32),
# 2 s healthy and 4 s faulted (from 10 and 30); bench_geo.py at 20 ops a
# row (from 150). Phase 15 took 35.6 and 40.2 s at 4 s drives, 3 s for
# the A/B and 5 s faulted; cut after the whole script took 820 s
BENCH_MP_REGIONS = 64
BENCH_MP_WORKERS = 24
BENCH_MP_SECS = 2
BENCH_MP_ETO_MS = 2000
BENCH_GRAY_SHAPE = (16, 8, 2, 4)  # regions, workers, healthy s, fault s
BENCH_GEO_OPS = 20
# the reference scripts' record keys, which each port record holds
REGION_ROW_KEYS = (
    "regions", "stores", "topology", "leaders", "boot_s", "elect_s",
    "ops_per_sec", "ok", "errors", "ack_p50_ms", "ack_p99_ms", "rss_mb",
    "rss_kb_per_region", "pd_store_hb_per_s", "pd_region_hb_per_s",
    "pd_batch_hb_per_s", "pd_delta_rows_per_s", "pd_rpcs_per_s",
    "asyncio_tasks", "workers", "pace_ms", "read_frac", "read_from",
    "lease_reads", "kv_batch_rpcs_per_s", "kv_batch_items_per_rpc",
    "kv_batch_fallbacks", "kv_batch_retry_codes", "srv_batch_rpcs",
    "srv_single_rpcs", "fsm_coalesced_flushes", "fsm_coalesced_ops",
    "stage_marks_ms", "write_plane", "read_stage_marks_ms", "read_plane",
    "tick_plane", "heat", "wall_s")
MP_ROW_KEYS = (
    "regions", "stores", "topology", "host_cpus", "boot_s", "elect_s",
    "ops_per_sec", "ok", "errors", "ack_p50_ms", "ack_p99_ms", "workers",
    "pace_ms", "read_frac", "transport", "store", "apply_lane",
    "encode_lane", "cpu_s_per_store", "cpu_s_client", "cpu_cores_used",
    "kv_batch_rpcs_per_s", "kv_batch_items_per_rpc", "store_metrics",
    "wall_s")
GRAY_KEYS = ("bench", "regions", "workers", "fault", "arms", "claim")
GRAY_ARM_KEYS = (
    "detection", "ops", "healthy_p99_ms", "faulted_p99_ms",
    "recovered_p99_ms", "window_ops", "victim", "victim_led_regions_before",
    "victim_led_regions_after", "evacuations", "shed_items", "faulted_x",
    "recovered_x")
GEO_KEYS = ("bench", "seed", "ops_per_row", "link_shape", "rows", "note")
GEO_ROW_KEYS = ("topology", "stores", "zones", "witness", "degraded_wan",
                "commit", "ack", "topology_counters")


def has_keys(rec: dict, keys, what: str) -> None:
    missing = sorted(set(keys) - set(rec))
    check(not missing, f"{what}: the reference's keys {missing} missing")


def roomy_tmp() -> str | None:
    """Where phase 15's stores keep their data: the default temporary
    directory, or /dev/shm where statvfs reads the default's filesystem
    past a store's near-full mark and /dev/shm has room. These scripts'
    stores take no explicit disk budget (neither the reference's nor the
    port's has a flag for one), and a store on a full filesystem sheds
    every write."""
    import tempfile

    def used(path: str) -> float:
        sv = os.statvfs(path)
        return 1.0 - sv.f_bavail / max(1, sv.f_blocks)

    if used(tempfile.gettempdir()) < 0.8:
        return None
    shm = "/dev/shm"
    if os.path.isdir(shm) and os.access(shm, os.W_OK) and used(shm) < 0.5:
        return shm
    return None


def phase_store_benches(args) -> dict:
    """Phase 15, after phase 14: the KV store bench at region density
    with its engines on the card, and the three host-plane A/Bs beside
    it, each script in its own process group."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="tpuraft_torch_bench15_",
                            dir=roomy_tmp())
    env = {"TMPDIR": work}
    small = args.cpu
    regions = (args.groups or 16) if small else BENCH_REGIONS
    g_regions, g_workers, g_healthy, g_fault = BENCH_GRAY_SHAPE
    children = []
    try:
        dens = BenchChild(
            args, "15a_region_density", work, "bench_torch_region_density.py",
            "--regions", str(regions), "--duration", str(BENCH_REGIONS_SECS),
            "--election-timeout-ms", "1000" if small
            else str(BENCH_REGIONS_ETO_MS), "--converge", "1.0", env=env)
        children.append(dens)
        mp = BenchChild(
            args, "15b_multiproc", work, "bench_torch_multiproc.py",
            "--regions", str(8 if small else BENCH_MP_REGIONS),
            "--workers", str(BENCH_MP_WORKERS),
            "--duration", str(BENCH_MP_SECS),
            "--election-timeout-ms", str(BENCH_MP_ETO_MS),
            device=False, env=env)
        children.append(mp)
        gray = BenchChild(
            args, "15c_gray", work, "bench_torch_gray.py",
            "--regions", str(g_regions), "--workers", str(g_workers),
            "--healthy-s", str(g_healthy), "--fault-s", str(g_fault),
            device=False, env=env)
        children.append(gray)
        geo = BenchChild(args, "15d_geo", work, "bench_torch_geo.py",
                         "--ops", str(BENCH_GEO_OPS), device=False, env=env)
        children.append(geo)
        geo_rec = geo.wait()
        gray_rec = gray.wait()
        mp_rec = mp.wait()
        dens_rec = dens.wait()
    finally:
        for c in children:
            c.kill()
        shutil.rmtree(work, ignore_errors=True)

    # (a) the store at region density, its engines on the card
    (key,) = [k for k in dens_rec if k.startswith("row")]
    row = dens_rec[key]
    log("[15a] " + json.dumps(row))
    has_keys(row, REGION_ROW_KEYS, "15(a)")
    check(row["rc"] == 0, f"15(a): the child exited {row['rc']}")
    check(row["leaders"] == row["leaders_at_end"] == regions,
          f"15(a): {row['leaders']} leaders at the drive, "
          f"{row['leaders_at_end']} after it, of {regions} regions")
    check(row["ok"] > 0, "15(a): no op acknowledged")
    check(row["errors"] == 0, f"15(a): {row['errors']} errors "
          f"(retry codes {row['kv_batch_retry_codes']})")
    check({"propose_s", "quorum_e", "apply_e", "ack"}
          <= set(row["stage_marks_ms"]),
          f"15(a): the put probe's marks {row['stage_marks_ms']}")
    check({"fence_s", "fence_e"} <= set(row["read_stage_marks_ms"]),
          f"15(a): the get probe's marks {row['read_stage_marks_ms']}")
    if not args.cpu:
        check(row["fused_tick_launches"] == row["ticks_by_engine"],
              f"15(a): launches {row['fused_tick_launches']} for ticks "
              f"{row['ticks_by_engine']}")
    # (b) the store across processes
    mp_rows = [r for k, r in mp_rec.items() if k.startswith("row_mp")]
    log("[15b] " + json.dumps(mp_rows))
    check(len(mp_rows) == 1, f"15(b): {len(mp_rows)} rows, not 1")
    for r in mp_rows:
        has_keys(r, MP_ROW_KEYS, "15(b)")
        check(r["ok"] > 0, f"15(b): no write acknowledged in {r['row']}")
    # (c) gray failure, both arms
    log("[15c] " + json.dumps(gray_rec))
    has_keys(gray_rec, GRAY_KEYS, "15(c)")
    check(set(gray_rec["arms"]) == {"on", "off"},
          f"15(c): arms {sorted(gray_rec['arms'])}")
    for name, arm in gray_rec["arms"].items():
        has_keys(arm, GRAY_ARM_KEYS, f"15(c) {name}")
        check(arm["ops"] > 0, f"15(c): no op in the {name} arm")
    # (d) geo latency rows
    log("[15d] " + json.dumps(geo_rec))
    has_keys(geo_rec, GEO_KEYS, "15(d)")
    check(len(geo_rec["rows"]) == 4, f"15(d): {len(geo_rec['rows'])} rows")
    for r in geo_rec["rows"]:
        has_keys(r, GEO_ROW_KEYS, f"15(d) {r['topology']}")
        check(r["ops"] > 0 and r["commit"]["n"] == r["ack"]["n"] == r["ops"],
              f"15(d) {r['topology']}: {r['commit']['n']} commits and "
              f"{r['ack']['n']} acks of {r['ops']} ops")
    res = {"launches": {"phase15a_region_density":
                        sum(row["fused_tick_launches"])},
           "ticks": {"phase15a_region_density": sum(row["ticks_by_engine"])},
           "multiproc_ops_per_sec": [r["ops_per_sec"] for r in mp_rows],
           "gray_ratios": {name: {"faulted_x": arm["faulted_x"],
                                  "recovered_x": arm["recovered_x"]}
                           for name, arm in gray_rec["arms"].items()},
           "geo_commit_p50_ms": {r["topology"]: r["commit"]["p50_ms"]
                                 for r in geo_rec["rows"]},
           "wall_s": time.perf_counter() - t0}
    log(f"[15] store benches done in {res['wall_s']:.3f} s: {regions} "
        f"regions x 3 at {row['ops_per_sec']} ops/s (ack p50 "
        f"{row['ack_p50_ms']} / p99 {row['ack_p99_ms']} ms), launches "
        f"{row['fused_tick_launches']} for ticks {row['ticks_by_engine']}; "
        f"multiproc {res['multiproc_ops_per_sec']} ops/s; gray ratios "
        f"(recorded, not gated) {json.dumps(res['gray_ratios'])}; geo "
        f"commit p50 {json.dumps(res['geo_commit_p50_ms'])}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse every phase at tiny sizes on the CPU "
                         "(plain versions; prints no device result)")
    ap.add_argument("--quick", action="store_true",
                    help="build with -Xptxas -v, compare both kernels "
                         "with their plain versions (3 tick rounds per "
                         "case), time nothing, stop")
    ap.add_argument("--groups", type=int, default=None,
                    help="with --cpu only: raft groups per endpoint in the "
                         "end-to-end rehearsal and regions of the KV store "
                         "rehearsal (default 16; the card always runs "
                         "1024)")
    ap.add_argument("--lifecycle-child", metavar="OUT",
                    help=argparse.SUPPRESS)  # phase 8's own process
    ap.add_argument("--replica-child", metavar="OUT",
                    help=argparse.SUPPRESS)  # phase 11(b)'s own process
    args = ap.parse_args()
    if args.groups is not None and not args.cpu:
        ap.error("--groups is for the --cpu rehearsal only")
    if args.replica_child:  # needs no JAX and no phase before it
        import torch

        if not args.cpu:
            check(torch.cuda.is_available(), "no CUDA device")
            from tpuraft_torch.ops import quorum_cuda

            quorum_cuda.load()  # built by the parent; loaded off the path
        res = asyncio.run(replica_plane_run(args))
        with open(args.replica_child, "w") as f:
            json.dump(res, f)
        return 0

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); use --cpu for the rehearsal", file=sys.stderr)
        return 2
    from tpuraft_torch.ops import quorum_cuda, tick

    if args.lifecycle_child:
        if not args.cpu:
            quorum_cuda.load()  # built by the parent; loaded outside the path
        res = asyncio.run(lifecycle_run(args, quorum_cuda, tick))
        with open(args.lifecycle_child, "w") as f:
            json.dump(res, f)
        return 0
    dev = torch.device("cpu" if args.cpu else "cuda")
    card, build_s = phase_card(args, torch, quorum_cuda)
    native_build_s = phase_native()
    if args.quick:
        phase_kernel(args, torch, quorum_cuda, dev)
        phase_tick(args, torch, dev)
        phase_replica_kernel(args, torch, dev)
        phase_mesh_kernels(args, torch, dev)
        log("[quick] build and compare done")
        return 0
    faults = start_fault_plane(args)
    try:
        rows = phase_kernel(args, torch, quorum_cuda, dev)
        tick_rows = phase_tick(args, torch, dev)
        replica_rows = phase_replica_kernel(args, torch, dev)
        asyncio.run(phase_engine(args, torch, dev))
        e2e = asyncio.run(phase_e2e(args, torch, quorum_cuda, tick, dev))
        kv = asyncio.run(phase_kv(args, quorum_cuda, tick))
        soak_res = asyncio.run(phase_soak(args, quorum_cuda, tick))
        life = phase_lifecycle(args)
        replica_res = phase_replica_plane(args)
        mesh_res = phase_mesh(args, torch, quorum_cuda, tick, dev)
        fleet = asyncio.run(phase_fleet(args))
        phase_fault_plane(faults)
        driver = phase_driver_entry(args, torch, dev, tick_rows)
        bench = phase_bench_family(args)
        stores15 = phase_store_benches(args)
    finally:
        stop_fault_plane(faults)
    paths = {"phase5_raft_groups": e2e, "phase6_kv_store": kv["store"],
             "phase6_kv_lease_reads": kv["lease"],
             "phase7_soak": soak_res, "phase8_lifecycle": life}
    # the mesh paths: one fused-tick launch a shard a tick
    mesh_paths = {"phase12b_mesh_engine": mesh_res["engine"],
                  "phase12c_mesh_raft_groups": mesh_res["e2e"]}
    libs = native_paths()

    def entry(name, source, replaces, count, rows, **extra):
        # the shape the KV store's engine gives it
        main_row = next((r for r in rows if (r["G"], r["P"]) == KV_SHAPE),
                        rows[-1])
        launches = {k: v[count] for k, v in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches["phase6_kv_store"],
                "launches_by_path": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "shape": [main_row["G"], main_row["P"]],
                "build_s": build_s, **extra, "by_shape": rows}

    kernels = [
        entry("fused_quorum", "tpuraft_torch/ops/csrc/fused_quorum.cu",
              "tpuraft/ops/quorum_pallas.py:108", "fused_quorum_launches",
              rows, main_path="its quorum core (quorum_core.cuh) runs "
              "inside every fused_tick launch; its own entry is not "
              "launched on the main paths"),
        entry("fused_tick", "tpuraft_torch/ops/csrc/fused_tick.cu",
              "tpuraft/ops/quorum_pallas.py:108", "launches", tick_rows,
              also_replaces="tpuraft/ops/tick.py:303 (raft_tick_outputs_jit, "
              "the XLA program around the Pallas call)",
              engine_ticks_by_path={k: v["engine_ticks"]
                                    for k, v in paths.items()},
              mesh_launches_by_path={k: v["launches"]
                                     for k, v in mesh_paths.items()},
              mesh_engine_ticks_by_path={
                  "phase12b_mesh_engine": mesh_res["engine"]["ticks"],
                  "phase12c_mesh_raft_groups":
                      mesh_res["e2e"]["engine_ticks"]},
              mesh_shards={"phase12b_mesh_engine": MESH_SHARDS,
                           "phase12c_mesh_raft_groups": MESH_E2E_SHARDS},
              phase13_launches={
                  "phase13a_entry": driver["entry"]["entry_launches"],
                  "phase13b_dryrun_sharded_tick":
                      driver["entry"]["sharded_launches"],
                  "phase13c_device_plane":
                      driver["plane"]["fused_tick_launches"]},
              phase13_ticks={"phase13a_entry": 1,
                             "phase13b_dryrun_sharded_tick": DRYRUN_SHARDS,
                             "phase13c_device_plane":
                                 driver["plane"]["ticks_run"]},
              phase14_launches=bench["launches"],
              phase14_ticks=bench["ticks"],
              phase14_mesh_shards={"phase14c_smoke_mesh":
                                   BENCH_MESH_SHARDS},
              phase15_launches=stores15["launches"],
              phase15_ticks=stores15["ticks"],
              server_engine_ticks={"phase9_supervised_fleet": {
                  ep: m["engine_ticks"]
                  for ep, m in fleet["servers"].items()}},
              main_path="launches counts phase 6 leg A (the KV store); the "
              "server processes of legs C and D and of phase 9 count in "
              "their own processes (server_engine_ticks: each engine tick "
              "there is one fused-tick launch, read through the servers' "
              "metrics RPC); phase 7 (the engine soak) and phase 8 (the "
              "region lifecycle) are in launches_by_path; phase 13 (the "
              "driver's entry points and bench.py's pipelined device "
              "plane) in phase13_launches, one a tick (a shard a tick in "
              "13(b)): phase13_ticks; phase 14 (the bench scripts, each in "
              "its own processes) in phase14_launches, one an engine tick "
              "(a shard a tick in 14(c)'s mesh): phase14_ticks; phase 15 "
              "(the KV store bench at region density, in its own "
              "processes) in phase15_launches, one an engine tick: "
              "phase15_ticks"),
    ]
    main_row = next(r for r in replica_rows if (r["R"], r["G"]) == (
        3, replica_res["groups"])) if not args.cpu else replica_rows[0]
    kernels.append({
        "name": "replica_quorum", "route": "cuda",
        "source": "tpuraft_torch/ops/csrc/replica_quorum.cu",
        "replaces": "tpuraft/parallel/collective.py:48",
        "launches": replica_res["launches"],
        "launches_by_path": {"phase11_replica_plane": replica_res["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in replica_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "library_call": "torch.kthvalue(rel, R - q + 1, dim=0) (the commit "
                        "half)",
        "shape": [main_row["R"], main_row["G"]], "build_s": build_s,
        "also_replaces": "tpuraft/parallel/collective.py:27, :36 "
                         "(replica_vote_count, replica_commit_point) and the "
                         "device call of tpuraft/parallel/replica_plane.py:281",
        "plane_ticks": replica_res["plane_ticks"],
        "grid_launches": mesh_res["plane"]["launches"],
        "grid_plane_ticks": mesh_res["plane"]["plane_ticks"],
        "phase13b_launches": driver["entry"]["replica_launches"],
        "phase13b_plane_ticks": driver["entry"]["cluster"]["plane_ticks"],
        "main_path": "launches counts phase 11(b), 3 x 1,024 groups of the "
                     "replica plane in its own process: one launch a plane "
                     "tick; grid_launches counts phase 12(d), the plane over "
                     "a 2 x 4 grid: one launch a groups-shard a plane "
                     "tick; phase13b_launches counts phase 13(b), plane (b) "
                     "and the (b') cluster over a 2 x 4 grid",
        "by_shape": replica_rows})
    fold_rows = mesh_res["kernels"]["fold_rows"]
    fold_main = fold_rows[0]  # a shard of the mesh engines' G = 65,536
    kernels.append({
        "name": "deadline_fold", "route": "cuda",
        "source": "tpuraft_torch/ops/csrc/deadline_fold.cu",
        "replaces": "tpuraft/parallel/mesh.py:91",
        "launches": mesh_res["e2e"]["fold_launches"],
        "launches_by_path": {
            "phase12b_mesh_engine": mesh_res["engine"]["fold_launches"],
            "phase12c_mesh_raft_groups": mesh_res["e2e"]["fold_launches"],
            "phase14c_smoke_mesh": bench["fold_launches"]},
        "fold_calls_by_path": {
            "phase12b_mesh_engine": mesh_res["engine"]["fold_calls"],
            "phase12c_mesh_raft_groups": mesh_res["e2e"]["fold_calls"],
            "phase14c_smoke_mesh": bench["fold_calls"]},
        "max_abs_err": max(r["max_abs_err"] for r in fold_rows),
        "ms": fold_main["ms"], "plain_ms": fold_main["plain_ms"],
        "bound_ms": fold_main["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": [fold_main["G"]], "build_s": build_s,
        "also_replaces": "tpuraft/core/engine.py:1569-1577 (the engine's "
                         "mesh-mode fold)",
        "mesh": mesh_res["kernels"]["mesh"],
        "main_path": "launches counts phase 12(c), 3 x 256 raft groups on "
                     "engines over 4 shards: one launch a shard a deadline "
                     "fold of the engines' loops; phases 12(b) and 14(c) "
                     "fold once a drive round over 8 shards",
        "by_shape": fold_rows})
    for k in kernels:
        if k["name"] == "deadline_fold":
            log(f"[k] deadline_fold: launches {k['launches_by_path']} for "
                f"folds {k['fold_calls_by_path']}, match "
                f"{'exact' if k['max_abs_err'] == 0 else k['max_abs_err']}, "
                + "; ".join(
                    f"G={r['G']}: kernel {(r['ms'] or 0) * 1e3:.3f} us, "
                    f"plain {(r['plain_ms'] or 0) * 1e3:.3f} us, bound "
                    f"{r['bound_ms'] * 1e3:.3f} us" for r in k["by_shape"]))
            continue
        if k["name"] == "replica_quorum":
            log(f"[k] replica_quorum: launches {k['launches']} for "
                f"{k['plane_ticks']} plane ticks, match "
                f"{'exact' if k['max_abs_err'] == 0 else k['max_abs_err']}, "
                + "; ".join(
                    f"R={r['R']} G={r['G']}: kernel "
                    f"{(r['ms'] or 0) * 1e3:.3f} us, plain "
                    f"{(r['plain_ms'] or 0) * 1e3:.3f} us, kthvalue "
                    f"{(r['library_ms'] or 0) * 1e3:.3f} us, bound "
                    f"{r['bound_ms'] * 1e3:.3f} us" for r in k["by_shape"]))
            continue
        log(f"[k] {k['name']}: launches {k['launches_by_path']}, match "
            f"{'exact' if k['max_abs_err'] == 0 else k['max_abs_err']}, "
            + "; ".join(
                f"G={r['G']} P={r['P']}: kernel "
                f"{(r['ms'] or 0) * 1e3:.3f} us, plain "
                f"{(r['plain_ms'] or 0) * 1e3:.3f} us, bound "
                f"{r['bound_ms'] * 1e3:.3f} us" for r in k["by_shape"]))
    log(json.dumps({"native_libraries": libs,
                    "native_build_s": native_build_s}))
    if args.cpu:
        log("rehearsal ok (cpu, tiny sizes): no device result")
        return 0
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
