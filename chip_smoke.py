#!/usr/bin/env python3
"""Chip smoke for tpuraft_torch: drives the port on one CUDA card.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --quick    # build (-Xptxas -v), compare, stop
    python3 chip_smoke.py --cpu      # rehearsal at tiny sizes on the CPU

Phases (any failure exits non-zero; none is caught):
  1. the card (nvidia-smi name and power limit) and the build of the
     kernel library (fused quorum and fused tick, one nvcc per source);
  2. the fused-quorum CUDA kernel against its plain torch version on the
     card at G=16,384 (P=8, 5 and 32), G=16,421 (P=16, ragged) and the
     cluster's G=1,028 (P=8): bit-exact, and timed with CUDA events;
  3. the fused tick (raft_tick on CUDA, one launch) against the plain
     tick on the CPU: 50 rounds of random full state at G=16,384 P=8,
     and rounds of edge rows at G=16,421 P=16 and G=1,028 P=5; all 11
     outputs and 15 state fields bit-exact; then the fused tick timed
     beside the plain tick on the card;
  4. the engine plane at 16,384 groups: MultiRaftEngine on CUDA and its
     numpy backend fed one ballot-box trace (3 voters; 5 voters with
     half the groups stalled at 2 acks) give identical commit callbacks;
  5. end to end (the main path): 3 endpoints x 1,024 engine-backed raft
     groups on the card elect, commit 8 writes per group read back from
     all three replicas, lose one endpoint, re-elect, and commit again on
     the two survivors; every engine tick of this phase must be exactly
     one fused-tick launch.
The last three lines are the card, the kernel table and the result, the
last two JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

NEG = -(2**30)
SEED = 0                   # every input of every phase comes from it
TIMED_LAUNCHES = 2000      # kernel and plain launches timed per shape
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)


def log(*a) -> None:
    print(*a, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 1: the card and the build -----------------------------------------

def phase_card(args, torch, quorum_cuda) -> tuple[str, float | None]:
    if args.cpu:
        log("[1] rehearsal on the CPU: no card, no build")
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
    for line in out.splitlines():  # -Xptxas -v for the main-path widths
        if "Compiling entry function" in line:
            entry = next((f"{k} S={w}" for k in ("fused_quorum", "fused_tick")
                          for w in (8, 16, 32)
                          if f"{k}_kernelILi{w}EE" in line), "")
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
    shapes = [(37, 16), (30, 5), (64, 8)] if args.cpu else \
        [(16384, 8), (16384 + 37, 16), (16384, 5), (16384, 32), (1028, 8)]
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


def tick_cases(args):
    """(name, G, P, fields generator, params, rounds) of phase 3."""
    if args.cpu:
        return [("random", 256, 8, rand_tick_fields, "rows", 5),
                ("edge", 101, 16, edge_tick_fields, "rows", 5),
                ("edge", 64, 5, edge_tick_fields, "scalars", 5)]
    rounds = 3 if args.quick else 50
    return [("random", 16384, 8, rand_tick_fields, "rows", rounds),
            ("edge", 16384 + 37, 16, edge_tick_fields, "rows", rounds),
            ("edge", 1028, 5, edge_tick_fields, "scalars", rounds)]


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
    for g, p in ([(64, 8)] if args.cpu else
                 [(16384, 8), (16384 + 37, 16), (1028, 8)]):
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


async def phase_e2e(args, torch, quorum_cuda, tick, dev) -> dict:
    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.core.node import Node, State
    from tpuraft_torch.core.node_manager import NodeManager
    from tpuraft_torch.entity import PeerId, Task
    from tpuraft_torch.options import NodeOptions, TickOptions
    from tpuraft_torch.rpc.transport import (InProcNetwork, InProcTransport,
                                             RpcServer)

    n_groups = (args.groups or 16) if args.cpu else 1024
    n_writes, eto_ms = 8, 2000
    loop = asyncio.get_running_loop()
    rng = np.random.default_rng(SEED + 7)
    eps = [PeerId.parse(f"127.0.0.1:{6000 + i}") for i in range(3)]
    conf = Configuration(list(eps))
    groups = [f"region-{k}" for k in range(n_groups)]
    LogFSM = make_fsm_class()
    net = InProcNetwork()
    engines, nodes, fsms = {}, {}, {}

    tick.LAUNCHES = 0  # the main path's counts start here
    quorum_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    for ep in eps:
        server = RpcServer(ep.endpoint)
        manager = NodeManager(server)
        net.bind(server)
        transport = InProcTransport(net, ep.endpoint)
        opts = TickOptions(max_groups=n_groups + 4)
        if args.cpu:
            opts.device = "cpu"
        engine = MultiRaftEngine(opts)
        await engine.start()
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
        log(f"[5] {len(eps)} x {n_groups} groups elected in {elect_s:.3f} s; "
            f"{acked} acked writes read back in order, once, from all 3 "
            f"replicas ({write_s:.3f} s)")

        # one endpoint stops: every group it led re-elects on the others
        dead = eps[0]
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
        log(f"[5] endpoint {dead.endpoint} stopped: {lost} groups lost "
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
    hist = [e.tick_histograms()["tick_device_ms"] for e in all_engines]
    res = {
        "launches": launches,
        "fused_quorum_launches": quorum_launches,
        "engine_ticks": sum(e.ticks for e in all_engines),
        "commit_advances": sum(e.commit_advances for e in all_engines),
        "eager_commits": sum(e.eager_commits for e in all_engines),
        "boot_s": boot_s, "elect_s": elect_s, "write_s": write_s,
        "failover_s": failover_s,
        "tick_device_ms_p50": [h["p50"] for h in hist],
        "tick_device_ms_p99": [h["p99"] for h in hist],
    }
    log("[5] " + json.dumps(res))
    if not args.cpu:
        check(launches > 0 and launches == res["engine_ticks"],
              f"{res['engine_ticks']} engine ticks made {launches} "
              f"fused-tick launches (one each expected)")
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
                         "end-to-end rehearsal (default 16; the card always "
                         "runs 1024)")
    args = ap.parse_args()
    if args.groups is not None and not args.cpu:
        ap.error("--groups is for the --cpu rehearsal only")

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); use --cpu for the rehearsal", file=sys.stderr)
        return 2
    from tpuraft_torch.ops import quorum_cuda, tick

    dev = torch.device("cpu" if args.cpu else "cuda")
    card, build_s = phase_card(args, torch, quorum_cuda)
    rows = phase_kernel(args, torch, quorum_cuda, dev)
    tick_rows = phase_tick(args, torch, dev)
    if args.quick:
        log("[quick] build and compare done")
        return 0
    asyncio.run(phase_engine(args, torch, dev))
    e2e = asyncio.run(phase_e2e(args, torch, quorum_cuda, tick, dev))

    def entry(name, source, replaces, launches, rows, **extra):
        main_row = rows[-1]  # the shape the end-to-end path gives it
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "shape": [main_row["G"], main_row["P"]],
                "build_s": build_s, **extra, "by_shape": rows}

    kernels = [
        entry("fused_quorum", "tpuraft_torch/ops/csrc/fused_quorum.cu",
              "tpuraft/ops/quorum_pallas.py:108", e2e["fused_quorum_launches"],
              rows, main_path="its quorum core (quorum_core.cuh) runs "
              "inside every fused_tick launch; its own entry is not "
              "launched on the main path"),
        entry("fused_tick", "tpuraft_torch/ops/csrc/fused_tick.cu",
              "tpuraft/ops/quorum_pallas.py:108", e2e["launches"], tick_rows,
              also_replaces="tpuraft/ops/tick.py:303 (raft_tick_outputs_jit, "
              "the XLA program around the Pallas call)",
              engine_ticks=e2e["engine_ticks"]),
    ]
    for k in kernels:
        log(f"[6] {k['name']}: launches {k['launches']}, match "
            f"{'exact' if k['max_abs_err'] == 0 else k['max_abs_err']}, "
            + "; ".join(
                f"G={r['G']} P={r['P']}: kernel "
                f"{(r['ms'] or 0) * 1e3:.3f} us, plain "
                f"{(r['plain_ms'] or 0) * 1e3:.3f} us, bound "
                f"{r['bound_ms'] * 1e3:.3f} us" for r in k["by_shape"]))
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
