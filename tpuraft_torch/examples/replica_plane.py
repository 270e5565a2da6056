"""Replica-axis collective plane, bootable (VERDICT r2 #2).

Boots R replica endpoints x G raft groups on ONE
ReplicatedClusterPlane — commit points for ALL groups come from one
launch of the replica-quorum kernel a tick (the order statistic over the
replica rows on the card; its plain version on the CPU, the numpy twin
with --numpy) computed from each replica's DURABLE log state.
Then drives writes, crashes a replica mid-load (chaos), keeps writing
on the surviving quorum, and verifies convergence.

    python -m tpuraft_torch.examples.replica_plane              # the card
    python -m tpuraft_torch.examples.replica_plane --device cpu
    python -m tpuraft_torch.examples.replica_plane --numpy      # numpy plane
    python -m tpuraft_torch.examples.replica_plane --mesh 2,4   # 2 x 4 cards
    python -m tpuraft_torch.examples.replica_plane --device cpu --mesh 2,4
    python -m tpuraft_torch.examples.replica_plane --replicas 4 --groups 8 --chaos

Reference role: the NCCL/MPI math plane of ``core:ReplicatorGroup`` ack
aggregation (SURVEY.md §6 comms backend), as a deployable mode.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time


def build_grid(spec: str, device: str):
    """The (replica, groups) grid of ``--mesh Rm,Gm``: Rm x Gm distinct
    cards (an error when fewer exist), or logical shards of the CPU."""
    from tpuraft_torch.parallel.mesh import make_mesh

    try:
        rm, gm = (int(x) for x in spec.split(","))
    except ValueError:
        raise SystemExit(f"--mesh takes Rm,Gm, got {spec!r}") from None
    devs = make_mesh(rm * gm, device)
    return [list(devs[i * gm:(i + 1) * gm]) for i in range(rm)]


async def main(args) -> None:
    from tpuraft_torch.parallel.replica_cluster import ReplicaPlaneCluster

    device = build_grid(args.mesh, args.device) if args.mesh else args.device
    c = ReplicaPlaneCluster(args.replicas, args.groups, device=device,
                            backend="numpy" if args.numpy else "torch",
                            election_timeout_ms=args.election_timeout_ms,
                            transport=args.transport,
                            base_port=args.base_port)
    await c.start_all()
    acked = 0
    try:
        leaders = {g: await c.wait_leader(g) for g in c.groups}
        t0 = time.monotonic()
        for wave in range(args.waves):
            await asyncio.gather(*(
                c.apply_ok(leaders[g], b"%s-w%d-%d" % (g.encode(), wave, i))
                for g in c.groups for i in range(args.writes_per_wave)))
            acked += len(c.groups) * args.writes_per_wave

        if args.chaos:
            # crash the replica leading the fewest groups: the plane's
            # order statistic still finds an (R-1)/R quorum, its groups
            # fail over, and commits keep flowing
            lead_count = {ep.endpoint: 0 for ep in c.endpoints}
            for g in c.groups:
                lead_count[leaders[g].server_id.endpoint] += 1
            victim = min(c.endpoints, key=lambda ep: lead_count[ep.endpoint])
            await c.stop_replica(victim)
            for g in c.groups:
                leaders[g] = await c.wait_leader(g, timeout_s=20)
            await asyncio.gather(*(
                c.apply_ok(leaders[g], b"%s-post-chaos" % g.encode())
                for g in c.groups))
            acked += len(c.groups)

        dt = time.monotonic() - t0
        # convergence on the surviving replicas
        want = args.waves * args.writes_per_wave + (1 if args.chaos else 0)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if all(len(c.fsms[k].logs) >= want for k in c.nodes):
                break
            await asyncio.sleep(0.05)
        for g in c.groups:
            logs = [c.fsms[(g, ep)].logs for ep in c.endpoints
                    if (g, ep) in c.nodes]
            assert logs and all(lg == logs[0] for lg in logs), \
                f"group {g} diverged"
        print(json.dumps({
            "replicas": args.replicas, "groups": args.groups,
            "transport": args.transport,
            "device": "numpy" if args.numpy else args.device,
            "mesh": args.mesh, "acked": acked,
            "plane_ticks": c.plane.ticks,
            "commit_advances": c.plane.commit_advances,
            "chaos": args.chaos, "elapsed_s": round(dt, 2)}))
    finally:
        await c.stop_all()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--writes-per-wave", type=int, default=5)
    ap.add_argument("--election-timeout-ms", type=int, default=600)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the plane's replica-quorum tick")
    ap.add_argument("--numpy", action="store_true",
                    help="run the plane's numpy twin instead")
    ap.add_argument("--mesh", metavar="RM,GM",
                    help="spread the plane over an RM x GM (replica, "
                         "groups) grid of devices")
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "tcp", "native"],
                    help="protocol-plane transport: in-proc loopback, "
                         "asyncio TCP sockets, or the C++ epoll engine")
    ap.add_argument("--base-port", type=int, default=7700)
    ap.add_argument("--chaos", action="store_true",
                    help="crash one replica mid-run")
    asyncio.run(main(ap.parse_args()))
