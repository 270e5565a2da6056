"""The driver's entry points on the port: one tick on one device, and the
multi-device dry run.

The counterparts of the JAX package's ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, args)``, the fused multi-raft tick
  (:func:`tpuraft_torch.ops.tick.raft_tick`) and its inputs at G=1,024
  groups and P=8 peer slots, on the card unless the caller names the CPU;
- :func:`dryrun_multichip` runs the three planes of the multi-device
  step once on small shapes: (a) the tick with G split over N shards,
  (b) the replica-axis quorum over a 2 x N/2 (replica, groups) grid,
  checked against the host's sort oracle, and (b') a replica-plane
  cluster over that grid committing two waves of writes.  It returns
  each plane's results.

A device list may name one card several times (N shards on one card);
only a caller that names the list gets that, as :func:`make_mesh` rules.
"""

from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import torch

from tpuraft_torch.device_plane import leader_state, resolve_device
from tpuraft_torch.ops.tick import TickParams, raft_tick
from tpuraft_torch.parallel.collective import replicated_tick
from tpuraft_torch.parallel.mesh import (gather_shards, make_mesh,
                                         shard_group_state, sharded_tick)

ENTRY_GROUPS, ENTRY_PEERS, VOTERS = 1024, 8, 3
CLUSTER_REPLICAS = 4
CLUSTER_ETO_MS = 800
CLUSTER_WAVES = 2


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` advances 1,024 leader groups (3
    voters, seeded matches) one tick."""
    dev = resolve_device(device)
    g, p = ENTRY_GROUPS, ENTRY_PEERS
    match = np.random.default_rng(0).integers(0, 64, (g, p)).astype(np.int32)
    state = dataclasses.replace(leader_state(g, p, VOTERS, dev),
                                match_rel=torch.from_numpy(match).to(dev))
    params = TickParams.make(1000, 100, 900, device=dev)
    # the clock as a Python int: a 0-d device tensor would be read back
    return raft_tick, (state, 1, params)


def sharded_plane_state(n_devices: int):
    """Plane (a)'s inputs on the CPU: G = 8N leaders of P = 4 slots (3
    voters), ``match_rel = arange(G * P) % 16``."""
    g, p = 8 * n_devices, 4
    match = torch.arange(g * p, dtype=torch.int32).reshape(g, p) % 16
    state = dataclasses.replace(leader_state(g, p, VOTERS, "cpu"),
                                match_rel=match)
    return state, TickParams.make(1000, 100, 900, device="cpu")


def replica_plane_inputs(n_devices: int):
    """Plane (b)'s inputs: R = 2 replicas' matches and votes for 4 groups
    a groups-shard, from ``default_rng(0)``."""
    r, g = 2, 4 * (n_devices // 2)
    rng = np.random.default_rng(0)
    match = rng.integers(0, 50, (r, g)).astype(np.int32)
    granted = rng.random((r, g)) < 0.5
    return match, granted


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {msg}")


async def _plane_cluster(n_devices: int, grid) -> dict:
    """(b'): 4 replica endpoints x N groups on one replica plane over
    the grid, in-process transport; two waves of one write a group."""
    from tpuraft_torch.parallel.replica_cluster import ReplicaPlaneCluster

    c = ReplicaPlaneCluster(CLUSTER_REPLICAS, n_devices, device=grid,
                            election_timeout_ms=CLUSTER_ETO_MS)
    await c.start_all()
    try:
        leaders = {g: await c.wait_leader(g) for g in c.groups}
        for step in range(CLUSTER_WAVES):
            await asyncio.gather(*(c.apply_ok(leaders[g], b"s%d" % step)
                                   for g in c.groups))
        _check(c.plane.ticks >= CLUSTER_WAVES,
               f"{c.plane.ticks} plane ticks")
        _check(c.plane.commit_advances >= len(c.groups),
               f"{c.plane.commit_advances} commit advances for "
               f"{len(c.groups)} groups")
    finally:
        await c.stop_all()
    return {"groups": len(c.groups), "replicas": CLUSTER_REPLICAS,
            "plane_ticks": c.plane.ticks,
            "commit_advances": c.plane.commit_advances}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the multi-device step once over ``n_devices`` shards.

    ``device`` is ``"cuda"`` (N distinct cards), ``"cpu"`` (N logical
    shards of the CPU) or a list of N devices.  Returns ``{"sharded":
    (new state, outputs) gathered to the CPU, "replica": (commit,
    votes) as numpy rows or None below 2 devices, "cluster": the
    cluster's counters or None below 4}``.
    """
    mesh = make_mesh(n_devices, device)
    res = {"sharded": None, "replica": None, "cluster": None}

    # plane (a): the tick with G split over the mesh
    state, params = sharded_plane_state(n_devices)
    tick = sharded_tick(mesh, donate=False)
    new_state, out = tick(shard_group_state(state, mesh), 1, params)
    res["sharded"] = (gather_shards(new_state), gather_shards(out))
    _check(tuple(res["sharded"][1].commit_rel.shape)
           == (state.role.shape[0],), "plane (a) commit shape")

    # plane (b): the replica-axis quorum over a 2 x N/2 grid
    g_dim = n_devices // 2
    grid = [list(mesh[:g_dim]), list(mesh[g_dim:2 * g_dim])]
    if n_devices >= 2:
        match, granted = replica_plane_inputs(n_devices)
        r = match.shape[0]
        commit, votes = replicated_tick(r, device=grid)(match, granted)
        commit = torch.cat([c.cpu() for c in commit]).numpy()
        votes = torch.cat([v.cpu() for v in votes]).numpy()
        # the host oracle: the q-th largest match of each group
        want = np.sort(match, axis=0)[::-1][r // 2]
        _check(np.array_equal(commit, want), "plane (b) against the oracle")
        res["replica"] = (commit, votes)

    # plane (b'): a replica-plane cluster over the grid, two waves
    if n_devices >= 4:
        res["cluster"] = asyncio.run(_plane_cluster(n_devices, grid))
    print(f"dryrun_multichip({n_devices}): group-sharded tick + "
          f"replica-collective quorum (toy + runtime cluster) OK")
    return res
