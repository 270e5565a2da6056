"""The plain references agree with the port at a tiny size on the CPU,
and count what they should."""

import dataclasses

import numpy as np
import torch

from benchmark.reference import commit_row
from benchmark.tests import tiny


def test_commit_row_agrees_with_the_ports_tick():
    from tpuraft_torch.ops.tick import (ROLE_FOLLOWER, ROLE_LEADER,
                                        GroupState, TickParams, raft_tick)

    rng = np.random.default_rng(4)
    g, p = 512, 8
    for _ in range(20):
        match = rng.integers(0, 50, (g, p)).astype(np.int32)
        voters = rng.random((g, p)) < 0.5
        voters[:, 0] = True
        commit = rng.integers(0, 30, g).astype(np.int32)
        pending = rng.integers(0, 40, g).astype(np.int32)
        leader = rng.random(g) < 0.8
        state = dataclasses.replace(
            GroupState.zeros(g, p, "cpu"),
            role=torch.from_numpy(np.where(leader, ROLE_LEADER,
                                           ROLE_FOLLOWER).astype(np.int32)),
            commit_rel=torch.from_numpy(commit),
            pending_rel=torch.from_numpy(pending),
            match_rel=torch.from_numpy(match),
            voter_mask=torch.from_numpy(voters))
        _, out = raft_tick(state, 5, TickParams.make(1000, 100, 900,
                                                     device="cpu"))
        want = commit_row.commit_row(match, voters, commit, pending, leader)
        assert np.array_equal(out.commit_rel.numpy(), want)


def test_commit_row_acks_cumulate_across_the_ring():
    ring = np.arange(3 * 4 * 2, dtype=np.int8).reshape(3, 4, 2)
    a = commit_row.Acks(ring)
    for t in range(10):
        want = sum(ring[i % 3].astype(np.int64) for i in range(t + 1))
        assert np.array_equal(a.match_after(t), want)


def test_the_plane_cells_are_correct_on_the_cpu():
    for name in ("plane.g64k.uniform", "plane.g64k.zipf"):
        out, ctx = tiny.run(tiny.cell(name), seed=2**31 + 17)
        assert out["correct"], out["checks"]
        assert ctx["notes"]["rows_compared"] >= 2
        assert ctx["committed"] > 0
