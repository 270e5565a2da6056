"""The port's ballot math (tpuraft_torch.ops.ballot) against the JAX
package's (tpuraft.ops.ballot): the same seeded numpy inputs through
both, exact equality (every output is int32 or bool)."""

from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuraft.ops.ballot as jb
import tpuraft_torch.ops.ballot as tb

NEG = -(2**30)
SHAPES = [(1, 4), (7, 8), (130, 8), (700, 16)]


def _planes(g, p, seed):
    """Seeded [G, P] planes with empty, single-voter, joint, witness and
    NEG-valued rows."""
    rng = np.random.default_rng(seed)
    match = rng.integers(-1, 100, (g, p)).astype(np.int32)
    ack = np.where(rng.random((g, p)) < 0.8, rng.integers(0, 10_000, (g, p)),
                   NEG).astype(np.int32)
    granted = rng.random((g, p)) < 0.5
    vm = rng.random((g, p)) < 0.6
    vm[rng.random(g) < 0.1] = False                   # no voters
    single = rng.random(g) < 0.1
    vm[single] = False
    vm[single, 0] = True                              # one voter
    ovm = (rng.random((g, p)) < 0.5) & (rng.random((g, 1)) < 0.3)  # joint
    wm = (rng.random((g, p)) < 0.2) & (rng.random((g, 1)) < 0.5)   # witness
    qidx = np.where(rng.random(g) < 0.9, rng.integers(-1, 100, g),
                    NEG).astype(np.int32)
    return dict(match=match, ack=ack, granted=granted, vm=vm, ovm=ovm,
                wm=wm, qidx=qidx)


CALLS = {
    "quorum_match_index": ("match", "vm"),
    "joint_quorum_match_index": ("match", "vm", "ovm"),
    "vote_quorum": ("granted", "vm"),
    "joint_vote_quorum": ("granted", "vm", "ovm"),
    "witness_commit_clamp": ("qidx", "match", "vm", "ovm", "wm"),
    "quorum_ack_time": ("ack", "vm"),
    "joint_quorum_ack_time": ("ack", "vm", "ovm"),
}


@pytest.mark.parametrize("g,p", SHAPES)
@pytest.mark.parametrize("fn", sorted(CALLS))
def test_ballot_matches_jax(fn, g, p):
    x = _planes(g, p, seed=g * 31 + p)
    args = [x[k] for k in CALLS[fn]]
    want = np.asarray(getattr(jb, fn)(*map(jnp.asarray, args)))
    got = getattr(tb, fn)(*map(torch.from_numpy, args))
    assert got.dtype == (torch.bool if want.dtype == bool else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{fn} {g}x{p}")


def test_witness_clamp_enumeration_matches_jax_and_host():
    """Every witness subset of 3..6-voter confs, plus seeded joint
    variants: the port's joint order statistic + witness clamp equals
    the JAX package's, and the port's own host BallotBox commit_point."""
    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.ballot_box import commit_point
    from tpuraft_torch.entity import PeerId

    rng = np.random.default_rng(19)
    cols = 8
    peers = [PeerId(f"10.0.0.{i + 1}", 80, 0) for i in range(cols)]
    col = {p: i for i, p in enumerate(peers)}
    cases = []
    for n in range(3, 7):
        for wn in range(n + 1):
            for wit in combinations(range(n), wn):
                conf = Configuration(list(peers[:n]),
                                     witnesses=[peers[i] for i in wit])
                cases.append((conf, Configuration(),
                              rng.integers(0, 30, cols)))
    for _ in range(60):
        n_new, n_old = int(rng.integers(3, 6)), int(rng.integers(3, 6))
        lo = int(rng.integers(0, 3))
        new_v, old_v = peers[:n_new], peers[lo:lo + n_old]
        conf = Configuration(
            list(new_v), witnesses=[p for p in new_v if rng.random() < 0.3])
        old = Configuration(
            list(old_v), witnesses=[p for p in old_v if rng.random() < 0.3])
        cases.append((conf, old, rng.integers(0, 30, cols)))

    g = len(cases)
    match = np.zeros((g, cols), np.int32)
    vm, ovm, wm = (np.zeros((g, cols), bool) for _ in range(3))
    for i, (conf, old, m) in enumerate(cases):
        match[i] = m
        for p in conf.peers:
            vm[i, col[p]] = True
        for p in old.peers:
            ovm[i, col[p]] = True
        for p in list(conf.witnesses) + list(old.witnesses):
            wm[i, col[p]] = True

    t = [torch.from_numpy(a) for a in (match, vm, ovm, wm)]
    got = tb.witness_commit_clamp(
        tb.joint_quorum_match_index(t[0], t[1], t[2]), *t).numpy()
    j = [jnp.asarray(a) for a in (match, vm, ovm, wm)]
    want = np.asarray(jb.witness_commit_clamp(
        jb.joint_quorum_match_index(j[0], j[1], j[2]), *j))
    np.testing.assert_array_equal(got, want)
    for i, (conf, old, m) in enumerate(cases):
        md = {p: int(m[col[p]]) for p in set(conf.peers) | set(old.peers)}
        assert got[i] == commit_point(md, conf, old), (i, conf, old, md)
