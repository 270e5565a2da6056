"""The port's replica-axis commit plane against the JAX package's.

- ``replicated_tick``: the port's plain version (CPU tensors) against
  the JAX collectives on the 8-device CPU mesh, (2, 4) and (1, 8);
- the plane: the JAX plane on that mesh and the port's plane on the CPU,
  stepped together through 50+ seeded mutations, rebases included;
- port copies of the scenarios of ``tests/test_replica_plane.py``, the
  runnable example, and the default device (the card, never the CPU);
- on a card, the replica-quorum kernel against its plain version.

Exact equality throughout: every output is int32.

On a machine with a card (and no JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_replica_plane.py
"""

import asyncio
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import replica_extremes, replica_inputs
from tpuraft_torch.entity import Task
from tpuraft_torch.parallel import collective
from tpuraft_torch.parallel.collective import (replica_commit_point,
                                               replica_quorum,
                                               replica_vote_count,
                                               replicated_tick)
from tpuraft_torch.parallel.replica_cluster import ReplicaPlaneCluster
from tpuraft_torch.parallel.replica_plane import (_REBASE_LIMIT,
                                                  ReplicatedClusterPlane)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(shape):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return Mesh(np.array(devs[:8]).reshape(shape), ("replica", "groups"))


def _oracle(match, granted):
    q = match.shape[0] // 2 + 1
    return np.sort(match, axis=0)[::-1][q - 1], granted.sum(axis=0)


# ---- the collective ---------------------------------------------------------

CASES = [((2, 4), r, g) for r in (2, 4, 8) for g in (8, 64, 1024)] + \
    [((1, 8), r, g) for r in (2, 3, 4, 5, 8) for g in (8, 64, 1024)]


@pytest.mark.parametrize("shape,r,g", CASES,
                         ids=[f"{s[0]}x{s[1]}-R{r}-G{g}" for s, r, g in CASES])
def test_replicated_tick_matches_the_jax_mesh(shape, r, g):
    import jax.numpy as jnp

    from tpuraft.parallel.collective import replicated_tick as jax_tick

    mesh = _mesh(shape)
    rng = np.random.default_rng(1000 * r + g)
    match, granted = replica_inputs(rng, r, g)
    want_c, want_v = jax_tick(mesh, n_replicas=r)(jnp.asarray(match),
                                                  jnp.asarray(granted))
    got_c, got_v = replicated_tick(r, device="cpu")(
        torch.from_numpy(match), torch.from_numpy(granted))
    assert got_c.dtype == torch.int32 and got_v.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# every edge of the kernel's layouts: segment widths 1-32 (R at and past
# each power of two), two replicas a lane (33-64), one thread a group (65)
LAYOUT_EDGES = [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 31, 32, 33, 63, 64, 65]
INT32_MIN = np.iinfo(np.int32).min


@pytest.mark.parametrize("r", LAYOUT_EDGES)
def test_plain_version_is_the_sort_oracle(r):
    """Every R the kernel is tested at, ragged G and G = 1, numpy inputs,
    uint8 grant planes and planes at the int32 edges (INT32_MIN and
    INT32_MAX, all-equal columns): the plain version equals the
    oracle."""
    rng = np.random.default_rng(r)
    match, granted = replica_inputs(rng, r, 1000)
    want_c, want_v = _oracle(match, granted)
    run = replicated_tick(r, device="cpu")
    for g in (granted, granted.astype(np.uint8) * 3):
        c, v = run(match, g)
        np.testing.assert_array_equal(c.numpy(), want_c)
        np.testing.assert_array_equal(v.numpy(), want_v)
    c, v = run(match)  # no grant plane: a zero plane
    np.testing.assert_array_equal(c.numpy(), want_c)
    assert not v.any()
    for g in (999, 1):
        match, granted = replica_extremes(rng, r, g)
        match[0, -1], match[-1, -1] = INT32_MIN, -INT32_MIN - 1
        want_c, want_v = _oracle(match, granted != 0)
        c, v = run(match, granted)
        np.testing.assert_array_equal(c.numpy(), want_c)
        np.testing.assert_array_equal(v.numpy(), want_v)


def _wrapped_oracle(match):
    """The JAX package's pick: it sorts -match, and -INT32_MIN wraps to
    INT32_MIN, so INT32_MIN ranks above every other value."""
    key = np.where(match == INT32_MIN, 2**31, match.astype(np.int64))
    pick = np.sort(key, axis=0)[::-1][match.shape[0] // 2]
    return np.where(pick == 2**31, INT32_MIN, pick).astype(np.int32)


@pytest.mark.parametrize("r", LAYOUT_EDGES)
def test_plain_version_matches_the_jax_mesh_at_every_layout_edge(r):
    """The plain version (what the card's kernel is held to) against the
    JAX replicated_tick on the (1, 8) mesh, at every edge of the
    kernel's layouts, on the edge planes and on planes at the int32
    edges.  Equal on every column that holds no INT32_MIN; on those that
    do, the port takes the sort oracle and the JAX package parts from it
    (its -INT32_MIN wraps: the reference-side finding pinned here).
    Real matches never reach INT32_MIN."""
    import jax.numpy as jnp

    from tpuraft.parallel.collective import replicated_tick as jax_tick

    jax_run = jax_tick(_mesh((1, 8)), n_replicas=r)
    run = replicated_tick(r, device="cpu")
    rng = np.random.default_rng(7000 + r)
    for match, granted in (replica_inputs(rng, r, 1000),
                           replica_extremes(rng, r, 1000),
                           replica_extremes(rng, r, 8)):
        granted = granted != 0
        want_c, want_v = (np.asarray(a) for a in jax_run(
            jnp.asarray(match), jnp.asarray(granted)))
        c, v = (t.numpy() for t in run(match, granted))
        np.testing.assert_array_equal(v, want_v)
        low = (match == INT32_MIN).any(axis=0)
        np.testing.assert_array_equal(c[~low], want_c[~low])
        np.testing.assert_array_equal(c, _oracle(match, granted)[0])
        np.testing.assert_array_equal(want_c, _wrapped_oracle(match))


def test_plain_version_counts_no_launch():
    before = collective.LAUNCHES
    m = torch.zeros((3, 16), dtype=torch.int32)
    replica_quorum(m, torch.zeros((3, 16), dtype=torch.bool), 3)
    assert collective.LAUNCHES == before
    assert replica_vote_count(torch.ones((3, 4), dtype=torch.bool)).tolist() \
        == [3] * 4
    assert replica_commit_point(torch.arange(12, dtype=torch.int32)
                                .reshape(3, 4), 3).tolist() == [4, 5, 6, 7]


@pytest.mark.parametrize("bad,err", [
    (lambda: replica_quorum(torch.zeros(4, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.bool), 1), ValueError),
    (lambda: replica_quorum(torch.zeros((3, 4), dtype=torch.int32),
                            torch.zeros((3, 4), dtype=torch.bool), 2),
     ValueError),
    (lambda: replica_quorum(torch.zeros((3, 4), dtype=torch.int64),
                            torch.zeros((3, 4), dtype=torch.bool), 3),
     TypeError),
    (lambda: replica_quorum(torch.zeros((3, 4), dtype=torch.int32),
                            torch.zeros((3, 4), dtype=torch.int32), 3),
     TypeError),
    (lambda: replica_quorum(torch.zeros((3, 4), dtype=torch.int32),
                            torch.zeros((3, 5), dtype=torch.bool), 3),
     ValueError),
    (lambda: replica_quorum(torch.zeros((4, 3), dtype=torch.int32).t(),
                            torch.zeros((3, 4), dtype=torch.bool), 3),
     ValueError),
], ids=["1d", "rows", "dtype", "grant-dtype", "grant-shape", "strided"])
def test_replica_quorum_refuses_bad_planes(bad, err):
    with pytest.raises(err):
        bad()


# ---- the plane, step by step ------------------------------------------------


def _plane_pair(mesh, r, g):
    """The JAX plane on the mesh and the port's plane on the CPU, each
    with a ballot box for every (replica, group) recording its
    _advance calls in one shared log."""
    from tpuraft.parallel.collective import replicated_tick as jax_tick
    from tpuraft.parallel.replica_plane import \
        ReplicatedClusterPlane as JaxPlane

    jp = JaxPlane(r, g, mesh=mesh)
    jp._fn = jax_tick(mesh, r)
    tp = ReplicatedClusterPlane(r, g, device="cpu")
    tp._fn = replicated_tick(r, device="cpu")
    out = []
    for p in (jp, tp):
        log = []
        boxes = {}
        for s in range(g):
            for rep in range(r):
                boxes[(rep, s)] = p.ballot_box_factory(f"g{s}", rep)(
                    lambda i, rep=rep, s=s, log=log: log.append((rep, s, i)))
        out.append((p, boxes, log))
    return out


def _mutate(rng, step, p, boxes, r, g):
    """One seeded step of protocol-shaped churn, applied alike to
    either plane (the same rng state drives both)."""
    lo = int(p.base.min())
    p.match[:, :] += rng.integers(0, 40, (r, g))
    if rng.random() < 0.5:
        p.match[rng.integers(0, r), rng.integers(0, g)] = lo
    if step % 7 == 3:  # cross the rebase limit on a few groups
        hot = rng.random(g) < 0.3
        p.match[:, hot] += _REBASE_LIMIT + rng.integers(1, 1000,
                                                         (r, int(hot.sum())))
    terms = rng.integers(0, 4, (r, g))
    keep = rng.random((r, g)) < 0.7
    p.accepted_term[keep] = terms[keep]
    lead = rng.integers(-1, r, g)
    flip = rng.random(g) < 0.2
    p.leader_replica[flip] = lead[flip]
    for s in range(g):
        lr = int(p.leader_replica[s])
        if lr < 0:
            continue
        box = boxes[(lr, s)]
        u = rng.random()
        if u < 0.1:
            box.reset_pending_index(int(p.commit_abs[s]) + 1)
        elif u < 0.2:
            box.pending_index = 0
        elif u < 0.5:
            box.pending_index = max(1, int(p.commit_abs[s])
                                    + int(rng.integers(-5, 30)))


@pytest.mark.parametrize("shape,r,g", [((1, 8), 3, 16), ((2, 4), 4, 8),
                                       ((1, 8), 5, 64)],
                         ids=["1x8-R3-G16", "2x4-R4-G8", "1x8-R5-G64"])
def test_plane_steps_match_the_jax_plane(shape, r, g):
    mesh = _mesh(shape)
    (jp, jb, jlog), (tp, tb, tlog) = _plane_pair(mesh, r, g)
    rebases = 0
    for step in range(60):
        seed = 10_000 * r + step
        for p, boxes in ((jp, jb), (tp, tb)):
            _mutate(np.random.default_rng(seed), step, p, boxes, r, g)
        base_before = tp.base.copy()
        got = tp.tick_once()
        want = jp.tick_once()
        rebases += int((tp.base != base_before).any())
        assert got == want, step
        np.testing.assert_array_equal(tp.commit_abs, jp.commit_abs)
        np.testing.assert_array_equal(tp.base, jp.base)
        assert tp.commit_advances == jp.commit_advances
        assert tlog == jlog, step
    assert rebases >= 3 and tp.commit_advances > 0
    assert tp.ticks == jp.ticks == 60


# ---- port copies of tests/test_replica_plane.py -----------------------------


async def _apply_ok(node, data, t=10.0):
    fut = asyncio.get_running_loop().create_future()
    await node.apply(Task(data=data, done=fut.set_result))
    st = await asyncio.wait_for(fut, t)
    assert st.is_ok(), st


def _free_base_port(n: int) -> int:
    """A base port with n consecutive ports free (the OS picks one,
    then the next n - 1 are probed)."""
    for _ in range(50):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + n >= 65536:
            continue
        socks = []
        try:
            for i in range(n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no run of free ports")


async def test_multi_step_commits_through_the_plane():
    """4 replicas x 8 groups, 3 waves of writes, every commit decided
    by the plane's replica quorum (the plain version on the CPU)."""
    c = ReplicaPlaneCluster(4, 8, device="cpu")
    await c.start_all()
    try:
        leaders = {g: await c.wait_leader(g) for g in c.groups}
        for wave in range(3):
            await asyncio.gather(*(
                _apply_ok(leaders[g], b"%s-w%d-%d" % (g.encode(), wave, i))
                for g in c.groups for i in range(5)))
        assert c.plane.ticks >= 3
        assert c.plane.commit_advances >= len(c.groups)
        deadline = asyncio.get_running_loop().time() + 10
        while asyncio.get_running_loop().time() < deadline:
            if all(len(f.logs) >= 15 for f in c.fsms.values()):
                break
            await asyncio.sleep(0.05)
        for g in c.groups:
            logs = [c.fsms[(g, ep)].logs for ep in c.endpoints]
            assert all(lg == logs[0] for lg in logs)
            assert len(logs[0]) == 15
    finally:
        await c.stop_all()


async def test_commits_survive_replica_loss_quorum_math():
    """Kill one of 4 replicas: the order statistic still finds a 3/4
    quorum; kill two: commits stall (no quorum)."""
    c = ReplicaPlaneCluster(4, 4, device="cpu")
    await c.start_all()
    try:
        gid = c.groups[0]
        leader = await c.wait_leader(gid)
        await _apply_ok(leader, b"before")
        victim = next(ep for ep in c.endpoints if ep != leader.server_id)
        c.net.stop_endpoint(victim.endpoint)
        for (g, ep) in [k for k in c.nodes if k[1] == victim]:
            await c.nodes.pop((g, ep)).shutdown()
        await _apply_ok(leader, b"with-3-of-4", t=10)
        victim2 = next(ep for ep in c.endpoints
                       if ep != leader.server_id and ep != victim)
        c.net.stop_endpoint(victim2.endpoint)
        for (g, ep) in [k for k in c.nodes if k[1] == victim2]:
            await c.nodes.pop((g, ep)).shutdown()
        fut = asyncio.get_running_loop().create_future()
        await leader.apply(Task(data=b"stalls", done=fut.set_result))
        try:
            st = await asyncio.wait_for(fut, 1.5)
            assert not st.is_ok(), f"committed without quorum: {st}"
        except asyncio.TimeoutError:
            pass
    finally:
        await c.stop_all()


async def test_unattested_rows_never_count():
    """SAFETY: a replica whose accepted_term does not match the leader's
    lineage is masked out of the reduce even with a high durable tip."""
    plane = ReplicatedClusterPlane(3, 2, backend="numpy")

    committed = []
    box = plane.ballot_box_factory("g0", 0)(committed.append)
    box.note_attested(5)
    box.reset_pending_index(11)
    plane.match[0, 0] = 15
    plane.accepted_term[1, 0] = 5
    plane.match[1, 0] = 15
    plane.accepted_term[2, 0] = 3
    plane.match[2, 0] = 40
    plane.tick_once()
    assert committed and committed[-1] == 15, committed
    plane.accepted_term[1, 0] = 0
    plane.match[0, 0] = 20
    plane.match[1, 0] = 20
    before = list(committed)
    plane.tick_once()
    assert committed == before, "unattested rows advanced the commit"
    plane.accepted_term[1, 0] = 5
    plane.tick_once()
    assert committed[-1] == 20


async def test_truncation_lowers_match_row():
    """SAFETY: a suffix truncation must LOWER the plane row (exact-tip
    on_stable semantics, not a monotone max)."""
    from tpuraft_torch.entity import EntryType, LogEntry, LogId
    from tpuraft_torch.storage.log_manager import LogManager
    from tpuraft_torch.storage.log_storage import MemoryLogStorage

    plane = ReplicatedClusterPlane(3, 1, backend="numpy")
    box = plane.ballot_box_factory("g0", 1)(lambda i: None)
    lm = LogManager(MemoryLogStorage())
    await lm.init()
    box.attach_log_manager(lm)
    entries = [LogEntry(type=EntryType.DATA, id=LogId(i, 2), data=b"x")
               for i in range(1, 41)]
    await lm.append_entries_leader(entries, term=2)
    await lm.flush_staged(40)
    assert plane.match[1, 0] == 40
    ok = await lm.append_entries_follower(
        10, 2, [LogEntry(type=EntryType.DATA, id=LogId(11, 3), data=b"y")])
    assert ok
    assert plane.match[1, 0] == 11, plane.match[1, 0]
    await lm.shutdown()


async def test_numpy_twin_matches_the_torch_plane():
    """The plane's numpy twin and its torch backend on the CPU produce
    identical commit points on random state."""
    rng = np.random.default_rng(0)
    R, G = 4, 8
    for trial in range(5):
        match = rng.integers(0, 100, (R, G))
        p_np = ReplicatedClusterPlane(R, G, backend="numpy")
        p_t = ReplicatedClusterPlane(R, G, device="cpu")
        p_t._fn = replicated_tick(R, device="cpu")
        for p in (p_np, p_t):
            p.match[:, :] = match
            p.accepted_term[:, :] = 7
            p.leader_replica[:] = 0
        commits = []
        for p in (p_np, p_t):
            for g in range(G):
                b = p.ballot_box_factory(f"t{trial}g{g}", 0)(lambda i: None)
                b.pending_index = 1
            p.tick_once()
            commits.append(p.commit_abs.copy())
        np.testing.assert_array_equal(commits[0], commits[1])


async def test_transport_seam_tcp():
    """The protocol plane above the replica quorum rides real sockets:
    same cluster, loopback TCP on ports the OS hands out, including a
    replica crash and failover."""
    c = ReplicaPlaneCluster(3, 4, election_timeout_ms=600,
                            transport="tcp", backend="numpy",
                            base_port=_free_base_port(3))
    await c.start_all()
    try:
        leaders = {g: await c.wait_leader(g) for g in c.groups}
        await asyncio.gather(*(
            c.apply_ok(leaders[g], b"%s-tcp" % g.encode())
            for g in c.groups))
        lead_count = {ep.endpoint: 0 for ep in c.endpoints}
        for g in c.groups:
            lead_count[leaders[g].server_id.endpoint] += 1
        victim = min(c.endpoints, key=lambda ep: lead_count[ep.endpoint])
        await c.stop_replica(victim)
        for g in c.groups:
            n = await c.wait_leader(g, timeout_s=20)
            await c.apply_ok(n, b"%s-post" % g.encode())
    finally:
        await c.stop_all()


# ---- the example and the default device -------------------------------------


def _example(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "tpuraft_torch.examples.replica_plane",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)


def test_example_runs_on_the_cpu_with_chaos():
    proc = _example("--device", "cpu", "--chaos", "--replicas", "3",
                    "--groups", "6", "--base-port", str(_free_base_port(3)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["chaos"] is True
    assert line["acked"] == 6 * 3 * 5 + 6
    assert line["plane_ticks"] > 0 and line["commit_advances"] >= 6


def test_example_runs_on_a_cpu_grid():
    """``--mesh 2,4``: the plane over a 2 x 4 (replica, groups) grid of
    CPU shards, a replica crashed mid-run."""
    proc = _example("--device", "cpu", "--mesh", "2,4", "--groups", "8",
                    "--chaos", "--base-port", str(_free_base_port(4)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["mesh"] == "2,4" and line["device"] == "cpu"
    assert line["acked"] == 8 * 3 * 5 + 8
    assert line["plane_ticks"] > 0 and line["commit_advances"] >= 8


async def test_default_device_is_the_card():
    """Without ``device`` the plane, the cluster and the example ask for
    the card: here, with none, they raise the CUDA error and compute
    nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card exists: the default runs there")
    plane = ReplicatedClusterPlane(3, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        await plane.start()
    with pytest.raises(RuntimeError, match="start"):
        plane.tick_once()
    assert plane.ticks == 0
    c = ReplicaPlaneCluster(3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        await c.start_all()
    assert c.nodes == {} and c.plane.ticks == 0
    proc = _example("--groups", "2", "--base-port", str(_free_base_port(4)))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""


async def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="backend"):
        await ReplicatedClusterPlane(3, 4, backend="jax").start()


# ---- the kernel on a card ---------------------------------------------------


def _kernel_against_plain(match, granted, r):
    """One call of the kernel on the card against the plain version on
    the same planes (numpy arrays or tensors); exactly one launch."""
    m, gr = torch.as_tensor(match).cuda(), torch.as_tensor(granted).cuda()
    before = collective.LAUNCHES
    c, v = replica_quorum(m, gr, r)
    assert collective.LAUNCHES == before + 1
    wc, wv = replica_commit_point(m, r), replica_vote_count(gr)
    torch.cuda.synchronize()
    g = match.shape[1]
    assert c.is_cuda and c.dtype == torch.int32 and c.shape == (g,)
    assert torch.equal(c, wc), (r, g, granted.dtype)
    assert torch.equal(v, wv), (r, g, granted.dtype)


@pytest.mark.gpu
def test_kernel_matches_plain_on_cuda():
    """Every R from 1 to 65 (every segment width, two replicas a lane,
    the wide path) and R = 130, at G = 1, 7, 1,000 and 16,384: on the
    edge planes, on planes at the int32 edges (INT32_MIN and INT32_MAX,
    all-equal columns) and with a uint8 grant plane of 0, 1, 2 and 255,
    the kernel equals the plain version on the card, one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    for r in [*range(1, 66), 130]:
        for g in (1, 7, 1000, 16384):
            _kernel_against_plain(*replica_inputs(rng, r, g), r)
            _kernel_against_plain(*replica_extremes(rng, r, g), r)


@pytest.mark.gpu
def test_kernel_matches_plain_past_2_30_lanes():
    """R = 3 (4 lanes a group) at G = 2^28 + 7: the launch's lanes pass
    2^30, so its groups span two rows of the grid, and the groups on both
    sides of the seam equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    r, g = 3, (1 << 28) + 7
    gen = torch.Generator(device="cuda").manual_seed(12)
    match = torch.randint(-2**31, 2**31 - 1, (r, g), dtype=torch.int32,
                          device="cuda", generator=gen)
    granted = torch.randint(0, 256, (r, g), dtype=torch.uint8,
                            device="cuda", generator=gen)
    _kernel_against_plain(match, granted, r)


@pytest.mark.gpu
def test_kernel_matches_plain_on_random_planes():
    """Property: on random planes (R <= 64, G <= 4,096; values from a
    few distinct ones, so ties abound, or from the whole int32 range;
    bool or uint8 grants) the kernel equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=300, deadline=None)
    @given(r=st.integers(1, 64), g=st.integers(1, 4096),
           seed=st.integers(0, 2**32 - 1), few=st.booleans(),
           as_bytes=st.booleans())
    def prop(r, g, seed, few, as_bytes):
        rng = np.random.default_rng(seed)
        if few:
            values = rng.integers(-2**31, 2**31, 3, dtype=np.int64)
            match = rng.choice(values, (r, g)).astype(np.int32)
        else:
            match = rng.integers(-2**31, 2**31, (r, g),
                                 dtype=np.int64).astype(np.int32)
        granted = (rng.integers(0, 256, (r, g)).astype(np.uint8)
                   * (rng.random((r, g)) < 0.5)) if as_bytes \
            else rng.random((r, g)) < 0.5
        _kernel_against_plain(match, granted, r)

    prop()
