"""Group-axis mesh sharding of the port against the JAX package's.

The JAX side runs on conftest's 8-device CPU mesh, the port's on 8
logical CPU shards (``make_mesh(8, "cpu")``), each fed the same seeded
numpy inputs.  Exact throughout: every output is an integer or a bool.

- the 6 tests of ``tests/test_parallel.py``: the sharded tick (one round
  and 8 rounds with state carried), the replica collective on (2, 4)
  and (1, 8) grids, the deadline fold against the host scan;
- the mesh engine: copies of the engine and protocol tests that ask for
  ``mesh_devices=8``, and the port's mesh engine beside the JAX mesh
  engine on one seeded script, commit for commit and event for event;
- the refusals, and the replica plane on a 2 x 4 grid of CPU shards;
- on a card, the fold kernel and the sharded tick with its shards
  sharing ``cuda:0``.

On a machine with a card (and no JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_mesh.py
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from tpuraft_torch.ops import deadline_fold as tfold
from tpuraft_torch.ops import tick as ttick
from tpuraft_torch.parallel import collective
from tpuraft_torch.parallel.mesh import (DEADLINE_NONE_I32, gather_shards,
                                         group_slices, make_mesh,
                                         shard_group_state, shard_params,
                                         sharded_deadline_fold, sharded_tick)

NEG = -(2**30)
STATE_FIELDS = [f.name for f in dataclasses.fields(ttick.GroupState)]
OUT_FIELDS = [f.name for f in dataclasses.fields(ttick.TickOutputs)]


def _jax_mesh():
    import jax

    from tpuraft.parallel.mesh import make_mesh as jax_make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return jax_make_mesh()


def _np_fields(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def _port_state(fields) -> ttick.GroupState:
    return ttick.group_state_from_numpy(fields, "cpu")


def _host_scan(role, quiescent, has_ctrl, elect, hb, stepdown) -> int:
    """The engine's host-side scan (MultiRaftEngine._next_deadline) in
    the fold's int32 domain."""
    awake = has_ctrl & ~quiescent
    ec = awake & (role <= 1)
    ld = awake & (role == 2)
    want = int(DEADLINE_NONE_I32)
    if ec.any():
        want = min(want, int(elect[ec].min()))
    if ld.any():
        want = min(want, int(hb[ld].min()))
        want = min(want, int(stepdown[ld].min()))
    return want


# ---- the 6 tests of tests/test_parallel.py ---------------------------------


def test_mesh_has_8_shards():
    import jax

    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    mesh = make_mesh(8, "cpu")
    assert len(mesh) == 8 and all(d.type == "cpu" for d in mesh)
    assert group_slices(64, 8)[3] == slice(24, 32)


def test_sharded_tick_matches_local():
    import jax.numpy as jnp

    from tpuraft.ops import tick as jtick

    _jax_mesh()
    G, P = 64, 8
    rng = np.random.default_rng(0)
    fields = _np_fields(jtick.GroupState.zeros(G, P))
    fields.update(role=np.full(G, ttick.ROLE_LEADER, np.int32),
                  voter_mask=rng.random((G, P)) < 0.7,
                  match_rel=rng.integers(0, 100, (G, P)).astype(np.int32),
                  pending_rel=np.ones(G, np.int32))
    js = jtick.GroupState(**{k: jnp.asarray(v) for k, v in fields.items()})
    _, expect = jtick.raft_tick(js, jnp.int32(5),
                                jtick.TickParams.make(1000, 100, 900))

    mesh = make_mesh(8, "cpu")
    tick = sharded_tick(mesh, donate=False)
    sh = shard_group_state(_port_state(fields), mesh)
    ns, out = tick(sh, 5, ttick.TickParams.make(1000, 100, 900,
                                                device="cpu"))
    got = gather_shards(out)
    np.testing.assert_array_equal(got.commit_rel.numpy(),
                                  np.asarray(expect.commit_rel))
    np.testing.assert_array_equal(got.elected.numpy(),
                                  np.asarray(expect.elected))
    # the result stays split: shard k holds rows [8k, 8k + 8)
    assert len(out) == len(ns) == 8
    assert all(o.commit_rel.shape == (8,) for o in out)


def _grid(shape):
    return [["cpu"] * shape[1] for _ in range(shape[0])]


def _jax_replicated(shape, r, match, granted):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpuraft.parallel.collective import replicated_tick as jax_tick

    _jax_mesh()
    devs = np.array(jax.devices()[:8]).reshape(shape)
    run = jax_tick(Mesh(devs, ("replica", "groups")), n_replicas=r)
    commit, votes = run(jnp.asarray(match), jnp.asarray(granted))
    return np.asarray(commit), np.asarray(votes)


def test_replicated_tick_psum_quorum():
    """Cross-replica quorum over a (replica=2, groups=4) grid."""
    R, G = 2, 16
    rng = np.random.default_rng(1)
    match = rng.integers(0, 50, (R, G)).astype(np.int32)
    granted = rng.random((R, G)) < 0.5
    want_c, want_v = _jax_replicated((2, 4), R, match, granted)
    before = collective.LAUNCHES
    commit, votes = collective.replicated_tick(R, device=_grid((2, 4)))(
        match, granted)
    assert len(commit) == len(votes) == 4  # one result a groups-shard
    np.testing.assert_array_equal(torch.cat(commit).numpy(), want_c)
    np.testing.assert_array_equal(torch.cat(votes).numpy(), want_v)
    q = R // 2 + 1
    np.testing.assert_array_equal(want_c, np.sort(match, 0)[::-1][q - 1])
    assert collective.LAUNCHES == before  # the plain version on the CPU


def test_replicated_tick_3_replicas():
    R, G = 3, 32
    rng = np.random.default_rng(2)
    match = rng.integers(0, 1000, (R, G)).astype(np.int32)
    granted = rng.random((R, G)) < 0.6
    want_c, want_v = _jax_replicated((1, 8), R, match, granted)
    commit, votes = collective.replicated_tick(R, device=_grid((1, 8)))(
        match, granted)
    np.testing.assert_array_equal(torch.cat(commit).numpy(), want_c)
    np.testing.assert_array_equal(torch.cat(votes).numpy(), want_v)
    np.testing.assert_array_equal(want_v, granted.sum(axis=0))


@pytest.mark.parametrize("shape,r,g", [((2, 4), 4, 64), ((2, 4), 8, 1024),
                                       ((1, 8), 5, 64), ((1, 8), 3, 1024)])
def test_replicated_tick_grids_match_the_jax_mesh(shape, r, g):
    """The grid with a zero grant plane kept per groups-shard, and with
    grants, on the plane's shapes."""
    rng = np.random.default_rng(r * g)
    match = rng.integers(0, 1 << 20, (r, g)).astype(np.int32)
    granted = rng.random((r, g)) < 0.5
    run = collective.replicated_tick(r, device=_grid(shape))
    want_c, want_v = _jax_replicated(shape, r, match, granted)
    commit, votes = run(torch.from_numpy(match), granted)
    np.testing.assert_array_equal(torch.cat(commit).numpy(), want_c)
    np.testing.assert_array_equal(torch.cat(votes).numpy(), want_v)
    commit, votes = run(match)
    np.testing.assert_array_equal(torch.cat(commit).numpy(), want_c)
    assert not torch.cat(votes).any()


def test_sharded_tick_bitwise_matches_single_device_multiround():
    """The 8-way sharded tick against the JAX package's 8-device sharded
    tick and the port's single-device tick over 8 rounds with state
    carried and every lane populated; at every second round one seeded
    host perturbation (fresh acks, appended entries, newly armed
    fences) goes into all three alike."""
    import jax.numpy as jnp

    from tests.test_parallel import _rand_full_state
    from tpuraft.ops import tick as jtick
    from tpuraft.parallel.mesh import shard_group_state as jshard
    from tpuraft.parallel.mesh import sharded_tick as jsharded

    jmesh = _jax_mesh()
    G, P = 64, 5
    rng = np.random.default_rng(1907)
    jlocal = _rand_full_state(rng, G, P)
    jsh = jshard(jlocal, jmesh)
    jtick_sh = jsharded(jmesh, donate=False)
    jparams = jtick.TickParams.make(1000, 100, 900, 1500)

    mesh = make_mesh(8, "cpu")
    fields = _np_fields(jlocal)
    local = _port_state(fields)
    sh = shard_group_state(local, mesh)
    tick_sh = sharded_tick(mesh, donate=False)
    params = ttick.TickParams.make(1000, 100, 900, 1500, device="cpu")
    sparams = shard_params(params, mesh, G)
    now = 100
    for r in range(8):
        now += int(rng.integers(120, 400))
        jns, jo = jtick_sh(jsh, jnp.int32(now), jparams)
        nl, ol = ttick.raft_tick(local, now, params)
        ns, os_ = tick_sh(sh, now, sparams)
        gs, go = gather_shards(ns), gather_shards(os_)
        for f in STATE_FIELDS:
            want = np.asarray(getattr(jns, f))
            np.testing.assert_array_equal(
                getattr(gs, f).numpy(), want,
                err_msg=f"round {r}: new_state.{f} vs the JAX mesh")
            np.testing.assert_array_equal(
                getattr(nl, f).numpy(), want,
                err_msg=f"round {r}: single-device new_state.{f}")
        for f in OUT_FIELDS:
            want = np.asarray(getattr(jo, f))
            np.testing.assert_array_equal(
                getattr(go, f).numpy(), want,
                err_msg=f"round {r}: outputs.{f} vs the JAX mesh")
            np.testing.assert_array_equal(
                getattr(ol, f).numpy(), want,
                err_msg=f"round {r}: single-device outputs.{f}")
        # the carried result stays split over the 8 shards
        assert len(ns) == 8 and all(s.role.shape == (8,) for s in ns)
        jsh, local, sh = jns, nl, ns
        if r % 2 == 1:
            h = _np_fields(jns)
            h["match_rel"] = (h["match_rel"] + rng.integers(
                0, 6, (G, P))).astype(np.int32)
            h["last_ack"] = np.where(rng.random((G, P)) < 0.5, now,
                                     h["last_ack"]).astype(np.int32)
            h["granted"] = rng.random((G, P)) < 0.4
            h["fence_start"] = np.where(
                rng.random(G) < 0.3, now - rng.integers(0, 200, G),
                h["fence_start"]).astype(np.int32)
            jsh = jshard(jtick.GroupState(
                **{k: jnp.asarray(v) for k, v in h.items()}), jmesh)
            local = _port_state(h)
            sh = shard_group_state(local, mesh)


def _fold_rows(rng, g):
    return (rng.integers(0, 4, g).astype(np.int32), rng.random(g) < 0.3,
            rng.random(g) < 0.7,
            rng.integers(0, 1 << 20, g).astype(np.int32),
            rng.integers(0, 1 << 20, g).astype(np.int32),
            rng.integers(0, 1 << 20, g).astype(np.int32))


def test_sharded_deadline_fold_matches_host_scan():
    """The port's fold (one plain fold a shard and a host min) against
    the JAX package's sharded fold and the engine's host scan on random
    role, quiescence and control mixes, and the sentinel when no slot
    schedules anything."""
    from tpuraft.parallel.mesh import sharded_deadline_fold as jax_fold

    jfold = jax_fold(_jax_mesh())
    fold = sharded_deadline_fold(make_mesh(8, "cpu"))
    rng = np.random.default_rng(3)
    G = 128
    before = tfold.LAUNCHES
    for trial in range(8):
        rows = _fold_rows(rng, G)
        got = fold(*rows)
        assert got == int(jfold(*rows)) == _host_scan(*rows), trial
        # each shard's plain fold agrees with the whole rows' fold
        for s in group_slices(G, 8):
            part = [torch.from_numpy(np.ascontiguousarray(x[s]))
                    for x in rows]
            assert int(tfold.deadline_fold(*part)) == _host_scan(
                *(x[s] for x in rows))
    role, _, _, elect, hb, stepdown = rows
    none = (np.full(G, 2, np.int32), np.zeros(G, bool), np.zeros(G, bool),
            elect, hb, stepdown)
    assert fold(*none) == int(jfold(*none)) == int(DEADLINE_NONE_I32)
    assert tfold.LAUNCHES == before  # the plain version on the CPU


def test_fold_takes_the_engine_int64_rows_wrapped():
    """The engine's deadline rows are int64 mirrors; the fold wraps them
    to int32 as astype(np.int32) does, and a row at the int32 edge still
    folds exactly."""
    fold = sharded_deadline_fold(make_mesh(4, "cpu"))
    rng = np.random.default_rng(4)
    role, q, c, elect, hb, sd = _fold_rows(rng, 64)
    c[:] = True
    q[:] = False
    elect64 = elect.astype(np.int64) + (1 << 32)  # wraps back to elect
    hb[5] = np.int32(-(2**31))
    role[5] = 2
    assert fold(role, q, c, elect64, hb, sd) == _host_scan(
        role, q, c, elect, hb, sd) == -(2**31)
    assert fold(role[:0], q[:0], c[:0], elect[:0], hb[:0], sd[:0]) == int(
        DEADLINE_NONE_I32)


# ---- the mesh engine --------------------------------------------------------


def _eng_mods(pkg: str):
    import importlib

    return tuple(importlib.import_module(f"{pkg}.{m}")
                 for m in ("conf", "entity", "core.engine", "options"))


async def test_engine_mesh_sharded_quorum_matches_numpy():
    """Copy of tests/test_engine.py::test_engine_mesh_sharded_quorum_
    matches_numpy: the engine's planes over 8 CPU shards give the numpy
    oracle's commits for identical state."""
    conf_m, ent, engine_m, opt = _eng_mods("tpuraft_torch")
    G, P = 64, 8
    peers = [ent.PeerId.parse(f"127.0.0.1:{7000 + i}") for i in range(3)]
    conf = conf_m.Configuration(list(peers))

    def build(opts):
        eng = engine_m.MultiRaftEngine(opts)
        commits = {}
        factory = eng.ballot_box_factory()
        boxes = []
        for g in range(G):
            box = factory(lambda idx, g=g: commits.__setitem__(g, idx))
            box.update_conf(conf, conf_m.Configuration())
            box.reset_pending_index(1)
            boxes.append(box)
        rng = np.random.default_rng(42)
        for box in boxes:
            for p in peers:
                box.commit_at(p, int(rng.integers(0, 100)), conf,
                              conf_m.Configuration())
        return eng, commits

    eng_np, commits_np = build(opt.TickOptions(
        max_groups=G, max_peers=P, backend="numpy", eager_commit=False))
    eng_np.tick_once()
    eng_mesh, commits_mesh = build(opt.TickOptions(
        max_groups=G, max_peers=P, device="cpu", mesh_devices=8,
        eager_commit=False))
    await eng_mesh.start()
    try:
        assert len(eng_mesh._mesh) == 8
        assert eng_mesh._deadline_fold is not None
        eng_mesh.tick_once()
        assert commits_mesh == commits_np
        assert len(commits_mesh) > 0
    finally:
        await eng_mesh.shutdown()


async def test_engine_64k_groups_mesh_sharded_with_learners():
    """Copy of tests/test_engine.py::test_engine_64k_groups_mesh_sharded_
    with_learners: 65,536 groups of 3 voters and a learner over 8 CPU
    shards stay bit-identical to the numpy oracle across ticks; learner
    acks never count toward the quorum."""
    conf_m, ent, engine_m, opt = _eng_mods("tpuraft_torch")
    Conf = conf_m.Configuration
    G, P = 65536, 8
    peers = [ent.PeerId.parse(f"127.0.0.1:{7000 + i}") for i in range(3)]
    learner = ent.PeerId.parse("127.0.0.1:7100")
    conf = Conf(list(peers), [learner])

    def build(opts):
        eng = engine_m.MultiRaftEngine(opts)
        commits = {}
        factory = eng.ballot_box_factory()
        boxes = []
        rng = np.random.default_rng(42)
        for g in range(G):
            box = factory(lambda idx, g=g: commits.__setitem__(g, idx))
            box.update_conf(conf, Conf())
            box.reset_pending_index(1)
            boxes.append(box)
        for box in boxes:
            for p in peers:
                box.commit_at(p, int(rng.integers(0, 100)), conf, Conf())
            box.commit_at(learner, 10_000, conf, Conf())
        return eng, boxes, commits

    eng_np, boxes_np, commits_np = build(opt.TickOptions(
        max_groups=G, max_peers=P, backend="numpy", eager_commit=False))
    eng_np.tick_once()
    eng_mesh, boxes_mesh, commits_mesh = build(opt.TickOptions(
        max_groups=G, max_peers=P, device="cpu", mesh_devices=8,
        eager_commit=False))
    await eng_mesh.start()
    try:
        eng_mesh.tick_once()
        assert commits_mesh == commits_np
        assert len(commits_mesh) > G * 0.99
        g_probe = 17
        before = commits_mesh.get(g_probe)
        for boxes, eng in ((boxes_np, eng_np), (boxes_mesh, eng_mesh)):
            boxes[g_probe].commit_at(learner, 20_000, conf, Conf())
            eng.tick_once()
        assert commits_mesh.get(g_probe) == before
        assert commits_np.get(g_probe) == before
        rng = np.random.default_rng(7)
        advances = {g: (100 + int(rng.integers(0, 50)),
                        100 + int(rng.integers(0, 50)))
                    for g in range(0, G, 97)}
        for boxes, eng in ((boxes_np, eng_np), (boxes_mesh, eng_mesh)):
            for g, (a, b) in advances.items():
                boxes[g].commit_at(peers[0], a, conf, Conf())
                boxes[g].commit_at(peers[1], b, conf, Conf())
            eng.tick_once()
        assert commits_mesh == commits_np
        for g, (a, b) in advances.items():
            assert commits_mesh[g] == max(commits_np.get(g, 0), min(a, b))
    finally:
        await eng_mesh.shutdown()


async def test_engine_grows_under_mesh_sharding():
    """Copy of tests/test_engine.py::test_engine_grows_under_mesh_
    sharding: 8 groups over 8 shards grow to 16 and the sharded tick
    still matches the numpy oracle; the shards' staging follows G."""
    conf_m, ent, engine_m, opt = _eng_mods("tpuraft_torch")
    peers = [ent.PeerId.parse(f"127.0.0.1:{7200 + i}") for i in range(3)]
    conf = conf_m.Configuration(list(peers))
    eng = engine_m.MultiRaftEngine(opt.TickOptions(
        max_groups=8, max_peers=4, device="cpu", mesh_devices=8,
        eager_commit=False))
    ref = engine_m.MultiRaftEngine(opt.TickOptions(
        max_groups=8, max_peers=4, backend="numpy", eager_commit=False))
    await eng.start()
    try:
        got: dict[int, int] = {}
        want: dict[int, int] = {}
        for g in range(12):             # exceeds 8: grow to 16
            b1 = eng.ballot_box_factory()(
                lambda idx, g=g: got.__setitem__(g, idx))
            b2 = ref.ballot_box_factory()(
                lambda idx, g=g: want.__setitem__(g, idx))
            for b in (b1, b2):
                b.update_conf(conf, conf_m.Configuration())
                b.reset_pending_index(1)
                for i, p in enumerate(peers):
                    b.commit_at(p, 3 * g + i, conf, conf_m.Configuration())
        assert eng.G == 16
        eng.tick_once()
        ref.tick_once()
        assert got == want and len(got) == 12
        assert [st.g for st in eng._staging] == [2] * 8
        assert eng._next_deadline() == ref._next_deadline()
    finally:
        await eng.shutdown()
        await ref.shutdown()


async def test_protocol_plane_on_mesh_sharded_engine():
    """Copy of tests/test_engine_protocol.py::test_protocol_plane_on_
    mesh_sharded_engine: 3 endpoints x 8 groups whose engines shard over
    8 CPU shards elect through the election_due / elected masks and
    commit through the sharded tick; every replica converges."""
    import time

    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import EngineControl, MultiRaftEngine
    from tpuraft_torch.core.node import Node
    from tpuraft_torch.core.node_manager import NodeManager
    from tpuraft_torch.core.state_machine import StateMachine
    from tpuraft_torch.entity import PeerId, Task
    from tpuraft_torch.options import NodeOptions, TickOptions
    from tpuraft_torch.rpc.transport import (InProcNetwork, InProcTransport,
                                             RpcServer)

    class LogFSM(StateMachine):
        def __init__(self):
            self.logs: list[bytes] = []

        async def on_apply(self, it) -> None:
            while it.valid():
                self.logs.append(it.data())
                it.next()

    net = InProcNetwork()
    eps = [PeerId.parse(f"127.0.0.1:{6300 + i}") for i in range(3)]
    conf = Configuration(list(eps))
    groups = [f"g{k}" for k in range(8)]
    engines, nodes, fsms = [], {}, {}
    loop = asyncio.get_running_loop()
    try:
        for ep in eps:
            server = RpcServer(ep.endpoint)
            manager = NodeManager(server)
            net.bind(server)
            transport = InProcTransport(net, ep.endpoint)
            engine = MultiRaftEngine(TickOptions(
                max_groups=16, max_peers=8, tick_interval_ms=5,
                device="cpu", mesh_devices=8))
            await engine.start()
            engines.append(engine)
            factory = engine.ballot_box_factory()
            for gid in groups:
                fsm = fsms[(gid, ep)] = LogFSM()
                node = Node(gid, ep, NodeOptions(
                    election_timeout_ms=2000, initial_conf=conf.copy(),
                    fsm=fsm, log_uri="memory://",
                    raft_meta_uri="memory://"),
                    transport, ballot_box_factory=factory)
                node.node_manager = manager
                manager.add(node)
                assert await node.init()
                nodes[(gid, ep)] = node

        async def leader_of(gid, timeout_s=20):
            deadline = loop.time() + timeout_s
            while loop.time() < deadline:
                ls = [n for (g, _), n in nodes.items()
                      if g == gid and n.is_leader()]
                if len(ls) == 1:
                    return ls[0]
                await asyncio.sleep(0.02)
            raise AssertionError(f"{gid}: no single leader")

        async def apply_retry(gid, data):
            for _ in range(20):
                leader = await leader_of(gid)
                fut = loop.create_future()
                await leader.apply(Task(data=data, done=fut.set_result))
                if (await asyncio.wait_for(fut, 10)).is_ok():
                    return
                await asyncio.sleep(0.1)
            raise AssertionError(f"{gid}: write never acknowledged")

        for gid in groups:
            leader = await leader_of(gid)
            assert isinstance(leader._ctrl, EngineControl)
        await asyncio.gather(*(apply_retry(gid, b"mesh-%s" % gid.encode())
                               for gid in groups))
        assert all(e.ticks > 0 for e in engines)

        def converged():
            for gid in groups:
                logs = [fsms[(gid, ep)].logs for ep in eps]
                if not logs[0] or any(lg != logs[0] for lg in logs):
                    return False
            return True

        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not converged():
            await asyncio.sleep(0.05)
        assert converged()
    finally:
        for n in nodes.values():
            await n.shutdown()
        for e in engines:
            await e.shutdown()


# the port's mesh engine beside the JAX mesh engine, event for event


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self) -> float:
        return self.t

    def wall(self) -> float:
        return self.t


class _Replicators:
    def all(self):
        return []


class _StubNode:
    replicators = _Replicators()

    def is_leader(self):
        return True

    def _check_dead_nodes(self):
        pass

    def _on_election_due(self):
        pass

    def _on_engine_elected(self):
        pass

    def _on_engine_quorum_dead(self):
        pass

    def _on_snapshot_due(self):
        pass


class _StubCtrl:
    """An EngineControl stand-in: the surface the engine's apply pass
    touches; every delivery it schedules goes into one event log."""

    def __init__(self, engine, slot: int, events: list):
        self.engine, self.slot, self.events = engine, slot, events
        self.node = _StubNode()

    def _adopt_eto(self, eff_eto_ms: int) -> None:
        pass

    def push_election_deadline(self, now_ms=None) -> None:
        e = self.engine
        now = e.now_ms() if now_ms is None else now_ms
        e.elect_deadline[self.slot] = now + int(e.eto_ms[self.slot])

    def schedule(self, name: str, handler) -> None:
        self.events.append(("deliver", self.slot, name))

    def maybe_quiesce(self, now: int) -> None:
        pass

    def wake_from_quiescence(self, reason: str = "activity", *a, **kw):
        pass


class _Fence:
    def __init__(self, events, slot):
        self.done, self.events, self.slot = False, events, slot

    def note_quorum(self):
        self.done = True
        self.events.append(("fence", self.slot))


def _lane_script(pkg: str, opts: dict, clock, G: int, rounds: int,
                 seed: int):
    """bench_multichip.py's mesh lanes at test size: data, witness and
    witness-majority probe confs, half the slots leading, elections
    falling due, staggered stepdown checks, read-fence waves; returns
    the engine and its event log (commits, deliveries, fences, each
    tick's outputs and the next deadline), filled by ``step()``."""
    conf_m, _ent, engine_m, opt = _eng_mods(pkg)
    eng = engine_m.MultiRaftEngine(opt.TickOptions(
        max_groups=G, max_peers=4, clock=clock, eager_commit=False,
        density_aware_timeouts=False, **opts))
    events: list = []
    confs = {
        "data": conf_m.Configuration.parse(
            "10.0.0.1:80,10.0.0.2:80,10.0.0.3:80"),
        "witness": conf_m.Configuration.parse(
            "10.0.0.1:80,10.0.0.2:80,10.0.0.3:80/witness"),
        "probe": conf_m.Configuration.parse(
            "10.0.0.1:80,10.0.0.2:80/witness,10.0.0.3:80/witness"),
    }
    self_peer = confs["data"].peers[0]
    factory = eng.ballot_box_factory()
    boxes = []
    for s in range(G):
        box = factory(lambda idx, s=s: events.append(("commit", s, idx)))
        kind = "probe" if s % 16 == 14 else (
            "witness" if s % 4 == 3 else "data")
        box.update_conf(confs[kind], conf_m.Configuration())
        eng.register_ctrl(_StubCtrl(eng, s, events), self_peer,
                          eto_ms=500, hb_ms=100, lease_ms=450)
        boxes.append(box)
    rng = np.random.default_rng(seed)
    now = eng.now_ms()
    leaders = np.arange(G) % 2 == 0
    lead = np.nonzero(leaders)[0]
    for s in lead:
        boxes[s].reset_pending_index(1)
    eng.role[~leaders] = 0  # ROLE_FOLLOWER
    eng.elect_deadline[:] = now + 3_600_000
    eng.elect_deadline[rng.choice(np.nonzero(~leaders)[0], 8,
                                  replace=False)] = now + 50
    eng.hb_deadline[:] = now + rng.integers(1, 400, G)
    eng.stepdown_deadline[:] = now + rng.integers(1, 250, G)
    eng.quiescent[rng.random(G) < 0.1] = True
    probe = np.array([s % 16 == 14 for s in range(G)])
    eng.match_abs[np.ix_(np.nonzero(probe)[0], [1, 2])] = 9
    eng.match_abs[probe, 0] = 3
    drive = lead[~probe[lead]]
    orig_apply = eng._apply_commits

    def record(out):
        events.append(("tick", {k: np.array(getattr(out, k))
                                for k in OUT_FIELDS}))
        return orig_apply(out)

    eng._apply_commits = record

    def step(r):
        clock.t += 0.11
        now = eng.now_ms()
        eng.last_ack[np.ix_(lead, [0, 1, 2])] = now
        eng.match_abs[np.ix_(drive, [0, 1])] = r + 1
        eng.match_abs[drive, 2] = r
        for s in lead[(r % 4)::8]:
            eng.arm_read_fence(int(s), _Fence(events, int(s)))
        eng.tick_once()
        events.append(("next_deadline", eng._next_deadline()))

    return eng, events, step


async def test_mesh_engine_matches_the_jax_mesh_engine():
    """One seeded lane script through the JAX engine on the 8-device
    mesh and the port's engine on 8 CPU shards: every commit callback,
    handler delivery, fence resolution, tick output and next deadline
    equal and in the same order."""
    _jax_mesh()
    G, rounds = 64, 12
    jeng, jev, jstep = _lane_script(
        "tpuraft", dict(backend="jax", mesh_devices=8), _Clock(), G,
        rounds, seed=19)
    teng, tev, tstep = _lane_script(
        "tpuraft_torch", dict(device="cpu", mesh_devices=8), _Clock(), G,
        rounds, seed=19)
    await jeng.start()
    await teng.start()
    try:
        assert jeng._deadline_fold is not None
        assert teng._deadline_fold is not None
        for r in range(rounds):
            jstep(r)
            tstep(r)
        assert len(tev) == len(jev)
        for i, (je, te) in enumerate(zip(jev, tev)):
            assert je[0] == te[0], (i, je[0], te[0])
            if je[0] == "tick":
                for k in OUT_FIELDS:
                    np.testing.assert_array_equal(
                        te[1][k], je[1][k], err_msg=f"event {i}: {k}")
            else:
                assert te == je, i
        kinds = {e[0] for e in tev} | {e[2] for e in tev
                                       if e[0] == "deliver"}
        # no vacuous match: every lane fired
        assert {"commit", "fence", "election_due", "stepdown_tick"} <= kinds
        stats = teng.lane_stats()
        assert stats["fence_lane_resolves"] > 0
        assert stats["stepdown_ticks"] > 0
        assert len({e[1] for e in tev if e[0] == "next_deadline"}) > 1
    finally:
        await teng.shutdown()
        await jeng.shutdown()


# ---- refusals ---------------------------------------------------------------


async def test_mesh_on_cuda_without_a_card_is_refused():
    if torch.cuda.is_available():
        pytest.skip("a card exists: the mesh may run there")
    _, _, engine_m, opt = _eng_mods("tpuraft_torch")
    eng = engine_m.MultiRaftEngine(opt.TickOptions(
        max_groups=8, max_peers=4, mesh_devices=2, device="cuda"))
    with pytest.raises(ValueError, match="CUDA devices"):
        await eng.start()
    assert eng._tick_fn is None and eng.ticks == 0
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(2, "cuda")
    with pytest.raises(ValueError, match="name the device list"):
        make_mesh(2, "cuda:0")


@pytest.mark.parametrize("opts,match", [
    (dict(max_groups=12, mesh_devices=8, device="cpu"), "divisible"),
    (dict(max_groups=8, mesh_devices=4, device=["cpu"] * 3),
     "lists 3 devices"),
    (dict(max_groups=8, mesh_devices=0, device=["cpu"] * 2),
     "lists 2 devices"),
], ids=["groups-not-divisible", "list-length", "list-without-mesh"])
async def test_mesh_engine_refusals(opts, match):
    _, _, engine_m, opt = _eng_mods("tpuraft_torch")
    eng = engine_m.MultiRaftEngine(opt.TickOptions(max_peers=4, **opts))
    with pytest.raises(ValueError, match=match):
        await eng.start()
    assert eng._tick_fn is None and eng.ticks == 0


@pytest.mark.parametrize("grid,r,g,match", [
    ([["cpu", "cpu"], ["cpu", "cpu"], ["cpu", "cpu"]], 4, 8, "R=4"),
    ([["cpu"] * 3] * 2, 4, 8, "G=8"),
    ([["cpu", "cpu"], ["cpu"]], 4, 8, "different lengths"),
    (["cpu", "cpu"], 4, 8, "rows of devices"),
], ids=["replicas", "groups", "ragged", "flat"])
def test_grid_refusals(grid, r, g, match):
    with pytest.raises(ValueError, match=match):
        run = collective.replicated_tick(r, device=grid)
        run(np.zeros((r, g), np.int32))


def test_sharded_tick_refuses_a_shard_count_off_the_mesh():
    mesh = make_mesh(4, "cpu")
    state = ttick.GroupState.zeros(8, 4, "cpu")
    with pytest.raises(ValueError, match="divisible"):
        shard_group_state(ttick.GroupState.zeros(6, 4, "cpu"), mesh)
    with pytest.raises(ValueError, match="shards for a mesh"):
        sharded_tick(mesh)(shard_group_state(state, make_mesh(2, "cpu")),
                           5, ttick.TickParams.make(1000, 100, 900,
                                                    device="cpu"))


# ---- the replica plane on a 2 x 4 grid -------------------------------------


async def _apply_ok(node, data, t=10.0):
    from tpuraft_torch.entity import Task

    fut = asyncio.get_running_loop().create_future()
    await node.apply(Task(data=data, done=fut.set_result))
    st = await asyncio.wait_for(fut, t)
    assert st.is_ok(), st


async def test_multi_step_commits_through_a_grid():
    """Copy of tests/test_replica_plane.py::test_multi_step_commits_
    through_collectives on a 2 x 4 grid of CPU shards: 4 replicas x 8
    groups, 3 waves of writes, every commit decided by the grid's
    replica quorum (one plain fold a groups-shard)."""
    from tpuraft_torch.parallel.replica_cluster import ReplicaPlaneCluster

    c = ReplicaPlaneCluster(4, 8, device=_grid((2, 4)),
                            election_timeout_ms=1000)
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


async def test_commits_survive_replica_loss_on_a_grid():
    """Copy of tests/test_replica_plane.py::test_commits_survive_replica_
    loss_quorum_math on a 2 x 4 grid: 3 of 4 replicas commit, 2 of 4
    stall."""
    from tpuraft_torch.entity import Task
    from tpuraft_torch.parallel.replica_cluster import ReplicaPlaneCluster

    c = ReplicaPlaneCluster(4, 4, device=_grid((2, 4)),
                            election_timeout_ms=1000)
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


# ---- on a card --------------------------------------------------------------


@pytest.mark.gpu
def test_fold_kernel_and_shared_card_tick_on_cuda():
    """The fold kernel against its plain version and the host scan, one
    launch a call; the sharded tick with 2, 4 and 8 shards sharing
    cuda:0 against the single-device fused tick, one launch a shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    before = tfold.LAUNCHES
    cases = 0
    for g in (0, 1, 255, 256, 257, 8192, 300_000):
        rows = _fold_rows(rng, g)
        want = _host_scan(*rows)
        cpu = [torch.from_numpy(x) for x in rows]
        got = tfold.deadline_fold(*(t.to(dev) for t in cpu))
        assert int(got) == want == int(tfold.deadline_fold(*cpu)), g
        cases += 1
    none = [torch.from_numpy(x).to(dev) for x in (
        np.full(64, 2, np.int32), np.zeros(64, bool), np.zeros(64, bool),
        *_fold_rows(rng, 64)[3:])]
    assert int(tfold.deadline_fold(*none)) == int(DEADLINE_NONE_I32)
    assert tfold.LAUNCHES - before == cases + 1
    fold = sharded_deadline_fold(make_mesh(device=[dev] * 8))
    rows = _fold_rows(rng, 65536)
    before = tfold.LAUNCHES
    assert fold(*rows) == _host_scan(*rows)
    assert tfold.LAUNCHES - before == 8

    from chip_smoke import rand_tick_fields

    g, p = 16384, 8
    fields = rand_tick_fields(rng, g, p)
    params = ttick.TickParams.make(1000, 100, 900, 700, device=dev)
    whole = ttick.group_state_from_numpy(fields, dev)
    for n in (2, 4, 8):
        mesh = make_mesh(device=[dev] * n)
        state, local = shard_group_state(whole, mesh), whole
        tick = sharded_tick(mesh)
        for r in range(4):
            before = ttick.LAUNCHES
            ns, out = tick(state, 1000 + 300 * r, params)
            assert ttick.LAUNCHES - before == n
            nl, ol = ttick.raft_tick(local, 1000 + 300 * r, params)
            gs, go = gather_shards(ns), gather_shards(out)
            for f in STATE_FIELDS:
                assert torch.equal(getattr(gs, f), getattr(nl, f).cpu()), f
            for f in OUT_FIELDS:
                assert torch.equal(getattr(go, f), getattr(ol, f).cpu()), f
            state, local = ns, nl
