"""The port's MultiRaftEngine against the JAX package's, and a port
cluster end to end on the CPU.

Both engines are fed the same ballot-box trace, each through its own
package's PeerId/Configuration, on the same injected clock; their commit
callbacks and every tick output must match exactly.
"""

import asyncio

import numpy as np
import pytest
import torch

import tpuraft.conf as jconf
import tpuraft.core.engine as jengine
import tpuraft.entity as jentity
import tpuraft.options as joptions
import tpuraft_torch.conf as tconf
import tpuraft_torch.core.engine as tengine
import tpuraft_torch.entity as tentity
import tpuraft_torch.options as toptions
from tpuraft_torch.core.node import Node, State
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.core.state_machine import StateMachine
from tpuraft_torch.rpc.transport import InProcNetwork, InProcTransport, RpcServer

_OUT_FIELDS = ("commit_rel", "commit_advanced", "elected", "election_due",
               "step_down", "hb_due", "lease_valid", "snap_due", "q_ack",
               "stepdown_due", "fence_ok")


class _Clock:
    """Deterministic engine clock shared by both engines of a trace."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self) -> float:
        return self.t

    def wall(self) -> float:
        return self.t


def _build(pkg, opts, clock, n_groups, seed):
    """One engine per package, driven through its ballot-box factory:
    3-, 5-voter, joint and witness confs; a few voters stall."""
    conf_mod, entity_mod, engine_mod, options_mod = pkg
    PeerId, Configuration = entity_mod.PeerId, conf_mod.Configuration
    eng = engine_mod.MultiRaftEngine(options_mod.TickOptions(
        clock=clock, **opts))
    peers = [PeerId.parse(f"127.0.0.1:{7500 + i}") for i in range(6)]
    commits, outs = {}, []
    factory = eng.ballot_box_factory()
    rng = np.random.default_rng(seed)
    boxes = []
    for g in range(n_groups):
        kind = g % 4
        if kind == 0:
            conf, old = Configuration(peers[:3]), Configuration()
        elif kind == 1:
            conf, old = Configuration(peers[:5]), Configuration()
        elif kind == 2:
            conf, old = Configuration(peers[1:4]), Configuration(peers[:3])
        else:
            conf = Configuration.parse(
                ",".join(p.endpoint for p in peers[:2])
                + f",{peers[2].endpoint}/witness")
            old = Configuration()
        box = factory(lambda idx, g=g: commits.setdefault(g, []).append(idx))
        box.update_conf(conf, old)
        box.reset_pending_index(int(rng.integers(1, 4)))
        boxes.append((box, conf, old))
    orig_apply = eng._apply_commits

    def record(out):
        outs.append({k: np.array(getattr(out, k)) for k in _OUT_FIELDS})
        return orig_apply(out)

    eng._apply_commits = record
    return eng, boxes, commits, outs, peers


def _drive(eng, boxes, peers, clock, rng, proto):
    """Acks through the boxes, then the protocol rows the nodes would
    write, then one tick."""
    for box, conf, old in boxes:
        voters = list(conf.peers) + [p for p in old.peers
                                     if p not in conf.peers]
        for p in voters:
            if rng.random() < 0.7:
                box.commit_at(p, int(rng.integers(1, 60)), conf, old)
    for name, row in proto.items():
        getattr(eng, name)[:len(row)] = row
    eng._params_dev = None  # snap_ms is a param row: re-stage it
    eng.tick_once()


async def test_engine_matches_jax_engine():
    G, rounds = 64, 4
    base = dict(max_groups=G, max_peers=8, eager_commit=False)
    jclock, tclock = _Clock(), _Clock()
    je, jboxes, jcommits, jouts, jpeers = _build(
        (jconf, jentity, jengine, joptions), dict(base, backend="jax"),
        jclock, G, seed=5)
    te, tboxes, tcommits, touts, tpeers = _build(
        (tconf, tentity, tengine, toptions),
        dict(base, backend="torch", device="cpu"), tclock, G, seed=5)
    await je.start()
    await te.start()
    try:
        jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
        prng = np.random.default_rng(11)
        for r in range(rounds):
            proto = {}
            if r >= 2:  # protocol rows: elections, leases, fences, beats
                proto = {
                    "role": prng.integers(0, 3, G).astype(np.int32),
                    "snap_ms": prng.integers(0, 2, G) * 500,
                    "snap_deadline": prng.integers(0, 3000, G),
                    "elect_deadline": prng.integers(0, 3000, G),
                    "hb_deadline": prng.integers(0, 3000, G),
                    "stepdown_deadline": prng.integers(0, 3000, G),
                    "last_ack": np.where(prng.random((G, 8)) < 0.8,
                                         prng.integers(0, 2000, (G, 8)),
                                         -(2 ** 30)),
                    "granted": prng.random((G, 8)) < 0.5,
                    "quiescent": prng.random(G) < 0.2,
                    "fence_start": np.where(prng.random(G) < 0.5,
                                            prng.integers(0, 2000, G),
                                            -(2 ** 30)),
                }
            jclock.t += 0.7
            tclock.t += 0.7
            _drive(je, jboxes, jpeers, jclock, jrng, proto)
            _drive(te, tboxes, tpeers, tclock, trng, proto)
        assert len(jouts) == len(touts) == rounds + 1  # + the warm tick
        for r, (jo, to) in enumerate(zip(jouts, touts)):
            for k in _OUT_FIELDS:
                np.testing.assert_array_equal(
                    to[k], jo[k], err_msg=f"round {r}: {k}")
        assert tcommits == jcommits
        assert len(tcommits) > G // 4  # the trace did commit groups
        for k in _OUT_FIELDS:  # every lane fired somewhere: no vacuous match
            assert any(np.any(o[k] != o[k].flat[0]) or o[k].flat[0]
                       for o in touts), k
    finally:
        await te.shutdown()
        await je.shutdown()


async def test_numpy_backend_matches_torch_cpu():
    """The engine's explicit numpy twin and its torch CPU tick agree on
    a 1K-group, 5-voter trace with half the groups stalled at 2 acks."""
    G = 1024
    peers = [tentity.PeerId.parse(f"127.0.0.1:{7500 + i}") for i in range(5)]
    conf = tconf.Configuration(list(peers))

    async def run(**kw):
        eng = tengine.MultiRaftEngine(toptions.TickOptions(
            max_groups=G, max_peers=8, eager_commit=False, **kw))
        await eng.start()
        try:
            commits = {}
            factory = eng.ballot_box_factory()
            rng = np.random.default_rng(3)
            for g in range(G):
                box = factory(lambda idx, g=g: commits.__setitem__(g, idx))
                box.update_conf(conf, tconf.Configuration())
                box.reset_pending_index(1)
                for p in (peers if g % 2 == 0 else peers[:2]):
                    box.commit_at(p, int(rng.integers(1, 90)), conf,
                                  tconf.Configuration())
            eng.tick_once()
            return commits
        finally:
            await eng.shutdown()

    np_commits = await run(backend="numpy")
    assert await run(backend="torch", device="cpu") == np_commits
    assert len(np_commits) == G // 2
    assert all(g % 2 == 0 for g in np_commits)


def test_torch_backend_never_ticks_before_start():
    eng = tengine.MultiRaftEngine(toptions.TickOptions(
        max_groups=4, max_peers=4, device="cpu"))
    with pytest.raises(RuntimeError, match="before start"):
        eng.tick_once()


async def test_default_options_need_cuda():
    """Default TickOptions tick on CUDA: without a card start() raises
    (no silent CPU fallback); with one the library builds and every tick
    is one fused-tick launch."""
    from tpuraft_torch.ops import tick

    eng = tengine.MultiRaftEngine(toptions.TickOptions(max_groups=4,
                                                       max_peers=4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await eng.start()
        return
    before = tick.LAUNCHES
    await eng.start()
    eng.tick_once()
    await eng.shutdown()
    assert tick.LAUNCHES - before == eng.ticks == 2


async def test_profile_dir_writes_a_chrome_trace(tmp_path):
    eng = tengine.MultiRaftEngine(toptions.TickOptions(
        max_groups=4, max_peers=4, device="cpu",
        profile_dir=str(tmp_path / "prof")))
    await eng.start()
    eng.tick_once()
    await eng.shutdown()
    traces = list((tmp_path / "prof").glob("engine_ticks_*.json"))
    assert len(traces) == 1
    assert "tpuraft.raft_tick" in traces[0].read_text()


async def test_mesh_devices_not_ported():
    eng = tengine.MultiRaftEngine(toptions.TickOptions(
        max_groups=4, max_peers=4, device="cpu", mesh_devices=2))
    with pytest.raises(NotImplementedError, match="mesh"):
        await eng.start()


class _FSM(StateMachine):
    def __init__(self):
        self.logs: list[bytes] = []

    async def on_apply(self, it) -> None:
        while it.valid():
            self.logs.append(it.data())
            it.next()


async def test_port_cluster_elects_replicates_fails_over():
    """3 endpoints x 8 engine-backed groups of the port, ticking on the
    CPU: every group elects, commits on all replicas, and re-elects
    after one endpoint stops."""
    n_groups, eps = 8, [tentity.PeerId.parse(f"127.0.0.1:{6100 + i}")
                        for i in range(3)]
    conf = tconf.Configuration(list(eps))
    groups = [f"g{k}" for k in range(n_groups)]
    net = InProcNetwork()
    engines, nodes, fsms = {}, {}, {}
    for ep in eps:
        server = RpcServer(ep.endpoint)
        manager = NodeManager(server)
        net.bind(server)
        transport = InProcTransport(net, ep.endpoint)
        engine = tengine.MultiRaftEngine(toptions.TickOptions(
            max_groups=n_groups + 4, max_peers=8, tick_interval_ms=5,
            device="cpu"))
        await engine.start()
        engines[ep.endpoint] = engine
        factory = engine.ballot_box_factory()
        for gid in groups:
            fsm = fsms[(gid, ep)] = _FSM()
            node = Node(gid, ep, toptions.NodeOptions(
                election_timeout_ms=300, initial_conf=conf.copy(), fsm=fsm,
                log_uri="memory://", raft_meta_uri="memory://"),
                transport, ballot_box_factory=factory)
            node.node_manager = manager
            manager.add(node)
            assert await node.init()
            nodes[(gid, ep)] = node

    async def leader_of(gid, timeout_s=10.0):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while loop.time() < deadline:
            ls = [n for (g, _), n in nodes.items()
                  if g == gid and n.state == State.LEADER]
            if len(ls) == 1:
                return ls[0]
            await asyncio.sleep(0.02)
        raise TimeoutError(gid)

    async def write(leader, data):
        fut = asyncio.get_running_loop().create_future()
        await leader.apply(tentity.Task(data=data, done=fut.set_result))
        st = await asyncio.wait_for(fut, 10)
        assert st.is_ok(), st

    async def converged(keys, n):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10
        while loop.time() < deadline:
            if all(len(fsms[k].logs) >= n for k in keys):
                return
            await asyncio.sleep(0.02)
        raise TimeoutError({k: len(fsms[k].logs) for k in keys})

    try:
        leaders = {g: await leader_of(g) for g in groups}
        await asyncio.gather(*[write(leaders[g], b"%s-%d" % (g.encode(), i))
                               for g in groups for i in range(3)])
        await converged(list(fsms), 3)
        for g in groups:
            logs = [fsms[(g, ep)].logs for ep in eps]
            assert logs[0] == logs[1] == logs[2]
            assert sorted(logs[0]) == [b"%s-%d" % (g.encode(), i)
                                       for i in range(3)]
        assert all(e.ticks > 0 for e in engines.values())
        # stop the endpoint that leads groups[0]: its leaders re-elect
        dead = leaders[groups[0]].server_id
        net.stop_endpoint(dead.endpoint)
        for g in groups:
            await nodes.pop((g, dead)).shutdown()
        await engines.pop(dead.endpoint).shutdown()
        net.unbind(dead.endpoint)
        survivors = [ep for ep in eps if ep != dead]
        for g in groups:
            new = await leader_of(g)
            assert new.server_id != dead
            await write(new, b"%s-after" % g.encode())
        await converged([(g, ep) for g in groups for ep in survivors], 4)
        for g in groups:
            a, b = (fsms[(g, ep)].logs for ep in survivors)
            assert a == b and a[-1] == b"%s-after" % g.encode()
    finally:
        for n in nodes.values():
            await n.shutdown()
        for e in engines.values():
            await e.shutdown()
