"""The port's driver entry points (``tpuraft_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``.

- ``entry()``: both ticks applied to their own inputs give the same new
  state and the same 11 outputs;
- ``dryrun_multichip(8, "cpu")``: plane (a), the group-sharded tick, and
  plane (b), the replica quorum over a 2 x 4 grid, against the JAX
  planes over conftest's 8 virtual CPU devices; plane (b'), the replica
  cluster, meets the JAX function's assertions;
- with no card, every entry point that asks for one raises.

Exact throughout (tolerance 0): every output is an integer or a bool.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from tpuraft_torch import device_plane, graft_entry
from tpuraft_torch.ops import tick as ttick

N = 8
STATE_FIELDS = [f.name for f in dataclasses.fields(ttick.GroupState)]
OUT_FIELDS = [f.name for f in dataclasses.fields(ttick.TickOutputs)]


def _jax_devices():
    import jax

    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device CPU mesh")
    return jax.devices()[:N]


def _assert_same(port, jax_obj, names, what):
    for k in names:
        got = getattr(port, k).cpu().numpy()
        want = np.asarray(getattr(jax_obj, k))
        assert got.dtype == want.dtype, (what, k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{what}.{k}")


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as jax_entry

    fn, args = graft_entry.entry(device="cpu")
    assert fn is ttick.raft_tick
    state, now, params = args
    assert type(now) is int and now == 1
    assert tuple(state.match_rel.shape) == (1024, 8)
    assert all(getattr(state, f).device.type == "cpu" for f in STATE_FIELDS)
    before = ttick.LAUNCHES
    new_state, out = fn(*args)
    assert ttick.LAUNCHES == before  # the plain version on the CPU

    jfn, jargs = jax_entry.entry()
    _assert_same(state, jargs[0], STATE_FIELDS, "input")
    jnew, jout = jfn(*jargs)
    _assert_same(out, jout, OUT_FIELDS, "outputs")
    _assert_same(new_state, jnew, STATE_FIELDS, "new state")
    assert out.commit_advanced.any()


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(N, "cpu")


def test_dryrun_sharded_plane_matches_the_jax_plane(dryrun):
    """Plane (a): G = 64 over 8 shards against the JAX sharded tick over
    8 devices, every state field and output."""
    import jax
    import jax.numpy as jnp

    from tpuraft.ops.tick import ROLE_LEADER, GroupState, TickParams
    from tpuraft.parallel.mesh import (make_mesh, shard_group_state,
                                       sharded_tick)

    _jax_devices()
    mesh = make_mesh(N)
    G, P = 8 * N, 4
    state = GroupState.zeros(G, P)
    state.role = jnp.full((G,), ROLE_LEADER, jnp.int32)
    voter = np.zeros((G, P), bool)
    voter[:, :3] = True
    state.voter_mask = jnp.asarray(voter)
    state.match_rel = jnp.asarray(
        np.arange(G * P, dtype=np.int32).reshape(G, P) % 16)
    state.pending_rel = jnp.ones((G,), jnp.int32)
    tick = sharded_tick(mesh, donate=False)
    jnew, jout = tick(shard_group_state(state, mesh), jnp.int32(1),
                      TickParams.make(1000, 100, 900))
    jax.block_until_ready(jout.commit_rel)

    new_state, out = dryrun["sharded"]
    _assert_same(out, jout, OUT_FIELDS, "plane (a) outputs")
    _assert_same(new_state, jnew, STATE_FIELDS, "plane (a) state")
    port_in, _ = graft_entry.sharded_plane_state(N)
    _assert_same(port_in, state, STATE_FIELDS, "plane (a) input")


def test_dryrun_replica_plane_matches_the_jax_plane(dryrun):
    """Plane (b): R = 2, G = 16 over a 2 x 4 grid against the JAX
    collectives over a (replica=2, groups=4) mesh and the host oracle."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpuraft.parallel.collective import replicated_tick

    devs = _jax_devices()
    R, G2 = 2, 4 * (N // 2)
    rng = np.random.default_rng(0)
    match = rng.integers(0, 50, (R, G2)).astype(np.int32)
    granted = rng.random((R, G2)) < 0.5
    mesh2 = Mesh(np.array(devs).reshape(2, N // 2), ("replica", "groups"))
    want_c, want_v = replicated_tick(mesh2, n_replicas=R)(
        jnp.asarray(match), jnp.asarray(granted))

    commit, votes = dryrun["replica"]
    assert commit.dtype == np.int32 and votes.dtype == np.int32
    np.testing.assert_array_equal(commit, np.asarray(want_c))
    np.testing.assert_array_equal(votes, np.asarray(want_v))
    np.testing.assert_array_equal(commit, np.sort(match, 0)[::-1][R // 2])
    got_m, got_g = graft_entry.replica_plane_inputs(N)
    np.testing.assert_array_equal(got_m, match)
    np.testing.assert_array_equal(got_g, granted)


def test_dryrun_cluster_meets_the_jax_assertions(dryrun):
    """Plane (b'): 4 replicas x 8 groups over the grid, two waves: at
    least 2 plane ticks and a commit advance per group."""
    c = dryrun["cluster"]
    assert c["groups"] == N and c["replicas"] == 4
    assert c["plane_ticks"] >= 2
    assert c["commit_advances"] >= c["groups"]


def test_dryrun_below_four_devices_skips_the_planes_jax_skips():
    res = graft_entry.dryrun_multichip(2, "cpu")
    assert res["cluster"] is None
    commit, _ = res["replica"]
    assert commit.shape == (4,)
    res = graft_entry.dryrun_multichip(1, "cpu")
    assert res["replica"] is None and res["cluster"] is None
    assert tuple(res["sharded"][1].commit_rel.shape) == (8,)


def test_entry_points_refuse_a_missing_card():
    """No card: each entry point that asks for one raises, and none runs
    on the CPU instead; no argument or switch selects a plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(ValueError, match="CUDA devices"):
        graft_entry.dryrun_multichip(N, ["cuda:0"] * N)
    with pytest.raises(ValueError, match="CUDA devices"):
        graft_entry.dryrun_multichip(N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_plane.run_plane(64, 8, 3, 32, 20, 2, 0, device="cuda")
    for fn in (graft_entry.entry, graft_entry.dryrun_multichip,
               device_plane.run_plane):
        assert "impl" not in inspect.signature(fn).parameters
    for mod in (graft_entry, device_plane):
        assert "environ" not in inspect.getsource(mod)
