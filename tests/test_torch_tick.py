"""The port's raft_tick against the JAX package's, state carried over
through group_state_from_numpy: every output and every new-state field
must match exactly, round after round."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuraft.ops import tick as jtick
from tpuraft_torch.ops import tick as ttick

NEG = -(2**30)


def _rand_fields(rng, g, p):
    """Every GroupState field populated — the distribution of the JAX
    package's randomized tick differentials (witness clamp, stepdown
    cadence, read fences, quiescence all live)."""
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


def _jax_state(fields):
    return jtick.GroupState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _params(rng, g, per_group):
    if per_group:
        return (rng.integers(300, 1200, g), rng.integers(50, 200, g),
                rng.integers(200, 1000, g), rng.integers(0, 2, g) * 700)
    return 1000, 100, 900, 700


@pytest.mark.parametrize("g,p,per_group", [(64, 8, False), (257, 8, True),
                                           (96, 16, True)])
def test_tick_matches_jax_over_rounds(g, p, per_group):
    rng = np.random.default_rng(g + p)
    fields = _rand_fields(rng, g, p)
    eto, hb, lease, snap = _params(rng, g, per_group)
    jparams = jtick.TickParams.make(eto, hb, lease, snap)
    tparams = ttick.tick_params_from_numpy(
        *(np.asarray(x) for x in (jparams.election_timeout_ms,
                                  jparams.heartbeat_ms, jparams.lease_ms,
                                  jparams.snapshot_ms)), device="cpu")
    jstate = _jax_state(fields)
    tstate = ttick.group_state_from_numpy(fields, device="cpu")
    for rnd in range(6):
        now = int(rng.integers(0, 3000))
        jstate, jout = jtick.raft_tick(jstate, jnp.int32(now), jparams)
        tstate, tout = ttick.raft_tick(tstate, now, tparams)
        for name, got in ttick.outputs_to_numpy(tout).items():
            np.testing.assert_array_equal(
                got, np.asarray(getattr(jout, name)),
                err_msg=f"round {rnd}: output {name}")
        for name, got in ttick.outputs_to_numpy(tstate).items():
            np.testing.assert_array_equal(
                got, np.asarray(getattr(jstate, name)),
                err_msg=f"round {rnd}: state {name}")
        # the host writes new acks/votes/roles between ticks
        fresh = _rand_fields(rng, g, p)
        keep = ttick.outputs_to_numpy(tstate)
        for name in ("match_rel", "last_ack", "granted", "role",
                     "fence_start"):
            keep[name] = fresh[name]
        jstate = _jax_state(keep)
        tstate = ttick.group_state_from_numpy(keep, device="cpu")


def test_tick_accepts_tensor_now():
    rng = np.random.default_rng(2)
    fields = _rand_fields(rng, 32, 8)
    params = ttick.TickParams.make(1000, 100, 900, 700, device="cpu")
    state = ttick.group_state_from_numpy(fields, device="cpu")
    a = ttick.raft_tick_outputs(state, 1234, params)
    b = ttick.raft_tick_outputs(
        state, torch.tensor(1234, dtype=torch.int32), params)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_carry_over_round_trip():
    """numpy -> port GroupState -> numpy is the identity, field order and
    names are the JAX package's, dtypes are int32/bool."""
    rng = np.random.default_rng(3)
    fields = _rand_fields(rng, 40, 8)
    state = ttick.group_state_from_numpy(fields, device="cpu")
    assert ([f.name for f in dataclasses.fields(ttick.GroupState)]
            == [f.name for f in dataclasses.fields(jtick.GroupState)])
    assert ([f.name for f in dataclasses.fields(ttick.TickOutputs)]
            == [f.name for f in dataclasses.fields(jtick.TickOutputs)])
    assert ([f.name for f in dataclasses.fields(ttick.TickParams)]
            == [f.name for f in dataclasses.fields(jtick.TickParams)])
    back = ttick.outputs_to_numpy(state)
    assert list(back) == list(fields)
    for k, v in fields.items():
        assert back[k].dtype == (bool if v.dtype == bool else np.int32), k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the JAX package's own zero state carries over to the port's
    jzero = jtick.GroupState.zeros(5, 4)
    tzero = ttick.group_state_from_numpy(
        {f.name: np.asarray(getattr(jzero, f.name))
         for f in dataclasses.fields(jzero)}, device="cpu")
    ref = ttick.GroupState.zeros(5, 4, device="cpu")
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(tzero, f.name), getattr(ref, f.name))
    assert ttick.witness_lanes_available() == jtick.witness_lanes_available()


@pytest.mark.parametrize("make", [
    lambda: ttick.GroupState.zeros(2, 4),
    lambda: ttick.TickParams.make(1000, 100, 900),
    lambda: ttick.group_state_from_numpy({}),
    lambda: ttick.tick_params_from_numpy(1000, 100, 900),
], ids=["zeros", "make", "state_from_numpy", "params_from_numpy"])
def test_constructors_take_no_default_device(make):
    """The device is the caller's choice: no constructor of the tick's
    state or parameters quietly puts them on the CPU."""
    with pytest.raises(TypeError, match="device"):
        make()
