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


# -- the fused tick's edge rows and packed outputs ----------------------------

def _assert_tick_matches_jax(tstate, tparams, jstate, jparams, now, tag):
    jnew, jout = jtick.raft_tick(jstate, jnp.int32(now), jparams)
    tnew, tout = ttick.raft_tick(tstate, now, tparams)
    for what, got, want in (("output", tout, jout), ("state", tnew, jnew)):
        for name, row in ttick.outputs_to_numpy(got).items():
            np.testing.assert_array_equal(
                row, np.asarray(getattr(want, name)),
                err_msg=f"{tag}: {what} {name}")
    return tnew


@pytest.mark.parametrize("params_kind", ["scalars", "rows"])
@pytest.mark.parametrize("p", [3, 5, 12])
def test_plain_tick_edge_rows_match_jax(p, params_kind):
    """The rows a kernel can get wrong bit by bit (P not a power of two;
    witness confs with negative data matches; values below -2^30; acks
    just above it with now near 2^31 - 1; deadlines and intervals that
    wrap; odd and negative timeouts; joint, empty and single-voter rows)
    through the port's plain tick and the JAX package's, exactly.  The
    one value the JAX package gets wrong, -2^31 itself (see
    test_quorum_paths_below_the_sentinel), becomes -2^31 + 1 here."""
    from chip_smoke import edge_now, edge_tick_fields, edge_tick_params

    rng = np.random.default_rng(100 + p)
    g = 97
    if params_kind == "scalars":
        prm = (999, 100, 900, 700)
    else:
        prm = edge_tick_params(rng, g)
    jparams = jtick.TickParams.make(*prm)
    tparams = ttick.tick_params_from_numpy(*prm, device="cpu")
    wrapped = 0
    for rnd in range(8):
        fields = edge_tick_fields(rng, g, p)
        for k in ("match_rel", "last_ack"):
            fields[k] = np.maximum(fields[k], -2**31 + 1).astype(np.int32)
        now = edge_now(rng) if rnd else 2**31 - 1
        wrapped += int(now > 2**31 - 3000)
        _assert_tick_matches_jax(
            ttick.group_state_from_numpy(fields, device="cpu"), tparams,
            _jax_state(fields), jparams, now, f"P={p} round {rnd}")
    assert wrapped > 0


def test_quorum_paths_below_the_sentinel():
    """Below the -2^30 sentinel the JAX package's two quorum paths part
    from the sort oracle (the q-th largest of the row, masked slots at
    -2^30), and the port follows the oracle.  The XLA path sorts -v, and
    -(-2^31) wraps to -2^31, so an ack of exactly -2^31 ranks first; the
    Pallas kernel takes its maximum over voters with -2^30 as the fill,
    so it never answers below -2^30.  Real matches and acks never go
    below the sentinel; the edge rows do, to hold the kernels to the
    oracle."""
    from tpuraft.ops.quorum_pallas import fused_quorum as jax_fused_quorum

    from tpuraft_torch.ops.quorum_cuda import fused_quorum_reference

    values = np.array([[-2**31, 1316, 248], [NEG - 7, -2**31, -2**31]],
                      np.int32)
    vm = np.array([[True, True, False], [True, False, True]])
    case = (values, vm, values, vm, np.zeros((2, 3), bool))
    oracle = [np.sort(np.where(m, v, NEG))[::-1][m.sum() // 2]
              for v, m in zip(values, vm)]
    assert oracle == [NEG, NEG - 7]
    port = fused_quorum_reference(*map(torch.from_numpy, case))
    xla = jax_fused_quorum(*map(jnp.asarray, case), impl="xla")
    kernel = jax_fused_quorum(*map(jnp.asarray, case),
                              impl="pallas_interpret")
    for out in (0, 2):
        assert port[out].tolist() == oracle
        assert np.asarray(xla[out]).tolist() == [1316, NEG]
        assert np.asarray(kernel[out]).tolist() == [NEG, NEG]


def test_edge_rows_reach_the_edges():
    """The edge generator does produce the rows it promises (so the
    differential above is not vacuous)."""
    from chip_smoke import edge_tick_fields

    from tpuraft_torch.ops.ballot import quorum_match_index

    f = edge_tick_fields(np.random.default_rng(5), 400, 5)
    vm = torch.from_numpy(f["voter_mask"])
    q = quorum_match_index(torch.from_numpy(f["match_rel"]), vm)
    assert (q < NEG).any()                              # below the sentinel
    witness = (f["witness_mask"] & f["voter_mask"]).any(1)
    data = f["voter_mask"] & ~f["witness_mask"]
    assert (witness & (np.where(data, f["match_rel"], -1) < 0).all(1)).any()
    assert (f["hb_deadline"] > 2**31 - 3000).any()     # now + x wraps
    assert (f["old_voter_mask"].any(1)).any()           # joint rows
    assert (~f["voter_mask"].any(1)).any()              # no voters


@pytest.mark.parametrize("params_kind", ["scalars", "rows"])
def test_packed_outputs_unpacked_by_the_engine_equal_jax(params_kind):
    """raft_tick_outputs(..., out=) writes the packed layout the engine's
    staging unpacks: field by field, the JAX package's TickOutputs."""
    from tpuraft_torch.core.engine import _TickStaging

    rng = np.random.default_rng(21)
    g, p = 75, 8
    fields = _rand_fields(rng, g, p)
    prm = (1000, 100, 900, 700) if params_kind == "scalars" else \
        _params(rng, g, True)
    tparams = ttick.tick_params_from_numpy(*prm, device="cpu")
    state = ttick.group_state_from_numpy(fields, device="cpu")
    st = _TickStaging(g, p, torch.device("cpu"))
    st.out_dev.fill_(0xAB)  # stale bytes: every byte must be rewritten
    views = ttick.raft_tick_outputs(state, 1234, tparams, out=st.out_dev)
    st.fetch()  # on the CPU the tick wrote the host buffer itself
    got = st.landed()
    _, jout = jtick.raft_tick(_jax_state(fields), jnp.int32(1234),
                              jtick.TickParams.make(*prm))
    for f in dataclasses.fields(ttick.TickOutputs):
        want = np.asarray(getattr(jout, f.name))
        np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)
        np.testing.assert_array_equal(getattr(views, f.name).numpy(), want,
                                      err_msg=f.name)
    assert st.out_dev.numel() == ttick.packed_nbytes(g) == 17 * g


def test_packed_out_is_checked():
    rng = np.random.default_rng(4)
    state = ttick.group_state_from_numpy(_rand_fields(rng, 16, 4),
                                         device="cpu")
    params = ttick.TickParams.make(1000, 100, 900, 700, device="cpu")
    for bad in (torch.empty(16 * 17 - 1, dtype=torch.uint8),
                torch.empty(16 * 17, dtype=torch.int8),
                torch.empty(16 * 17 * 2, dtype=torch.uint8)[::2]):
        with pytest.raises(ValueError, match="out must be"):
            ttick.raft_tick_outputs(state, 5, params, out=bad)


@pytest.mark.parametrize("where", ["meta", "cuda"])
def test_non_cpu_tick_never_takes_plain_version(where, monkeypatch):
    """Only CPU tensors take the plain tick; any other device launches
    the fused tick or raises.  "cuda": the dispatch is told the tensors
    are on a card and the library refuses to load, so the call must
    raise without ever reaching the plain version."""
    from tpuraft_torch.ops import quorum_cuda

    rng = np.random.default_rng(6)
    fields = _rand_fields(rng, 16, 4)

    def plain(*a, **k):
        raise AssertionError("the plain tick ran for a non-CPU tensor")

    monkeypatch.setattr(ttick, "raft_tick_reference", plain)
    before = ttick.LAUNCHES
    if where == "meta":
        state = ttick.group_state_from_numpy(fields, device="meta")
        params = ttick.TickParams.make(1000, 100, 900, 700, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ttick.raft_tick(state, 5, params)
        with pytest.raises(ValueError, match="unsupported device"):
            ttick.raft_tick_outputs(state, 5, params)
    else:
        def refuse():
            raise RuntimeError("kernel library refused")

        monkeypatch.setattr(quorum_cuda, "load", refuse)
        monkeypatch.setattr(ttick, "_tick_device",
                            lambda s, p: torch.device("cuda"))
        state = ttick.group_state_from_numpy(fields, device="cpu")
        params = ttick.TickParams.make(1000, 100, 900, 700, device="cpu")
        for call in (ttick.raft_tick, ttick.raft_tick_outputs):
            with pytest.raises((RuntimeError, AssertionError)) as e:
                call(state, 5, params)
            assert "plain tick ran" not in str(e.value)
    assert ttick.LAUNCHES == before
