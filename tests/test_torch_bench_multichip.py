"""``bench_torch_multichip.py`` (the port's mesh-mode lanes and
single-device tick shape) against the JAX package's
``bench_multichip.py``.

``--smoke``: the reference on its own 8 virtual host devices, the port
on 8 logical CPU shards, 1,024 groups each: the same lane verdicts
(witness clamp held and engaged, witness groups committing, ``ok``) and
the same lane layout.  ``--engine-shape``: the reference's standing
state laid into the reference's numpy engine and the port's, started on
the CPU, one frozen clock, then 5 ticks of each: every tick output,
``commit_abs`` and ``role`` equal (exact).  The port's ``--engine-shape
--cpu`` prints its one result, launching nothing (the plain tick).  No
committed record changes.

On a card (no JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_bench_multichip.py
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from bench_script import REPO, finish, records, result_row, start


def bench_module():
    spec = importlib.util.spec_from_file_location(
        "bench_torch_multichip",
        os.path.join(REPO, "bench_torch_multichip.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_lanes_match_the_reference(tmp_path):
    before = records()
    ref = start("bench_multichip.py", "--smoke")
    port = start("bench_torch_multichip.py", "--smoke", "--cpu",
                 "--out", str(tmp_path / "mc.json"))
    ref_rc, ref_out, ref_err = finish(ref)
    port_rc, port_out, port_err = finish(port)
    assert ref_rc == 0, ref_err[-3000:]
    assert port_rc == 0, port_err[-3000:]
    want, got = result_row(ref_out), result_row(port_out)
    assert json.loads((tmp_path / "mc.json").read_text())["smoke"] == got
    lanes = {k for k, v in want.items() if isinstance(v, bool)}
    assert lanes == {"witness_commit_ok", "clamp_held", "clamp_engaged",
                     "ok"}
    assert {k: got[k] for k in lanes} == {k: want[k] for k in lanes}
    assert got["ok"] and got["failures"] == want["failures"] == []
    for key in ("groups", "peers", "mesh_devices", "witness_groups",
                "clamp_probe_groups", "fences_pending"):
        assert got[key] == want[key], key
    for row in (want, got):
        assert row["stepdown_ticks"] == row["stepdown_handler_calls"] > 0
        assert row["election_due_handled"] > 0
        assert row["fence_armed"] == row["fence_resolved"] > 0
        assert row["commits"] > 0
    assert got["devices"] == ["cpu"] * 8
    assert got["fused_tick_launches"] == got["fold_launches"] == 0
    assert got["fold_calls"] >= got["drive_rounds"]
    assert records() == before


class _Clock:
    """One frozen clock for both engines: their ``now`` rows agree."""

    t = 100.0

    def monotonic(self) -> float:
        return self.t

    def wall(self) -> float:
        return self.t


def _record_outputs(eng) -> list:
    """Every tick's outputs, as the engine applies them."""
    outs = []
    apply = eng._apply_commits

    def record(out):
        outs.append({k: np.array(getattr(out, k))
                     for k in type(out).__slots__})
        return apply(out)

    eng._apply_commits = record
    return outs


async def test_engine_shape_ticks_like_the_reference():
    from tpuraft.core.engine import ROLE_FOLLOWER as J_FOLLOWER
    from tpuraft.core.engine import ROLE_LEADER as J_LEADER
    from tpuraft.core.engine import MultiRaftEngine as JaxEngine
    from tpuraft.options import TickOptions as JaxOptions

    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.options import TickOptions

    groups, seed = 1024, 7
    clock = _Clock()
    # the reference's standing state (bench_multichip.py, engine shape),
    # on its never-started engine (its numpy tick)
    ref = JaxEngine(JaxOptions(max_groups=groups, max_peers=4,
                               tick_interval_ms=20, clock=clock))
    rng = np.random.default_rng(seed)
    g = ref.G
    now = ref.now_ms()
    ref.role[:] = np.where(np.arange(g) % 2 == 0, J_LEADER, J_FOLLOWER)
    ref.voter_mask[:, :3] = True
    ref.self_col[:] = 0
    ref.has_ctrl[:] = False
    ref.last_ack[:, :3] = now
    ref.elect_deadline[:] = now + 3_600_000
    ref.hb_deadline[:] = now + 3_600_000
    ref.stepdown_deadline[:] = now + 3_600_000
    ref.match_abs[:, :3] = rng.integers(1, 50, size=(g, 3))
    ref.pending_rel[:] = 1

    eng = MultiRaftEngine(TickOptions(max_groups=groups, max_peers=4,
                                      tick_interval_ms=20, clock=clock,
                                      device="cpu"))
    await eng.start()
    try:
        bench_module().standing_state(eng, seed)
        assert eng.G == ref.G
        np.testing.assert_array_equal(eng.match_abs, ref.match_abs)
        want, got = _record_outputs(ref), _record_outputs(eng)
        for _ in range(5):
            clock.t += 0.02
            ref.tick_once()
            eng.tick_once()
            np.testing.assert_array_equal(eng.commit_abs, ref.commit_abs)
            np.testing.assert_array_equal(eng.role, ref.role)
        assert len(got) == len(want) == 5
        for w, o in zip(want, got):
            assert set(o) == set(w)
            for k in w:
                np.testing.assert_array_equal(o[k], w[k], err_msg=k)
        # the leaders' median match: every leader's commit advances
        leaders = ref.role == J_LEADER
        assert got[0]["commit_advanced"][leaders].all()
        np.testing.assert_array_equal(
            got[0]["commit_rel"][leaders],
            np.sort(ref.match_abs[leaders, :3], axis=1)[:, 1]
            - ref.base[leaders])
    finally:
        await eng.shutdown()


def test_engine_shape_prints_its_result(tmp_path):
    out = tmp_path / "mc.json"
    rc, stdout, err = finish(start(
        "bench_torch_multichip.py", "--engine-shape", "--cpu", "--groups",
        "256", "--duration", "0.3", "--out", str(out)))
    assert rc == 0, err[-3000:]
    row = result_row(stdout)
    assert row["groups"] == 256 and row["device"] == "cpu"
    assert row["engine_ticks_per_sec"] > 0 and row["ok"]
    assert len(row["runs"]) == 3
    assert all(r["fused_tick_launches"] == 0 and r["ticks"] > 1
               for r in row["runs"])
    assert json.loads(out.read_text())["engine_shape"] == row


@pytest.mark.parametrize("mode", ["--smoke", "--engine-shape"])
def test_refuses_without_a_card(tmp_path, mode):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a CUDA card")
    out = tmp_path / "mc.json"
    rc, stdout, err = finish(start("bench_torch_multichip.py", mode,
                                   "--out", str(out)))
    assert rc != 0
    # the engine's own errors: its device check, or the mesh's
    assert ("no CUDA device is available" in err
            or "0 CUDA devices are present" in err), err[-2000:]
    assert "RESULT" not in stdout and not out.exists()


# ---- on a card ----------------------------------------------------------------


@pytest.mark.gpu
def test_modes_on_the_card_launch_once_a_tick_a_shard(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused tick has no CPU mode")
    out = tmp_path / "mc.json"
    rc, stdout, err = finish(start(
        "bench_torch_multichip.py", "--smoke", "--duration", "1",
        "--out", str(out)), timeout=300)
    assert rc == 0, err[-3000:]
    row = result_row(stdout)
    assert row["ok"] and row["platform"] == "cuda"
    assert row["fused_tick_launches"] == row["ticks"] * 8
    assert row["fold_launches"] == row["fold_calls"] * 8
    rc, stdout, err = finish(start(
        "bench_torch_multichip.py", "--engine-shape", "--duration", "0.5",
        "--out", str(out)), timeout=300)
    assert rc == 0, err[-3000:]
    row = result_row(stdout)
    assert row["ok"] and row["card"]["name"]
    assert all(r["fused_tick_launches"] == r["ticks"] > 1
               for r in row["runs"])
    rec = json.loads(out.read_text())
    assert set(rec) == {"smoke", "engine_shape"}
