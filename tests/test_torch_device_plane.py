"""The port's pipelined device plane (``tpuraft_torch/device_plane.py``)
against a plain loop of the JAX package's ``raft_tick``.

``run_plane`` at G=256, P=8, 3 voters, 60 ticks after 4 warm-up ticks,
seed 0, on the CPU: every submitted tick's commit row equals the JAX
loop's over bench.py's acks (state carried, the link probes included),
and so do the total commits, each pass's commits (the profiled one
too) and ``commits_per_tick_per_group``, whatever the window
(``depth`` 1, 4, 16 or sized from the link).  The window changes when
acks arrive, never what they say.  Exact (tolerance 0).

``bench_torch_plane.py --cpu`` prints its one JSON line.  On a card
(no JAX; this file imports it only inside the CPU tests):
    python -m pytest --noconftest -m gpu tests/test_torch_device_plane.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuraft_torch import device_plane
from tpuraft_torch.device_plane import BURST, PASSES, RTT_PROBES, run_plane
from tpuraft_torch.ops import tick as ttick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, P, VOTERS, BATCH, TICKS, WARMUP, SEED = 256, 8, 3, 32, 60, 4, 0
HALF = (TICKS - BURST) // PASSES
TIMED = WARMUP + BURST + PASSES * HALF    # the profiled pass comes after
SUBMITTED = TIMED + HALF


def _bench_advances(total):
    """bench.py's draw (``bench.py:62-70``), written out here."""
    rng = np.random.default_rng(SEED)
    advances = rng.integers(BATCH // 2, BATCH + 1,
                            (total, G, P)).astype(np.int8)
    advances[:, :, VOTERS:] = 0
    return advances


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX tick over the same acks, one tick at a time with the
    state carried, the 5 link probes (``now`` 0, no new acks) after the
    warm-up: the commit row of each submitted tick."""
    import jax
    import jax.numpy as jnp

    from tpuraft.ops.tick import ROLE_LEADER, GroupState, TickParams, raft_tick

    advances = _bench_advances(WARMUP + TICKS + HALF)
    state = GroupState.zeros(G, P)
    state.role = jnp.full((G,), ROLE_LEADER, jnp.int32)
    voter = np.zeros((G, P), bool)
    voter[:, :VOTERS] = True
    state.voter_mask = jnp.asarray(voter)
    state.pending_rel = jnp.ones((G,), jnp.int32)
    params = TickParams.make(1000, 100, 900)
    tick = jax.jit(raft_tick)
    host_match = np.zeros((G, P), np.int32)
    rows = []
    for i in range(SUBMITTED):
        if i == WARMUP:
            for _ in range(RTT_PROBES):
                state, _ = tick(state, jnp.int32(0), params)
        host_match[:, :] += advances[i]
        state.match_rel = jnp.asarray(host_match.copy())
        state, out = tick(state, jnp.int32(i), params)
        rows.append(np.asarray(out.commit_rel))
    return np.stack(rows)


def _pass_commits(rows, k):
    """Commits of timed pass k from the JAX rows."""
    start = WARMUP + BURST + k * HALF
    return int(rows[start + HALF - 1].sum()) - int(rows[start - 1].sum())


@pytest.mark.parametrize("depth", [1, 4, 16, None],
                         ids=["depth1", "depth4", "depth16", "sized"])
def test_rows_equal_the_jax_loop_at_every_window(jax_rows, depth):
    before = ttick.LAUNCHES
    res = run_plane(G, P, VOTERS, BATCH, TICKS, WARMUP, SEED, device="cpu",
                    depth=depth, record=True)
    assert ttick.LAUNCHES == before  # the plain version on the CPU
    assert res["launches"] == 0
    assert res["submitted"] == SUBMITTED
    assert res["ticks_run"] == SUBMITTED + RTT_PROBES
    rows = res["rows"]
    assert rows.dtype == np.int32 and rows.shape == (SUBMITTED, G)
    np.testing.assert_array_equal(rows, jax_rows)
    assert res["total_commits"] == int(jax_rows[-1].sum())
    want = [_pass_commits(jax_rows, k) for k in range(PASSES + 1)]
    assert [p["commits"] for p in res["passes"]] == want[:PASSES]
    med = sorted(res["passes"], key=lambda r: r["commits_per_sec"])[
        PASSES // 2]
    k = res["passes"].index(med)
    assert res["commits_per_tick_per_group"] == want[k] / HALF / G
    if depth is None:
        assert res["depth_sized_from_link"]
        assert 4 <= res["pipeline_depth"] <= device_plane.MAX_DEPTH
    else:
        assert res["pipeline_depth"] == depth
    # the profiled pass: its acks drawn after bench.py's ticks; on the
    # CPU it reports no device time
    prof = res["profiled_pass"]
    assert prof["ticks"] == HALF and prof["commits"] == want[PASSES]
    assert prof["device_busy_ms"] is None and prof["busy_share"] is None
    for key in ("commits_per_sec", "ticks_per_sec", "ack_p50_ms",
                "ack_p99_ms", "dispatch_ms", "completion_rtt_ms"):
        assert res[key] > 0, key


def test_advances_are_bench_py_draw():
    got = device_plane.plane_advances(G, P, VOTERS, BATCH, WARMUP + TICKS,
                                      SEED)
    np.testing.assert_array_equal(got, _bench_advances(WARMUP + TICKS))
    longer = device_plane.plane_advances(G, P, VOTERS, BATCH,
                                         WARMUP + TICKS + HALF, SEED)
    np.testing.assert_array_equal(longer[:WARMUP + TICKS], got)


def test_run_plane_refuses_bad_windows():
    with pytest.raises(ValueError, match="depth"):
        run_plane(G, P, VOTERS, BATCH, TICKS, WARMUP, SEED, device="cpu",
                  depth=0)
    with pytest.raises(ValueError, match="ticks"):
        run_plane(G, P, VOTERS, BATCH, BURST, WARMUP, SEED, device="cpu")


def test_bench_script_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "bench_torch_plane.py", "--cpu", "--groups", "64",
         "--ticks", "20", "--out", os.devnull],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert rec["metric"] == "multiraft_batched_commits_per_sec_16k_groups"
    assert rec["unit"] == "commits/s" and rec["value"] > 0
    extra = rec["extra"]
    assert extra["groups"] == 64 and extra["device"] == "cpu"
    assert extra["launches"] == 0
    for key in ("commits_per_tick_per_group", "pipeline_depth",
                "dispatch_ms", "ticks_per_sec", "ack_p50_ms", "ack_p99_ms",
                "completion_rtt_ms", "pass_commits_per_sec"):
        assert key in extra, key


# ---- on a card ----------------------------------------------------------------


@pytest.mark.gpu
def test_run_plane_on_the_card_equals_the_cpu_run():
    """G=2,048, P=8, 40 ticks: the fused tick with several ticks in
    flight gives the plain tick's rows, one launch a tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused tick has no CPU mode")
    args = (2048, 8, 3, 32, 40, 4, 0)
    want = run_plane(*args, device="cpu", depth=1, record=True)
    before = ttick.LAUNCHES
    got = run_plane(*args, device="cuda", record=True)
    assert ttick.LAUNCHES - before == got["launches"] == got["ticks_run"]
    np.testing.assert_array_equal(got["rows"], want["rows"])
    assert got["total_commits"] == want["total_commits"]
    assert [p["commits"] for p in got["passes"]] == [
        p["commits"] for p in want["passes"]]
    assert got["profiled_pass"]["commits"] == want["profiled_pass"]["commits"]
    assert got["profiled_pass"]["kernels"] >= got["profiled_pass"]["ticks"]
    for depth in (1, 4, 16):
        res = run_plane(*args, device="cuda", depth=depth, record=True)
        np.testing.assert_array_equal(res["rows"], want["rows"])
