"""``bench_torch_scale.py`` (the port's protocol-plane ladder) against
the JAX package's ``bench_scale.py``.

One rung of each at 16 groups x 3 replicas, 2 s of paced writes, a 1 s
election timeout released over 50 ms, ``--meta memory``, in temporary
directories: the port's row holds every key of the reference's, both
elect every group, ack every write without error and apply each one on
all three replicas; the port's engines on the CPU launch nothing (the
plain tick).  The idle probe shows quiescence lowering the idle RPC
rate; the ladder's parent writes its record to ``--out`` only.  No
committed record changes.

On a card (no JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_bench_scale.py
"""

import json

import pytest
import torch

from bench_script import finish, records, result_row, start

RUNG = ["--groups", "16", "--replicas", "3", "--duration", "2",
        "--election-timeout-ms", "1000", "--elect-spread-s", "0.05",
        "--pace-ms", "300", "--batch", "16", "--meta", "memory"]


def test_rung_matches_the_reference_rung(tmp_path):
    before = records()
    ref = start("bench_scale.py", "--rung", *RUNG,
                "--dir", str(tmp_path / "ref"),
                env={"JAX_PLATFORMS": "cpu"})
    port = start("bench_torch_scale.py", "--rung", "--cpu", *RUNG,
                 "--converge", "1.0", "--dir", str(tmp_path / "port"))
    ref_rc, ref_out, ref_err = finish(ref)
    port_rc, port_out, port_err = finish(port)
    assert ref_rc == 0, ref_err[-3000:]
    assert port_rc == 0, port_err[-3000:]
    want, got = result_row(ref_out), result_row(port_out)
    assert set(want) <= set(got), set(want) - set(got)
    for row in (want, got):
        assert row["groups"] == 16 and row["replicas"] == 3
        assert row["leaders"] == row["groups"], row
        assert row["errors"] == 0 and row["errors_by_class"] == {}, row
        assert row["ok"] > 0
        assert row["applied_total"] == row["replicas"] * row["ok"], row
    assert got["device"] == "cpu" and got["card"] is None
    assert got["fused_tick_launches"] == [0, 0, 0]  # the plain tick
    assert sum(got["ticks_by_engine"]) == got["engine_ticks"] > 0
    assert got["leaders_at_end"] == 16
    assert records() == before


def test_idle_probe_quiescence_lowers_the_idle_rpc_rate(tmp_path):
    out = tmp_path / "idle.json"
    rc, stdout, err = finish(start(
        "bench_torch_scale.py", "--cpu", "--idle-probe", "--rungs", "16",
        "--duration", "1", "--election-timeout-ms", "1000",
        "--elect-spread-s", "0.05", "--out", str(out)))
    assert rc == 0, err[-3000:]
    pair = json.loads(out.read_text())["idle_beat_plane"]
    off, on = pair["quiesce_off"], pair["quiesce_on"]
    assert off["rc"] == on["rc"] == 0
    assert off["quiescent_groups"] == 0
    assert on["quiescent_groups"] == 48  # every replica of every group
    assert on["idle_rpcs_per_s"] < off["idle_rpcs_per_s"], pair
    assert pair["rpc_reduction_x"] > 1
    assert json.loads(stdout.splitlines()[-1])["idle_probe"] == "done"


def test_ladder_writes_its_rows_to_out_only(tmp_path):
    before = records()
    out = tmp_path / "scale.json"
    rc, stdout, err = finish(start(
        "bench_torch_scale.py", "--cpu", "--rungs", "16", "--duration", "2",
        "--offered", "1280", "--election-timeout-ms", "1000",
        "--elect-spread-s", "0.05", "--converge", "1.0", "--out", str(out)))
    assert rc == 0, err[-3000:]
    rec = json.loads(out.read_text())
    assert rec["metric"] == "protocol_plane_scale_ladder"
    (row,) = rec["rows"]
    assert row["rc"] == 0 and row["groups"] == 16
    assert row["pace_ms"] == 200.0 and row["offered_per_sec"] == 1280.0
    assert row["errors"] == 0 and row["leaders"] == 16
    assert set(rec["per_g_overhead"]["16"]) == {"rss_kb_per_group",
                                                "tasks_per_group"}
    assert json.loads(stdout.splitlines()[-1]) == {"rungs": 1, "ok": 1}
    assert records() == before


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a CUDA card")
    out = tmp_path / "scale.json"
    rc, _, err = finish(start("bench_torch_scale.py", "--rungs", "16",
                              "--out", str(out)))
    assert rc != 0
    assert "no CUDA device is available" in err, err[-2000:]
    assert not out.exists()


# ---- on a card ----------------------------------------------------------------


@pytest.mark.gpu
def test_rung_on_the_card_launches_once_a_tick(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused tick has no CPU mode")
    out = tmp_path / "scale.json"
    rc, _, err = finish(start(
        "bench_torch_scale.py", "--rungs", "16", "--duration", "2",
        "--offered", "1280", "--election-timeout-ms", "1000",
        "--elect-spread-s", "0.05", "--converge", "1.0", "--out", str(out)),
        timeout=300)
    assert rc == 0, err[-3000:]
    (row,) = json.loads(out.read_text())["rows"]
    assert row["device"] == "cuda:0" and row["card"]["name"]
    assert row["fused_tick_launches"] == row["ticks_by_engine"]
    assert all(t > 0 for t in row["ticks_by_engine"])
    assert row["leaders"] == 16 and row["errors"] == 0
    assert row["applied_total"] == 3 * row["ok"] > 0
