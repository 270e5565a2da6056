"""``bench_torch_region_density.py`` (the KV store at region density)
against the JAX package's ``bench_region_density.py``.

Each case runs both parents side by side at 8 regions x 3 stores, 4
workers for 2 s and a 1 s election timeout, each writing its record to
a file under tmp: the port's row holds every key of the reference's,
both lead every region by the end of the drive, ack without error, and
the stage probes mark the same stages; the port's engines on the CPU
launch nothing (the plain tick).  No committed record changes.

The stores take no explicit disk budget (neither script has a flag for
one): each reads its capacity from statvfs, and a filesystem over 92 %
used reads FULL, every store turns SICK and sheds writes.  So the
stores' data goes where the filesystem has room (``roomy_dir``); where
none has, only the ``--no-disk-guard`` case (one of the reference's own
A/B knobs) asserts no error.

On a card (no JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_bench_region_density.py
"""

import json

import pytest
import torch

from bench_script import finish, records, roomy_dir, start

SHAPE = ["--regions", "8", "--duration", "2", "--workers", "4",
         "--election-timeout-ms", "1000"]
CASES = {
    "write_mix": [],
    "lease_reads": ["--read-frac", "0.5", "--lease-reads"],
    "no_disk_guard": ["--no-disk-guard"],
}
KEYS = {"write_mix": "row_8_w4", "lease_reads": "row_8_w4_r50_lease",
        "no_disk_guard": "row_8_w4_nodg"}


def last_row(out: str) -> dict:
    """The parent's last stdout line: the row it filed."""
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_row_matches_the_reference_row(tmp_path, case):
    before = records()
    with roomy_dir(tmp_path) as (data, room):
        ref = start("bench_region_density.py", *SHAPE, *CASES[case],
                    "--json-out", str(tmp_path / "ref.json"),
                    env={"JAX_PLATFORMS": "cpu", "TMPDIR": data})
        port = start("bench_torch_region_density.py", "--cpu", *SHAPE,
                     *CASES[case], "--converge", "1.0",
                     "--out", str(tmp_path / "port.json"),
                     env={"TMPDIR": data})
        ref_rc, ref_out, ref_err = finish(ref)
        port_rc, port_out, port_err = finish(port)
    assert ref_rc == 0, ref_err[-3000:]
    assert port_rc == 0, port_err[-3000:]
    want, got = last_row(ref_out), last_row(port_out)
    assert set(want) <= set(got), set(want) - set(got)
    key = KEYS[case]
    assert got["row"] == key
    assert json.loads((tmp_path / "port.json").read_text())[key] == got
    assert json.loads((tmp_path / "ref.json").read_text())[key] == want
    acked = room or case == "no_disk_guard"
    for row in (want, got):
        assert row["regions"] == 8 and row["stores"] == 3
        assert row["tick_plane"]["groups"] == 24
        assert row["tick_plane"]["leaders"] == 8, row  # after the drive
        assert row["ok"] + row["errors"] > 0
        if acked:
            assert row["ok"] > 0 and row["errors"] == 0, row
    assert got["leaders"] == got["leaders_at_end"] == 8
    assert set(got["stage_marks_ms"]) == set(want["stage_marks_ms"])
    assert set(got["read_stage_marks_ms"]) == \
        set(want["read_stage_marks_ms"])
    if acked:
        assert {"propose_s", "quorum_e", "apply_e", "ack"} <= \
            set(got["stage_marks_ms"])
        assert {"fence_s", "fence_e"} <= set(got["read_stage_marks_ms"])
    assert got["read_frac"] == want["read_frac"]
    assert got["lease_reads"] == want["lease_reads"]
    assert got["device"] == "cpu" and got["card"] is None
    assert got["fused_tick_launches"] == [0, 0, 0]  # the plain tick
    assert sum(got["ticks_by_engine"]) == got["engine_ticks"] > 0
    assert got["rc"] == 0
    assert records() == before


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a CUDA card")
    out = tmp_path / "regions.json"
    rc, stdout, err = finish(start("bench_torch_region_density.py",
                                   "--regions", "8", "--out", str(out)))
    assert rc != 0
    assert "no CUDA device is available" in err, err[-2000:]
    assert "RESULT" not in stdout and not out.exists()


# ---- on a card ----------------------------------------------------------------


@pytest.mark.gpu
def test_engines_on_the_card_launch_once_a_tick(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused tick has no CPU mode")
    out = tmp_path / "regions.json"
    rc, stdout, err = finish(start(
        "bench_torch_region_density.py", *SHAPE, "--converge", "1.0",
        "--out", str(out)), timeout=300)
    assert rc == 0, err[-3000:]
    row = last_row(stdout)
    assert row["device"] == "cuda:0" and row["card"]["name"]
    assert row["fused_tick_launches"] == row["ticks_by_engine"]
    assert all(t > 0 for t in row["ticks_by_engine"])
    assert row["leaders_at_end"] == 8 and row["ok"] > 0
    assert row["errors"] == 0, row
