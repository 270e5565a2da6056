"""The port's host-plane A/Bs against the JAX package's: the store
across OS processes (``bench_torch_multiproc.py`` / ``bench_multiproc.py``),
the gray-failure A/B (``bench_torch_gray.py`` / ``bench_gray.py``) and
the geo latency rows (``bench_torch_geo.py`` / ``bench_geo.py``).

Each case runs both scripts side by side at a tiny size, every record to
an absolute path under tmp (``bench_gray.py`` writes ``BENCH_GRAY.json``
in its working directory, so both gray scripts run from tmp): the port's
record holds every key of the reference's, with the same rows or arms,
work done in each, and the host-plane machine record (no device, no
card here).  No engine runs in any of them, as in the reference.  The
stores' data goes where statvfs reads the filesystem as having room
(``roomy_dir``: these stores take no explicit disk budget, and a full
one sheds every write).  No committed record changes.
"""

import json

import pytest

from bench_script import finish, records, roomy_dir, start


def _multiproc(tmp_path, data):
    shape = ["--regions", "8", "--workers", "4,8", "--duration", "2",
             "--election-timeout-ms", "1000", "--transport", "native"]
    ref = start("bench_multiproc.py", *shape, "--json-out",
                str(tmp_path / "ref.json"),
                env={"JAX_PLATFORMS": "cpu", "TMPDIR": data})
    port = start("bench_torch_multiproc.py", *shape, "--out",
                 str(tmp_path / "port.json"), env={"TMPDIR": data})
    return ref, port


def _gray(tmp_path, data):
    shape = ["--regions", "16", "--workers", "8", "--healthy-s", "2",
             "--fault-s", "4"]
    for arm in ("ref", "port"):
        (tmp_path / arm).mkdir()
    ref = start("bench_gray.py", *shape, cwd=str(tmp_path / "ref"),
                env={"JAX_PLATFORMS": "cpu", "TMPDIR": data})
    port = start("bench_torch_gray.py", *shape, "--out",
                 str(tmp_path / "port.json"), cwd=str(tmp_path / "port"),
                 env={"TMPDIR": data})
    return ref, port


def _geo(tmp_path, data):
    ref = start("bench_geo.py", "--ops", "10", "--out",
                str(tmp_path / "ref.json"),
                env={"JAX_PLATFORMS": "cpu", "TMPDIR": data})
    port = start("bench_torch_geo.py", "--ops", "10", "--out",
                 str(tmp_path / "port.json"), env={"TMPDIR": data})
    return ref, port


def _check_multiproc(tmp_path, room):
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(want) == set(got) == {"row_mp_8_w4_r0", "row_mp_8_w8_r0"}
    for key, row in got.items():
        assert set(want[key]) <= set(row), set(want[key]) - set(row)
        assert row["row"] == key and row["topology"] == "multi-process"
        assert row["workers"] == want[key]["workers"]
        assert set(row["cpu_s_per_store"]) and len(row["store_metrics"]) == 3
        assert row["device"] is None and row["plane"] == "host"
        assert row["card"] is None
        for r in (row, want[key]):
            assert r["ok"] + r["errors"] > 0
            if room:
                assert r["ok"] > 0, r


def _check_gray(tmp_path, room):
    want = json.loads((tmp_path / "ref" / "BENCH_GRAY.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert not list((tmp_path / "port").iterdir())  # writes --out only
    assert set(want) <= set(got), set(want) - set(got)
    assert set(got["arms"]) == set(want["arms"]) == {"on", "off"}
    for name, arm in got["arms"].items():
        assert set(want["arms"][name]) <= set(arm)
        assert arm["detection"] == (name == "on")
        assert arm["ops"] > 0 and want["arms"][name]["ops"] > 0
        assert len(arm["window_ops"]) == 3
    for rec in (want, got):  # no health scoring: nothing evacuates
        assert rec["arms"]["off"]["evacuations"] == 0
    assert got["device"] is None and got["card"] is None


def _check_geo(tmp_path, room):
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(want) <= set(got), set(want) - set(got)
    assert [r["topology"] for r in got["rows"]] == \
        [r["topology"] for r in want["rows"]] == [
            "3-zone", "5-zone", "3-zone-degraded-wan", "3-zone-witness-2+1"]
    for mine, theirs in zip(got["rows"], want["rows"]):
        assert set(theirs) <= set(mine)
        assert mine["ops"] == 10
        assert mine["commit"]["n"] == mine["ack"]["n"] == mine["ops"]
        assert theirs["commit"]["n"] == theirs["ack"]["n"] == 10
        assert mine["topology_counters"]["frames"] > 0
    assert got["device"] is None and got["card"] is None


CASES = {"multiproc": (_multiproc, _check_multiproc),
         "gray": (_gray, _check_gray),
         "geo": (_geo, _check_geo)}


@pytest.mark.parametrize("case", list(CASES))
def test_record_matches_the_reference_record(tmp_path, case):
    before = records()
    run, check = CASES[case]
    with roomy_dir(tmp_path) as (data, room):
        ref, port = run(tmp_path, data)
        ref_rc, _, ref_err = finish(ref)
        port_rc, _, port_err = finish(port)
    assert ref_rc == 0, ref_err[-3000:]
    assert port_rc == 0, port_err[-3000:]
    check(tmp_path, room)
    assert records() == before
