"""``bench_torch_gate.py`` (the port's pre-merge perf gate) against the
JAX package's ``bench_gate.py``.

The parity cases load both scripts as modules and feed them the same
stubbed inputs: the floor rule (``_gate``) over scripted measurements,
the argv of every row runner with ``subprocess`` stubbed, and ``main()``
with every row runner replaced by the same deterministic fakes (the
reference pointed at a tmp copy of its two calibration files by its
``REPO``).  Then the port's own refusals (exit 2), and one real
``--cpu --record`` and gate run at tiny shapes from a tmp calibration,
the stores' data where statvfs reads room (``roomy_dir``).  No case
touches a committed record.
"""

import copy
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import pytest

from bench_script import REPO, records, roomy_dir

# pytest's assertion rewriting must not touch the two scripts
_MODULES = {}


def _load(name: str):
    if name not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"_gate_under_test_{name}", os.path.join(REPO, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[name] = mod
    return _MODULES[name]


@pytest.fixture
def ref():
    return _load("bench_gate")


@pytest.fixture
def port():
    return _load("bench_torch_gate")


def _committed_extras() -> tuple[dict, dict]:
    """The reference's two calibrations (BENCH_E2E.json's and
    BENCH_REGIONS.json's ``extra``)."""
    with open(os.path.join(REPO, "BENCH_E2E.json")) as f:
        e2e = json.load(f)["extra"]
    with open(os.path.join(REPO, "BENCH_REGIONS.json")) as f:
        kv = json.load(f)["extra"]
    return e2e, kv


# -- (a) the floor rule -------------------------------------------------------

class Scripted:
    """Measurements in order; an exception instance is raised instead."""

    def __init__(self, values):
        self.values, self.calls = list(values), 0

    def __call__(self):
        v = self.values[self.calls]
        self.calls += 1
        if isinstance(v, Exception):
            raise v
        return v


SCRIPTS = {
    "pass_first": [120.0, 0.0, 0.0],
    "pass_after_a_retry": [50.0, 95.0, 0.0],
    "regress_every_retry": [50.0, 60.0, 70.0],
    "broken": [50.0, RuntimeError("kv bench run failed (rc=1)"), 0.0],
}


@pytest.mark.parametrize("threshold,retries",
                         [(0.20, 2), (0.05, 1), (0.5, 0)])
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_gate_matches_the_reference(ref, port, capsys, script, threshold,
                                    retries):
    want_run, got_run = Scripted(SCRIPTS[script]), Scripted(SCRIPTS[script])
    want = ref._gate("row", 100.0, want_run, threshold, retries)
    ref_out = capsys.readouterr().out
    got = port._gate("row", 100.0, got_run, threshold, retries)
    assert got == want
    assert got_run.calls == want_run.calls
    assert capsys.readouterr().out == ref_out


# -- (b) the row runners' commands --------------------------------------------

_OUT_FLAGS = ("--out", "--json-out")


class Children:
    """``subprocess.call`` / ``subprocess.run`` stand-ins: each records
    the argv and environment and writes what the named script would: a
    record filed under the key the port's script files it by (so a
    runner that reads another key fails), or a ``RESULT`` line."""

    def __init__(self):
        self.argvs, self.envs = [], []

    def _note(self, cmd, env):
        self.argvs.append(list(cmd))
        self.envs.append(env)

    def call(self, cmd, env=None, **kw):
        self._note(cmd, env)
        out = next(cmd[i + 1] for i, a in enumerate(cmd) if a in _OUT_FLAGS)
        script = os.path.basename(cmd[1])
        with open(out, "w") as f:
            json.dump({"value": 7.0, _row_key(script, cmd[2:]):
                       {"ops_per_sec": 7.0}}, f)
        return 0

    def run(self, cmd, env=None, **kw):
        self._note(cmd, env)
        return subprocess.CompletedProcess(
            cmd, 0, 'RESULT {"engine_ticks_per_sec": 7.0}\n', "")


def _row_key(script: str, argv: list) -> str:
    """The key the port's script files this argv's row under (its own
    ``row_key``), for either package's spelling of the script."""
    sys.path.insert(0, REPO)
    try:
        if "region_density" in script:
            mod = _load("bench_torch_region_density")
            ns = _ns(argv, {"regions": 1024, "workers": 24,
                            "read_frac": -1.0})
            return mod.row_key(ns)
        if "multiproc" in script:
            mod = _load("bench_torch_multiproc")
            ns = _ns(argv, {"regions": 1024, "workers": "24,256"})
            return mod.row_key(ns, int(ns.workers))
        return "row"
    finally:
        sys.path.remove(REPO)


def _ns(argv: list, defaults: dict):
    import argparse

    ns = argparse.Namespace(**defaults, lease_reads=False, quiesce=False,
                            no_heat=False, no_disk_guard=False,
                            chaos_clock=False, no_write_batch=False,
                            lifecycle_pd=False, no_apply_lane=False)
    kinds = {"regions": int, "read_frac": float, "workers": str}
    for i, a in enumerate(argv):
        if not a.startswith("--"):
            continue
        name = a[2:].replace("-", "_")
        if name in kinds:
            setattr(ns, name, kinds[name](argv[i + 1]))
        elif hasattr(ns, name):
            setattr(ns, name, True)
    if isinstance(ns.workers, str) and "," not in ns.workers:
        ns.workers = int(ns.workers)
    return ns


KV_KNOBS = {
    "mix": {}, "read": {"read_frac": 0.95},
    "write": {"read_frac": 0.0, "workers": 256},
    "traced": {"trace_sample": 0.05}, "heat_off": {"heat_off": True},
    "disk_guard_off": {"disk_guard_off": True},
    "chaos_clock": {"chaos_clock": True},
    "lifecycle_pd": {"lifecycle_pd": True},
}
RUNNERS = {
    "e2e": (lambda m, e2e, kv, **c: m._run_e2e_once(e2e, 6.0, **c), True),
    "engine": (lambda m, e2e, kv, **c: m._run_engine_once(e2e, **c), True),
    "mp": (lambda m, e2e, kv, **c: m._run_mp_once(kv, 6.0), False),
    **{f"kv_{name}": ((lambda kw: lambda m, e2e, kv, **c:
                       m._run_kv_once(kv, 6.0, **kw, **c))(knobs), True)
       for name, knobs in KV_KNOBS.items()},
}


def _renamed(argv: list) -> list:
    """The reference's argv as the port spells it: every script its
    ``bench_torch_`` counterpart, ``--json-out`` as ``--out``, and the
    record's path left out (each run has its own temp dir)."""
    out, skip = [], False
    for a in argv:
        if skip:
            out.append("<record>")
            skip = False
            continue
        if a in _OUT_FLAGS:
            out.append("--out")
            skip = True
            continue
        m = re.fullmatch(r"(.*/)bench_(\w+)\.py", a)
        out.append(f"{m.group(1)}bench_torch_{m.group(2)}.py" if m else a)
    return out


@pytest.mark.parametrize("cpu", [False, True], ids=["card", "cpu"])
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_row_commands_match_the_reference(ref, port, tmp_path, monkeypatch,
                                          runner, cpu):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    e2e, kv = _committed_extras()
    drive, takes_cpu = RUNNERS[runner]
    got = {}
    for name, mod in (("ref", ref), ("port", port)):
        kids = Children()
        monkeypatch.setattr(subprocess, "call", kids.call)
        monkeypatch.setattr(subprocess, "run", kids.run)
        value = drive(mod, copy.deepcopy(e2e), copy.deepcopy(kv),
                      **({"cpu": cpu} if takes_cpu and name == "port"
                         else {}))
        assert value == 7.0
        assert len(kids.argvs) == 1
        got[name] = (kids.argvs[0], kids.envs[0])
    (want_argv, _), (port_argv, port_env) = got["ref"], got["port"]
    out_path = next((port_argv[i + 1] for i, a in enumerate(port_argv)
                     if a == "--out"), None)
    want = _renamed(want_argv) + (["--cpu"] if cpu and takes_cpu else [])
    assert [a if a != out_path else "<record>" for a in port_argv] == want
    scripts = [a for a in port_argv if a.endswith(".py")]
    assert scripts and all(
        re.fullmatch(r"bench_torch_\w+\.py", os.path.basename(a))
        for a in scripts), port_argv
    assert "JAX_PLATFORMS" not in port_env
    assert port_env["PYTHONPATH"] == REPO


# -- (c) main() ---------------------------------------------------------------

class Fakes:
    """Deterministic row runners shared by both modules: each kind of
    run gives its scripted values in order (the last one repeats)."""

    def __init__(self, table: dict):
        self.table, self.calls = table, {}

    def _next(self, kind: str) -> float:
        i = self.calls.get(kind, 0)
        self.calls[kind] = i + 1
        vals = self.table[kind]
        v = vals[min(i, len(vals) - 1)]
        if isinstance(v, Exception):
            raise v
        return v

    def e2e(self, extra, duration, cpu=False):
        return self._next("e2e")

    def engine(self, extra, cpu=False):
        return self._next("engine")

    def mp(self, extra, duration):
        return self._next("mp")

    def kv(self, extra, duration, read_frac=-1.0, trace_sample=0.0,
           heat_off=False, disk_guard_off=False, chaos_clock=False,
           lifecycle_pd=False, workers=0, cpu=False):
        if read_frac == 0.95:
            return self._next("read")
        if workers == 256:
            return self._next("write")
        for on, kind in ((trace_sample > 0, "traced"),
                         (heat_off, "heat_off"),
                         (disk_guard_off, "disk_guard_off"),
                         (chaos_clock, "clocked"),
                         (lifecycle_pd, "lifecycle")):
            if on:
                return self._next(kind)
        return self._next("kv")

    def install(self, monkeypatch, mod):
        for attr, fn in (("_run_e2e_once", self.e2e),
                         ("_run_engine_once", self.engine),
                         ("_run_kv_once", self.kv),
                         ("_run_mp_once", self.mp)):
            monkeypatch.setattr(mod, attr, fn)


_PASS = {"e2e": [9400.0], "engine": [1400.0], "kv": [1100.0],
         "traced": [1090.0], "heat_off": [1100.0],
         "disk_guard_off": [1100.0], "clocked": [1100.0],
         "lifecycle": [1100.0], "read": [2600.0], "write": [950.0],
         "mp": [900.0]}
SCENARIOS = {
    "pass": (_PASS, 0),
    # the e2e row under its floor every time, a same-session row that
    # passes on its second run, and one that regresses
    "regression": ({**_PASS, "e2e": [5000.0, 6000.0, 7000.0],
                    "kv": [1100.0, 1000.0, 1100.0],
                    "clocked": [1000.0, 1099.0], "lifecycle": [900.0]}, 1),
    # kv_ops_per_sec not OK: the same-session rows do not run
    "kv_not_ok": ({**_PASS, "kv": [500.0]}, 1),
    "broken": ({**_PASS, "mp": [RuntimeError("mp bench run failed "
                                             "(rc=1)")]}, 2),
}


def _reports(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith('{"gate"')]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_main_matches_the_reference(ref, port, tmp_path, monkeypatch,
                                    capsys, scenario):
    table, want_rc = SCENARIOS[scenario]
    for var in ("THRESHOLD", "DURATION", "RETRIES", "TRACE_THRESHOLD",
                "HEAT_THRESHOLD", "DISK_THRESHOLD", "CLOCK_THRESHOLD",
                "LIFECYCLE_THRESHOLD"):
        monkeypatch.delenv(f"BENCH_GATE_{var}", raising=False)
    before = records()
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for name in ("BENCH_E2E.json", "BENCH_REGIONS.json"):
        shutil.copy(os.path.join(REPO, name), ref_dir / name)
    monkeypatch.setattr(ref, "REPO", str(ref_dir))
    monkeypatch.setattr(sys, "argv", ["bench_gate.py"])
    e2e, kv = _committed_extras()
    cal = tmp_path / "gate.json"
    cal.write_text(json.dumps({"device": "cpu", "e2e": e2e, "kv": kv}))

    ref_fakes, port_fakes = Fakes(table), Fakes(table)
    ref_fakes.install(monkeypatch, ref)
    port_fakes.install(monkeypatch, port)
    assert ref.main() == want_rc
    want = _reports(capsys.readouterr().out)
    assert port.main(["--cpu", "--calibration", str(cal)]) == want_rc
    got = _reports(capsys.readouterr().out)
    assert got == want
    assert port_fakes.calls == ref_fakes.calls
    ran_same_session = "traced" in port_fakes.calls
    assert ran_same_session == (scenario != "kv_not_ok")
    assert len(got) == (11 if ran_same_session else 6)
    assert records() == before


# -- (d) what the gate refuses ------------------------------------------------

_CALIBRATED = ("gate_commits_per_sec", "gate_engine_ticks_per_sec",
               "gate_kv_ops_per_sec", "gate_read_ops_per_sec",
               "gate_write_ops_per_sec", "gate_mp_write_ops_per_sec")


def test_no_calibration_file_is_exit_2(port, tmp_path, monkeypatch, capsys):
    fakes = Fakes(_PASS)
    fakes.install(monkeypatch, port)
    assert port.main(["--cpu", "--calibration",
                      str(tmp_path / "none.json")]) == 2
    assert fakes.calls == {}
    assert "no calibration" in capsys.readouterr().out


@pytest.mark.parametrize("missing", _CALIBRATED)
def test_a_missing_row_calibration_is_exit_2(port, tmp_path, monkeypatch,
                                             capsys, missing):
    """No fallback: the row reads BROKEN, even beside a full run's
    ``value``, and its runner never starts."""
    e2e, kv = _committed_extras()
    e2e["value"] = 1.0
    for extra in (e2e, kv):
        extra.pop(missing, None)
    cal = tmp_path / "gate.json"
    cal.write_text(json.dumps({"device": "cpu", "e2e": e2e, "kv": kv}))
    fakes = Fakes(_PASS)
    fakes.install(monkeypatch, port)
    assert port.main(["--cpu", "--calibration", str(cal)]) == 2
    broken = [r for r in _reports(capsys.readouterr().out)
              if r["verdict"] == "BROKEN"]
    assert broken == [{"gate": broken[0]["gate"], "verdict": "BROKEN",
                       "error": f"no {missing} calibration"}]


def test_another_device_is_exit_2(port, tmp_path, monkeypatch, capsys):
    e2e, kv = _committed_extras()
    cal = tmp_path / "gate.json"
    cal.write_text(json.dumps({"device": "NVIDIA H100 80GB HBM3, 700.00 W",
                               "e2e": e2e, "kv": kv}))
    fakes = Fakes(_PASS)
    fakes.install(monkeypatch, port)
    assert port.main(["--cpu", "--calibration", str(cal)]) == 2
    assert fakes.calls == {}
    assert "H100" in capsys.readouterr().out


# -- (e) a real calibration and gate run on the CPU ---------------------------

TINY = {"e2e": {"groups": 4, "stores": 3, "window_per_group": 2,
                "payload_bytes": 16, "gate_engine_groups": 16,
                "gate_engine_duration_s": 0.2},
        "kv": {"gate_regions": 4, "gate_eto_ms": 500,
               "gate_mp_regions": 4, "gate_mp_eto_ms": 1000}}


def _gate_child(cal, data, *args) -> tuple[int, str]:
    env = dict(os.environ, TMPDIR=data, BENCH_GATE_DURATION="0.5",
               BENCH_GATE_RETRIES="0", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch_gate.py"),
         "--cpu", "--calibration", str(cal), *args],
        capture_output=True, text=True, env=env, cwd=data, timeout=400)
    return proc.returncode, proc.stdout + proc.stderr


def test_record_then_gate_on_the_cpu(tmp_path):
    before = records()
    with open(os.path.join(REPO, "BASELINE.json"), "rb") as f:
        baseline = f.read()
    cal = tmp_path / "gate.json"
    cal.write_text(json.dumps(TINY))
    with roomy_dir(tmp_path) as (data, _room):
        rc, out = _gate_child(cal, data, "--record")
        assert rc == 0, out[-3000:]
        recorded = json.loads(cal.read_text())
        assert recorded["device"] == "cpu"
        for extra, shape in (("e2e", "groups"), ("kv", "gate_regions")):
            assert recorded[extra][shape] == TINY[extra][shape]
        for key in _CALIBRATED:
            where = "e2e" if key in ("gate_commits_per_sec",
                                     "gate_engine_ticks_per_sec") else "kv"
            assert recorded[where][key] > 0, recorded
        rc, out = _gate_child(cal, data)
    reports = _reports(out)
    assert rc in (0, 1), out[-3000:]
    assert {r["gate"] for r in reports} >= {
        "e2e_commits_per_sec", "engine_ticks_per_sec", "kv_ops_per_sec",
        "kv_read_ops_per_sec", "kv_write_ops_per_sec",
        "kv_mp_write_ops_per_sec"}, out[-3000:]
    assert all(r["verdict"] in ("OK", "REGRESSION") for r in reports), \
        reports
    if next(r for r in reports
            if r["gate"] == "kv_ops_per_sec")["verdict"] == "OK":
        assert len(reports) == 11, reports
    assert records() == before
    with open(os.path.join(REPO, "BASELINE.json"), "rb") as f:
        assert f.read() == baseline
