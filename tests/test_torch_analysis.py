"""The port's analysis tool (tpuraft_torch.analysis) against the JAX
package's (tpuraft.analysis), and its torch host-sync rule.

- on the JAX package's fixtures both tools report the same findings,
  rule for rule, except the jit-based host-sync and donated-read rules
  (the port finds no ``jax.jit`` root);
- the torch host-sync rule fires on its own fixtures and honours its
  waivers;
- the port's sanctions are exactly what the reference reports on the
  originals of the port's copies;
- ``python -m tpuraft_torch.analysis`` exits 0 on ``tpuraft_torch/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from tpuraft_torch.analysis import lock_order
from tpuraft_torch.analysis.core import (load_modules, load_sanctioned,
                                         run_checkers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "graftcheck")
TORCH_FIXTURES = os.path.join(REPO, "tests", "fixtures", "graftcheck_torch")
JIT_RULES = {"host-sync", "donated-read"}


def _run(module: str, *args: str) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, "-m", module, *args, "--json", "--quiet"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode in (0, 1), proc.stderr
    return json.loads(proc.stdout)


def _keys(findings, skip=frozenset()):
    return sorted((f["file"], f["line"], f["rule"]) for f in findings
                  if f["rule"] not in skip)


# ---- the fixture differential -----------------------------------------------


@pytest.fixture(scope="module")
def both_on_fixtures():
    return (_run("tpuraft.analysis", FIXTURES),
            _run("tpuraft_torch.analysis", FIXTURES))


def test_fixture_findings_match_the_reference(both_on_fixtures):
    ref, port = both_on_fixtures
    assert _keys(port, JIT_RULES) == _keys(ref, JIT_RULES)
    assert len(_keys(ref, JIT_RULES)) >= 35


@pytest.mark.parametrize("rule", [
    "guarded-by", "loop-confined", "lock-order", "blocking-call",
    "future-leak", "transitive-blocking", "loop-affinity", "lane-coverage"])
def test_fixture_rule_matches_the_reference(both_on_fixtures, rule):
    ref, port = both_on_fixtures
    want = [f for f in ref if f["rule"] == rule]
    got = [f for f in port if f["rule"] == rule]
    assert want, rule
    assert _keys(got) == _keys(want)
    if rule not in ("blocking-call", "transitive-blocking", "lock-order",
                    "lane-coverage"):
        # their messages name the tick plane or the lockfile's path, or
        # list a set of sites in hash order
        assert sorted(f["message"] for f in got) == \
            sorted(f["message"] for f in want)


def test_jit_rules_find_no_root_in_the_port(both_on_fixtures):
    ref, port = both_on_fixtures
    assert {f["rule"] for f in ref} >= JIT_RULES
    assert not [f for f in port if f["rule"] in JIT_RULES]


# ---- the torch host-sync rule -----------------------------------------------


@pytest.fixture(scope="module")
def torch_found():
    mods, errs = load_modules([TORCH_FIXTURES])
    assert not errs
    return run_checkers(mods)


def _at(found, name, line):
    return [f for f in found if f.path.endswith(name) and f.line == line]


LAUNCH = "ops/seeded_launch.py"
CALLER = "seeded_caller.py"


@pytest.mark.parametrize("where,line,needle", [
    (LAUNCH, 18, "_helper(): .tolist()"),
    (LAUNCH, 32, "launch(): .item()"),
    (LAUNCH, 33, "launch(): int() of a tensor"),
    (LAUNCH, 42, "wrapper(): data-dependent Python `if`"),
    (LAUNCH, 44, "wrapper(): data-dependent Python `while`"),
    (LAUNCH, 44, "wrapper(): bool() of a tensor"),
    (LAUNCH, 47, "wrapper(): .cpu()"),
    (LAUNCH, 48, "wrapper(): float() of a tensor"),
    (CALLER, 21, "Plane.tick(): .tolist()"),
    (CALLER, 24, "Plane._read(): .item()"),
], ids=lambda v: str(v))
def test_torch_host_sync_fires(torch_found, where, line, needle):
    hits = _at(torch_found, where, line)
    assert any(f.rule == "host-sync" and needle in f.message
               for f in hits), [str(f) for f in hits]


def test_torch_host_sync_exact_set_and_waivers(torch_found):
    """Nothing else fires: metadata, identity and scalar branches, the
    entry point's return code, the waived designed copies, and every
    host sync off the tick path stay clean."""
    assert all(f.rule == "host-sync" for f in torch_found)
    assert len(torch_found) == 10, [str(f) for f in torch_found]
    assert not _at(torch_found, LAUNCH, 50)   # waived .numpy()
    assert not _at(torch_found, CALLER, 20)   # waived .cpu()
    lines = {(os.path.basename(f.path), f.line) for f in torch_found}
    src = open(os.path.join(TORCH_FIXTURES, "ops",
                            "seeded_launch.py")).read().splitlines()
    probe = next(i for i, s in enumerate(src, 1) if "def ok_host_probe" in s)
    assert not any(name == "seeded_launch.py" and line >= probe
                   for name, line in lines)
    assert not any(name == "seeded_caller.py" and line >= 27
                   for name, line in lines)


def test_the_reference_sees_no_tick_path_in_torch_code():
    assert _run("tpuraft.analysis", TORCH_FIXTURES) == []


# ---- the sanctions ------------------------------------------------------------


def test_sanctioned_findings_are_the_references_own():
    """sanctioned.json lists exactly what the reference reports on the
    original of each sanctioned copy, at the same lines."""
    sanctioned = load_sanctioned()
    files = sorted({p for p, _, _ in sanctioned})
    assert files == ["tpuraft_torch/examples/proc_supervisor.py"]
    ref = _run("tpuraft.analysis",
               os.path.join(REPO, "examples", "proc_supervisor.py"))
    assert {("tpuraft_torch/" + f["file"], f["line"], f["rule"])
            for f in ref} == sanctioned
    assert len(sanctioned) == 9


def test_lock_order_sanctions_the_references_edges():
    ref = json.load(open(os.path.join(REPO, "tpuraft", "analysis",
                                      "lock_order.json")))
    port = json.load(open(lock_order.lock_file_path()))
    assert port == ref
    mods, _ = load_modules([os.path.join(REPO, "tpuraft_torch")])
    assert set(lock_order.derive_graph(mods)) == lock_order.load_sanctioned()


def test_wire_schema_lock_is_the_references_plus_the_counter():
    ref = json.load(open(os.path.join(REPO, "tpuraft", "analysis",
                                      "wire_schema.lock.json")))
    port = json.load(open(os.path.join(REPO, "tpuraft_torch", "analysis",
                                       "wire_schema.lock.json")))
    assert port["_comment"] == ref["_comment"]
    renamed = {tid: {**e, "module": e["module"].replace(
        "tpuraft/", "tpuraft_torch/", 1)} for tid, e in ref["types"].items()}
    extra = {tid: e for tid, e in port["types"].items() if tid not in renamed}
    assert {tid: port["types"][tid] for tid in renamed} == renamed
    assert sorted(extra) == ["240", "241", "242"]
    assert {e["module"] for e in extra.values()} == \
        {"tpuraft_torch/examples/counter.py"}


def test_unsanctioned_findings_are_exactly_sixteen():
    """Without its sanction lists the port's tree reports the 16
    findings the reference reports on the originals (4 lock nestings,
    3 wire types, 9 in the supervisor) and nothing else."""
    ref = _run("tpuraft.analysis", os.path.join(REPO, "tpuraft_torch"))
    assert len(ref) == 16
    assert sorted(f["rule"] for f in ref).count("lock-order") == 4
    assert sorted(f["rule"] for f in ref).count("wire-schema") == 3


# ---- the gate -----------------------------------------------------------------


def test_port_tree_is_clean():
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "tpuraft_torch.analysis"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graftcheck:" in proc.stderr and "clean" in proc.stderr
    assert time.monotonic() - t0 < 120


def test_every_port_waiver_has_a_reason():
    mods, _ = load_modules([os.path.join(REPO, "tpuraft_torch")])
    waivers = [(m.rel, w) for m in mods for w in m.waivers]
    assert all(w.reason for _, w in waivers)
    # the tick path's designed copies: the engine's, the plane's, the
    # deadline fold's results and the tick's clock
    sync = sorted(rel for rel, w in waivers if w.rule == "host-sync")
    assert sync == ["tpuraft_torch/core/engine.py",
                    "tpuraft_torch/ops/tick.py",
                    "tpuraft_torch/parallel/mesh.py",
                    "tpuraft_torch/parallel/replica_plane.py"]
