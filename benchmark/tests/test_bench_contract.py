"""The harness keeps to its interface: what it loads, what it prints,
and what it finds by name."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import run as run_mod
from benchmark.core import spec as spec_mod
from benchmark.tests import tiny

BENCH = spec_mod.BENCH_DIR
ROOT = spec_mod.ROOT


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        for name in _imports(path):
            assert name.split(".")[0] not in run_mod.FORBIDDEN, (path, name)


def test_the_references_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                assert name.split(".")[0] not in ("tpuraft_torch", "torch"), \
                    (f, name)


def test_a_run_loads_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests import tiny\n"
            "from benchmark import run\n"
            "out, _ = tiny.run(tiny.cell('plane.g64k.zipf'), seconds=0.3)\n"
            "assert out['correct']\n"
            "print(run.forbidden_modules())\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_every_name_resolves_to_its_files():
    spec = spec_mod.load_spec()
    for w in spec["workloads"]:
        cell = spec_mod.resolve(spec, w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        spec_mod.runner(cell.config)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec_mod.reader(m["name"]))
    for m in spec["per_layer"]:
        for w in m.get("workloads", ()):
            cell = spec_mod.resolve(spec, w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_required_keys(trace):
    out, _ = tiny.run(tiny.cell("plane.g64k.uniform"), seconds=0.3,
                      trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(out) == keys + ["checks"]
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        dev |= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["device"]) == dev
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_without_a_card_a_run_prints_no_result():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "plane.g64k.uniform", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_in_a_bare_directory_a_run_prints_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "plane.g64k.zipf",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "plane.g64k.uniform", "--seed", str(2**33 + 1), "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
