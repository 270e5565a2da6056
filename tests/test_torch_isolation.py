"""tpuraft_torch stands alone: it imports neither jax nor anything of
tpuraft or of the top-level examples package, and its copies of their
modules do not drift from their originals except where the port must
differ."""

import ast
import difflib
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT, ORIG = ROOT / "tpuraft_torch", ROOT / "tpuraft"

# Host modules carried over as copies: byte for byte the original after
# the import rename, apart from the spans that _spans() allows.
COPIES = [
    "entity.py", "errors.py", "conf.py", "options.py",
    "util/__init__.py", "util/quorum.py", "util/clock.py", "util/trace.py",
    "util/metrics.py", "util/timer.py", "util/describer.py",
    "util/health.py",
    "rpc/__init__.py", "rpc/messages.py", "rpc/transport.py",
    "storage/__init__.py", "storage/log_storage.py",
    "storage/meta_storage.py", "storage/log_manager.py",
    "core/state_machine.py", "core/ballot_box.py", "core/fsm_caller.py",
    "core/replicator.py", "core/send_plane.py", "core/heartbeat_hub.py",
    "core/read_only.py", "core/node.py", "core/node_manager.py",
    "core/engine.py",
    "storage/snapshot.py", "core/snapshot_executor.py",
    "rpc/cli_messages.py", "core/cli_service.py",
    "core/raft_group_service.py", "core/append_batcher.py", "core/lanes.py",
    "util/heat.py", "util/metrics_http.py", "rpc/tcp.py",
    "rheakv/metadata.py", "rheakv/kv_operation.py", "rheakv/raw_store.py",
    "rheakv/state_machine.py", "rheakv/raft_store.py",
    "rheakv/region_engine.py", "rheakv/region_route_table.py",
    "rheakv/kv_service.py", "rheakv/pd_messages.py", "rheakv/pd_client.py",
    "rheakv/store_engine.py", "rheakv/client.py", "rheakv/__init__.py",
    "util/linearizability.py",
    "examples/rheakv_server.py",
    "util/native_build.py", "storage/native_log.py", "storage/multilog.py",
    "storage/meta_multilog.py", "rheakv/native_store.py",
    "util/nemesis.py", "rpc/topology.py", "examples/soak.py",
    "rpc/native_tcp.py", "rpc/fault.py", "route_table.py",
    "rheakv/keyspace.py", "rheakv/placement.py", "rheakv/pd_server.py",
    "examples/pd_server.py",
    "storage/fault.py", "config.py", "examples/rheakv_bench.py",
    "examples/counter.py", "examples/election.py", "examples/admin.py",
    "examples/proc_supervisor.py",
    "parallel/replica_plane.py", "parallel/replica_cluster.py",
    "examples/replica_plane.py",
    "analysis/__init__.py", "analysis/__main__.py",
    "analysis/blocking_calls.py", "analysis/callgraph.py",
    "analysis/concurrency.py", "analysis/core.py",
    "analysis/future_leaks.py", "analysis/guarded_by.py",
    "analysis/lanes.py", "analysis/lock_order.py", "analysis/raw_clock.py",
    "analysis/wire_schema.py",
]
# Copies whose original lies outside the JAX package: the top-level
# examples package.
ORIGINALS = {rel: ROOT / rel for rel in COPIES if rel.startswith("examples/")}
# Copies that are not Python: byte for byte their originals.
DATA = ["examples/counter.yaml", "analysis/lock_order.json"]
# The C++ sources of the native engines: the port builds its own copy.
NATIVE = sorted(subprocess.run(
    ["git", "ls-files", "native"], cwd=ROOT, capture_output=True,
    text=True, check=True).stdout.split())
# Modules written for the port (no original to track byte for byte).
WRITTEN = [
    "__init__.py", "core/__init__.py", "ops/__init__.py",
    "ops/ballot.py", "ops/quorum_cuda.py", "ops/tick.py",
    "ops/deadline_fold.py",
    "examples/__init__.py",
    "parallel/__init__.py", "parallel/collective.py", "parallel/mesh.py",
    "graft_entry.py", "device_plane.py",
]


def _rename(src: str) -> str:
    """The one mechanical edit of a copy: tpuraft -> tpuraft_torch in
    import statements, and the top-level examples package ->
    tpuraft_torch.examples in imports and in the ``-m`` argument of a
    child's command line."""
    src = re.sub(r"(?m)^(\s*)from tpuraft([. ])", r"\1from tpuraft_torch\2",
                 src)
    src = re.sub(r"(?m)^(\s*)import tpuraft([. ]|$)",
                 r"\1import tpuraft_torch\2", src)
    src = re.sub(r"(?m)^(\s*)from examples\.",
                 r"\1from tpuraft_torch.examples.", src)
    return src.replace('"-m", "examples.', '"-m", "tpuraft_torch.examples.')


# core/engine.py: the device half, which the port rewrites for torch;
# _resolve_mesh is the port's own (it goes in after _resolve_backend).
_ENGINE_DEVICE_METHODS = ("_resolve_backend", "_resolve_mesh", "start",
                          "shutdown", "_device_tick")


def _engine_spans(tree: ast.Module) -> list[tuple[int, int]]:
    """The device half of core/engine.py: the module docstring, the
    numpy outputs twin (the torch tick's staging goes in after it), the
    tick-function attributes, the device methods, the mesh fold of
    _next_deadline, the tick dispatch of tick_once and the docstring of
    _np_tick.  The host half around them stays the original's."""
    out = [(0, tree.body[0].end_lineno)]
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "_NpOutputs":
            out.append((node.lineno - 1, node.end_lineno))
    eng = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "MultiRaftEngine")
    for fn in eng.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in _ENGINE_DEVICE_METHODS:
            out.append((fn.lineno - 1, fn.end_lineno))
        elif fn.name == "__init__":
            attrs = [s for s in fn.body if isinstance(s, ast.Assign)
                     and ast.unparse(s.targets[0]) in (
                         "self._tick_fn", "self._deadline_fold",
                         "self._params_dev")]
            out.append((attrs[0].lineno - 1, attrs[-1].end_lineno))
        elif fn.name == "_next_deadline":
            fold = fn.body[1]
            assert "_deadline_fold" in ast.unparse(fold.test)
            out.append((fn.body[0].lineno - 1, fold.end_lineno))
        elif fn.name == "tick_once":
            out += [(s.lineno - 1, s.end_lineno) for s in fn.body
                    if isinstance(s, ast.If)
                    and "_tick_fn" in ast.unparse(s.test)]
        elif fn.name == "_np_tick":
            out.append((fn.body[0].lineno - 1, fn.body[0].end_lineno))
    return out


def _soak_spans(tree: ast.Module) -> list[tuple[int, int]]:
    """examples/soak.py: the ``device`` keyword (run_soak's,
    run_lifecycle_soak's and SoakCluster.__init__'s signatures, the
    attribute it sets, the SoakCluster calls that pass it on and the
    TickOptions that takes it), run_lifecycle_soak's wait for the
    initial regions, which the port ends when the PD's regions tile the
    keyspace (the original's count races the PD's cold merges), and its
    PD with the import that names ClusterStatsManager: the port never
    merges the fleet under the hot detector's ``hot_min_population``
    (the original's floor, half the regions, is 6 at 12, where no region
    can be flagged hot, so a hotspot that heats after the merges never
    splits)."""
    fns = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    cluster = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "SoakCluster")
    init = next(n for n in cluster.body if isinstance(n, ast.FunctionDef)
                and n.name == "__init__")
    out = [(fn.lineno - 1, fn.body[0].lineno - 1)
           for fn in (fns["run_soak"], fns["run_lifecycle_soak"], init)]
    out += [(s.lineno - 1, s.end_lineno) for s in init.body
            if ast.unparse(s) == "self.engine = engine"]
    for scope, call in ((fns["run_soak"], "SoakCluster("),
                        (fns["run_lifecycle_soak"], "SoakCluster("),
                        (cluster, "MultiRaftEngine(")):
        out += [(n.lineno - 1, n.end_lineno) for n in ast.walk(scope)
                if isinstance(n, ast.Assign)
                and ast.unparse(n.value).startswith(call)]
    out += [(n.lineno - 1, n.end_lineno)
            for n in ast.walk(fns["run_lifecycle_soak"])
            if isinstance(n, ast.While)
            and "PD never learned" in ast.unparse(n)]
    life = fns["run_lifecycle_soak"].body
    out += [_stmt(life, "from tpuraft_torch.rheakv.pd_server import"),
            _stmt(life, "pd = PlacementDriverServer(")]
    return out


def _pd_spans(tree: ast.Module) -> list[tuple[int, int]]:
    """rheakv/pd_server.py: the PD's merge pick, which the port holds
    under one lock until its pending pair is replicated (the original
    picks during another heartbeat batch's replication, without that
    pair in its floor count, and merges the fleet under its floor), the
    lock in ``__init__`` and the import that makes it."""
    d = _defs(tree)
    life = d["PlacementDriverServer._lifecycle_pass"].body
    pick = _stmt(life, "pick = placement.pick_merge(")
    merge = _stmt(life, "if pick is not None:")
    return [_stmt(tree.body, "import logging"),
            _stmt(d["PlacementDriverServer.__init__"].body,
                  "self._group: Optional[RaftGroupService] = None"),
            (pick[0], merge[1])]


def _stmt(body, prefix: str) -> tuple[int, int]:
    """The span of the one statement of ``body`` whose source starts
    with ``prefix``."""
    hits = [s for s in body if ast.unparse(s).startswith(prefix)]
    assert len(hits) == 1, (prefix, len(hits))
    return hits[0].lineno - 1, hits[0].end_lineno


def _defs(tree) -> dict:
    """Top-level functions and classes, and the methods of each class
    as ``Class.method``."""
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out[n.name] = n
        if isinstance(n, ast.ClassDef):
            out.update({f"{n.name}.{m.name}": m for m in n.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))})
    return out


def _signature(fn) -> tuple[int, int]:
    return fn.lineno - 1, fn.body[0].lineno - 1


def _replica_spans(tree, rel: str, n_lines: int) -> list[tuple[int, int]]:
    """The replica plane: ``mesh=`` becomes ``device=``/``backend=``
    (the constructors, the plane's start, its tick's device branch and
    describe, the example's CLI and JSON line); the example's
    ``build_mesh`` goes."""
    d = _defs(tree)
    if rel == "parallel/replica_plane.py":
        init = d["ReplicatedClusterPlane.__init__"]
        return [_signature(init), _stmt(init.body, "self.mesh ="),
                _stmt(d["ReplicatedClusterPlane.start"].body, "if "),
                _stmt(d["ReplicatedClusterPlane.tick_once"].body,
                      "if self._fn is not None"),
                _stmt(d["ReplicatedClusterPlane.describe"].body, "return")]
    if rel == "parallel/replica_cluster.py":
        cls, init = d["ReplicaPlaneCluster"], d["ReplicaPlaneCluster.__init__"]
        return [_stmt(cls.body, "'R replica endpoints"), _signature(init),
                _stmt(init.body, "self.plane =")]
    main, run = d["main"], tree.body[-1].body  # the __main__ block
    return [(0, tree.body[0].end_lineno),
            (d["build_mesh"].lineno - 1, d["main"].lineno - 1),
            (_stmt(main.body, "mesh = None")[0],
             _stmt(main.body, "c = ReplicaPlaneCluster(")[1]),
            (lambda body: _stmt(body, "print(json.dumps("))(
                next(s for s in main.body if isinstance(s, ast.Try)).body),
            (_stmt(run, "ap.add_argument('--mesh',")[0],
             _stmt(run, "ap.add_argument('--mesh-groups-axis'")[1])]


def _analysis_spans(tree, rel: str, n_lines: int) -> list[tuple[int, int]]:
    """The analysis tool: the port's default root and package prefix,
    its tick plane (``ops/`` and ``parallel/collective.py``), the
    clock-disciplined tree, the sanction list of inherited findings,
    and in lanes.py the torch host-sync rule in place of the jit-based
    host-sync and donated-read rules."""
    d = _defs(tree)
    if rel == "analysis/__main__.py":
        body = d["main"].body
        return [_stmt(body, "ap = argparse.ArgumentParser("),
                _stmt(body, "ap.add_argument('paths'"),
                _stmt(body, "roots =")]
    if rel == "analysis/lock_order.py":
        return [_stmt(d["_module_tag"].body, "if rel.startswith(")]
    if rel == "analysis/blocking_calls.py":
        loop = next(s for s in d["check"].body if isinstance(s, ast.For))
        return [(0, tree.body[0].end_lineno),
                _stmt(loop.body, "tick_plane ="),
                _stmt(d["_scan_module"].body, "why_module =")]
    if rel == "analysis/concurrency.py":
        loop = next(s for s in d["check"].body if isinstance(s, ast.For))
        inner = next(s for s in loop.body if isinstance(s, ast.Assign)
                     and ast.unparse(s).startswith("tick_plane ="))
        return [(inner.lineno - 1, inner.end_lineno),
                _stmt(d["_check_function"].body, "if tick_plane:")]
    if rel == "analysis/raw_clock.py":
        return [(_stmt(tree.body, "_SCOPES =")[0],
                 _stmt(tree.body, "_SCOPE_FILES =")[1])]
    if rel == "analysis/core.py":
        run = d["run_checkers"]
        return [_stmt(run.body, "findings = [f for f in findings if f.rule "
                                "== 'waiver'"),
                (tree.body[-1].lineno - 1, n_lines)]
    if rel == "analysis/lanes.py":
        return [(0, tree.body[0].end_lineno),
                _stmt(tree.body, "from tpuraft_torch.analysis.callgraph"),
                (d["check"].lineno - 1, d["check"].end_lineno),
                (d["_check_state_parity"].end_lineno, n_lines)]
    return []


def _spans(src: str, rel: str) -> list[tuple[int, int]]:
    """0-based [start, end) line spans of the original where the copy
    may differ: TickOptions, the directory the native loaders build in,
    the directory the supervisor starts its children in, the soak's
    device keyword and the engine's device half."""
    tree = ast.parse(src)
    n_lines = len(src.splitlines())
    if rel in ("parallel/replica_plane.py", "parallel/replica_cluster.py",
               "examples/replica_plane.py"):
        return _replica_spans(tree, rel, n_lines)
    if rel.startswith("analysis/"):
        return _analysis_spans(tree, rel, n_lines)
    if rel == "core/engine.py":
        return _engine_spans(tree)
    if rel == "examples/soak.py":
        return _soak_spans(tree)
    if rel == "rheakv/pd_server.py":
        return _pd_spans(tree)
    out = []
    if rel in ("storage/native_log.py", "storage/multilog.py",
               "rheakv/native_store.py", "rpc/native_tcp.py"):
        # the port builds and loads tpuraft_torch/native, not native/
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == "_native_dir")
        out.append((fn.lineno - 1, fn.end_lineno))
    if rel == "examples/proc_supervisor.py":
        # the children start in the checkout's root, where both packages
        # import: one directory up from examples/, two from the copy's
        # tpuraft_torch/examples/
        proc = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                    and n.name == "StoreProcess")
        spawn = next(n for n in proc.body if isinstance(n, ast.FunctionDef)
                     and n.name == "spawn")
        out += [(s.lineno - 1, s.end_lineno) for s in spawn.body
                if isinstance(s, ast.Assign)
                and ast.unparse(s.targets[0]) == "self.proc"]
    for node in ast.walk(tree):
        if rel == "options.py" and isinstance(node, ast.ClassDef) \
                and node.name == "TickOptions":
            out.append((node.lineno - 1, node.end_lineno))
    return out


def test_copy_list_covers_the_package():
    found = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))
    assert found == sorted(COPIES + WRITTEN)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    orig = _rename(ORIGINALS.get(rel, ORIG / rel).read_text()).splitlines()
    copy = (PORT / rel).read_text().splitlines()
    spans = _spans("\n".join(orig), rel)
    expected = {"options.py": 1, "core/engine.py": 10,
                "storage/native_log.py": 1, "storage/multilog.py": 1,
                "rheakv/native_store.py": 1, "rpc/native_tcp.py": 1,
                "examples/proc_supervisor.py": 1,
                "examples/soak.py": 10, "rheakv/pd_server.py": 3,
                "parallel/replica_plane.py": 5,
                "parallel/replica_cluster.py": 3,
                "examples/replica_plane.py": 5,
                "analysis/__main__.py": 3, "analysis/lock_order.py": 1,
                "analysis/blocking_calls.py": 3,
                "analysis/concurrency.py": 2, "analysis/raw_clock.py": 1,
                "analysis/core.py": 2, "analysis/lanes.py": 4}.get(rel, 0)
    assert len(spans) == expected, spans
    for tag, i1, i2, _, _ in difflib.SequenceMatcher(
            None, orig, copy, autojunk=False).get_opcodes():
        if tag == "equal":
            continue
        assert any(a <= i1 and i2 <= b and (i1 < b or i1 == i2 == b)
                   for a, b in spans), (
            f"{rel}: copy differs from the original at lines "
            f"{i1 + 1}-{i2}:\n" + "\n".join(orig[i1:i2]))
    if rel in ("examples/rheakv_server.py", "examples/pd_server.py"):
        # the servers' native transport is the port's own module, byte
        # for byte the original's branch
        assert "from tpuraft_torch.rpc.native_tcp import NativeTcpRpcServer" \
            " as Server" in "\n".join(copy)


@pytest.mark.parametrize("rel", DATA)
def test_data_copy_matches_original(rel):
    orig = ROOT / rel if rel.startswith("examples/") else ORIG / rel
    assert (PORT / rel).read_bytes() == orig.read_bytes()


@pytest.mark.parametrize("name", NATIVE)
def test_native_source_matches_original(name):
    """The port builds its native engines from its own copy of the C++
    sources, byte for byte the JAX package's."""
    rel = Path(name).name
    assert (PORT / "native" / rel).read_bytes() == \
        (ROOT / name).read_bytes()


def test_native_copy_is_complete():
    ours = sorted(p.name for p in (PORT / "native").iterdir()
                  if p.suffix in (".cc", ".h") or p.name == "Makefile")
    assert ours == sorted(Path(n).name for n in NATIVE)


def test_no_a6_refusal_remains():
    for path in PORT.rglob("*.py"):
        assert "ROADMAP A6" not in path.read_text(), path


def test_no_a9_refusal_remains():
    for path in PORT.rglob("*.py"):
        assert "ROADMAP A9" not in path.read_text(), path


def test_no_a7_refusal_remains():
    for path in PORT.rglob("*.py"):
        assert "ROADMAP A7" not in path.read_text(), path


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
     *ROOT.glob("bench_torch_*.py"), *ROOT.glob("probe_torch_*.py"),
     *ROOT.glob("profile_torch_*.py")],
    key=str),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpuraft_imports_in_source(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpuraft", "examples"), \
            f"{path}: {mod}"
        # nor a root script of the JAX package (bench.py, bench_*.py,
        # __graft_entry__.py): the port's scripts import only their own
        assert not (top in ("bench", "__graft_entry__")
                    or (top.startswith("bench_")
                        and not top.startswith("bench_torch_"))), \
            f"{path}: {mod}"


def test_every_port_root_script_is_held_to_the_import_rule():
    """The rule above reads every ``bench_torch_*.py`` by its glob: the
    gate and each bench script it starts are among them."""
    scripts = {p.name for p in ROOT.glob("bench_torch_*.py")}
    assert {"bench_torch_gate.py", "bench_torch_e2e.py",
            "bench_torch_region_density.py", "bench_torch_multiproc.py",
            "bench_torch_multichip.py"} <= scripts


def test_every_module_imports_without_jax_or_tpuraft():
    """Walk and import the whole port in a fresh interpreter where jax
    is absent and any tpuraft or top-level examples import is
    refused."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        sys.modules["jax"] = None

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("tpuraft", "examples"):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import tpuraft_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpuraft_torch.__path__, "tpuraft_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("tpuraft", "examples", "jax", "jaxlib")
               and sys.modules[m] is not None]
        assert not bad, bad
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= len(COPIES) + len(WRITTEN) - 1
