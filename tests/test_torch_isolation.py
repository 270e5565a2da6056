"""tpuraft_torch stands alone: it imports neither jax nor anything of
tpuraft, and its copies of tpuraft's host modules do not drift from
their originals except where the port must differ."""

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
]
# Copies whose original lies outside the JAX package.
ORIGINALS = {"examples/rheakv_server.py": ROOT / "examples/rheakv_server.py"}
# Modules written for the port (no original to track byte for byte).
WRITTEN = [
    "__init__.py", "core/__init__.py", "ops/__init__.py",
    "ops/ballot.py", "ops/quorum_cuda.py", "ops/tick.py",
    "examples/__init__.py",
]


def _rename(src: str) -> str:
    """The one mechanical edit of a copy: tpuraft -> tpuraft_torch in
    import statements."""
    src = re.sub(r"(?m)^(\s*)from tpuraft([. ])", r"\1from tpuraft_torch\2",
                 src)
    return re.sub(r"(?m)^(\s*)import tpuraft([. ]|$)",
                  r"\1import tpuraft_torch\2", src)


# core/engine.py: the device half, which the port rewrites for torch.
_ENGINE_DEVICE_METHODS = ("_resolve_backend", "start", "shutdown",
                          "_device_tick")


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


def _spans(src: str, rel: str) -> list[tuple[int, int]]:
    """0-based [start, end) line spans of the original where the copy
    may differ: TickOptions, the unported storage URI branches, the lazy
    import of the unported shared meta journal in node.py, the native KV
    engine and the multilog scheme of the store, the server's import
    block (it carries make_regions in) and its native branches, and the
    engine's device half."""
    tree = ast.parse(src)
    if rel == "core/engine.py":
        return _engine_spans(tree)
    out = []
    if rel == "rheakv/__init__.py":
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == "create_raw_kv_store")
        assert "native_store" in ast.unparse(fn.body[1])
        out.append((fn.body[1].lineno - 1, fn.end_lineno))
    if rel == "examples/rheakv_server.py":
        # the original imports make_regions from examples/rheakv_bench.py,
        # which loads the JAX package; the copy defines it here instead
        imports = [n for n in tree.body
                   if isinstance(n, (ast.Import, ast.ImportFrom))]
        derive = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                      and n.name == "derive_regions")
        out.append((imports[0].lineno - 1, derive.lineno - 1))
    for node in ast.walk(tree):
        if rel == "options.py" and isinstance(node, ast.ClassDef) \
                and node.name == "TickOptions":
            out.append((node.lineno - 1, node.end_lineno))
        if isinstance(node, ast.If):
            test = ast.unparse(node.test)
            body = ast.unparse(ast.Module(body=node.body, type_ignores=[]))
            if (rel == "storage/log_storage.py" and (
                    "'native://'" in test or "'multilog://'" in test)) or (
                    rel == "rheakv/store_engine.py"
                    and test == "self.opts.log_scheme == 'multilog'") or (
                    rel == "examples/rheakv_server.py"
                    and test.endswith("_kind == 'native'")):
                # the branch body, comments included (not its `if` line)
                out.append((node.lineno, node.body[-1].end_lineno))
            if rel == "core/node.py" and (
                    "storage.meta_multilog" in body and "'multimeta://'"
                    in test):
                lazy = [s for s in node.body
                        if isinstance(s, ast.ImportFrom)]
                out.append((lazy[0].lineno - 1, node.body[-1].end_lineno))
    return out


def test_copy_list_covers_the_package():
    found = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))
    assert found == sorted(COPIES + WRITTEN)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    orig = _rename(ORIGINALS.get(rel, ORIG / rel).read_text()).splitlines()
    copy = (PORT / rel).read_text().splitlines()
    spans = _spans("\n".join(orig), rel)
    expected = {"options.py": 1, "storage/log_storage.py": 2,
                "core/node.py": 1, "core/engine.py": 10,
                "rheakv/__init__.py": 1, "rheakv/store_engine.py": 1,
                "examples/rheakv_server.py": 3}.get(rel, 0)
    assert len(spans) == expected, spans
    for tag, i1, i2, _, _ in difflib.SequenceMatcher(
            None, orig, copy, autojunk=False).get_opcodes():
        if tag == "equal":
            continue
        assert any(a <= i1 and i2 <= b and (i1 < b or i1 == i2 == b)
                   for a, b in spans), (
            f"{rel}: copy differs from the original at lines "
            f"{i1 + 1}-{i2}:\n" + "\n".join(orig[i1:i2]))
    unported = {"storage/log_storage.py": 2, "core/node.py": 1,
                "rheakv/__init__.py": 1, "rheakv/store_engine.py": 1,
                "examples/rheakv_server.py": 2}
    if rel in unported:
        # the unported branches fail loudly instead of importing modules
        # the port lacks
        assert "\n".join(copy).count("raise NotImplementedError(") \
            == unported[rel]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
     ROOT / "bench_torch_tick.py", ROOT / "bench_torch_kv.py"], key=str),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpuraft_imports_in_source(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpuraft"), f"{path}: {mod}"


def test_every_module_imports_without_jax_or_tpuraft():
    """Walk and import the whole port in a fresh interpreter where jax
    is absent and any tpuraft import is refused."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        sys.modules["jax"] = None

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "tpuraft" or name.startswith("tpuraft."):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import tpuraft_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpuraft_torch.__path__, "tpuraft_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("tpuraft", "jax", "jaxlib")
               and sys.modules[m] is not None]
        assert not bad, bad
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= len(COPIES) + len(WRITTEN) - 1
