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
]
# Modules written for the port (no original to track byte for byte).
WRITTEN = [
    "__init__.py", "core/__init__.py", "ops/__init__.py",
    "ops/ballot.py", "ops/quorum_cuda.py", "ops/tick.py",
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
    may differ: TickOptions, the unported storage URI branches, the two
    lazy imports of unported modules in node.py, and the engine's device
    half."""
    tree = ast.parse(src)
    if rel == "core/engine.py":
        return _engine_spans(tree)
    out = []
    for node in ast.walk(tree):
        if rel == "options.py" and isinstance(node, ast.ClassDef) \
                and node.name == "TickOptions":
            out.append((node.lineno - 1, node.end_lineno))
        if isinstance(node, ast.If):
            test = ast.unparse(node.test)
            body = ast.unparse(ast.Module(body=node.body, type_ignores=[]))
            if rel == "storage/log_storage.py" and (
                    "'native://'" in test or "'multilog://'" in test):
                # the branch body, comments included (not its `if` line)
                out.append((node.lineno, node.body[-1].end_lineno))
            if rel == "core/node.py" and (
                    "storage.meta_multilog" in body and "'multimeta://'"
                    in test or "core.snapshot_executor" in body):
                lazy = [s for s in node.body
                        if isinstance(s, ast.ImportFrom)]
                out.append((lazy[0].lineno - 1, node.body[-1].end_lineno))
    return out


def test_copy_list_covers_the_package():
    found = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))
    assert found == sorted(COPIES + WRITTEN)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    orig = _rename((ORIG / rel).read_text()).splitlines()
    copy = (PORT / rel).read_text().splitlines()
    spans = _spans("\n".join(orig), rel)
    expected = {"options.py": 1, "storage/log_storage.py": 2,
                "core/node.py": 2, "core/engine.py": 10}.get(rel, 0)
    assert len(spans) == expected, spans
    for tag, i1, i2, _, _ in difflib.SequenceMatcher(
            None, orig, copy, autojunk=False).get_opcodes():
        if tag == "equal":
            continue
        assert any(a <= i1 and i2 <= b and (i1 < b or i1 == i2 == b)
                   for a, b in spans), (
            f"{rel}: copy differs from the original at lines "
            f"{i1 + 1}-{i2}:\n" + "\n".join(orig[i1:i2]))
    if rel in ("storage/log_storage.py", "core/node.py"):
        # the unported branches fail loudly instead of importing modules
        # the port lacks
        assert "\n".join(copy).count("raise NotImplementedError(") == 2


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
     ROOT / "bench_torch_tick.py"], key=str),
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
