"""Checker 2: lock-order cycle detection.

Derives the static lock-acquisition graph: an edge A -> B means some
code path acquires B while (lexically) holding A — from nested ``with``
blocks, plus ONE level of intra-module call resolution (while holding A,
``self.m(...)`` / ``m(...)`` resolves to a same-module function whose
body acquires B at its top level).  Deadlock needs a cycle; the graph
must therefore stay acyclic, and every edge must be pre-sanctioned in
the committed partial order (``lock_order.json``) so a NEW nesting gets
human review before it can ship:

    python -m tpuraft.analysis --record   # after review

Lock identification is lexical: a ``with`` item whose expression chain
contains ``lock``, ``guard`` or ``mutex`` (case-insensitive) is an
acquisition.  Names are canonicalized module-locally:

    self._lock inside class C of storage/multilog.py
        -> storage/multilog.C._lock
    module-global _paths_guard -> storage/meta_storage._paths_guard
    _path_lock(path)           -> storage/meta_storage._path_lock()

All instances of a class share one node — the per-object distinction
("different BallotBox instances") is deliberately collapsed: two
instances of the same class CAN deadlock against each other through the
same code path, and the conservative collapse is what makes that
visible.  Self-edges are skipped: re-entry is either an RLock (legal) or
a self-deadlock the guarded-by discipline already prevents via its
``holds`` call-site rule.
"""

from __future__ import annotations

import ast
import json
import os
import re

from tpuraft_torch.analysis.core import Finding, Module, attr_chain, repo_root

RULE = "lock-order"
LOCK_FILE = "lock_order.json"

_LOCKISH = re.compile(r"lock|guard|mutex", re.IGNORECASE)


def lock_file_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), LOCK_FILE)


def _module_tag(mod: Module) -> str:
    rel = mod.rel
    if rel.startswith("tpuraft_torch" + os.sep):
        rel = rel[len("tpuraft_torch" + os.sep):]
    return rel[:-3] if rel.endswith(".py") else rel


def _lock_id(mod: Module, cls_name: str | None, expr: ast.AST) -> str | None:
    """Canonical node name for a with-item, or None if not lock-ish."""
    tag = _module_tag(mod)
    if isinstance(expr, ast.Call):
        chain = attr_chain(expr.func)
        if chain and _LOCKISH.search(chain):
            return f"{tag}.{chain}()"
        return None
    chain = attr_chain(expr)
    if not chain or not _LOCKISH.search(chain):
        return None
    if chain.startswith("self.") and cls_name:
        return f"{tag}.{cls_name}.{chain[len('self.'):]}"
    return f"{tag}.{chain}"


class _ModuleGraph:
    """Acquisition facts for one module."""

    def __init__(self, mod: Module):
        self.mod = mod
        # function key -> locks acquired anywhere in its body (for one
        # level of call resolution), and edges observed lexically.
        # Key: ("C", "m") for methods, (None, "f") for module functions.
        self.acquires: dict[tuple, set[str]] = {}
        self.calls_under: list[tuple[str, tuple, int]] = []  # (held, callee_key, line)
        self.edges: dict[tuple[str, str], int] = {}  # (a, b) -> first line
        # method name -> class names defining it; class name -> True
        self.method_owners: dict[str, list[str]] = {}
        self.class_methods_by_class: dict[str, bool] = {}
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                self.class_methods_by_class[node.name] = True
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.method_owners.setdefault(
                            item.name, []).append(node.name)
        self._scan()

    def _scan(self) -> None:
        def scan_fn(fn, cls_name: str | None) -> None:
            key = (cls_name, fn.name)
            acquired: set[str] = set()

            def visit(node, held: tuple[str, ...]) -> None:
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    new = []
                    for item in node.items:
                        lid = _lock_id(self.mod, cls_name, item.context_expr)
                        if lid:
                            for h in held + tuple(new):
                                if h != lid:
                                    self.edges.setdefault(
                                        (h, lid), node.lineno)
                            new.append(lid)
                            acquired.add(lid)
                    inner = held + tuple(new)
                    for child in node.body:
                        visit(child, inner)
                    return
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    return  # closures run outside this lexical lock scope
                if isinstance(node, ast.Call) and held:
                    chain = attr_chain(node.func)
                    callee = None
                    if chain.startswith("self.") and "." not in chain[5:]:
                        callee = (cls_name, chain[5:])
                    elif chain and "." not in chain:
                        # module function, or ClassName() -> its __init__
                        callee = (None, chain)
                        if chain in self.class_methods_by_class:
                            callee = (chain, "__init__")
                    elif isinstance(node.func, ast.Attribute) \
                            and isinstance(node.func.value, ast.Name) \
                            and node.func.value.id != "self":
                        # obj.m(...) on a bare local: resolve iff exactly
                        # one class in this module defines m (e.g.
                        # j.close() under the registry lock ->
                        # MetaJournal.close).  Attribute receivers
                        # (self._f.close()) are NOT resolved: common
                        # method names collide with stdlib handles
                        owners = self.method_owners.get(node.func.attr, ())
                        if len(owners) == 1:
                            callee = (owners[0], node.func.attr)
                    if callee:
                        for h in held:
                            self.calls_under.append((h, callee, node.lineno))
                for child in ast.iter_child_nodes(node):
                    visit(child, held)

            for stmt in fn.body:
                visit(stmt, ())
            self.acquires[key] = acquired

        for node in self.mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_fn(node, None)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        scan_fn(item, node.name)

    def resolve_calls(self) -> None:
        """One level of intra-module call resolution: held-A call sites
        inherit the callee's direct acquisitions as A -> B edges."""
        for held, callee, line in self.calls_under:
            target = self.acquires.get(callee)
            if not target:
                # method name may be unique across the module's classes
                # (self.<m> on a collaborator is out of scope by design)
                continue
            for lid in target:
                if lid != held:
                    self.edges.setdefault((held, lid), line)


def derive_graph(mods: list[Module]) -> dict[tuple[str, str], tuple[str, int]]:
    """(a, b) -> (file, line) of the first observed acquisition of b
    under a."""
    out: dict[tuple[str, str], tuple[str, int]] = {}
    for mod in mods:
        g = _ModuleGraph(mod)
        g.resolve_calls()
        for (a, b), line in g.edges.items():
            out.setdefault((a, b), (mod.rel, line))
    return out


def _find_cycle(edges: set[tuple[str, str]]) -> list[str] | None:
    adj: dict[str, list[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    stack: list[str] = []

    def dfs(n: str) -> list[str] | None:
        color[n] = GREY
        stack.append(n)
        for m in adj.get(n, ()):
            c = color.get(m, WHITE)
            if c == GREY:
                return stack[stack.index(m):] + [m]
            if c == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(adj):
        if color.get(n, WHITE) == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


def load_sanctioned(path: str | None = None) -> set[tuple[str, str]]:
    path = path or lock_file_path()
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return set()
    return {(e[0], e[1]) for e in data.get("edges", [])}


def record(mods: list[Module], path: str | None = None) -> None:
    graph = derive_graph(mods)
    payload = {
        "_comment": (
            "Sanctioned lock acquisition order (graftcheck lock-order). "
            "An edge [A, B] permits acquiring B while holding A. "
            "Regenerate with `python -m tpuraft.analysis --record` after "
            "reviewing any new nesting."),
        "edges": sorted([a, b] for a, b in graph),
    }
    with open(path or lock_file_path(), "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


_record_fn = record


def check(mods: list[Module], record: bool = False,
          path: str | None = None) -> list[Finding]:
    if record:
        _record_fn(mods, path)
    graph = derive_graph(mods)
    sanctioned = load_sanctioned(path)
    out: list[Finding] = []

    cycle = _find_cycle(set(graph))
    if cycle:
        a, b = cycle[0], cycle[1]
        rel, line = graph.get((a, b), ("?", 0))
        out.append(Finding(
            RULE, rel, line,
            "lock-order cycle: " + " -> ".join(cycle)
            + " — a concurrent pair of these paths deadlocks"))

    for (a, b), (rel, line) in sorted(graph.items()):
        if (a, b) not in sanctioned:
            out.append(Finding(
                RULE, rel, line,
                f"unsanctioned lock nesting {a} -> {b}: review the "
                f"ordering against tpuraft/analysis/{LOCK_FILE} and run "
                f"`python -m tpuraft.analysis --record`"))
    return out
