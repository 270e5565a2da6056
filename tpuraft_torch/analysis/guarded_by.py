"""Checker 1: guarded-by lock discipline (+ loop-confined classes).

Annotations (trailing comment on the statement, or the line above):

  self._segments = []        # guarded-by: _lock
  self.state = ...           # guarded-by: _lock (writes)
  _path_locks: dict = {}     # guarded-by: _paths_guard   (module global)

A field annotated ``guarded-by: <lock>`` may only be touched inside a
``with self.<lock>`` / ``async with self.<lock>`` block.  The
``(writes)`` variant checks mutations only — the asyncio-plane
convention (node.py): single reads on the owning event loop are safe,
multi-await critical sections must hold the lock, so every *rebind* of
protocol state goes through it.

Helper methods that are *called with the lock held* declare it:

  def _enter_error_locked(self, status):          # name suffix, or
  def _find_segment(self, index):  # graftcheck: holds(_lock)

and the call-site rule closes the loop: a ``holds``-annotated method may
only be invoked (as ``self.m(...)``) from a lock-held context — calling
``_step_down`` without the node lock is itself a finding.

Closures reset the held set: a nested ``def``/lambda runs later, outside
the lexical ``with`` (the PR 2 `FileLogStorage.shutdown` race was
exactly a "looks inside the block, runs outside it" confusion).

Classes annotated ``# graftcheck: loop-confined`` declare event-loop
confinement; reaching for ``threading`` primitives or ``time.sleep``
inside one is a finding (rule ``loop-confined``) — their state has no
lock to take, so the only legal concurrency is the loop itself.

Known limits (documented, not silently unchecked): cross-object access
(``node.conf_entry = ...`` from a collaborator) and container-interior
mutation under ``(writes)`` (``self._acks[k] = v`` reads the dict
attribute) are out of scope; the lock-order and blocking-call checkers
cover the inter-object hazards this checker cannot see.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass

from tpuraft_torch.analysis.core import (Finding, Module, attr_chain, decl_lineno,
                                   iter_classes)

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)\s*(\(writes\))?")
_HOLDS_RE = re.compile(r"#\s*graftcheck:\s*holds\((\w+)\)")
_LOOP_CONFINED_RE = re.compile(r"#\s*graftcheck:\s*loop-confined")

RULE = "guarded-by"
RULE_LOOP = "loop-confined"


@dataclass
class _Field:
    name: str
    lock: str          # attribute name relative to self ('' prefix) or global
    writes_only: bool
    line: int


def check(mods: list[Module]) -> list[Finding]:
    out: list[Finding] = []
    for mod in mods:
        out.extend(_check_module_globals(mod))
        for cls in iter_classes(mod):
            out.extend(_check_class(mod, cls))
    return out


# ---- class fields -----------------------------------------------------------


def _collect_fields(mod: Module, cls) -> dict[str, _Field]:
    fields: dict[str, _Field] = {}

    def note(target: ast.AST, line: int) -> None:
        m = _GUARDED_RE.search(mod.comment_at_or_above(line))
        if not m:
            return
        name = None
        if isinstance(target, ast.Attribute) and isinstance(
                target.value, ast.Name) and target.value.id == "self":
            name = target.attr
        elif isinstance(target, ast.Name):
            name = target.id
        if name:
            fields[name] = _Field(name, m.group(1), bool(m.group(2)), line)

    init = cls.methods.get("__init__")
    bodies = list(cls.node.body) + (list(ast.walk(init)) if init else [])
    for node in bodies:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                note(t, node.lineno)
        elif isinstance(node, ast.AnnAssign):
            note(node.target, node.lineno)
    return fields


def _holds_locks(mod: Module, cls, fields) -> dict[str, set[str]]:
    """method name -> set of lock names the caller must hold."""
    class_locks = {f.lock for f in fields.values()}
    holds: dict[str, set[str]] = {}
    for name, fn in cls.methods.items():
        locks = set()
        for m in _HOLDS_RE.finditer(mod.comment_at_or_above(fn.lineno)):
            locks.add(m.group(1))
        # the bare name suffix is only unambiguous when the class guards
        # everything with ONE lock; with several, the suffix can't say
        # WHICH is held (granting all of them both over-demands at call
        # sites and over-grants in the body) — annotate explicitly
        if name.endswith("_locked") and len(class_locks) == 1:
            locks |= class_locks
        if locks:
            holds[name] = locks
    return holds


def _with_locks(node: ast.With | ast.AsyncWith) -> set[str]:
    """Lock names acquired by this with-statement, as dotted chains
    ('self._lock', 'G')."""
    acquired = set()
    for item in node.items:
        chain = attr_chain(item.context_expr)
        if chain:
            acquired.add(chain)
    return acquired


def _check_class(mod: Module, cls) -> list[Finding]:
    out: list[Finding] = []
    fields = _collect_fields(mod, cls)
    holds = _holds_locks(mod, cls, fields)
    loop_confined = bool(
        _LOOP_CONFINED_RE.search(
            mod.comment_block_above(decl_lineno(cls.node)))
        or (cls.node.body and isinstance(cls.node.body[0], ast.Expr)
            and isinstance(cls.node.body[0].value, ast.Constant)
            and isinstance(cls.node.body[0].value.value, str)
            and "graftcheck: loop-confined" in cls.node.body[0].value.value))

    for name, fn in cls.methods.items():
        if loop_confined:
            # __init__ included: construction predates SHARING (which is
            # why guarded-by exempts it below) but a constructor that
            # spawns threads or sleeps is no less a confinement breach
            out.extend(_scan_loop_confined(mod, fn))
        if name == "__init__":
            continue
        held0 = {f"self.{lk}" for lk in holds.get(name, ())}
        out.extend(_scan_body(mod, cls, fn, fields, holds, held0))
    return out


def _scan_body(mod: Module, cls, fn, fields, holds,
               held: set[str]) -> list[Finding]:
    out: list[Finding] = []

    def visit(node: ast.AST, held: frozenset[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held | _with_locks(node)
            for item in node.items:
                visit(item.context_expr, held)
            for child in node.body:
                visit(child, frozenset(inner))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a closure runs later, outside the lexical lock scope
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                visit(child, frozenset())
            return
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id == "self":
            f = fields.get(node.attr)
            if f is not None:
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                if (is_write or not f.writes_only) \
                        and f"self.{f.lock}" not in held:
                    kind = "written" if is_write else "read"
                    out.append(Finding(
                        RULE, mod.rel, node.lineno,
                        f"{cls.node.name}.{node.attr} is guarded-by "
                        f"{f.lock} (declared at line {f.line}) but {kind} "
                        f"in {fn.name}() without holding self.{f.lock}"))
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain.startswith("self."):
                callee = chain[len("self."):]
                need = holds.get(callee)
                if need and not {f"self.{lk}" for lk in need} <= held:
                    out.append(Finding(
                        RULE, mod.rel, node.lineno,
                        f"{cls.node.name}.{callee}() requires the caller "
                        f"to hold {', '.join(sorted(need))} (holds "
                        f"annotation) but {fn.name}() calls it without"))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn.body:
        visit(stmt, frozenset(held))
    return out


# ---- loop-confined ----------------------------------------------------------


def _scan_loop_confined(mod: Module, fn) -> list[Finding]:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain.startswith("threading."):
            out.append(Finding(
                RULE_LOOP, mod.rel, node.lineno,
                f"loop-confined class uses {chain}() in {fn.name}() — "
                f"its state has no lock; cross-thread access is a race"))
        elif chain == "time.sleep":
            out.append(Finding(
                RULE_LOOP, mod.rel, node.lineno,
                f"loop-confined class calls time.sleep() in {fn.name}() — "
                f"blocks the event loop every other group runs on"))
    return out


# ---- module-level globals ---------------------------------------------------


def _module_global_fields(mod: Module) -> dict[str, _Field]:
    fields: dict[str, _Field] = {}
    for node in mod.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                m = _GUARDED_RE.search(mod.comment_at_or_above(node.lineno))
                if m:
                    fields[t.id] = _Field(t.id, m.group(1), bool(m.group(2)),
                                          node.lineno)
    return fields


def _check_module_globals(mod: Module) -> list[Finding]:
    fields = _module_global_fields(mod)
    if not fields:
        return []
    out: list[Finding] = []

    def visit(node: ast.AST, held: frozenset[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held | _with_locks(node)
            for child in node.body:
                visit(child, frozenset(inner))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # same closure rule as the class checker: a nested def runs
            # later, outside the lexical lock scope
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                visit(child, frozenset())
            return
        if isinstance(node, ast.Name) and node.id in fields:
            f = fields[node.id]
            if node.lineno != f.line and f.lock not in held:
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                if is_write or not f.writes_only:
                    out.append(Finding(
                        RULE, mod.rel, node.lineno,
                        f"module global {node.id} is guarded-by {f.lock} "
                        f"(declared at line {f.line}) but touched without "
                        f"holding it"))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    visit_targets = [n for n in mod.tree.body
                     if not isinstance(n, (ast.Import, ast.ImportFrom))]
    for stmt in visit_targets:
        visit(stmt, frozenset())
    return out
