"""Shared graftcheck infrastructure: module loading, comment/waiver
extraction, findings, and the checker registry.

Everything here is pure stdlib (``ast`` + ``tokenize``) and import-free
with respect to the analyzed code — the whole-tree lint must stay under
~10s and must not drag jax into a lint run.  The one exception is the
wire-schema *meta-test* (tests/test_analysis.py), which imports the live
registry to prove the AST extraction faithful.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

# rule ids, in report order
RULES = (
    "guarded-by",
    "loop-confined",
    "lock-order",
    "wire-schema",
    "blocking-call",
    "future-leak",
    "transitive-blocking",
    "loop-affinity",
    "lane-coverage",
    "host-sync",
    "donated-read",
    "raw-clock",
    "waiver",
)

_ALLOW_RE = re.compile(
    r"#\s*graftcheck:\s*allow\(([a-z-]+)\)\s*(?:[—–-]+\s*(.*))?")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str       # repo-relative
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Waiver:
    rule: str
    line: int
    reason: str


class Module:
    """One parsed source file: AST + per-line comments + waivers."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=rel)
        # line -> comment text (tokenize is string-literal-safe, unlike
        # scanning lines for '#').  A comment annotates the statement it
        # TRAILS, or — only when it owns its whole line — the statement
        # below it; a trailing comment must never leak onto the next
        # statement (``self.a = 1  # guarded-by: _lock`` followed by
        # ``self.b = 2`` does not annotate b).
        self.comments: dict[int, str] = {}
        self.standalone_comments: set[int] = set()
        src_lines = source.splitlines()
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    line = tok.start[0]
                    self.comments[line] = tok.string
                    if not src_lines[line - 1][:tok.start[1]].strip():
                        self.standalone_comments.add(line)
        except tokenize.TokenError:
            pass  # ast.parse succeeded; a tokenize edge case loses comments only
        self.waivers: list[Waiver] = []
        for line, text in self.comments.items():
            m = _ALLOW_RE.search(text)
            if m:
                self.waivers.append(
                    Waiver(m.group(1), line, (m.group(2) or "").strip()))
        # def-line waivers cover the whole function body for that rule
        self._fn_waivers: list[tuple[int, int, str]] = []  # (lo, hi, rule)
        by_line = {w.line: w for w in self.waivers}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                w = by_line.get(node.lineno)
                if w is None and node.lineno - 1 in self.standalone_comments:
                    w = by_line.get(node.lineno - 1)
                if w is not None:
                    self._fn_waivers.append(
                        (node.lineno, node.end_lineno or node.lineno, w.rule))

    def comment_at_or_above(self, line: int) -> str:
        """Trailing comment on ``line``, else a STANDALONE comment on the
        line above (the two sanctioned annotation placements)."""
        c = self.comments.get(line)
        if c:
            return c
        if line - 1 in self.standalone_comments:
            return self.comments[line - 1]
        return ""

    def comment_block_above(self, line: int) -> str:
        """The whole CONTIGUOUS standalone-comment block ending just
        above ``line``, joined top-down — class-level annotations are
        routinely written as multi-line comments whose marker sits on
        the FIRST line (``# graftcheck: loop-confined — because...``
        wrapped over two lines), which ``comment_at_or_above``'s
        single-line lookback silently missed: every multi-line
        loop-confined annotation in the tree was dead on arrival."""
        trailing = self.comments.get(line)
        lines: list[str] = [trailing] if trailing else []
        cur = line - 1
        while cur in self.standalone_comments:
            lines.append(self.comments[cur])
            cur -= 1
        return "\n".join(reversed(lines))

    def waived(self, rule: str, line: int) -> bool:
        for w in self.waivers:
            if w.rule == rule and (
                    w.line == line
                    or (w.line == line - 1
                        and w.line in self.standalone_comments)):
                return True
        return any(lo <= line <= hi and r == rule
                   for lo, hi, r in self._fn_waivers)

    def check_waiver_reasons(self) -> list[Finding]:
        """A waiver with no written justification is itself a finding —
        the escape hatch must leave a review trail (no silent
        suppression)."""
        out = []
        for w in self.waivers:
            if not w.reason:
                out.append(Finding(
                    "waiver", self.rel, w.line,
                    f"allow({w.rule}) carries no justification — write "
                    f"'# graftcheck: allow({w.rule}) — <reason>'"))
            if w.rule not in RULES:
                out.append(Finding(
                    "waiver", self.rel, w.line,
                    f"allow({w.rule}) names an unknown rule "
                    f"(known: {', '.join(r for r in RULES if r != 'waiver')})"))
        return out


def repo_root() -> str:
    """The directory containing the ``tpuraft`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


_SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".venv"}


def iter_py_files(roots: list[str]) -> list[str]:
    out = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    return out


def load_modules(roots: list[str]) -> tuple[list[Module], list[Finding]]:
    mods, findings = [], []
    base = repo_root()
    for path in iter_py_files(roots):
        rel = os.path.relpath(path, base)
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
            mods.append(Module(path, rel, src))
        except SyntaxError as e:
            findings.append(Finding(
                "waiver", rel, e.lineno or 0, f"unparsable: {e.msg}"))
        except (OSError, UnicodeDecodeError, ValueError) as e:
            # unreadable/non-UTF-8 source must surface as a finding, not
            # crash the gate with a raw traceback
            findings.append(Finding(
                "waiver", rel, 0, f"unreadable: {e!r}"))
    return mods, findings


def run_checkers(mods: list[Module], record: bool = False,
                 rules: set[str] | None = None) -> list[Finding]:
    """Run every checker over the loaded modules.  ``record`` rewrites
    the committed lockfiles (wire_schema.lock.json, lock_order.json)
    from the live tree before verifying."""
    from tpuraft_torch.analysis import (blocking_calls, callgraph, concurrency,
                                  future_leaks, guarded_by, lanes,
                                  lock_order, raw_clock, wire_schema)

    def want(*ids: str) -> bool:
        """Skip checkers whose rules are all filtered out — a targeted
        `--rule guarded-by` run must not pay the whole-program index
        (still filtered post-hoc below, since concurrency also emits
        guarded-by findings)."""
        return rules is None or bool(rules & set(ids))

    findings: list[Finding] = []
    for m in mods:
        findings.extend(m.check_waiver_reasons())
    if want("guarded-by", "loop-confined"):
        findings.extend(guarded_by.check(mods))
    if record or want("lock-order"):
        findings.extend(lock_order.check(mods, record=record))
    if record or want("wire-schema"):
        findings.extend(wire_schema.check(mods, record=record))
    if want("blocking-call"):
        findings.extend(blocking_calls.check(mods))
    if want("future-leak"):
        findings.extend(future_leaks.check(mods))
    if want("raw-clock"):
        findings.extend(raw_clock.check(mods))
    run_concurrency = want("transitive-blocking", "loop-affinity",
                           "guarded-by")
    run_lanes = want("lane-coverage", "host-sync", "donated-read")
    if run_concurrency or run_lanes:
        # the whole-program index (call graph + summaries) is built
        # ONCE per run and shared by every interprocedural rule — the
        # lint budget pays one extra AST walk per module, not one per
        # checker
        index = callgraph.ProjectIndex(mods)
        if run_concurrency:
            findings.extend(concurrency.check(mods, index))
        if run_lanes:
            findings.extend(lanes.check(mods, index))
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    # drop waived findings last: waivers apply uniformly to every rule
    # EXCEPT the waiver rule itself — 'allow(waiver)' must not be able
    # to silence the reasonless-waiver finding, or the no-silent-
    # suppression guarantee is one comment away from defeat
    findings = [f for f in findings
                if f.rule == "waiver" or not _waived(mods, f)]
    # the reference's own findings, inherited by its byte-for-byte
    # copies, are sanctioned by place in sanctioned.json
    sanctioned = load_sanctioned()
    findings = [f for f in findings
                if (f.path.replace(os.sep, "/"), f.line, f.rule)
                not in sanctioned]
    order = {r: i for i, r in enumerate(RULES)}
    findings.sort(key=lambda f: (f.path, f.line, order.get(f.rule, 99)))
    return findings


def _waived(mods: list[Module], f: Finding) -> bool:
    for m in mods:
        if m.rel == f.path:
            return m.waived(f.rule, f.line)
    return False


# ---- small AST helpers shared by checkers -----------------------------------


def decl_lineno(node) -> int:
    """The line a class/function ANNOTATION comment sits above: the
    first decorator's line when decorators exist, else the def/class
    line itself — ``comment_block_above(node.lineno)`` on a decorated
    class stops at the decorator and silently kills the annotation."""
    if getattr(node, "decorator_list", None):
        return node.decorator_list[0].lineno
    return node.lineno


def attr_chain(node: ast.AST) -> str:
    """Dotted name for Name/Attribute chains ('self._lock', 'a.b.c');
    '' when the expression is not a plain chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def parent_map(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


@dataclass
class ClassInfo:
    module: Module
    node: ast.ClassDef
    methods: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = field(
        default_factory=dict)


def iter_classes(mod: Module):
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            info = ClassInfo(mod, node)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods[item.name] = item
            yield info


SANCTION_FILE = "sanctioned.json"


def load_sanctioned() -> set[tuple[str, int, str]]:
    """(path, line, rule) of every finding ``sanctioned.json`` lists."""
    import json

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SANCTION_FILE)
    with open(path, encoding="utf-8") as f:
        return {(e["path"], e["line"], e["rule"])
                for e in json.load(f)["findings"]}
