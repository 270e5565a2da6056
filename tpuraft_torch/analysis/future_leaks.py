"""Checker 5: future-completion lint (the wedged-waiter class).

A function that creates a future and completes it locally must complete
it on EVERY path.  The shape that wedges (PR 2 #7/#8: the in-flight
``change_peers`` waiter on shutdown, the catch-up waiter on abort):

    fut = loop.create_future()
    ...
    result = do_risky_work()        # raises ->
    fut.set_result(result)          # never runs; waiter blocks forever

The rule: between the creation and the first completion call, any
expression that can raise (i.e. any call) makes the straight-line
completion insufficient — there must ALSO be a completion
(``set_result`` / ``set_exception`` / ``cancel``) inside an ``except``
handler or ``finally`` block of the function, covering the failure path.

Scope (deliberate, documented): futures whose OWNERSHIP ESCAPES the
function — returned, yielded, stored into an attribute/container,
passed to another call, or captured by a closure — are skipped: their
completion contract lives with the new owner, which a per-function AST
pass cannot see.  The chaos harness remains the check for those; this
lint kills the local-completion class at review time instead.  A future
that neither escapes nor is completed is flagged outright.
"""

from __future__ import annotations

import ast

from tpuraft_torch.analysis.core import Finding, Module, attr_chain, parent_map

RULE = "future-leak"

_COMPLETES = {"set_result", "set_exception", "cancel"}

_CREATORS = (
    "create_future",      # loop.create_future() / get_event_loop()...
)


def _is_future_creation(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    # X.create_future() for any receiver, including the chained
    # asyncio.get_running_loop().create_future() (receiver is a Call,
    # so attr_chain alone can't see it)
    if isinstance(value.func, ast.Attribute) and value.func.attr in _CREATORS:
        return True
    chain = attr_chain(value.func)
    # asyncio.Future() / concurrent.futures.Future() / bare Future()
    return chain in ("asyncio.Future", "concurrent.futures.Future",
                     "futures.Future", "Future")


def check(mods: list[Module]) -> list[Finding]:
    out: list[Finding] = []
    for mod in mods:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(_scan_function(mod, node))
    return out


class _FutUse:
    def __init__(self, name: str, line: int):
        self.name = name
        self.line = line
        self.escapes = False
        self.completions: list[ast.Call] = []   # X.set_result(...) etc.
        self.other_uses = 0


def _scan_function(mod: Module, fn) -> list[Finding]:
    # locals assigned a fresh future in THIS function's direct body
    # (nested defs analyzed on their own walk(tree) visit)
    futs: dict[str, _FutUse] = {}
    direct = list(_iter_direct(fn))
    for node in direct:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            # fut: asyncio.Future = loop.create_future() — the annotated
            # form is common in-tree (tcp.py/native_tcp.py) and must not
            # exempt the rule
            target = node.target
        if target is not None and isinstance(target, ast.Name) \
                and node.value is not None \
                and _is_future_creation(node.value):
            futs[target.id] = _FutUse(target.id, node.lineno)
    if not futs:
        return []

    parents = parent_map(fn)
    for node in direct:
        if isinstance(node, ast.Name) and node.id in futs \
                and isinstance(node.ctx, ast.Load):
            use = futs[node.id]
            parent = parents.get(node)
            # completion: X.set_result(...) / X.set_exception / X.cancel
            if isinstance(parent, ast.Attribute) \
                    and parent.attr in _COMPLETES:
                call = parents.get(parent)
                if isinstance(call, ast.Call) and call.func is parent:
                    use.completions.append(call)
                    continue
            # done-guard reads don't transfer ownership
            if isinstance(parent, ast.Attribute) and parent.attr in (
                    "done", "cancelled", "result", "exception",
                    "add_done_callback"):
                use.other_uses += 1
                continue
            if isinstance(parent, (ast.Return, ast.Yield, ast.Await)):
                use.escapes = True
                continue
            # any other Load use: argument, container element, attribute
            # store RHS, closure capture... — ownership escapes
            use.escapes = True
    # closure capture: a nested def referencing the name
    for node in ast.walk(fn):
        if node is fn:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Name) and inner.id in futs:
                    futs[inner.id].escapes = True

    out: list[Finding] = []
    for use in futs.values():
        if use.escapes:
            continue
        if not use.completions:
            out.append(Finding(
                RULE, mod.rel, use.line,
                f"{fn.name}() creates future '{use.name}' but never "
                f"completes it and it never escapes — every waiter "
                f"wedges"))
            continue
        if _has_risky_gap(fn, use, parents) \
                and not _completed_on_failure_path(use, parents):
            out.append(Finding(
                RULE, mod.rel, use.line,
                f"{fn.name}() completes future '{use.name}' only on the "
                f"straight-line path; a raise between creation "
                f"(line {use.line}) and completion leaves waiters wedged "
                f"— complete it in an except/finally too"))
    return out


def _iter_direct(fn):
    """Walk fn's body but do not descend into nested function defs."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _has_risky_gap(fn, use: _FutUse, parents) -> bool:
    """Any call (other than the creation and the completions themselves)
    between creation and the first completion can raise."""
    first_completion = min(c.lineno for c in use.completions)
    for node in _iter_direct(fn):
        if isinstance(node, ast.Call) \
                and use.line < node.lineno < first_completion:
            chain = attr_chain(node.func)
            if chain.split(".")[-1] in _COMPLETES:
                continue
            return True
    return False


def _completed_on_failure_path(use: _FutUse, parents) -> bool:
    """Some completion call sits in an except handler or finally block."""
    for call in use.completions:
        node = call
        while True:
            parent = parents.get(node)
            if parent is None:
                break
            if isinstance(parent, ast.ExceptHandler):
                return True
            if isinstance(parent, ast.Try) and _in_body(
                    parent.finalbody, node):
                return True
            node = parent
    return False


def _in_body(body: list, node: ast.AST) -> bool:
    return any(node is stmt for stmt in body)
