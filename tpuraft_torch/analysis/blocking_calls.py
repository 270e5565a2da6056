"""Checker 4: blocking-call lint.

The tick plane (``tpuraft_torch/ops/``, the replica quorum of
``tpuraft_torch/parallel/collective.py`` and the sharded tick of
``tpuraft_torch/parallel/mesh.py``) sits under the device-step budget,
FSM apply paths run inline on the commit pipeline, coroutines share one
event loop with every raft group of the process, and anything holding a
lock convoys every waiter behind it.  A blocking call in any of those
contexts stalls the whole multi-raft plane, not one caller — so inside
them this lint forbids:

  * ``time.sleep(...)``
  * blocking socket IO: ``socket.create_connection`` /
    ``socket.socket(...)`` use, and ``.recv/.send/.sendall/.accept/
    .connect(...)`` on a receiver whose name mentions ``sock``
  * untimed ``<future>.result()`` — ``concurrent.futures`` waits with
    no timeout are exactly the PR 2 wedged-waiter class (#7/#8): the
    completer dies, the waiter blocks forever.  Pass ``timeout=`` so a
    wedge becomes a visible error.

Contexts checked (everything else is free to block):
  1. every function in ``tpuraft_torch/ops/``,
     ``tpuraft_torch/parallel/collective.py`` and
     ``tpuraft_torch/parallel/mesh.py``               (tick plane)
  2. methods of ``*StateMachine`` classes (by name or base) and
     functions named ``on_apply*`` / ``apply_*``       (FSM apply path)
  3. any ``async def`` body — sleep/socket only: ``.result()`` on a
     *done* asyncio task is non-blocking and idiomatic   (event loop)
  4. statements lexically inside ``with <lock-ish>``   (lock held)

Passing a blocking function as a *reference* (``run_in_executor(None,
time.sleep, ...)``) is fine — only calls are flagged.
"""

from __future__ import annotations

import ast
import os
import re

from tpuraft_torch.analysis.core import Finding, Module, attr_chain

RULE = "blocking-call"

_LOCKISH = re.compile(r"lock|guard|mutex", re.IGNORECASE)
_SOCK_METHODS = {"recv", "recv_into", "send", "sendall", "accept", "connect"}


def check(mods: list[Module]) -> list[Finding]:
    out: list[Finding] = []
    for mod in mods:
        tick_plane = (os.sep + "ops" + os.sep) in mod.rel \
            or mod.rel.startswith("ops" + os.sep) \
            or mod.rel.endswith((os.path.join("parallel", "collective.py"),
                                 os.path.join("parallel", "mesh.py")))
        out.extend(_scan_module(mod, tick_plane))
    return out


def _is_fsm_class(cls: ast.ClassDef) -> bool:
    names = [cls.name] + [attr_chain(b) or getattr(b, "id", "")
                          for b in cls.bases]
    return any(n.split(".")[-1].endswith("StateMachine") for n in names if n)


def _is_fsm_fn(name: str) -> bool:
    return name.startswith("on_apply") or name.startswith("apply_")


def _lock_name(item: ast.withitem) -> str | None:
    expr = item.context_expr
    chain = attr_chain(expr)
    if not chain and isinstance(expr, ast.Call):
        chain = attr_chain(expr.func)
    if chain and _LOCKISH.search(chain):
        return chain
    return None


def _scan_module(mod: Module, tick_plane: bool) -> list[Finding]:
    out: list[Finding] = []

    def visit(node, held: str | None, hard_why: str | None,
              loop_why: str | None) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # async with counts too: blocking under the asyncio node
            # lock stalls the loop AND every waiter queued on the lock
            lock = next((_lock_name(i) for i in node.items
                         if _lock_name(i)), None)
            inner = lock or held
            for child in node.body:
                visit(child, inner, hard_why, loop_why)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_fn(node, hard_why if tick_plane else None)
            return
        if isinstance(node, ast.Lambda):
            # a lambda body runs when called — commonly on an executor
            # thread (run_in_executor(None, lambda: ...)): never under
            # the lexical lock or the enclosing coroutine; only the
            # module-wide tick-plane context persists
            visit(node.body, None,
                  hard_why if tick_plane else None, None)
            return
        if isinstance(node, ast.Call):
            found = _blocking_call(node)
            if found:
                msg, is_result_wait = found
                ctx = (f"while holding {held}" if held
                       else hard_why if hard_why
                       else loop_why if not is_result_wait else None)
                if ctx:
                    out.append(Finding(
                        RULE, mod.rel, node.lineno, f"{msg} {ctx}"))
        for child in ast.iter_child_nodes(node):
            visit(child, held, hard_why, loop_why)

    def scan_fn(fn, hard_why: str | None) -> None:
        """hard_why: tick-plane / FSM context (flags everything incl.
        untimed result()); coroutine bodies get the softer loop context
        (sleep/socket only)."""
        if hard_why is None and _is_fsm_fn(fn.name):
            hard_why = "on the FSM apply path"
        loop_why = ("in a coroutine (blocks the shared event loop)"
                    if isinstance(fn, ast.AsyncFunctionDef) else None)
        for stmt in fn.body:
            visit(stmt, None, hard_why, loop_why)

    why_module = ("in tick-plane code (tpuraft_torch/ops, "
                  "parallel/collective.py, parallel/mesh.py)"
                  ) if tick_plane else None
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_fn(node, why_module)
        elif isinstance(node, ast.ClassDef):
            fsm = _is_fsm_class(node)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_fn(item, why_module or (
                        "on the FSM apply path" if fsm else None))
    return out


def _blocking_call(node: ast.Call) -> tuple[str, bool] | None:
    chain = attr_chain(node.func)
    if chain == "time.sleep":
        return "time.sleep()", False
    if chain in ("socket.create_connection", "socket.socket"):
        return f"{chain}()", False
    if isinstance(node.func, ast.Attribute):
        meth = node.func.attr
        recv = attr_chain(node.func.value)
        if meth in _SOCK_METHODS and recv and "sock" in recv.lower():
            return f"blocking socket IO {recv}.{meth}()", False
        if meth == "result" and not node.args \
                and not any(kw.arg == "timeout" for kw in node.keywords):
            return (f"untimed {recv or '<expr>'}.result() (wedged-waiter "
                    f"class: pass timeout=)"), True
    return None
