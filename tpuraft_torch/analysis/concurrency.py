"""Checker 6: interprocedural concurrency analysis (graftcheck v2).

Built on the whole-program :mod:`tpuraft.analysis.callgraph` index, two
rules close the one-hop blind spots of the intra-procedural lints:

``transitive-blocking``
    The blocking-call lint's four contexts (tick plane, FSM apply path,
    coroutine bodies, lexically under a lock) now see THROUGH calls: a
    call site whose resolved callee *transitively* reaches
    ``time.sleep`` / blocking socket IO / an untimed ``.result()`` is a
    finding, and the message carries the offending chain
    (``helper -> _sync -> time.sleep() (tpuraft/x.py:42)``) so review
    lands on the real sink, not the innocent call.  Coroutine bodies
    keep the direct lint's softer contract (sleep/socket only — an
    untimed ``.result()`` on a done task is idiomatic asyncio), and
    propagation follows only edges that execute synchronously: plain
    calls to sync functions, plus ``await``-ed coroutine calls.  The
    rule also flags an ``await`` lexically inside a *sync* ``with
    <lock-ish>`` block: a threading lock held across a suspension point
    convoys every other task behind the awaiting one.

``loop-affinity``
    Infers which functions run OFF the event loop — ``run_in_executor``
    targets, ``Thread(target=)`` callables, ``<executor>.submit(...)``
    arguments, including lambdas and nested defs, closed transitively
    over the call graph — and flags loop-confined state touched from
    that inferred executor context: an off-loop function belonging to a
    ``# graftcheck: loop-confined`` class may not WRITE a ``self``
    attribute unless that attribute is ``# guarded-by:``-annotated
    (locked state is the sanctioned cross-thread channel — the PR 11/12
    in-thread flush-timing pattern times the fsync in the executor and
    feeds a LOCKED probe; this rule checks that shape instead of
    remembering it).  Reads are documented out of scope (an off-loop
    read of a config attribute is ubiquitous and benign; the write is
    where corruption starts).  The rule also extends the loop-confined
    lint transitively: a confined class's method calling an
    out-of-class helper that eventually sleeps or spawns threads is a
    finding (in-class sinks are already flagged directly).

The ``holds(_lock)`` call-site rule also becomes transitive here: the
intra-class rule (guarded_by.py) only sees ``self.<m>()`` calls, but a
collaborator routinely drives a node's holds-annotated methods through
a CROSS-OBJECT reference (``node._step_down(...)`` from the membership
ctx).  Such a call must either sit lexically inside ``with
<receiver>.<lock>`` or come from a class annotated ``# graftcheck:
called-under(<lock>)`` — the class-level declaration that every one of
its methods is invoked with the collaborator's named lock already held
(the _ConfigurationCtx convention, previously enforced by prose alone).
These findings report under the ``guarded-by`` rule: they are the same
lock discipline, seen one hop further.

Known limits (documented, not silently unchecked): attribute-receiver
calls (``self._log.flush()``) are never resolved, so chains through a
collaborator object are invisible — the lock-order checker's resolution
contract, kept deliberately; callables that escape through containers
or constructor wiring (``render=self.metrics_text``) are likewise out
of reach.  The chaos harness remains the net for those.
"""

from __future__ import annotations

import ast
import os
import re

from tpuraft_torch.analysis import guarded_by
from tpuraft_torch.analysis.blocking_calls import _is_fsm_class, _is_fsm_fn
from tpuraft_torch.analysis.callgraph import (RESULT, FunctionInfo, ProjectIndex,
                                        _all_functions, attr_chain,
                                        format_chain)
from tpuraft_torch.analysis.core import Finding, Module, decl_lineno, iter_classes

RULE_BLOCKING = "transitive-blocking"
RULE_AFFINITY = "loop-affinity"
RULE_HOLDS = "guarded-by"   # the holds call-site rule, one hop further

_CALLED_UNDER_RE = re.compile(r"#\s*graftcheck:\s*called-under\((\w+)\)")


def check(mods: list[Module], index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    confined = _confined_classes(mods)
    holds = _holds_methods(mods)
    called_under = _called_under_classes(mods)
    for mod in mods:
        midx = index.by_rel.get(mod.rel)
        if midx is None:
            continue
        tick_plane = (os.sep + "ops" + os.sep) in mod.rel \
            or mod.rel.startswith("ops" + os.sep) \
            or mod.rel.endswith((os.path.join("parallel", "collective.py"),
                                 os.path.join("parallel", "mesh.py")))
        fsm_classes = {ci.name for ci in midx.classes.values()
                       if _is_fsm_class(ci.node)}
        for info in _all_functions(midx):
            out.extend(_check_function(index, info, tick_plane,
                                       fsm_classes, confined))
            out.extend(_check_holds_cross_object(index, info, holds,
                                                 called_under))
    out.extend(_check_off_loop_writes(index, confined))
    return out


# ---- transitive blocking ----------------------------------------------------


def _check_function(index: ProjectIndex, info: FunctionInfo,
                    tick_plane: bool, fsm_classes: set[str],
                    confined: dict) -> list[Finding]:
    out: list[Finding] = []
    mod = info.mod
    hard_why = None
    if tick_plane:
        hard_why = ("in tick-plane code (tpuraft_torch/ops, "
                    "parallel/collective.py, parallel/mesh.py)")
    elif (info.cls_name in fsm_classes
          and "<locals>" not in info.qualname) or _is_fsm_fn(info.name):
        hard_why = "on the FSM apply path"
    loop_why = ("in a coroutine (blocks the shared event loop)"
                if info.is_async else None)

    for line, lock in info.awaits_under_lock:
        out.append(Finding(
            RULE_BLOCKING, mod.rel, line,
            f"{info.qualname}() awaits while holding sync lock {lock} — "
            f"a threading lock held across a suspension point convoys "
            f"every task behind this one; use an asyncio lock or move "
            f"the await outside the critical section"))

    cls_key = (mod.rel, info.cls_name)
    in_confined = confined.get(cls_key)

    for site in info.calls:
        callee = index.resolve_call(info, site.call)
        if callee is None:
            continue
        if callee.is_async and not site.awaited:
            continue  # builds a coroutine; nothing runs here
        tb = index.transitive_blocks(callee)
        if tb:
            ctx = None
            kinds = list(tb)
            if site.lock is not None:
                ctx = f"while holding {site.lock}"
            elif hard_why is not None:
                ctx = hard_why
            elif loop_why is not None:
                kinds = [k for k in kinds if k != RESULT]
                ctx = loop_why if kinds else None
            if ctx is not None and kinds:
                names, msg, rel, line = tb[kinds[0]]
                # a chain that is empty means the callee blocks
                # DIRECTLY — the intra-procedural lint owns that
                # finding when callee and context share a function, but
                # from the CALLER's side it is still one hop away and
                # invisible to it, so report it here
                out.append(Finding(
                    RULE_BLOCKING, mod.rel, site.line,
                    f"call to {callee.qualname}() transitively blocks "
                    f"{ctx}: "
                    + format_chain((callee.qualname,) + names,
                                   msg, rel, line)))
                continue
        if in_confined is not None:
            out.extend(_confined_transitive(index, info, site, callee,
                                            in_confined))
    return out


# ---- loop-confined, transitively --------------------------------------------


def _confined_transitive(index: ProjectIndex, info: FunctionInfo, site,
                         callee: FunctionInfo, cls_name: str
                         ) -> list[Finding]:
    """A loop-confined class's method calling OUT-OF-CLASS code that
    eventually sleeps or spawns threads.  Same-class sinks are skipped:
    the direct loop-confined rule already flags those lines."""
    if callee.cls_name == cls_name and callee.mod is info.mod:
        return []
    out = []
    tb = index.transitive_blocks(callee)
    sleep = tb.get("sleep")
    if sleep is not None:
        names, msg, rel, line = sleep
        out.append(Finding(
            RULE_AFFINITY, info.mod.rel, site.line,
            f"loop-confined {cls_name}.{info.name}() calls "
            f"{callee.qualname}() which transitively sleeps: "
            + format_chain((callee.qualname,) + names, msg, rel, line)
            + " — blocks the event loop every other group runs on"))
    threads = index.transitive_threads(callee)
    if threads is not None:
        names, msg, rel, line = threads
        out.append(Finding(
            RULE_AFFINITY, info.mod.rel, site.line,
            f"loop-confined {cls_name}.{info.name}() calls "
            f"{callee.qualname}() which transitively reaches a "
            f"threading primitive: "
            + format_chain((callee.qualname,) + names, msg, rel, line)
            + " — its state has no lock; cross-thread access is a race"))
    return out


# ---- cross-object holds call-site rule --------------------------------------


def _check_holds_cross_object(index: ProjectIndex, info: FunctionInfo,
                              holds: dict, called_under: dict
                              ) -> list[Finding]:
    out: list[Finding] = []
    for site in info.calls:
        callee = index.resolve_call(info, site.call)
        if callee is None or callee.cls_name is None:
            continue
        need = holds.get((callee.mod.rel, callee.cls_name, callee.name))
        if not need:
            continue
        chain = attr_chain(site.call.func)
        if chain.startswith("self.") and info.cls_name == callee.cls_name \
                and info.mod is callee.mod:
            continue  # the intra-class rule (guarded_by.py) owns this
        recv = chain.rsplit(".", 1)[0] if "." in chain else ""
        lexically = {f"{recv}.{lk}" for lk in need} <= set(site.held)
        declared = need <= called_under.get((info.mod.rel, info.cls_name),
                                            set())
        if lexically or declared:
            continue
        out.append(Finding(
            RULE_HOLDS, info.mod.rel, site.line,
            f"{callee.qualname}() requires the caller to hold "
            f"{', '.join(sorted(need))} (holds annotation) but "
            f"{info.qualname}() calls it through "
            f"'{recv or chain}' without — wrap the call in "
            f"'with {recv or '<receiver>'}.{sorted(need)[0]}' or annotate "
            f"the calling class '# graftcheck: "
            f"called-under({sorted(need)[0]})'"))
    return out


def _holds_methods(mods: list[Module]) -> dict:
    """(mod.rel, cls, method) -> lock names the caller must hold."""
    out: dict = {}
    for mod in mods:
        for cls in iter_classes(mod):
            fields = guarded_by._collect_fields(mod, cls)
            for name, locks in guarded_by._holds_locks(
                    mod, cls, fields).items():
                out[(mod.rel, cls.node.name, name)] = locks
    return out


def _called_under_classes(mods: list[Module]) -> dict:
    """(mod.rel, cls) -> lock names the class's methods are always
    invoked under (collaborator-owned locks, declared at class level)."""
    out: dict = {}
    for mod in mods:
        for cls in iter_classes(mod):
            text = mod.comment_block_above(decl_lineno(cls.node))
            if cls.node.body and isinstance(cls.node.body[0], ast.Expr) \
                    and isinstance(cls.node.body[0].value, ast.Constant) \
                    and isinstance(cls.node.body[0].value.value, str):
                text += "\n" + cls.node.body[0].value.value
            locks = {m.group(1)
                     for m in _CALLED_UNDER_RE.finditer(text)}
            if locks:
                out[(mod.rel, cls.node.name)] = locks
    return out


# ---- executor context touching loop-confined state --------------------------


def _check_off_loop_writes(index: ProjectIndex, confined: dict
                           ) -> list[Finding]:
    out: list[Finding] = []
    for info, desc, root_rel, root_line in index.off_loop().values():
        cls = confined.get((info.mod.rel, info.cls_name))
        if cls is None:
            continue
        guarded = _guarded_fields(info.mod, cls)
        for attr, line in info.writes_self:
            if attr in guarded:
                continue  # locked state is the sanctioned channel
            out.append(Finding(
                RULE_AFFINITY, info.mod.rel, line,
                f"loop-confined {cls}.{info.name}() runs off-loop "
                f"({desc}, submitted at {root_rel}:{root_line}) and "
                f"writes self.{attr} without a guard — loop-confined "
                f"state touched from an inferred executor context; "
                f"post it back to the loop or annotate the field "
                f"guarded-by a real lock"))
    return out


# ---- shared lookups ---------------------------------------------------------


def _confined_classes(mods: list[Module]) -> dict:
    """(mod.rel, cls_name) -> cls_name for every loop-confined class;
    also caches the ClassInfo for guarded-field lookups."""
    out: dict = {}
    for mod in mods:
        for cls in iter_classes(mod):
            if _is_loop_confined(mod, cls):
                out[(mod.rel, cls.node.name)] = cls.node.name
    return out


def _is_loop_confined(mod: Module, cls) -> bool:
    node = cls.node
    return bool(
        guarded_by._LOOP_CONFINED_RE.search(
            mod.comment_block_above(decl_lineno(node)))
        or (node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
            and isinstance(node.body[0].value.value, str)
            and "graftcheck: loop-confined" in node.body[0].value.value))


def _guarded_fields(mod: Module, cls_name: str) -> set[str]:
    for cls in iter_classes(mod):
        if cls.node.name == cls_name:
            return set(guarded_by._collect_fields(mod, cls))
    return set()
