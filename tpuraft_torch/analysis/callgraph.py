"""Whole-program index for graftcheck: call graph + function summaries.

PR 7's checkers were deliberately intra-procedural — one level of
call resolution inside one module (lock_order.py).  That stops seeing
hazards the moment they take one hop: a loop-confined method calling a
helper that transitively ``time.sleep``s, an FSM apply path reaching an
untimed ``Future.result()`` through two utility functions, a lambda
handed to ``run_in_executor`` that fans out into methods mutating
loop-confined state.  This module builds, ONCE per lint run:

  * a project-wide call graph.  Resolution rules are lock_order.py's
    (``self.m()``, module ``f()``, ``ClassName()`` ctors, bare-local
    ``obj.m()`` iff the method name is unique in the module), extended
    CROSS-MODULE along absolute imports whose target module is in the
    analyzed set (``from tpuraft.x import f`` / ``import tpuraft.x``):
    the gate analyzes all of ``tpuraft/``, so every in-package import
    edge resolves.  Attribute receivers (``self._log.flush()``) stay
    deliberately unresolved — common method names collide with stdlib
    handles, and a wrong edge is worse than a missing one.

  * per-function summaries {blocks, acquires, awaits-under-lock,
    spawns-threads, writes-self-attrs}, computed from the function's
    DIRECT synchronous body (nested defs/lambdas run later, in their
    own context — they get their own summaries).

  * transitive closures over those summaries (memoized): "does calling
    f eventually block?", with the offending chain retained so the
    finding can say ``f -> g -> time.sleep() (storage/x.py:42)``
    instead of pointing at an innocent-looking call site.

  * an OFF-LOOP set: functions inferred to run on executor threads —
    ``run_in_executor`` targets, ``Thread(target=)``, ``executor
    .submit(...)`` arguments, including lambdas and nested defs —
    closed transitively over the call graph.  The PR 11/12 in-thread
    flush-timing pattern (time the fsync IN the executor, feed a
    LOCKED probe) is safe exactly because the off-loop code writes no
    unguarded loop-confined state; the concurrency checker verifies
    that instead of remembering it.

Everything is pure stdlib AST; summaries are computed lazily and cached
per function node, so a whole-tree run pays one extra AST walk per
module plus the (small) transitive closure.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from tpuraft_torch.analysis.core import Module, attr_chain

_LOCKISH = re.compile(r"lock|guard|mutex", re.IGNORECASE)
_SOCK_METHODS = {"recv", "recv_into", "send", "sendall", "accept", "connect"}
_EXECUTORISH = re.compile(r"executor|pool|worker", re.IGNORECASE)

# blocking kinds a summary can carry
SLEEP, SOCKET, RESULT = "sleep", "socket", "result"


def direct_blocking_call(node: ast.Call) -> Optional[tuple[str, str]]:
    """(kind, message) when this call blocks directly; None otherwise.
    Mirrors blocking_calls._blocking_call — one definition of "blocks"
    shared by the direct lint and the summaries."""
    chain = attr_chain(node.func)
    if chain == "time.sleep":
        return SLEEP, "time.sleep()"
    if chain in ("socket.create_connection", "socket.socket"):
        return SOCKET, f"{chain}()"
    if isinstance(node.func, ast.Attribute):
        meth = node.func.attr
        recv = attr_chain(node.func.value)
        if meth in _SOCK_METHODS and recv and "sock" in recv.lower():
            return SOCKET, f"blocking socket IO {recv}.{meth}()"
        if meth == "result" and not node.args \
                and not any(kw.arg == "timeout" for kw in node.keywords):
            return RESULT, f"untimed {recv or '<expr>'}.result()"
    return None


def _module_name_to_rel(dotted: str) -> str:
    """'tpuraft.core.node' -> 'tpuraft/core/node.py' (the Module.rel
    shape for in-repo files)."""
    return dotted.replace(".", "/") + ".py"


class CallSite:
    __slots__ = ("call", "line", "awaited", "lock", "held")

    def __init__(self, call: ast.Call, line: int, awaited: bool,
                 held: tuple[str, ...]):
        self.call = call
        self.line = line
        self.awaited = awaited   # the call is the operand of an Await
        # lexically-enclosing SYNC with-locks, outermost first; ``lock``
        # keeps the innermost for messages
        self.held = held
        self.lock = held[-1] if held else None


class FunctionInfo:
    """Direct (non-transitive) facts about one function/method body."""

    __slots__ = ("mod", "cls_name", "name", "node", "is_async",
                 "blocks", "threads", "acquires", "awaits_under_lock",
                 "calls", "writes_self", "nested", "qualname")

    def __init__(self, mod: Module, cls_name: Optional[str], name: str,
                 node, qualname: str):
        self.mod = mod
        self.cls_name = cls_name
        self.name = name
        self.node = node
        self.qualname = qualname
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        self.blocks: list[tuple[str, str, int]] = []   # (kind, msg, line)
        self.threads: list[tuple[str, int]] = []       # (chain, line)
        self.acquires: set[str] = set()
        self.awaits_under_lock: list[tuple[int, str]] = []
        self.calls: list[CallSite] = []
        self.writes_self: list[tuple[str, int]] = []   # (attr, line)
        self.nested: dict[str, "FunctionInfo"] = {}    # nested defs by name


class _ClassIdx:
    __slots__ = ("name", "node", "methods", "bases")

    def __init__(self, name: str, node: ast.ClassDef):
        self.name = name
        self.node = node
        self.methods: dict[str, FunctionInfo] = {}
        self.bases: list[str] = [attr_chain(b) or getattr(b, "id", "")
                                 for b in node.bases]


class _ModuleIdx:
    __slots__ = ("mod", "functions", "classes", "imports", "method_owners")

    def __init__(self, mod: Module):
        self.mod = mod
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, _ClassIdx] = {}
        # local name -> ("mod", rel) for imported modules,
        #               ("sym", rel, symbol) for imported symbols
        self.imports: dict[str, tuple] = {}
        self.method_owners: dict[str, list[str]] = {}


class ProjectIndex:
    """The once-per-run whole-program index (ISSUE 14 tentpole)."""

    def __init__(self, mods: list[Module]):
        self.mods = mods
        self.by_rel: dict[str, _ModuleIdx] = {}
        for mod in mods:
            self.by_rel[mod.rel] = self._index_module(mod)
        # memo caches for the transitive closures
        self._block_memo: dict[int, dict[str, tuple]] = {}
        self._thread_memo: dict[int, Optional[tuple]] = {}
        self._off_loop: Optional[dict[int, tuple]] = None

    # -- module indexing -----------------------------------------------------

    def _index_module(self, mod: Module) -> _ModuleIdx:
        idx = _ModuleIdx(mod)
        for node in mod.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._index_import(idx, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                idx.functions[node.name] = self._scan_function(
                    mod, None, node, node.name)
            elif isinstance(node, ast.ClassDef):
                ci = _ClassIdx(node.name, node)
                idx.classes[node.name] = ci
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        ci.methods[item.name] = self._scan_function(
                            mod, node.name, item,
                            f"{node.name}.{item.name}")
                        idx.method_owners.setdefault(
                            item.name, []).append(node.name)
        return idx

    def _index_import(self, idx: _ModuleIdx, node) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                rel = _module_name_to_rel(alias.name)
                local = alias.asname or alias.name.split(".")[0]
                if alias.asname is None and "." in alias.name:
                    # `import tpuraft.core.node` binds `tpuraft`; calls
                    # spell the full chain, which attr_chain flattens —
                    # map the full dotted prefix instead
                    idx.imports.setdefault(alias.name, ("mod", rel))
                else:
                    idx.imports[local] = ("mod", rel)
            return
        if node.level:           # relative imports: not used in-tree
            return
        if node.module is None:
            return
        mod_rel = _module_name_to_rel(node.module)
        for alias in node.names:
            local = alias.asname or alias.name
            # `from tpuraft.core import node` imports a MODULE; `from
            # tpuraft.core.node import Node` imports a symbol.  Decide
            # by what exists in the analyzed set.
            sub_rel = _module_name_to_rel(f"{node.module}.{alias.name}")
            idx.imports[local] = ("maybe", mod_rel, alias.name, sub_rel)

    # -- per-function fact scan ----------------------------------------------

    def _scan_function(self, mod: Module, cls_name: Optional[str],
                       fn, qualname: str) -> FunctionInfo:
        info = FunctionInfo(mod, cls_name, fn.name, fn, qualname)

        def visit(node, held: tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: its body runs later in its own context
                info.nested[node.name] = self._scan_function(
                    mod, cls_name, node, f"{qualname}.<locals>.{node.name}")
                return
            if isinstance(node, ast.Lambda):
                return  # lambdas handled at their use sites (off-loop roots)
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    ln = _lock_name(item)
                    if ln:
                        info.acquires.add(ln)
                        if isinstance(node, ast.With):
                            inner = inner + (ln,)  # sync lock: held across
                for item in node.items:
                    visit(item.context_expr, held)
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.Await):
                if held:
                    info.awaits_under_lock.append((node.lineno, held[-1]))
                if isinstance(node.value, ast.Call):
                    self._note_call(info, node.value, awaited=True, held=held)
                    for arg in ast.iter_child_nodes(node.value):
                        visit(arg, held)
                    return
                visit(node.value, held)
                return
            if isinstance(node, ast.Call):
                self._note_call(info, node, awaited=False, held=held)
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                info.writes_self.append((node.attr, node.lineno))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, ())
        return info

    def _note_call(self, info: FunctionInfo, node: ast.Call,
                   awaited: bool, held: tuple[str, ...]) -> None:
        found = direct_blocking_call(node)
        if found:
            kind, msg = found
            info.blocks.append((kind, msg, node.lineno))
        chain = attr_chain(node.func)
        # only CONCURRENCY SPAWNS propagate transitively: a helper that
        # constructs a threading.Lock() is a thread-SAFE collaborator
        # (locked state is the sanctioned cross-thread channel), not a
        # confinement breach — the direct loop-confined rule still
        # flags any threading.* use written inside the class itself
        if chain in ("threading.Thread", "Thread", "threading.Timer"):
            info.threads.append((chain, node.lineno))
        info.calls.append(CallSite(node, node.lineno, awaited, held))

    # -- resolution ----------------------------------------------------------

    def resolve_import(self, idx: _ModuleIdx, local: str
                       ) -> Optional[tuple[str, Optional[str]]]:
        """Local imported name -> (module rel, symbol|None)."""
        entry = idx.imports.get(local)
        if entry is None:
            return None
        if entry[0] == "mod":
            return (entry[1], None) if entry[1] in self.by_rel else None
        # "maybe": symbol of mod_rel, or submodule sub_rel
        _, mod_rel, sym, sub_rel = entry
        if sub_rel in self.by_rel:
            return (sub_rel, None)
        if mod_rel in self.by_rel:
            return (mod_rel, sym)
        return None

    def _lookup(self, rel: str, name: str) -> Optional[FunctionInfo]:
        midx = self.by_rel.get(rel)
        if midx is None:
            return None
        fn = midx.functions.get(name)
        if fn is not None:
            return fn
        ci = midx.classes.get(name)
        if ci is not None:
            return ci.methods.get("__init__")
        return None

    def resolve_call(self, info: FunctionInfo, call: ast.Call
                     ) -> Optional[FunctionInfo]:
        """Resolve a call site inside ``info`` to a known function, or
        None (unresolvable / out of the analyzed set)."""
        return self._resolve_expr(info, call.func)

    def _resolve_expr(self, info: FunctionInfo, func
                      ) -> Optional[FunctionInfo]:
        midx = self.by_rel.get(info.mod.rel)
        if midx is None:
            return None
        chain = attr_chain(func)
        if not chain:
            return None
        # self.m(...): method of the lexical class (one level of base
        # following along resolvable names)
        if chain.startswith("self.") and "." not in chain[5:]:
            return self._resolve_method(midx, info.cls_name, chain[5:])
        if "." not in chain:
            # nested def in the same function
            if chain in info.nested:
                return info.nested[chain]
            # module function / local class ctor
            target = midx.functions.get(chain)
            if target is not None:
                return target
            ci = midx.classes.get(chain)
            if ci is not None:
                return ci.methods.get("__init__")
            imp = self.resolve_import(midx, chain)
            if imp is not None and imp[1] is not None:
                return self._lookup(imp[0], imp[1])
            return None
        head, rest = chain.split(".", 1)
        # imported module attribute: mod.f(...) / pkg.mod.f(...)
        for prefix in (_dotted_prefixes(chain)):
            ent = midx.imports.get(prefix)
            if ent is not None:
                imp = self.resolve_import(midx, prefix)
                if imp is None:
                    return None
                rel, sym = imp
                tail = chain[len(prefix) + 1:]
                if sym is None and "." not in tail:
                    return self._lookup(rel, tail)
                return None
        # ClassName.m(...) on a local class
        ci = midx.classes.get(head)
        if ci is not None and "." not in rest:
            return ci.methods.get(rest)
        # obj.m(...) on a bare local: unique-owner rule (lock_order.py)
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id != "self" and "." not in rest:
            owners = midx.method_owners.get(rest, ())
            if len(owners) == 1:
                return midx.classes[owners[0]].methods.get(rest)
        return None

    def _resolve_method(self, midx: _ModuleIdx, cls_name: Optional[str],
                        meth: str) -> Optional[FunctionInfo]:
        seen = set()
        while cls_name and cls_name not in seen:
            seen.add(cls_name)
            ci = midx.classes.get(cls_name)
            if ci is None:
                return None
            m = ci.methods.get(meth)
            if m is not None:
                return m
            # one resolvable base, same module or imported
            nxt = None
            for b in ci.bases:
                base = b.split(".")[-1]
                if base in midx.classes:
                    nxt = base
                    break
                imp = self.resolve_import(midx, b.split(".")[0])
                if imp is not None:
                    rel = imp[0]
                    target = self.by_rel.get(rel)
                    if target is not None and base in target.classes:
                        bm = target.classes[base].methods.get(meth)
                        if bm is not None:
                            return bm
            cls_name = nxt
        return None

    # -- transitive closures -------------------------------------------------

    def transitive_blocks(self, info: FunctionInfo
                          ) -> dict[str, tuple]:
        """kind -> (chain_names, msg, rel, line): the first observed
        path from ``info`` to a direct blocking call of that kind,
        following only edges that execute synchronously (plain calls to
        sync functions; awaited calls to coroutines)."""
        memo = self._block_memo
        key = id(info.node)
        if key in memo:
            return memo[key]
        memo[key] = {}  # cycle guard: in-progress = no extra facts
        out: dict[str, tuple] = {}
        for kind, msg, line in info.blocks:
            out.setdefault(kind, ((), msg, info.mod.rel, line))
        for site in info.calls:
            callee = self.resolve_call(info, site.call)
            if callee is None or not _edge_executes(site, callee):
                continue
            for kind, (names, msg, rel, line) in \
                    self.transitive_blocks(callee).items():
                if kind not in out:
                    out[kind] = ((callee.qualname,) + names, msg, rel, line)
        memo[key] = out
        return out

    def transitive_threads(self, info: FunctionInfo) -> Optional[tuple]:
        """(chain_names, chain_msg, rel, line) when calling ``info``
        eventually reaches a threading primitive; None otherwise."""
        memo = self._thread_memo
        key = id(info.node)
        if key in memo:
            return memo[key]
        memo[key] = None
        out = None
        if info.threads:
            chain, line = info.threads[0]
            out = ((), f"{chain}()", info.mod.rel, line)
        else:
            for site in info.calls:
                callee = self.resolve_call(info, site.call)
                if callee is None or not _edge_executes(site, callee):
                    continue
                sub = self.transitive_threads(callee)
                if sub is not None:
                    names, msg, rel, line = sub
                    out = ((callee.qualname,) + names, msg, rel, line)
                    break
        memo[key] = out
        return out

    # -- executor / loop affinity --------------------------------------------

    def off_loop(self) -> dict[int, tuple]:
        """id(fn node) -> (FunctionInfo, root_desc, rel, line):
        functions inferred to run OFF the event loop — executor/thread
        targets and their transitive callees."""
        if self._off_loop is not None:
            return self._off_loop
        roots: list[tuple[FunctionInfo, str, str, int]] = []
        for midx in self.by_rel.values():
            for info in _all_functions(midx):
                for target, desc, line in self._off_loop_targets(info):
                    roots.append((target, desc, info.mod.rel, line))
        out: dict[int, tuple] = {}
        stack = list(roots)
        while stack:
            info, desc, rel, line = stack.pop()
            key = id(info.node)
            if key in out:
                continue
            out[key] = (info, desc, rel, line)
            for site in info.calls:
                callee = self.resolve_call(info, site.call)
                if callee is not None and not callee.is_async:
                    stack.append((callee, desc, rel, line))
        self._off_loop = out
        return out

    def _off_loop_targets(self, info: FunctionInfo):
        """Yield (FunctionInfo, root_desc, line) for every executor /
        thread submission inside ``info``."""
        for site in info.calls:
            call = site.call
            chain = attr_chain(call.func)
            target_expr = None
            desc = None
            if chain.endswith("run_in_executor") and len(call.args) >= 2:
                target_expr = call.args[1]
                desc = "run_in_executor target"
            elif chain.split(".")[-1] == "Thread" or chain == "Thread":
                for kw in call.keywords:
                    if kw.arg == "target":
                        target_expr = kw.value
                        desc = "Thread(target=) callable"
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "submit" and call.args:
                recv = attr_chain(call.func.value)
                if recv and _EXECUTORISH.search(recv):
                    target_expr = call.args[0]
                    desc = f"{recv}.submit() target"
            if target_expr is None:
                continue
            if isinstance(target_expr, ast.Lambda):
                # scan the lambda body inline: it runs off-loop; give it
                # a synthetic FunctionInfo so callees propagate
                lam = FunctionInfo(info.mod, info.cls_name, "<lambda>",
                                   target_expr,
                                   f"{info.qualname}.<lambda>")
                self._scan_lambda(lam, target_expr)
                yield lam, f"{desc} (lambda)", site.line
                continue
            resolved = self._resolve_expr(info, target_expr)
            if resolved is not None:
                yield resolved, desc, site.line

    def _scan_lambda(self, lam: FunctionInfo, node: ast.Lambda) -> None:
        def visit(n):
            if isinstance(n, ast.Call):
                found = direct_blocking_call(n)
                if found:
                    lam.blocks.append((found[0], found[1], n.lineno))
                lam.calls.append(CallSite(n, n.lineno, False, ()))
            if isinstance(n, ast.Attribute) \
                    and isinstance(n.ctx, (ast.Store, ast.Del)) \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id == "self":
                lam.writes_self.append((n.attr, n.lineno))
            for child in ast.iter_child_nodes(n):
                visit(child)

        visit(node.body)


def _edge_executes(site: CallSite, callee: FunctionInfo) -> bool:
    """A call edge runs the callee's body synchronously iff the callee
    is a plain function, or a coroutine that is awaited right here
    (calling an async def without await just builds the coroutine)."""
    return (not callee.is_async) or site.awaited


def _lock_name(item: ast.withitem) -> Optional[str]:
    expr = item.context_expr
    chain = attr_chain(expr)
    if not chain and isinstance(expr, ast.Call):
        chain = attr_chain(expr.func)
    if chain and _LOCKISH.search(chain):
        return chain
    return None


def _dotted_prefixes(chain: str):
    """'a.b.c' -> ['a.b', 'a'] (longest import-prefix match first)."""
    parts = chain.split(".")
    for i in range(len(parts) - 1, 0, -1):
        yield ".".join(parts[:i])


def _all_functions(midx: _ModuleIdx):
    for info in midx.functions.values():
        yield from _with_nested(info)
    for ci in midx.classes.values():
        for info in ci.methods.values():
            yield from _with_nested(info)


def _with_nested(info: FunctionInfo):
    yield info
    for sub in info.nested.values():
        yield from _with_nested(sub)


def format_chain(names: tuple, msg: str, rel: str, line: int) -> str:
    """'helper -> _sync -> time.sleep() (tpuraft/x.py:42)'."""
    hops = " -> ".join(names + (msg,)) if names else msg
    return f"{hops} ({rel}:{line})"
