"""Checkers 7+8: device-plane lane lint (graftcheck v2).

The engine's premise is vectorizing per-group protocol state over the
``[G]`` / ``[G, P]`` device plane — and every new lane pays a wiring
tax at four engine lifecycle sites.  PR 10's ``tick_q_ack`` touched
grow/``pad``, the ``release`` reset, ``set_conf`` invalidation and the
time-shift path, and nothing but review memory catches a missed site
until state silently corrupts on resize.  These rules mechanize that
contract:

``lane-coverage``
    Every ``[G]``/``[G, P]`` lane — a ``self.X = np.zeros/full/ones/
    empty(g, ...)`` assignment in ``MultiRaftEngine.__init__`` whose
    leading dimension is the group-capacity local ``g`` — must be
    WRITTEN at each of the four lifecycle sites:

      grow   ``_grow``               (capacity doubling pads every lane)
      free   ``release``             (slot reuse resets every lane)
      conf   ``set_conf``            (conf-derived lanes re-map/invalidate)
      shift  ``_maybe_time_rebase``  (time-valued lanes epoch-shift)

    One level of intra-class call resolution applies (``release`` covers
    ``has_ctrl`` through its ``self.unregister_ctrl(s)`` call).  A lane
    that legitimately skips a site declares it ON ITS DECLARATION LINE:

        self.role = np.full(g, ROLE_INACTIVE, np.int32) \\
            # lane: no-conf no-shift — role is host-applied, not
            # conf-derived; not time-valued

    A waiver with no reason is itself a finding (the graftcheck
    escape-hatch policy).  The same rule keeps the device dataclasses
    honest: ``GroupState``/``TickOutputs`` field sets must match every
    keyword construction of them (engine upload, mesh shardings, the
    numpy twin) and ``_NpOutputs.__slots__`` must equal ``TickOutputs``
    — the exact multi-file drift PR 10 hand-wired.

``host-sync``
    On the tick path of the torch port — the functions that launch a
    port kernel (they call a ``tpuraft_*`` entry point of the library
    ``quorum_cuda.load()`` returns), the tick-plane wrappers around them
    (``ops/``, ``parallel/collective.py``, ``parallel/mesh.py``), the
    functions that call a wrapper through an attribute bound to it, and
    everything the launching functions and those callers call — flag host
    synchronization: ``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``, ``int()/float()/bool()`` of a tensor, and
    data-dependent Python branching (``if``/``while`` on a tensor's
    values; its shape, dtype, device and identity are metadata).  A
    parameter may hold a tensor unless its annotation is scalar
    (str/int/bool/float); so may a local bound from a ``torch.*`` call.
    The tick's one designed device->host copy carries a
    ``# graftcheck: allow(host-sync) — <reason>`` waiver.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from tpuraft_torch.analysis.callgraph import (ProjectIndex, _all_functions,
                                              _module_name_to_rel,
                                              _with_nested)
from tpuraft_torch.analysis.core import Finding, Module, attr_chain

RULE_LANE = "lane-coverage"
RULE_SYNC = "host-sync"
RULE_DONATED = "donated-read"

ENGINE_CLASS = "MultiRaftEngine"
SITES = (
    ("grow", "_grow"),
    ("free", "release"),
    ("conf", "set_conf"),
    ("shift", "_maybe_time_rebase"),
)
_SITE_NAMES = {s for s, _ in SITES}

_LANE_RE = re.compile(r"#\s*lane:\s*((?:no-[a-z]+\s*)+)(?:[—–-]+\s*(\S.*))?")
_NP_CTORS = {"np.zeros", "np.full", "np.ones", "np.empty",
             "numpy.zeros", "numpy.full", "numpy.ones", "numpy.empty"}
_STATE_CLASSES = ("GroupState", "TickOutputs")
_NP_TWIN = "_NpOutputs"
_SCALARISH = re.compile(r"\b(str|int|bool|float|bytes|None)\b")
_ARRAYISH = re.compile(r"ndarray|Array|GroupState|TickParams|TickOutputs")


def check(mods: list[Module], index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    out.extend(_check_lanes(mods))
    out.extend(_check_state_parity(mods))
    out.extend(_check_host_sync(index))
    return out


# ---- lane-site coverage -----------------------------------------------------


def _check_lanes(mods: list[Module]) -> list[Finding]:
    out: list[Finding] = []
    for mod in mods:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == ENGINE_CLASS:
                out.extend(_check_engine_class(mod, node))
    return out


def _check_engine_class(mod: Module, cls: ast.ClassDef) -> list[Finding]:
    methods = {item.name: item for item in cls.body
               if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))}
    init = methods.get("__init__")
    if init is None:
        return []
    lanes = _collect_lanes(mod, init)
    if not lanes:
        return []
    out: list[Finding] = []
    written = {}
    for site, meth_name in SITES:
        fn = methods.get(meth_name)
        written[site] = (_written_attrs(methods, fn) if fn is not None
                         else set())
    for name, (line, waived, reason, bad_tokens) in sorted(lanes.items()):
        for tok in bad_tokens:
            out.append(Finding(
                RULE_LANE, mod.rel, line,
                f"lane '{name}': unknown waiver site 'no-{tok}' (known: "
                + ", ".join(f"no-{s}" for s in _SITE_NAMES) + ")"))
        if waived and not reason:
            out.append(Finding(
                RULE_LANE, mod.rel, line,
                f"lane '{name}': waiver carries no justification — write "
                f"'# lane: no-<site> — <reason>'"))
        for site, meth_name in SITES:
            if site in waived:
                continue
            if name not in written[site]:
                out.append(Finding(
                    RULE_LANE, mod.rel, line,
                    f"[G] lane '{name}' (declared line {line}) is not "
                    f"covered at the {site} site ({ENGINE_CLASS}."
                    f"{meth_name}) — handle it there or waive with "
                    f"'# lane: no-{site} — <reason>'"))
    return out


def _collect_lanes(mod: Module, init) -> dict:
    """lane name -> (decl line, waived site set, reason, bad tokens)."""
    lanes: dict = {}
    for node in ast.walk(init):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            continue
        if not _is_group_row_ctor(node.value):
            continue
        waived: set[str] = set()
        bad: list[str] = []
        reason = ""
        m = _LANE_RE.search(mod.comment_block_above(node.lineno))
        if m:
            for tok in m.group(1).split():
                site = tok[3:]
                if site in _SITE_NAMES:
                    waived.add(site)
                else:
                    bad.append(site)
            reason = (m.group(2) or "").strip()
        lanes[t.attr] = (node.lineno, waived, reason, bad)
    return lanes


def _is_group_row_ctor(value: ast.AST) -> bool:
    """np.zeros/full/ones/empty with the group-capacity local ``g`` as
    the leading dimension."""
    if not isinstance(value, ast.Call) or not value.args:
        return False
    if attr_chain(value.func) not in _NP_CTORS:
        return False
    shape = value.args[0]
    if isinstance(shape, ast.Tuple) and shape.elts:
        shape = shape.elts[0]
    return isinstance(shape, ast.Name) and shape.id == "g"


def _written_attrs(methods: dict, fn, depth: int = 1) -> set[str]:
    """self attributes written anywhere in ``fn``, with one level of
    intra-class self-call resolution."""
    written: set[str] = set()
    calls: list[str] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                _collect_target(t, written)
        elif isinstance(node, ast.AugAssign):
            _collect_target(node.target, written)
        elif isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            for kw in node.keywords:
                if kw.arg == "out":
                    _self_attr_of(kw.value, written)
            if chain.endswith("copyto") and node.args:
                _self_attr_of(node.args[0], written)
            if chain.startswith("self.") and chain.count(".") == 2 \
                    and chain.endswith((".fill", ".clear")):
                written.add(chain.split(".")[1])
            if chain.startswith("self.") and chain.count(".") == 1:
                calls.append(chain[5:])
    if depth > 0:
        for name in calls:
            callee = methods.get(name)
            if callee is not None and callee is not fn:
                written |= _written_attrs(methods, callee, depth - 1)
    return written


def _collect_target(t: ast.AST, written: set[str]) -> None:
    if isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            _collect_target(e, written)
        return
    if isinstance(t, ast.Starred):
        _collect_target(t.value, written)
        return
    if isinstance(t, ast.Subscript):
        _self_attr_of(t.value, written)
        return
    _self_attr_of(t, written)


def _self_attr_of(node: ast.AST, written: set[str]) -> None:
    chain = attr_chain(node)
    if chain.startswith("self.") and chain.count(".") == 1:
        written.add(chain[5:])


# ---- device dataclass parity ------------------------------------------------


def _check_state_parity(mods: list[Module]) -> list[Finding]:
    fields: dict[str, tuple[list[str], str, int]] = {}  # cls -> (names, rel, line)
    slots: list[tuple[list[str], Module, int]] = []
    for mod in mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if node.name in _STATE_CLASSES:
                names = [item.target.id for item in node.body
                         if isinstance(item, ast.AnnAssign)
                         and isinstance(item.target, ast.Name)]
                if names:
                    fields.setdefault(node.name,
                                      (names, mod.rel, node.lineno))
            elif node.name == _NP_TWIN:
                for item in node.body:
                    if isinstance(item, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id == "__slots__"
                            for t in item.targets):
                        vals = getattr(item.value, "elts", [])
                        names = [v.value for v in vals
                                 if isinstance(v, ast.Constant)]
                        slots.append((names, mod, item.lineno))
    out: list[Finding] = []
    tick_out = fields.get("TickOutputs")
    if tick_out is not None:
        expected = set(tick_out[0])
        for names, mod, line in slots:
            missing = expected - set(names)
            extra = set(names) - expected
            if missing or extra:
                out.append(Finding(
                    RULE_LANE, mod.rel, line,
                    f"{_NP_TWIN}.__slots__ drifted from TickOutputs "
                    f"({tick_out[1]}:{tick_out[2]})"
                    + (f": missing {sorted(missing)}" if missing else "")
                    + (f": extra {sorted(extra)}" if extra else "")
                    + " — the numpy twin must mirror the device lanes"))
    # every keyword construction of a state class passes the full lane set
    for mod in mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = attr_chain(node.func).split(".")[-1]
            target = name if name in _STATE_CLASSES else (
                "TickOutputs" if name == _NP_TWIN else None)
            if target is None or target not in fields:
                continue
            if node.args or not node.keywords \
                    or any(kw.arg is None for kw in node.keywords):
                continue  # positional/**kw constructions: out of scope
            expected = set(fields[target][0])
            got = {kw.arg for kw in node.keywords}
            missing = expected - got
            if missing:
                out.append(Finding(
                    RULE_LANE, mod.rel, node.lineno,
                    f"{name}(...) construction misses lane field(s) "
                    f"{sorted(missing)} (declared {fields[target][1]}:"
                    f"{fields[target][2]}) — every device-state "
                    f"construction site must carry every lane"))
    return out


# ---- the tick path: kernel launches and the functions around them -------


def _in_tick_plane(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    return "/ops/" in rel or rel.startswith("ops/") \
        or rel.endswith(("parallel/collective.py", "parallel/mesh.py"))


def _launches(fn) -> bool:
    """Does ``fn`` call an entry point (``<lib>.tpuraft_*(...)``) of a
    kernel library it bound from a ``load()`` call?"""
    libs = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and attr_chain(node.value.func).split(".")[-1] == "load":
            libs |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr.startswith(_ENTRY_PREFIX) \
                and attr_chain(node.func.value) in libs:
            return True
    return False


class _TickPath:
    """The functions the torch host-sync rule reads:

    - roots: the functions that launch a port kernel;
    - the wrappers: tick-plane functions (``ops/``,
      ``parallel/collective.py``, ``parallel/mesh.py``) that reach a
      root;
    - the callers: functions elsewhere that call a wrapper through an
      attribute bound to it (``self._tick_fn = raft_tick_outputs``,
      ``self._fn = replicated_tick(...)``), where the tick's copies
      live;
    - everything the roots and those callers call.
    """

    def __init__(self, index: ProjectIndex):
        self.index = index
        funcs = [info for midx in index.by_rel.values()
                 for info in _all_functions(midx)]
        callees = {id(f): [c for c in (index.resolve_call(f, site.call)
                                       for site in f.calls)
                           if c is not None] for f in funcs}
        roots = [f for f in funcs if _launches(f.node)]
        scope = {id(f): f for f in roots}
        # wrappers: tick-plane callers of the scope, to a fixed point
        grew = True
        while grew:
            grew = False
            for f in funcs:
                if id(f) not in scope and _in_tick_plane(f.mod.rel) \
                        and any(id(c) in scope for c in callees[id(f)]):
                    scope[id(f)] = f
                    grew = True
        bound = {}  # (module, class) -> attributes bound to a wrapper
        callers = []
        for f in funcs:
            if id(f) in scope or f.cls_name is None:
                continue
            key = (f.mod.rel, f.cls_name)
            if key not in bound:
                bound[key] = self._bound_attrs(f, scope)
            if bound[key] and any(
                    isinstance(site.call.func, ast.Attribute)
                    and attr_chain(site.call.func).startswith("self.")
                    and attr_chain(site.call.func)[5:] in bound[key]
                    for site in f.calls):
                callers.append(f)
        stack = list(roots)
        for f in callers:
            scope[id(f)] = f
            stack += [c for c in callees[id(f)] if not c.is_async]
        while stack:
            f = stack.pop()
            if id(f) in scope and f not in roots:
                continue
            scope[id(f)] = f
            stack += [c for c in callees.get(id(f), ())
                      if id(c) not in scope and not c.is_async]
        self.scope = scope

    def _bound_attrs(self, f, scope) -> set[str]:
        """Attributes of ``f``'s class bound to a wrapper, or to the
        result of a tick-plane factory whose nested function is one."""
        midx = self.index.by_rel.get(f.mod.rel)
        ci = midx.classes.get(f.cls_name) if midx is not None else None
        out = set()
        for meth in (ci.methods.values() if ci is not None else ()):
            local = {}  # names bound by `from <module> import <name>`
            binds = []
            for node in ast.walk(meth.node):
                if isinstance(node, ast.ImportFrom) and node.module \
                        and not node.level:
                    for alias in node.names:
                        local[alias.asname or alias.name] = (
                            _module_name_to_rel(node.module), alias.name)
                elif isinstance(node, ast.Assign) \
                        and len(node.targets) == 1:
                    tgt = attr_chain(node.targets[0])
                    if tgt.startswith("self.") and tgt.count(".") == 1:
                        binds.append((tgt[5:], node.value))
            for attr, val in binds:
                factory = isinstance(val, ast.Call)
                fexpr = val.func if factory else val
                target = self.index._resolve_expr(meth, fexpr)
                if target is None and attr_chain(fexpr) in local:
                    target = self.index._lookup(*local[attr_chain(fexpr)])
                if target is None or not _in_tick_plane(target.mod.rel):
                    continue
                if id(target) in scope or factory and any(
                        id(n) in scope for n in _with_nested(target)):
                    out.add(attr)
        return out


# ---- torch host-sync lint ---------------------------------------------------

_ENTRY_PREFIX = "tpuraft_"
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
# tensor metadata: reading it never waits for the device
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "nbytes", "itemsize"}
_META_METHODS = {"dim", "size", "numel", "is_contiguous", "data_ptr",
                 "stride", "element_size", "nelement", "get_device"}
_TENSORISH = re.compile(r"Tensor|GroupState|TickParams|TickOutputs")


def _check_host_sync(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    path = _TickPath(index)
    for info in path.scope.values():
        out.extend(_scan_tick_fn(info))
    return out


def _tensor_names(fn) -> set[str]:
    """Parameters that may hold tensors (not annotated as a scalar),
    and locals bound from a ``torch.*`` call or from a method of one."""
    names = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        if a.arg in ("self", "cls"):
            continue
        ann = ast.unparse(a.annotation) if a.annotation is not None else ""
        if not ann or _TENSORISH.search(ann) or not _SCALARISH.search(ann):
            names.add(a.arg)
    grew = True
    while grew:
        grew = False
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            chain = attr_chain(node.value.func)
            recv = node.value.func.value \
                if isinstance(node.value.func, ast.Attribute) else None
            made = (chain.startswith("torch.")
                    and not chain.startswith(("torch.cuda.", "torch.device"))
                    ) or (isinstance(recv, ast.Name) and recv.id in names
                          and node.value.func.attr not in _META_METHODS)
            if not made:
                continue
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id not in names:
                        names.add(n.id)
                        grew = True
    return names


def _reads_data(expr, tensors: set[str]) -> bool:
    """Does ``expr`` read a tensor's values (not its metadata, not its
    identity)?"""
    if isinstance(expr, ast.Name):
        return expr.id in tensors
    if isinstance(expr, ast.Attribute) and expr.attr in _META_ATTRS:
        return False
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Attribute) and f.attr in _META_METHODS:
            return False
        if attr_chain(f) in ("isinstance", "len", "type", "id"):
            return False
    if isinstance(expr, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
        return False
    return any(_reads_data(c, tensors) for c in ast.iter_child_nodes(expr))


def _scan_tick_fn(info) -> list[Finding]:
    fn = info.node
    mod = info.mod
    tensors = _tensor_names(fn)
    out: list[Finding] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args:
                out.append(Finding(
                    RULE_SYNC, mod.rel, node.lineno,
                    f"{info.qualname}(): .{node.func.attr}() on the tick "
                    f"path waits for the device and copies to the host — "
                    f"keep the value on the device, or waive the tick's "
                    f"one designed copy"))
            elif chain in ("int", "float", "bool") and node.args \
                    and _reads_data(node.args[0], tensors):
                out.append(Finding(
                    RULE_SYNC, mod.rel, node.lineno,
                    f"{info.qualname}(): {chain}() of a tensor on the tick "
                    f"path is a device->host sync — keep it a tensor or "
                    f"pass a host value"))
        elif isinstance(node, (ast.If, ast.While)) \
                and _reads_data(node.test, tensors):
            kind = "if" if isinstance(node, ast.If) else "while"
            out.append(Finding(
                RULE_SYNC, mod.rel, node.lineno,
                f"{info.qualname}(): data-dependent Python `{kind}` on a "
                f"tensor on the tick path syncs with the device — branch "
                f"with torch.where or decide on the host's values"))
    return out
