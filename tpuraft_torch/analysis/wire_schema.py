"""Checker 3: wire-schema drift.

``decode_message`` walks a dataclass's fields IN DECLARATION ORDER and
fills missing TRAILING defaulted fields from their defaults (the
mixed-fleet contract PR 3 added).  That makes the field list part of the
wire format: inserting, reordering, removing or retyping a field — or
appending one without a default — silently breaks decoding against any
older peer, and nothing at the call site looks wrong.  PR 3 only guards
this at DECODE time; this checker guards it at lint time.

The snapshot (``wire_schema.lock.json``) maps every registered type id
to its class, module and ordered field list (name, annotation, default
presence + source).  Extraction is AST-only (no imports — a lint run
must not load jax); the runtime meta-test in tests/test_analysis.py
proves the extraction faithful against the live ``_MSG_TYPES`` registry.

Registration forms recognized (all in use today):

  register_message(128, KVCommandRequest)            # literal call
  @_cli(64) / @_pd(140)                              # tid-decorators that
      class GetLeaderRequest: ...                    # wrap register_message
  for i, t in enumerate([A, B, ...]):                # the raft-core block
      register_message(i, t)

Intentional changes re-record with ``python -m tpuraft.analysis
--record`` (docs/operations.md "Wire-format changes"); --record refuses
nothing but the check tells a compatible extension (append WITH default:
record it) apart from a wire-breaking edit (everything else: redesign it
or version the message)."""

from __future__ import annotations

import ast
import json
import os

from tpuraft_torch.analysis.core import Finding, Module

RULE = "wire-schema"
LOCK_FILE = "wire_schema.lock.json"


def lock_file_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), LOCK_FILE)


# ---- AST extraction ---------------------------------------------------------


def _class_fields(cls: ast.ClassDef) -> list[dict]:
    fields = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            ann = ast.unparse(node.annotation)
            if ann.startswith("ClassVar"):
                continue
            fields.append({
                "name": node.target.id,
                "type": ann,
                "default": ast.unparse(node.value) if node.value else None,
            })
    return fields


def _tid_decorator_names(mod: Module) -> set[str]:
    """Names of module functions that wrap register_message with a tid
    (the _cli/_pd pattern): ``def f(tid): ... register_message(tid, ...)``."""
    out = set()
    for node in mod.tree.body:
        if isinstance(node, ast.FunctionDef):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Call) and isinstance(
                        inner.func, ast.Name) \
                        and inner.func.id == "register_message":
                    out.add(node.name)
                    break
    return out


def extract_module(mod: Module) -> dict[int, dict]:
    """tid -> {cls, module, line, fields} for every registration in one
    module."""
    classes = {n.name: n for n in ast.walk(mod.tree)
               if isinstance(n, ast.ClassDef)}
    tid_decos = _tid_decorator_names(mod)
    found: dict[int, dict] = {}

    def add(tid: int, cls_name: str, line: int) -> None:
        cls = classes.get(cls_name)
        found[tid] = {
            "cls": cls_name,
            "module": mod.rel.replace(os.sep, "/"),
            "line": cls.lineno if cls else line,
            "fields": _class_fields(cls) if cls else [],
        }

    for node in ast.walk(mod.tree):
        # literal call: register_message(128, KVCommandRequest)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "register_message" \
                and len(node.args) == 2 \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, int) \
                and isinstance(node.args[1], ast.Name):
            add(node.args[0].value, node.args[1].id, node.lineno)
        # decorator form: @_cli(64) class Foo: ...
        if isinstance(node, ast.ClassDef):
            for deco in node.decorator_list:
                if isinstance(deco, ast.Call) and isinstance(
                        deco.func, ast.Name) \
                        and deco.func.id in tid_decos \
                        and len(deco.args) == 1 \
                        and isinstance(deco.args[0], ast.Constant) \
                        and isinstance(deco.args[0].value, int):
                    add(deco.args[0].value, node.name, node.lineno)
        # enumerate block: for i, t in enumerate([A, B]): register_message(i, t)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Call) \
                and isinstance(node.iter.func, ast.Name) \
                and node.iter.func.id == "enumerate" \
                and node.iter.args \
                and isinstance(node.iter.args[0], (ast.List, ast.Tuple)):
            body_regs = [
                c for c in ast.walk(node)
                if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                and c.func.id == "register_message"]
            if body_regs:
                for i, elt in enumerate(node.iter.args[0].elts):
                    if isinstance(elt, ast.Name):
                        add(i, elt.id, node.lineno)
    return found


def extract_tree(mods: list[Module]) -> dict[int, dict]:
    schema: dict[int, dict] = {}
    for mod in mods:
        for tid, entry in extract_module(mod).items():
            prev = schema.get(tid)
            if prev is not None and prev["cls"] != entry["cls"]:
                # duplicate tid across modules: surfaced by check()
                entry = dict(entry)
                entry["duplicate_of"] = prev["cls"]
            schema[tid] = entry
    return schema


# ---- lockfile + drift rules -------------------------------------------------


def record(mods: list[Module], path: str | None = None) -> None:
    schema = extract_tree(mods)
    payload = {
        "_comment": (
            "Committed wire schema (graftcheck wire-schema): tid -> "
            "ordered dataclass fields + defaults for every "
            "register_message type.  decode_message fills missing "
            "trailing defaulted fields, so order/defaults ARE the wire "
            "format.  Regenerate with `python -m tpuraft.analysis "
            "--record` after reviewing the change for mixed-fleet "
            "compatibility (docs/operations.md)."),
        "types": {
            str(tid): {k: v for k, v in entry.items() if k != "line"}
            for tid, entry in sorted(schema.items())
        },
    }
    with open(path or lock_file_path(), "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


def load_lock(path: str | None = None) -> dict[int, dict] | None:
    try:
        with open(path or lock_file_path(), "r", encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return None
    return {int(tid): entry for tid, entry in data.get("types", {}).items()}


def check(mods: list[Module], record: bool = False,
          path: str | None = None) -> list[Finding]:
    if record:
        _record_fn(mods, path)
    live = extract_tree(mods)
    lock = load_lock(path)
    out: list[Finding] = []

    for tid, entry in sorted(live.items()):
        if "duplicate_of" in entry:
            out.append(Finding(
                RULE, entry["module"], entry["line"],
                f"type id {tid} registered twice: {entry['duplicate_of']} "
                f"and {entry['cls']}"))

    if lock is None:
        out.append(Finding(
            RULE, "tpuraft/analysis/" + LOCK_FILE, 0,
            "wire_schema.lock.json missing — run "
            "`python -m tpuraft.analysis --record` and commit it"))
        return out

    # a targeted run (`python -m tpuraft.analysis <subpath>`) only
    # extracts the modules it was given: lock entries for modules
    # OUTSIDE the analyzed set are not comparable (everything would
    # read as "removed") — the full-tree gate still covers them
    analyzed = {m.rel.replace(os.sep, "/") for m in mods}
    for tid, old in sorted(lock.items()):
        cur = live.get(tid)
        loc = (old["module"], 0)
        if cur is None:
            if old["module"] not in analyzed:
                continue
            out.append(Finding(
                RULE, *loc,
                f"message type {tid} ({old['cls']}) removed — peers still "
                f"send it; decode_message would KeyError.  Deprecate by "
                f"keeping the class and refusing in the handler"))
            continue
        loc = (cur["module"], cur["line"])
        if cur["cls"] != old["cls"]:
            out.append(Finding(
                RULE, *loc,
                f"type id {tid} renamed {old['cls']} -> {cur['cls']} — "
                f"if the shape changed too this is wire-breaking; "
                f"re-record after review"))
        out.extend(_diff_fields(tid, old, cur, loc))

    for tid, cur in sorted(live.items()):
        if tid not in lock:
            out.append(Finding(
                RULE, cur["module"], cur["line"],
                f"new message type {tid} ({cur['cls']}) not in the "
                f"committed schema — review mixed-fleet behavior (an old "
                f"receiver KeyErrors on an unknown tid: gate it behind "
                f"method negotiation / ENOMETHOD fallback) then "
                f"`python -m tpuraft.analysis --record`"))
    return out


def _diff_fields(tid: int, old: dict, cur: dict,
                 loc: tuple[str, int]) -> list[Finding]:
    out: list[Finding] = []
    ofields, cfields = old["fields"], cur["fields"]
    name = cur["cls"]
    for i, of in enumerate(ofields):
        if i >= len(cfields):
            out.append(Finding(
                RULE, *loc,
                f"{name} (tid {tid}): field '{of['name']}' removed — "
                f"wire-breaking (old peers still encode it); keep the "
                f"field or version the message"))
            continue
        cf = cfields[i]
        if cf["name"] != of["name"]:
            out.append(Finding(
                RULE, *loc,
                f"{name} (tid {tid}): field #{i} changed "
                f"'{of['name']}' -> '{cf['name']}' — insertion/reorder/"
                f"rename is wire-breaking: fields decode by position; "
                f"new fields go LAST with a default"))
        elif cf["type"] != of["type"]:
            out.append(Finding(
                RULE, *loc,
                f"{name} (tid {tid}): field '{cf['name']}' retyped "
                f"{of['type']} -> {cf['type']} — the codec packs by "
                f"annotation; wire-breaking"))
        elif (cf["default"] or None) != (of["default"] or None):
            out.append(Finding(
                RULE, *loc,
                f"{name} (tid {tid}): default of '{cf['name']}' changed "
                f"{of['default']!r} -> {cf['default']!r} — old-format "
                f"frames decode to the default, so this silently changes "
                f"their meaning; re-record only if that is intended"))
    for cf in cfields[len(ofields):]:
        if cf["default"] is None:
            out.append(Finding(
                RULE, *loc,
                f"{name} (tid {tid}): new field '{cf['name']}' has no "
                f"default — frames from old senders fail to decode "
                f"(the PR 3 mixed-fleet guard only fills TRAILING "
                f"DEFAULTED fields).  Give it a default"))
        else:
            out.append(Finding(
                RULE, *loc,
                f"{name} (tid {tid}): compatible extension — new trailing "
                f"defaulted field '{cf['name']}'.  Review then "
                f"`python -m tpuraft.analysis --record`"))
    return out


_record_fn = record
