"""raw-clock: timing-sensitive code must read the injectable clock.

ISSUE 18 made every store's time plane injectable (tpuraft/util/clock.py):
election timers, engine tick deadlines, store-lease bookkeeping, lease
windows and health hysteresis all read ONE per-store clock, so a
ChaosClock skews a store exactly like a machine with a bad oscillator —
and the drift-bound lease math stays honest because no consumer secretly
falls back to the real clock.  A direct ``time.monotonic()`` /
``time.time()`` / ``loop.time()`` call inside the clock-disciplined
tree punches a hole in that plane: the chaos soak can no longer reach
the code path, and the lease-safety argument silently loses a premise.

Scope: ``tpuraft/core/``, ``tpuraft/rheakv/`` and
``tpuraft/util/health.py`` (the hysteresis trackers).  ``time.
perf_counter()`` is exempt — it only feeds trace/latency telemetry and
MUST stay on the real clock (a frozen chaos clock would zero every
duration histogram).  Genuinely real-time sites (operator drain
budgets, scrape-cache TTLs, PD-side cooldowns, client retry deadlines)
carry ``# graftcheck: allow(raw-clock) — <reason>`` waivers; the
reason requirement rides the existing reasonless-waiver finding.
"""

from __future__ import annotations

import ast

from tpuraft_torch.analysis.core import (
    _ALLOW_RE,
    Finding,
    Module,
    attr_chain,
)

# rel-path prefixes under the clock discipline
_SCOPES = ("tpuraft_torch/core/", "tpuraft_torch/rheakv/")
_SCOPE_FILES = ("tpuraft_torch/util/health.py",)

# dotted call chains that read the REAL clock directly
_RAW_CHAINS = {"time.monotonic", "time.time"}


def _in_scope(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    return rel.startswith(_SCOPES) or rel in _SCOPE_FILES


def _is_raw_call(node: ast.Call) -> str:
    """'' when fine, else the offending dotted chain."""
    chain = attr_chain(node.func)
    if chain in _RAW_CHAINS:
        return chain
    # loop.time() in any spelling: `loop.time()`, `self._loop.time()`,
    # `asyncio.get_running_loop().time()` resolves to no plain chain,
    # but the common direct forms do
    if chain.endswith(".time") and "loop" in chain.rsplit(".", 2)[-2]:
        return chain
    return ""


def _block_waived(mod: Module, line: int) -> bool:
    """Multi-line waiver blocks: the allow() marker may sit on the FIRST
    line of a wrapped standalone comment block above the call — the
    single-line ``Module.waived`` lookback misses those, exactly like
    the loop-confined annotations before ``comment_block_above``."""
    for m in _ALLOW_RE.finditer(mod.comment_block_above(line)):
        if m.group(1) == "raw-clock":
            return True
    return False


def check(mods: list[Module]) -> list[Finding]:
    out: list[Finding] = []
    for mod in mods:
        if not _in_scope(mod.rel):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _is_raw_call(node)
            if not chain:
                continue
            if _block_waived(mod, node.lineno):
                continue
            out.append(Finding(
                "raw-clock", mod.rel, node.lineno,
                f"direct {chain}() in clock-disciplined code — read the "
                f"store's injectable clock (tpuraft/util/clock.py; "
                f"node._clock / hub.clock / engine._clock) so chaos "
                f"clocks and the drift-bound lease math reach this "
                f"path, or waive with a written reason"))
    return out
