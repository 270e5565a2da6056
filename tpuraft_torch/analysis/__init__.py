"""graftcheck: project-invariant static analysis for the Python plane.

PAPER.md §6 wires race detection and sanitizers into the native engines
(``make san``); this package is the equivalent gate for the ~20k-line
Python plane — eight AST-based checkers for the defect classes the
chaos harness kept catching *dynamically* (PR 2's storage lock races
and wedged future waiters, PR 3's wire-format trailing-default drift,
PR 10's hand-wired lane lifecycle sites):

  guarded-by     fields annotated ``# guarded-by: <lock>`` are only
                 touched under ``with self.<lock>``; ``holds(<lock>)``
                 helpers may only be called lock-held — including
                 CROSS-OBJECT calls, satisfied lexically or by a
                 class-level ``# graftcheck: called-under(<lock>)``
                 declaration (guarded_by + concurrency)
  loop-confined  classes annotated ``# graftcheck: loop-confined`` never
                 reach for threading primitives (guarded_by)
  lock-order     the static lock-acquisition graph is acyclic and a
                 subset of the sanctioned partial order committed in
                 ``lock_order.json`` (lock_order)
  wire-schema    every ``register_message`` dataclass matches the
                 committed ``wire_schema.lock.json`` — no field
                 insertion/reorder/removal, new fields only trailing
                 with defaults (wire_schema)
  blocking-call  no ``time.sleep`` / blocking socket IO / untimed
                 ``Future.result()`` in tick-plane code (``ops/``), FSM
                 apply paths, coroutines, or while holding a lock
                 (blocking_calls)
  future-leak    functions that create AND complete a future locally
                 complete it on every path — try/except/finally
                 coverage (future_leaks)
  transitive-blocking / loop-affinity
                 the v2 whole-program pass (callgraph + concurrency):
                 per-function summaries {blocks, acquires,
                 awaits-under-lock} propagate over a project-wide call
                 graph, so the blocking contexts see THROUGH calls;
                 executor/thread targets are inferred off-loop and may
                 not write unguarded loop-confined state
  lane-coverage / host-sync / donated-read
                 the device-plane lint (lanes): every ``[G]`` engine
                 lane is handled at grow/free/conf/shift (``# lane:
                 no-<site> — <reason>`` waivers), device dataclasses
                 stay in parity with their twins and construction
                 sites, jitted bodies never host-sync traced values,
                 donated buffers are never read after the call

Run ``python -m tpuraft.analysis`` (or ``make lint``); intentional wire
or lock-order changes are re-recorded with ``--record`` after review;
``--rule <name>`` filters, ``--json`` emits machine-readable findings.
Escapes: ``# graftcheck: allow(<rule>) — <reason>`` on the offending
line (or on a ``def`` line to waive the whole function); a waiver with
no reason is itself a finding.
"""

from tpuraft_torch.analysis.core import Finding, Module, load_modules, run_checkers

__all__ = ["Finding", "Module", "load_modules", "run_checkers"]
