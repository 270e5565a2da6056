"""graftcheck CLI: ``python -m tpuraft.analysis [paths...] [options]``.

Exit codes: 0 clean, 1 findings, 2 internal error.  Pure-stdlib and
import-free with respect to the analyzed tree — a whole-tree run stays
well under the ~10s lint budget (the jax import alone would triple it).

  python -m tpuraft.analysis                 # lint tpuraft/ (the gate)
  python -m tpuraft.analysis examples        # lint another tree
  python -m tpuraft.analysis --rule guarded-by
  python -m tpuraft.analysis --json          # machine-readable findings
                                             # (file/line/rule/message)
                                             # for CI annotation
  python -m tpuraft.analysis --record        # re-record wire_schema.
                                             # lock.json + lock_order.json
                                             # after reviewing a change
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from tpuraft_torch.analysis.core import (RULES, load_modules, repo_root,
                                   run_checkers)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuraft_torch.analysis",
        description="graftcheck: project-invariant static analysis "
                    "(guarded-by, lock-order, wire-schema, blocking-call, "
                    "future-leak, transitive-blocking, loop-affinity, "
                    "lane-coverage, host-sync, donated-read, raw-clock)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint "
                         "(default: tpuraft_torch/)")
    ap.add_argument("--record", action="store_true",
                    help="re-record wire_schema.lock.json and "
                         "lock_order.json from the live tree, then verify")
    ap.add_argument("--rule", action="append", choices=sorted(RULES),
                    help="run only these rules (repeatable)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array of {file, line, "
                         "rule, message} on stdout (for CI annotation)")
    ap.add_argument("--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    roots = args.paths or [os.path.join(repo_root(), "tpuraft_torch")]
    mods, findings = load_modules(roots)
    findings += run_checkers(mods, record=args.record,
                             rules=set(args.rule) if args.rule else None)
    if args.as_json:
        print(json.dumps(
            [{"file": f.path, "line": f.line, "rule": f.rule,
              "message": f.message} for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
    if not args.quiet:
        dt = time.monotonic() - t0
        verdict = "clean" if not findings else f"{len(findings)} finding(s)"
        print(f"graftcheck: {len(mods)} files, {verdict} "
              f"[{dt:.2f}s]" + (" (lockfiles re-recorded)"
                                if args.record else ""),
              file=sys.stderr)
    return 1 if findings else 0


def _run() -> int:
    try:
        return main()
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001 — the gate's error contract
        import traceback

        traceback.print_exc()
        print("graftcheck: internal error (exit 2)", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_run())
