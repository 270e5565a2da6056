#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell, its configuration, its traffic
and its metrics are found by name (``benchmark/core/spec.py``).  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read under the profiler.  The
numbers the reference compared, each beside its limit, are the last
lines on standard error and the last key of the line.  The process
exits non-zero, with no line, when the card or the cards the cell asks
for are not there, or when jax, jaxlib, flax or the JAX package
``tpuraft`` has been imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuraft")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(torch, chips: int) -> dict:
    """The result's ``device``: ``count`` the cards the cell uses."""
    import subprocess

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit": smi[0] if smi else None}


def result_line(cell, ctx: dict, dev: dict, trace: bool) -> tuple:
    """(the result object, the checks' lines for standard error)."""
    from benchmark.core import spec as spec_mod

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec_mod.reader(m["name"])(ctx)
        if value is None:
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in ctx["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {k: dev[k] for k in ("platform", "kind", "count")}
    device["memory_peak_bytes"] = int(ctx["memory_peak_bytes"])
    out = {"correct": correct, "attempted": int(ctx["attempted"]),
           "failed": int(ctx["failed"]), "metrics": metrics,
           "device": device}
    if trace and ctx.get("trace"):
        device["busy_s"] = ctx["trace"]["busy_s"]
        device["window_s"] = ctx["trace"]["window_s"]
        out["breakdown"] = ctx["trace"]["breakdown"]
    out["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']})"
             for k, c in checks.items()]
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0 or not math.isfinite(args.seconds):
        ap.error("--seconds must be positive")

    from benchmark.core import spec as spec_mod

    cell = spec_mod.resolve(spec_mod.load_spec(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    runner = spec_mod.runner(cell.config)
    ctx = runner.run(cell.config, cell.traffic, args.seed, args.seconds,
                     bool(args.trace), "cuda:0", T_START)
    ctx["card"] = dev = card(torch, cell.chips)
    out, lines = result_line(cell, ctx, dev, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"run: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    notes = {"workload": cell.name, "seed": args.seed, "card": dev,
             **ctx["notes"]}
    try:  # what the process wrote to storage
        with open("/proc/self/io") as f:
            notes["io"] = {k: int(v) for k, v in (
                line.split(": ") for line in f) if k in (
                "wchar", "write_bytes")}
    except OSError:
        pass
    if ctx.get("trace"):
        notes.update({k: ctx["trace"][k]
                      for k in ("kernels", "copies", "reduce_s")})
    print(json.dumps(notes), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    except BaseException:  # noqa: BLE001 — reported, then a failed exit
        import traceback

        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # the CUDA context is torn down with the process; a run starts no
    # child process
    os._exit(rc)
