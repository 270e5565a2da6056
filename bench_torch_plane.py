#!/usr/bin/env python3
"""Batched multi-raft commit throughput of the port's device plane on
one CUDA card: the counterpart of ``bench.py``.

    python3 bench_torch_plane.py [--out FILE]
    python3 bench_torch_plane.py --cpu [--groups G] [--ticks N]

G = 16,384 raft groups of P = 8 peer slots (3 voters), each follower
acking 16-32 entries a tick; per tick one upload of the [G, P] match
plane, one fused-tick launch and one asynchronous commit download,
with a bounded in-flight window sized from the measured completion RTT
and dispatch cost (``tpuraft_torch.device_plane.run_plane``).  400 ticks
after 40 warm-up ticks; the median of three passes, then one more pass
under ``torch.profiler`` for the card's busy share.

Prints ONE JSON line, ``{"metric":
"multiraft_batched_commits_per_sec_16k_groups", "value": N, "unit":
"commits/s", "extra": {...}}``, and writes it with every pass to
``--out`` (default ``chiprun_out/bench_torch_plane.json``).  Exits 1 if
the fused tick's launches differ from the ticks run.  ``--cpu`` runs the
plain tick on the host at a small size: a rehearsal, no device figure.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_record(torch) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip(),
            "count": torch.cuda.device_count()}


def host_record() -> dict:
    """A host-plane record's machine: no device runs its work, and the
    card beside it (name and power limit), where there is one."""
    import torch

    return {"device": None, "plane": "host",
            "card": card_record(torch) if torch.cuda.is_available()
            else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the plain tick on the host at a small size "
                         "(a rehearsal; no device figure)")
    ap.add_argument("--groups", type=int, default=None,
                    help="with --cpu only: raft groups (default 256)")
    ap.add_argument("--ticks", type=int, default=None,
                    help="with --cpu only: ticks after the warm-up "
                         "(default 60)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "bench_torch_plane.json"))
    args = ap.parse_args()
    if (args.groups is not None or args.ticks is not None) and not args.cpu:
        ap.error("--groups and --ticks are for the --cpu rehearsal only")

    import torch

    from tpuraft_torch.device_plane import run_plane

    if args.cpu:
        groups, ticks, warmup = args.groups or 256, args.ticks or 60, 4
        card = {"name": "cpu", "nvidia_smi": None, "count": 0}
    else:
        groups, ticks, warmup = 16384, 400, 40
        card = card_record(torch)  # raises without a card
    res = run_plane(groups, 8, 3, 32, ticks, warmup, 0,
                    device="cpu" if args.cpu else "cuda")
    prof = res["profiled_pass"]
    extra = {
        "groups": groups, "peer_slots": 8, "voters": 3, "batch": 32,
        "ticks": ticks, "warmup": warmup,
        "commits_per_tick_per_group": res["commits_per_tick_per_group"],
        "pipeline_depth": res["pipeline_depth"],
        "dispatch_ms": res["dispatch_ms"],
        "ticks_per_sec": res["ticks_per_sec"],
        "aggregation": res["aggregation"],
        "pass_commits_per_sec": [p["commits_per_sec"]
                                 for p in res["passes"]],
        "ack_p50_ms": res["ack_p50_ms"], "ack_p99_ms": res["ack_p99_ms"],
        "completion_rtt_ms": res["completion_rtt_ms"],
        "launches": res["launches"], "ticks_run": res["ticks_run"],
        "profiled_pass": {k: prof[k] for k in (
            "ticks", "wall_s", "ticks_per_sec", "device_busy_ms",
            "busy_share", "device_busy_us_per_tick", "kernels", "copies")
            if k in prof},
        "device": res["device"], "card": card,
    }
    line = {"metric": "multiraft_batched_commits_per_sec_16k_groups",
            "value": res["commits_per_sec"], "unit": "commits/s",
            "extra": extra}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({**line, "passes": res["passes"], "rtt_ms": res["rtt_ms"]},
                  f, indent=1)
    print(json.dumps(line))
    if not args.cpu and res["launches"] != res["ticks_run"]:
        print(f"bench_torch_plane: {res['launches']} fused-tick launches "
              f"for {res['ticks_run']} ticks", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
