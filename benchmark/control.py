#!/usr/bin/env python3
"""The controls: the reference, with one guarantee of the configuration
broken, put in the program's place and judged as a run is judged.  A
control has to come out not correct; its readings are the upper ends of
the limits the checks hold the program to (PERF.md lists them).  The
benchmark's own runs never run it.

    python3 benchmark/control.py --workload NAME --seeds 11,12,13 --seconds S

- the commit plane: the reference's commit computed on the card, at the
  cell's own G and P, from the match one tick old (before the tick's
  acks landed), in place of ``raft_tick`` inside ``device_plane``'s
  loop: a tick's row no longer counts every ack landed before it.

One JSON line a seed: the checks' readings, and whether it came out
correct.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark.core import spec as spec_mod  # noqa: E402


class StaleMatchTick:
    """The reference's commit, computed on the state's device from the
    match one tick old: the majority-th largest voter match of the
    match before this tick's acks landed."""

    def __init__(self):
        self.prev = None

    def __call__(self, state, now_ms, params):
        import torch

        match = state.match_rel
        old = self.prev if self.prev is not None else torch.zeros_like(match)
        self.prev = match.clone()
        low = torch.full_like(old, torch.iinfo(torch.int32).min)
        ranked = torch.where(state.voter_mask, old, low).sort(
            dim=1, descending=True).values
        q = (state.voter_mask.sum(dim=1) // 2).clamp(max=match.shape[1] - 1)
        quorum = ranked.gather(1, q[:, None].long())[:, 0]
        can = (state.role == 2) & (quorum >= state.pending_rel)
        commit = torch.where(can, torch.maximum(state.commit_rel, quorum),
                             state.commit_rel)
        return (dataclasses.replace(state, commit_rel=commit),
                SimpleNamespace(commit_rel=commit))


@contextlib.contextmanager
def tick_replaced(fn):
    """``device_plane``'s tick replaced by ``fn`` for the block."""
    from tpuraft_torch import device_plane

    orig = device_plane.raft_tick
    device_plane.raft_tick = fn
    try:
        yield
    finally:
        device_plane.raft_tick = orig


def plane_control(cell, seed: int, seconds: float, device: str) -> dict:
    run = spec_mod.runner(cell.config).run
    with tick_replaced(StaleMatchTick()):
        ctx = run(cell.config, cell.traffic, seed, seconds, False, device,
                  time.perf_counter())
    return ctx["checks"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    cell = spec_mod.resolve(spec_mod.load_spec(ROOT),
                            args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = plane_control(cell, seed, args.seconds, args.device)
        print(json.dumps({
            "control": cell.name, "seed": seed,
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: v for k, (v, _) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
