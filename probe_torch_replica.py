#!/usr/bin/env python3
"""The replica-quorum kernel (csrc/replica_quorum.cu) on one CUDA card:
where a launch's time goes, and a parent and change pair in one process.

    python3 probe_torch_replica.py --parent OLD.cu [--change NEW.cu]
                                   [--out DIR]

OLD.cu is another version of ``replica_quorum.cu`` (for a parent commit:
``git archive <commit> tpuraft_torch/ops/csrc | tar -x -C build/parent``);
NEW.cu defaults to this checkout's.  Passing OLD.cu as both times one
version four times (how to measure it before the change exists).
Each source is built alone with ``nvcc -Xptxas -v`` into its own library
(the plain C interface ``tpuraft_replica_quorum``), beside two variants
compiled from this file that bound a launch from below:

- ``null``: the launch's grid with an empty body (one thread a group,
  and one segment of S lanes a group);
- ``copy``: every input read once and both outputs written, with no
  ranking (the per-group maximum stands in for the commit).

At every shape both versions must equal the plain torch version on the
edge and extremes planes of ``chip_smoke.py``. Then each variant, both
versions (parent, change, change, parent), ``torch.kthvalue`` and the
plain version are timed as CUDA graphs of 100 launches. ptxas' report
and the SASS of both libraries go to DIR (default chiprun_out/probe);
the last line is a JSON summary, also written to DIR/probe.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "tpuraft_torch" / "ops" / "csrc"
SHAPES = [(3, 1024), (3, 16384), (5, 1024), (1, 1000), (2, 1000), (4, 1000),
          (7, 1000), (8, 1000), (9, 1000), (16, 1000), (17, 1000),
          (32, 1000), (33, 1000), (64, 1000), (65, 1000)]

VARIANTS = r"""
#include "quorum_core.cuh"
using namespace tpuraft;

__global__ void null_kernel() {}

template <int RMAX>
__global__ void __launch_bounds__(kThreads) copy_thread(
    const int32_t* __restrict__ rel, const uint8_t* __restrict__ granted,
    int32_t* __restrict__ commit, int32_t* __restrict__ votes, int R,
    int G) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  int32_t m = INT32_MIN;
  int n = 0;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
    m = max(m, __ldg(rel + static_cast<size_t>(r) * G + g));
    n += __ldg(granted + static_cast<size_t>(r) * G + g) != 0;
  }
  commit[g] = m;
  votes[g] = n;
}

template <int S, int V>
__global__ void __launch_bounds__(kThreads) copy_segment(
    const int32_t* __restrict__ rel, const uint8_t* __restrict__ granted,
    int32_t* __restrict__ commit, int32_t* __restrict__ votes, int R,
    int G) {
  const Lane<S> ln(G, R);
  int32_t m = INT32_MIN;
  int n = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int r = ln.k + j * S;
    const bool live = ln.g < G && r < R;
    const size_t off = static_cast<size_t>(r) * G + ln.g;
    m = max(m, live ? __ldg(rel + off) : INT32_MIN);
    n += __popc(ln.ballot(live && __ldg(granted + off) != 0));
  }
  m = segment_max<S>(m);
  if (ln.k == 0 && ln.g < G) {
    commit[ln.g] = m;
    votes[ln.g] = n;
  }
}

template <int S, int V>
cudaError_t seg(const int32_t* rel, const uint8_t* granted, int32_t* commit,
        int32_t* votes, int R, int G, cudaStream_t s) {
  copy_segment<S, V><<<grid_for<S>(G), kThreads, 0, s>>>(rel, granted,
                                                         commit, votes, R, G);
  return cudaGetLastError();
}

template <int RMAX>
cudaError_t thr(const int32_t* rel, const uint8_t* granted, int32_t* commit,
        int32_t* votes, int R, int G, cudaStream_t s) {
  copy_thread<RMAX><<<(G + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      rel, granted, commit, votes, R, G);
  return cudaGetLastError();
}

extern "C" int probe_null(int blocks, cudaStream_t s) {
  null_kernel<<<blocks, kThreads, 0, s>>>();
  return cudaGetLastError();
}

extern "C" int probe_copy_segment(const int32_t* rel, const uint8_t* gr,
                                  int32_t* c, int32_t* v, int R, int G,
                                  cudaStream_t s) {
  if (R <= kMaxPeers)
    return with_segment(R, [&](auto w) {
      return seg<decltype(w)::value, 1>(rel, gr, c, v, R, G, s);
    });
  return R <= 2 * kMaxPeers ? seg<32, 2>(rel, gr, c, v, R, G, s)
                            : cudaErrorInvalidValue;
}

extern "C" int probe_copy_thread(const int32_t* rel, const uint8_t* gr,
                                 int32_t* c, int32_t* v, int R, int G,
                                 cudaStream_t s) {
  if (R <= 4) return thr<4>(rel, gr, c, v, R, G, s);
  if (R <= 8) return thr<8>(rel, gr, c, v, R, G, s);
  if (R <= 16) return thr<16>(rel, gr, c, v, R, G, s);
  if (R <= 32) return thr<32>(rel, gr, c, v, R, G, s);
  return thr<64>(rel, gr, c, v, R, G, s);
}
"""

QUORUM_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]


def build(out: Path, sources: dict) -> dict:
    """name -> (library, ptxas output): one nvcc a source, all at once."""
    from tpuraft_torch.ops import quorum_cuda

    nvcc = quorum_cuda._find_nvcc()
    procs = {}
    for name, src in sources.items():
        so = out / f"lib_{name}.so"
        cmd = [nvcc, *quorum_cuda._NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(CSRC), "-shared", "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (so, p) in procs.items():
        text = p.communicate()[0]
        cs.check(p.returncode == 0, f"nvcc {name} failed:\n{text}")
        (out / f"ptxas_{name}.txt").write_text(text)
        built[name] = (so, text)
    return built


def ptxas_report(text: str) -> list[str]:
    """One line a kernel: its name and ptxas' registers, stack and
    spills."""
    lines, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m[1]
        elif entry and ("Used" in line or "spill" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def sass_loads(nvcc: str, so: Path, out: Path, name: str) -> dict:
    """The SASS of every kernel in ``so`` (saved to DIR), and for each
    replica-quorum kernel where its global loads sit: their indices in
    the instruction stream and the branches among them."""
    tool = Path(nvcc).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True)
    cs.check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
    (out / f"sass_{name}.txt").write_text(proc.stdout)
    found, fn, ops = {}, None, []

    def close():
        if fn and "replica_quorum" in fn:
            ld = [i for i, op in enumerate(ops) if op.startswith("LDG")]
            first_wait = next((i for i, op in enumerate(ops)
                               if op.startswith(("SHFL", "VOTE", "ISETP"))
                               and ld and i > ld[0]), None)
            found[fn] = {
                "instructions": len(ops), "ldg": ld,
                "branches_between_loads": sum(
                    op.startswith("BRA") for op in ops[ld[0]:ld[-1]])
                if ld else 0,
                "loads_before_first_compare": sum(
                    i < first_wait for i in ld) if first_wait else len(ld)}

    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            fn, ops = m[1], []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and fn:
            ops.append(m[1])
    close()
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the other version's replica_quorum.cu")
    ap.add_argument("--change", type=Path, default=CSRC / "replica_quorum.cu",
                    help="the version under test (default: this checkout's)")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "probe")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    from tpuraft_torch.ops import quorum_cuda
    from tpuraft_torch.parallel import collective

    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    cs.log(card)
    variants = args.out / "variants.cu"
    variants.write_text(VARIANTS)
    built = build(args.out, {"parent": args.parent,
                             "change": args.change,
                             "variants": variants})
    libs = {}
    for name, (so, text) in built.items():
        for line in ptxas_report(text):
            cs.log(f"[ptxas {name}] {line}")
        libs[name] = ctypes.CDLL(str(so))
    nvcc = quorum_cuda._find_nvcc()
    sass = {name: sass_loads(nvcc, built[name][0], args.out, name)
            for name in ("parent", "change")}
    for name, fns in sass.items():
        for fn, rec in fns.items():
            cs.log(f"[sass {name}] {fn}: {rec}")
    for name in ("parent", "change"):
        fn = libs[name].tpuraft_replica_quorum
        fn.argtypes, fn.restype = QUORUM_ARGS, ctypes.c_int
    for name in ("probe_copy_segment", "probe_copy_thread"):
        fn = getattr(libs["variants"], name)
        fn.argtypes, fn.restype = QUORUM_ARGS, ctypes.c_int
    null = libs["variants"].probe_null
    null.argtypes, null.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 12)
    rows = []
    for r, g in SHAPES:
        s_w = quorum_cuda.segment_width(min(r, 32))
        commit = torch.empty(g, dtype=torch.int32, device=dev)
        votes = torch.empty(g, dtype=torch.int32, device=dev)

        def stream():  # the one being captured, inside a graph
            return torch.cuda.current_stream().cuda_stream

        def call(fn, rel, gr):
            return lambda: cs.check(fn(rel.data_ptr(), gr.data_ptr(),
                                       commit.data_ptr(), votes.data_ptr(),
                                       r, g, stream()) == 0, "launch failed")

        for planes in (cs.replica_inputs(rng, r, g),
                       cs.replica_extremes(rng, r, g)):
            rel, gr = (torch.from_numpy(a).to(dev) for a in planes)
            want = (collective.replica_commit_point(rel, r),
                    collective.replica_vote_count(gr))
            for name in ("parent", "change"):
                call(libs[name].tpuraft_replica_quorum, rel, gr)()
                torch.cuda.synchronize()
                cs.check(torch.equal(commit, want[0])
                         and torch.equal(votes, want[1]),
                         f"{name} differs from plain at R={r} G={g}")
        rel, gr = (torch.from_numpy(a).to(dev)
                   for a in cs.replica_inputs(rng, r, g))
        q = r // 2 + 1
        blocks = {"thread": -(-g // 256), "segment": -(-g * s_w // 256)}
        fns = {
            "null_thread": lambda: null(blocks["thread"], stream()),
            "null_segment": lambda: null(blocks["segment"], stream()),
            "copy_thread": call(libs["variants"].probe_copy_thread, rel, gr),
            "parent": call(libs["parent"].tpuraft_replica_quorum, rel, gr),
            "change": call(libs["change"].tpuraft_replica_quorum, rel, gr),
            "kthvalue": lambda: torch.kthvalue(rel, r - q + 1, dim=0),
            "plain": lambda: (collective.replica_commit_point(rel, r),
                              collective.replica_vote_count(gr)),
        }
        if r <= 64:
            fns["copy_segment"] = call(libs["variants"].probe_copy_segment,
                                       rel, gr)
        row = {"R": r, "G": g, "S": s_w, "bound_us":
               cs.replica_bound_ms(r, g) * 1e3}
        for name in ("null_thread", "null_segment", "copy_thread",
                     "copy_segment", "parent", "change", "change", "parent",
                     "kthvalue", "plain"):
            if name in fns:
                us = cs.time_graph(torch, fns[name], replays=20) * 1e3
                row.setdefault(f"{name}_us", []).append(us)
        rows.append(row)
        cs.log(f"[probe] R={r} G={g} S={s_w}: " + ", ".join(
            f"{k[:-3]} " + "/".join(f"{u:.3f}" for u in v)
            for k, v in row.items() if k.endswith("_us") and k != "bound_us")
            + f", bound {row['bound_us']:.4f} us")
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "rows": rows,
           "ptxas": {n: ptxas_report(t) for n, (_, t) in built.items()},
           "sass": sass}
    (args.out / "probe.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
