"""Fused quorum reduction: the hand-written Hopper kernel and its plain
torch version; and the loader of the port's CUDA library.

:func:`fused_quorum` computes, for every raft group, the three
``[G, P] -> [G]`` reductions of the tick (commit order statistic, vote
quorum, quorum ack time), each joint-consensus aware.  It dispatches on
the device of its tensors:

- CUDA tensors launch ``csrc/fused_quorum.cu`` or raise;
- CPU tensors take :func:`fused_quorum_reference`, the same function as
  plain torch ops built on :mod:`tpuraft_torch.ops.ballot`.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.

:func:`load` builds one shared library from every source under ``csrc/``
(the fused quorum, the fused tick of :mod:`tpuraft_torch.ops.tick` and
the warp-segmented core they share) with ``nvcc`` for ``sm_90a`` at
first use, one compiler process per source, all started together, and
loads it with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from tpuraft_torch.ops.ballot import (
    joint_quorum_ack_time,
    joint_quorum_match_index,
    joint_vote_quorum,
)

MAX_PEERS = 32  # one warp: P <= 32 slots per group, one lane each

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("fused_quorum.cu", "fused_tick.cu")  # each a compiler process
_HEADERS = ("quorum_core.cuh",)
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def fused_quorum_reference(match, granted, last_ack, voter_mask,
                           old_voter_mask):
    """Plain torch version of the kernel: (quorum_idx[G] int32,
    elected[G] bool, q_ack[G] int32) on the inputs' device."""
    qidx = joint_quorum_match_index(match, voter_mask, old_voter_mask)
    elected = joint_vote_quorum(granted, voter_mask, old_voter_mask)
    qack = joint_quorum_ack_time(last_ack, voter_mask, old_voter_mask)
    return qidx, elected, qack


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the fused_quorum "
        "kernel cannot be built")


def _library_path() -> Path:
    """Where the built library lives: keyed by the hash of every source
    and the flags, so an edited source never loads a stale library."""
    h = hashlib.sha256()
    for name in (*_SOURCES, *_HEADERS):
        h.update(name.encode() + b"\0" + (_CSRC / name).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libtpuraft_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the library unless it exists; returns (path, compiler
    output).  ``verbose`` adds ``-Xptxas -v`` (registers, spills).  Each
    source compiles in its own ``nvcc`` process, all at once; the link
    writes a temporary name that is renamed into place, so a concurrent
    loader never sees a half-written library."""
    so = _library_path()
    if so.exists() and not verbose:
        return so, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"{so.stem}.{os.getpid()}.{threading.get_ident()}"
    objs = [_BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in _SOURCES]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    cmds = [[nvcc, *_NVCC_FLAGS, *ptxas, "-c", "-o", str(o),
             str(_CSRC / src)] for src, o in zip(_SOURCES, objs)]
    tmp = so.with_name(f"{tag}.tmp.so")
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        for c, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(c)}\n{out}")
        link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return so, "".join(outs) + proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            fn = lib.tpuraft_fused_quorum
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.tpuraft_fused_tick
            fn.argtypes = ([ctypes.c_void_p] * 15
                           + [ctypes.c_void_p, ctypes.c_int] * 4
                           + [ctypes.c_int32] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            if lib.tpuraft_fused_quorum_max_peers() != MAX_PEERS:
                raise RuntimeError("kernel library and wrapper disagree "
                                   "on the peer-slot limit")
            _lib = lib
        return _lib


def segment_width(p: int) -> int:
    """Lanes per group in the kernels' warp segments: the next power of
    two >= P."""
    return 1 << (p - 1).bit_length()


def check_launch_size(g: int, p: int) -> None:
    """The kernels index threads with 32-bit ints: G * S < 2^31."""
    if g * segment_width(p) >= 2**31:
        raise ValueError(f"G={g} groups x P={p} slots exceed one launch "
                         f"(G * next_pow2(P) must stay below 2^31)")


def _check(match, granted, last_ack, voter_mask, old_voter_mask) -> None:
    if match.dim() != 2:
        raise ValueError(f"fused_quorum: match must be [G, P], got "
                         f"{tuple(match.shape)}")
    g, p = match.shape
    if not 1 <= p <= MAX_PEERS:
        raise ValueError(f"fused_quorum: P={p} peer slots; the kernel "
                         f"takes 1..{MAX_PEERS}")
    check_launch_size(g, p)
    for name, t, dtype in (("match", match, torch.int32),
                           ("granted", granted, torch.bool),
                           ("last_ack", last_ack, torch.int32),
                           ("voter_mask", voter_mask, torch.bool),
                           ("old_voter_mask", old_voter_mask, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"fused_quorum: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != (g, p):
            raise ValueError(f"fused_quorum: {name} shape "
                             f"{tuple(t.shape)} != {(g, p)}")
        if t.device != match.device:
            raise ValueError(f"fused_quorum: {name} on {t.device}, "
                             f"match on {match.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_quorum: {name} is not contiguous")


def fused_quorum(match, granted, last_ack, voter_mask, old_voter_mask):
    """(quorum_idx[G] int32, elected[G] bool, q_ack[G] int32) from the
    [G, P] planes: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Never falls back from one to the other."""
    _check(match, granted, last_ack, voter_mask, old_voter_mask)
    dev = match.device
    if dev.type == "cpu":
        return fused_quorum_reference(match, granted, last_ack, voter_mask,
                                      old_voter_mask)
    if dev.type != "cuda":
        raise ValueError(f"fused_quorum: unsupported device {dev}")
    lib = load()
    g, p = match.shape
    qidx = torch.empty(g, dtype=torch.int32, device=dev)
    elected = torch.empty(g, dtype=torch.bool, device=dev)
    qack = torch.empty(g, dtype=torch.int32, device=dev)
    if g == 0:
        return qidx, elected, qack
    with torch.cuda.device(dev):
        rc = lib.tpuraft_fused_quorum(
            match.data_ptr(), granted.data_ptr(), last_ack.data_ptr(),
            voter_mask.data_ptr(), old_voter_mask.data_ptr(),
            qidx.data_ptr(), elected.data_ptr(), qack.data_ptr(), g, p,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_quorum kernel launch failed: "
                           f"cudaError {rc} (G={g}, P={p})")
    global LAUNCHES
    LAUNCHES += 1
    return qidx, elected, qack
