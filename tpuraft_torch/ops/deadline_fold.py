"""The engine's earliest-deadline fold: the hand-written Hopper kernel and
its plain torch version.

:func:`deadline_fold` reduces one shard's group rows to the earliest
deadline the engine's loop must wake for: election deadlines of awake
followers and candidates, heartbeat and stepdown deadlines of awake
leaders (awake = controlled and not quiescent).  It returns
:data:`DEADLINE_NONE_I32` when no row schedules anything.  It dispatches
on the device of its tensors:

- CUDA tensors launch ``csrc/deadline_fold.cu`` or raise;
- CPU tensors take :func:`deadline_fold_reference`, the same function as
  plain torch ops.

``LAUNCHES`` counts kernel launches (and nothing else).
:func:`tpuraft_torch.parallel.mesh.sharded_deadline_fold` calls it once
per shard.

The kernel's int32 [3] work buffer (``out``) comes from
:func:`fold_work_buffer` and nowhere else: the kernel makes no memset,
it leaves its two scratch words at rest for the next fold, and the
buffer starts at rest.
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

# deadline-fold sentinel: "no engine-scheduled deadline on this shard" —
# int32 max, NOT the engine's 1<<60 host sentinel (the fold runs in the
# device's int32 time domain)
DEADLINE_NONE_I32 = np.int32(2**31 - 1)

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

# every live work buffer fold_work_buffer made, by id
_WORK: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
    weakref.WeakValueDictionary()

ROW_NAMES = ("role", "quiescent", "has_ctrl", "elect_deadline",
             "hb_deadline", "stepdown_deadline")
_BOOL_ROWS = frozenset(("quiescent", "has_ctrl"))


def deadline_fold_reference(role, quiescent, has_ctrl, elect_deadline,
                            hb_deadline, stepdown_deadline) -> torch.Tensor:
    """Plain version: the int32 0-d min on the rows' device."""
    awake = has_ctrl & ~quiescent
    # ROLE_FOLLOWER == 0, ROLE_CANDIDATE == 1, ROLE_LEADER == 2
    ec = awake & (role <= 1)
    ld = awake & (role == 2)
    none = torch.full((), int(DEADLINE_NONE_I32), dtype=torch.int32,
                      device=role.device)
    nxt = torch.where(ec, elect_deadline, none)
    nxt = torch.minimum(nxt, torch.where(ld, hb_deadline, none))
    nxt = torch.minimum(nxt, torch.where(ld, stepdown_deadline, none))
    return nxt.amin() if nxt.numel() else none


def fold_work_buffer(device) -> torch.Tensor:
    """A fold's int32 [3] work buffer on ``device``, every word
    0xFFFFFFFF: the rest state of ``out[1]`` (the min's key) and
    ``out[2]`` (the ticket of the last block), which every fold leaves
    as it found it; ``out[0]`` receives each fold's result.  Folds that
    share it must run one after another on one stream."""
    buf = torch.full((3,), -1, dtype=torch.int32, device=device)
    _WORK[id(buf)] = buf
    return buf


def _check(rows, out) -> None:
    g = rows[0].shape[0] if rows[0].dim() == 1 else -1
    dev = rows[0].device
    for name, t in zip(ROW_NAMES, rows):
        dtype = torch.bool if name in _BOOL_ROWS else torch.int32
        if t.dtype != dtype:
            raise TypeError(f"deadline_fold: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if t.dim() != 1 or t.shape[0] != g:
            raise ValueError(f"deadline_fold: {name} must be a [G] row of "
                             f"the role row's length, got "
                             f"{list(t.shape)}")
        if t.device != dev:
            raise ValueError(f"deadline_fold: {name} on {t.device}, role "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"deadline_fold: {name} is not contiguous")
    if out is None:
        return
    if _WORK.get(id(out)) is not out:
        raise ValueError("deadline_fold: out must be a buffer made by "
                         "fold_work_buffer (the kernel needs its scratch "
                         "at rest)")
    if out.device != dev:
        raise ValueError(f"deadline_fold: out on {out.device}, the rows "
                         f"on {dev}")


def deadline_fold(role, quiescent, has_ctrl, elect_deadline, hb_deadline,
                  stepdown_deadline,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The earliest deadline of the rows as an int32 0-d tensor on their
    device: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  Never falls back from one to the other.  ``out``, a work
    buffer of :func:`fold_work_buffer` on the rows' device, receives the
    result in ``out[0]`` (the kernel's scratch in the rest); the result
    is a view of it."""
    rows = (role, quiescent, has_ctrl, elect_deadline, hb_deadline,
            stepdown_deadline)
    _check(rows, out)
    dev = role.device
    if dev.type == "cpu":
        res = deadline_fold_reference(*rows)
        if out is None:
            return res
        out[0] = res
        return out[0]
    if dev.type != "cuda":
        raise ValueError(f"deadline_fold: unsupported device {dev}")
    from tpuraft_torch.ops import quorum_cuda

    lib = quorum_cuda.load()
    if out is None:
        out = fold_work_buffer(dev)
    with torch.cuda.device(dev):
        rc = lib.tpuraft_deadline_fold(
            *(t.data_ptr() for t in rows), out.data_ptr(), role.shape[0],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deadline_fold kernel launch failed: cudaError "
                           f"{rc} (G={role.shape[0]})")
    global LAUNCHES
    LAUNCHES += 1
    return out[0]
