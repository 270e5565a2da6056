"""Group-axis sharding of the multi-raft tick over a list of devices.

The counterpart of the JAX package's ``parallel/mesh.py``.  The tick is
element-wise over the G axis, so splitting G into N contiguous row
blocks lets every shard advance its own groups with no cross-device
traffic; the only cross-device values are the N scalars of the
deadline fold.  One process drives every shard, as one JAX process
drives every device of its mesh: the engine's host half keeps every [G]
mirror, and only the device tick is split.

A mesh is a tuple of N ``torch.device`` along the ``groups`` axis:

- :func:`make_mesh` takes the first N CUDA cards (and raises when fewer
  exist), N logical shards of the CPU for ``"cpu"``, or an explicit
  list, which may name one card several times: that is how one card runs
  N shards, and only a caller that names the list gets it;
- :func:`group_slices` is the row split every sharded function uses:
  shard k holds rows ``[k*G/N, (k+1)*G/N)``;
- :func:`sharded_tick` launches the tick once per shard, on the shard's
  device and its current stream (the fused tick on CUDA, the plain
  version on the CPU); :func:`sharded_tick_outputs` is its outputs-only
  form, the one the engine calls;
- :func:`sharded_deadline_fold` launches the fold kernel of
  :mod:`tpuraft_torch.ops.deadline_fold` once per shard and takes the
  min of the N results on the host.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Optional, Sequence

import numpy as np
import torch

from tpuraft_torch.ops.deadline_fold import (
    DEADLINE_NONE_I32,
    deadline_fold,
    fold_work_buffer,
)
from tpuraft_torch.ops.tick import (
    GroupState,
    TickParams,
    raft_tick,
    raft_tick_outputs,
)

__all__ = ["DEADLINE_NONE_I32", "make_mesh", "group_slices",
           "shard_group_state", "shard_params", "gather_shards",
           "pinned_staging", "sharded_tick", "sharded_tick_outputs",
           "sharded_deadline_fold"]

Mesh = tuple  # of torch.device, one per shard along "groups"


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _checked(dev: torch.device) -> torch.device:
    """``dev`` as the mesh holds it: a CUDA device names its card."""
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"mesh: unsupported device {dev}")
    have = _cuda_count()
    idx = dev.index if dev.index is not None else (
        torch.cuda.current_device() if have else 0)
    if idx >= have:
        raise ValueError(f"mesh: {dev} requested but only {have} CUDA "
                         f"devices are present")
    return torch.device("cuda", idx)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """N devices along ``groups``.

    - ``device="cuda"``: the first N cards (all of them when N is None);
      fewer than N raises — a silent shared card would change the
      layout the caller validated against;
    - ``device="cpu"``: N logical shards of the CPU (N required);
    - a list (or tuple) of devices: those, in order; its length must be
      N when N is given.  It may repeat a card: N shards on one card.
    """
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("mesh: an empty device list")
        if n_devices is not None and n_devices != len(device):
            raise ValueError(f"mesh of {n_devices} devices requested but "
                             f"the device list names {len(device)}")
        return tuple(_checked(torch.device(d)) for d in device)
    dev = torch.device(device)
    if dev.type == "cpu":
        if not n_devices or n_devices < 1:
            raise ValueError("mesh: a CPU mesh needs its shard count")
        return (dev,) * n_devices
    if dev.type != "cuda":
        raise ValueError(f"mesh: unsupported device {dev}")
    if dev.index is not None:
        if n_devices not in (None, 1):
            raise ValueError(f"mesh of {n_devices} shards on {dev}: name "
                             f"the device list to share one card")
        return (_checked(dev),)
    have = _cuda_count()
    n = n_devices or have
    if n < 1 or n > have:
        raise ValueError(
            f"mesh of {n} CUDA devices requested but only {have} present "
            f"— a silent truncation or a shared card would change the "
            f"sharding the caller validated against (a device list may "
            f"name one card several times)")
    return tuple(torch.device("cuda", i) for i in range(n))


def group_slices(g: int, n: int) -> list[slice]:
    """The contiguous row block of each of N shards of G groups — the
    single home of the group-axis layout: the engine and the tick both
    use it.  G must divide evenly (pad the group capacity, not the
    mesh)."""
    if n < 1 or g % n:
        raise ValueError(f"G={g} groups not divisible by {n} shards")
    k = g // n
    return [slice(i * k, (i + 1) * k) for i in range(n)]


def shard_group_state(state: GroupState, mesh: Mesh
                      ) -> tuple[GroupState, ...]:
    """The SoA state split into each shard's row block on its device
    (contiguous; a view of ``state`` where the device is its own)."""
    sl = group_slices(state.role.shape[0], len(mesh))
    return tuple(GroupState(**{
        f.name: getattr(state, f.name)[s].to(dev).contiguous()
        for f in fields(GroupState)}) for dev, s in zip(mesh, sl))


def shard_params(params: TickParams, mesh: Mesh, g: int
                 ) -> tuple[TickParams, ...]:
    """Each shard's parameters: scalars on every device, [G] rows
    split like the state."""
    sl = group_slices(g, len(mesh))
    return tuple(TickParams(**{
        f.name: (t.to(dev) if t.dim() == 0 else t[s].to(dev).contiguous())
        for f in fields(TickParams)
        for t in (getattr(params, f.name),)}) for dev, s in zip(mesh, sl))


def gather_shards(parts):
    """One host-side value of a sharded GroupState or TickOutputs: each
    field's shards copied to the CPU and joined along G (what
    ``np.asarray`` of a sharded array gives in the JAX package)."""
    cls = type(parts[0])
    return cls(**{f.name: torch.cat([getattr(p, f.name).cpu()
                                     for p in parts])
                  for f in fields(cls)})


def _check_shards(mesh: Mesh, *per_shard) -> None:
    for seq in per_shard:
        if len(seq) != len(mesh):
            raise ValueError(f"{len(seq)} shards for a mesh of "
                             f"{len(mesh)} devices")


def sharded_tick(mesh: Mesh, axis_name: str = "groups",
                 donate: bool = True):
    """raft_tick with G split over the mesh.  Returns
    ``run(state, now_ms, params) -> (new_state, outputs)``: ``state`` is
    :func:`shard_group_state`'s tuple, ``params`` a TickParams (split
    here) or :func:`shard_params`' tuple, and both results are tuples
    of shards, shard k's covering rows ``[k*G/N, (k+1)*G/N)``.  One
    fused-tick launch per shard on its device and current stream.
    ``donate`` has no torch meaning — the tick never writes its input
    state — and is ignored."""
    del axis_name, donate

    def run(state, now_ms, params):
        _check_shards(mesh, state)
        if isinstance(params, TickParams):
            params = shard_params(params, mesh,
                                  sum(s.role.shape[0] for s in state))
        _check_shards(mesh, params)
        new_state, outputs = [], []
        for st, pr in zip(state, params):
            ns, out = raft_tick(st, now_ms, pr)
            new_state.append(ns)
            outputs.append(out)
        return tuple(new_state), tuple(outputs)

    return run


def sharded_tick_outputs(mesh: Mesh):
    """The outputs half of :func:`sharded_tick`, what the engine calls:
    ``run(state, now_ms, params, outs)`` writes shard k's packed outputs
    into ``outs[k]`` (a uint8 buffer of ``packed_nbytes(G/N)`` bytes on
    its device) and returns the shards' TickOutputs views.  One launch
    per shard."""

    def run(state, now_ms, params, outs: Sequence[torch.Tensor]):
        _check_shards(mesh, state, params, outs)
        return tuple(raft_tick_outputs(st, now_ms, pr, out=o)
                     for st, pr, o in zip(state, params, outs))

    return run


def pinned_staging(fields, device: torch.device):
    """Staging for one shard: the ``(name, dtype, shape)`` fields packed
    in order into one byte buffer (int32 fields first keep their views
    aligned), pinned on the host when ``device`` is a card, and its
    mirror on ``device`` (the host buffer itself on the CPU).  Returns
    ``(host, dev, host_views, dev_views)``: numpy views of the host
    buffer, typed tensor views of the device one."""
    layout, off = [], 0
    for name, dtype, shape in fields:
        n = int(np.prod(shape)) * (4 if dtype == torch.int32 else 1)
        layout.append((name, dtype, shape, off, off + n))
        off += n
    cuda = device.type == "cuda"
    host = torch.empty(off, dtype=torch.uint8, pin_memory=cuda)
    dev = (torch.empty(off, dtype=torch.uint8, device=device)
           if cuda else host)
    hnp = host.numpy()  # a view of the host buffer, no copy
    host_views = {
        name: hnp[a:b].view(np.int32 if dtype == torch.int32 else bool)
        .reshape(shape) for name, dtype, shape, a, b in layout}
    dev_views = {name: dev[a:b].view(dtype).view(shape)
                 for name, dtype, shape, a, b in layout}
    return host, dev, host_views, dev_views


class _FoldStaging:
    """One shard's fold buffers: its six rows staged by
    :func:`pinned_staging` (the four int32 rows first), and the kernel's
    work buffer (:func:`fold_work_buffer`)."""

    def __init__(self, g: int, device: torch.device, rows: slice):
        self.rows = rows
        self.host, self.dev, self.host_views, self.dev_views = \
            pinned_staging([(name, torch.int32, (g,)) for name in (
                "role", "elect_deadline", "hb_deadline", "stepdown_deadline")]
                + [(name, torch.bool, (g,))
                   for name in ("quiescent", "has_ctrl")], device)
        self.out = fold_work_buffer(device)

    def fill(self, rows: dict) -> None:
        """This shard's rows into the host buffer (wider integer rows
        wrap to int32 exactly like ``astype(np.int32)``)."""
        for name, view in self.host_views.items():
            np.copyto(view, rows[name][self.rows], casting="unsafe")

    def upload(self) -> dict:
        """One host->device copy; returns the typed device rows."""
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)
        return self.dev_views


def sharded_deadline_fold(mesh: Mesh, axis_name: str = "groups"):
    """The engine's earliest-deadline scan as one fold per shard and a
    min over the N results: each shard folds its own group rows
    (election deadlines for awake followers and candidates, heartbeat
    and stepdown deadlines for awake leaders).

    Returns ``fold(role, quiescent, has_ctrl, elect_deadline,
    hb_deadline, stepdown_deadline) -> int`` over host [G] rows (numpy
    arrays or CPU tensors), ``DEADLINE_NONE_I32`` when no slot
    schedules anything.  Each shard's six rows go up in one copy from a
    pinned staging buffer, one fold launch runs on the shard's device
    and current stream, and its 4-byte result comes back into a pinned
    slot; the min of the N slots is the answer."""
    del axis_name
    n = len(mesh)
    cards = sorted({d for d in mesh if d.type == "cuda"}, key=str)
    # the N shard results: pinned when a card writes them
    res = torch.empty(n, dtype=torch.int32, pin_memory=bool(cards))
    staging: dict[int, list[_FoldStaging]] = {}

    def fold(role, quiescent, has_ctrl, elect_deadline, hb_deadline,
             stepdown_deadline) -> int:
        rows = {"role": np.asarray(role), "quiescent": np.asarray(quiescent),
                "has_ctrl": np.asarray(has_ctrl),
                "elect_deadline": np.asarray(elect_deadline),
                "hb_deadline": np.asarray(hb_deadline),
                "stepdown_deadline": np.asarray(stepdown_deadline)}
        g = rows["role"].shape[0]
        st = staging.get(g)
        if st is None:  # first call, or the engine grew: one G at a time
            staging.clear()
            st = staging[g] = [
                _FoldStaging(g // n, dev, s)
                for dev, s in zip(mesh, group_slices(g, n))]
        for k, s in enumerate(st):
            s.fill(rows)
            d = s.upload()
            out = deadline_fold(d["role"], d["quiescent"], d["has_ctrl"],
                                d["elect_deadline"], d["hb_deadline"],
                                d["stepdown_deadline"], out=s.out)
            res[k:k + 1].copy_(out.view(1), non_blocking=True)
        for dev in cards:
            torch.cuda.current_stream(dev).synchronize()
        # graftcheck: allow(host-sync) — the fold's N 4-byte D2H copies, landed
        return int(res.numpy().min())

    return fold
