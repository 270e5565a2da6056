"""Replica-axis quorum: the commit point and the vote count of every raft
group from the replicas' ``[R, G]`` rows, on one device or over a
``(replica, groups)`` grid of devices.

Row r of ``match`` is replica r's durable matchIndex for each of G
groups, row r of ``granted`` its vote.  For every group:

- commit = the q-th largest match over the R rows, q = R // 2 + 1;
- votes  = the number of granting rows.

The JAX package reduces the rows with collectives over a (replica,
groups) device mesh.  Here the R rows of a groups-shard meet on one
device, so the gather and the sum become one launch of
``ops/csrc/replica_quorum.cu``.  :func:`replica_quorum` dispatches on
the device of its tensors:

- CUDA tensors launch the kernel or raise;
- CPU tensors take the plain version, :func:`replica_commit_point` and
  :func:`replica_vote_count`.

``LAUNCHES`` counts kernel launches (and nothing else).
:func:`replicated_tick` runs on one device, or on an ``[Rm][Gm]`` grid:
replica block i of groups-shard j lives on ``grid[i][j]``, and each
groups-shard gathers its Rm blocks onto ``grid[0][j]`` and makes one
launch there.  One process drives the whole grid; a grid may name one
card several times.
"""

from __future__ import annotations

import torch

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def replica_vote_count(granted: torch.Tensor) -> torch.Tensor:
    """Plain version: int32 [G], the nonzero entries of each column of
    ``granted`` [R, G]."""
    return (granted != 0).sum(dim=0, dtype=torch.int32)


def replica_commit_point(match: torch.Tensor, n_replicas: int
                         ) -> torch.Tensor:
    """Plain version: int32 [G], the q-th largest of each column of
    ``match`` [R, G] (q = n_replicas // 2 + 1), as the sort oracle
    ``np.sort(match, 0)[::-1][q - 1]`` picks it."""
    q = n_replicas // 2 + 1
    return torch.sort(match, dim=0, descending=True).values[q - 1]


def _check(match, granted, n_replicas: int) -> None:
    if match.dim() != 2:
        raise ValueError(f"replica_quorum: match must be [R, G], got "
                         f"{tuple(match.shape)}")
    if match.shape[0] != n_replicas or n_replicas < 1:
        raise ValueError(f"replica_quorum: {match.shape[0]} rows for "
                         f"{n_replicas} replicas")
    if match.shape[0] * match.shape[1] >= 2**31:
        raise ValueError("replica_quorum: R * G must stay below 2^31")
    if match.dtype != torch.int32:
        raise TypeError(f"replica_quorum: match must be torch.int32, got "
                        f"{match.dtype}")
    if granted.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"replica_quorum: granted must be torch.bool or "
                        f"torch.uint8, got {granted.dtype}")
    if granted.shape != match.shape:
        raise ValueError(f"replica_quorum: granted shape "
                         f"{tuple(granted.shape)} != {tuple(match.shape)}")
    if granted.device != match.device:
        raise ValueError(f"replica_quorum: granted on {granted.device}, "
                         f"match on {match.device}")
    if not (match.is_contiguous() and granted.is_contiguous()):
        raise ValueError("replica_quorum: planes must be contiguous")


def replica_quorum(match: torch.Tensor, granted: torch.Tensor,
                   n_replicas: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(commit[G] int32, votes[G] int32) from the [R, G] planes: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Never falls back from one to the other."""
    _check(match, granted, n_replicas)
    dev = match.device
    if dev.type == "cpu":
        return (replica_commit_point(match, n_replicas),
                replica_vote_count(granted))
    if dev.type != "cuda":
        raise ValueError(f"replica_quorum: unsupported device {dev}")
    from tpuraft_torch.ops import quorum_cuda

    lib = quorum_cuda.load()
    r, g = match.shape
    commit = torch.empty(g, dtype=torch.int32, device=dev)
    votes = torch.empty(g, dtype=torch.int32, device=dev)
    if g == 0:
        return commit, votes
    with torch.cuda.device(dev):
        rc = lib.tpuraft_replica_quorum(
            match.data_ptr(), granted.data_ptr(), commit.data_ptr(),
            votes.data_ptr(), r, g, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"replica_quorum kernel launch failed: "
                           f"cudaError {rc} (R={r}, G={g})")
    global LAUNCHES
    LAUNCHES += 1
    return commit, votes


def _resolve_device(device=None) -> torch.device:
    """The one device the replica rows share: None means the card.
    Nothing runs on another device than the one asked for: the card
    where none exists is refused."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"replica plane on {dev} but no CUDA device is available; pass "
            "device='cpu' or backend='numpy' to run it on the host")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"replica plane: unsupported device {dev}")
    return dev


def _resolve_grid(grid) -> tuple[tuple[torch.device, ...], ...]:
    """An ``[Rm][Gm]`` arrangement of devices — the (replica, groups)
    mesh — as a tuple of rows of ``torch.device``.  Every row must name
    Gm devices; a card that does not exist is refused."""
    from tpuraft_torch.parallel.mesh import make_mesh

    rows = [r for r in grid]
    if not rows or not all(isinstance(r, (list, tuple)) and r
                           for r in rows):
        raise ValueError("replica grid: a non-empty list of rows of "
                         "devices, [replica][groups]")
    if len({len(r) for r in rows}) != 1:
        raise ValueError("replica grid: rows of different lengths")
    return tuple(make_mesh(len(r), list(r)) for r in rows)


def _split(n: int, k: int, what: str) -> list[slice]:
    if n % k:
        raise ValueError(f"replica grid: {what}={n} not divisible by the "
                         f"grid's {k}")
    m = n // k
    return [slice(i * m, (i + 1) * m) for i in range(k)]


def _gather(plane: torch.Tensor, rows, cols: slice, devs,
            home: torch.device) -> torch.Tensor:
    """Groups-shard ``cols`` of ``plane``: replica block i placed on
    ``devs[i]`` (a no-op move where it lies there), then the blocks
    gathered into one contiguous [R, G/Gm] plane on ``home``."""
    out = torch.empty((plane.shape[0], cols.stop - cols.start),
                      dtype=plane.dtype, device=home)
    for rs, dev in zip(rows, devs):
        out[rs].copy_(plane[rs, cols].to(dev))
    return out


def replicated_tick(n_replicas: int, device=None):
    """Build the cross-replica quorum step on one device (None: the
    card) or on an ``[Rm][Gm]`` grid of devices (R must divide by Rm and
    G by Gm, as the JAX package's shard_map requires).

    ``run(match, granted=None)`` takes the global planes (tensors or
    numpy arrays; copied to the device unless they lie there):
      match:   int32 [R, G]  — row r = replica r's durable matchIndex
      granted: bool  [R, G]  — row r = replica r's current-election vote;
               None reads a zero plane kept on the device
    and returns (on one device, on it; on a grid, a tuple of the Gm
    groups-shards' rows, shard j on ``grid[0][j]``):
      commit:  int32 [G] — quorum commit point per group
      votes:   int32 [G] — vote counts per group
    One replica-quorum launch per groups-shard.
    """
    if isinstance(device, (list, tuple)):
        return _grid_tick(n_replicas, _resolve_grid(device))
    dev = _resolve_device(device)
    zeros: dict[tuple[int, ...], torch.Tensor] = {}

    def run(match, granted=None):
        match = torch.as_tensor(match, device=dev)
        if granted is None:
            granted = zeros.get(tuple(match.shape))
            if granted is None:
                granted = zeros[tuple(match.shape)] = torch.zeros(
                    tuple(match.shape), dtype=torch.bool, device=dev)
        else:
            granted = torch.as_tensor(granted, device=dev)
        return replica_quorum(match, granted, n_replicas)

    return run


def _grid_tick(n_replicas: int, grid):
    rm, gm = len(grid), len(grid[0])
    rows = _split(n_replicas, rm, "R")
    zeros: dict[tuple, torch.Tensor] = {}

    def run(match, granted=None):
        match = torch.as_tensor(match)
        if match.dim() != 2 or match.shape[0] != n_replicas:
            raise ValueError(f"replica grid: match must be [{n_replicas}, "
                             f"G], got {tuple(match.shape)}")
        g = match.shape[1]
        if granted is not None:
            granted = torch.as_tensor(granted)
        commits, votes = [], []
        for j, cols in enumerate(_split(g, gm, "G")):
            devs = [grid[i][j] for i in range(rm)]
            home = devs[0]
            m = _gather(match, rows, cols, devs, home)
            if granted is None:
                key = (str(home), tuple(m.shape))
                gr = zeros.get(key)
                if gr is None:
                    gr = zeros[key] = torch.zeros(
                        tuple(m.shape), dtype=torch.bool, device=home)
            else:
                gr = _gather(granted, rows, cols, devs, home)
            c, v = replica_quorum(m, gr, n_replicas)
            commits.append(c)
            votes.append(v)
        return tuple(commits), tuple(votes)

    return run
