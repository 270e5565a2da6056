"""The fused multi-group tick: one call advances ALL G raft groups.

PyTorch counterpart of the JAX package's ``ops/tick.py``.  One call
computes every group's commit advancement, election vote tally,
election-timeout firing, leader-lease / step-down checks, heartbeat,
snapshot and stepdown cadence, and read-fence resolution.  It
dispatches on the state's device:

- CUDA tensors launch the fused tick, ``csrc/fused_tick.cu``: the
  whole tick in one kernel launch (built by
  :func:`tpuraft_torch.ops.quorum_cuda.load`), or raise;
- CPU tensors take :func:`raft_tick_reference`, the same function as
  plain torch ops.

``LAUNCHES`` counts fused-tick launches (and nothing else).  While a
torch profiler records in the process (:func:`tracing`), the fused tick
(``TICK_SPANS``) and ``device_plane``'s loop enter :class:`Span` ranges,
which land in the profiler's trace and add up, by name, in ``SPANS``;
with none recording, each pass reads the profiler's flag once and
enters :func:`no_span`.

Division of labor (as in the reference design):
  - the tick mutates only *derived, monotone* state (commit_rel and
    the hb / snapshot / stepdown deadlines);
  - role/term/vote transitions are host-applied from the output masks,
    so the host stays the single writer of protocol state.

All times are int32 milliseconds relative to engine start; all log
indexes are int32 relative to a per-group host-managed base.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from dataclasses import dataclass, fields
from typing import Mapping, Optional

import numpy as np
import torch

from tpuraft_torch.ops import quorum_cuda
from tpuraft_torch.ops.ballot import NEG_INF_I32, witness_commit_clamp
from tpuraft_torch.ops.quorum_cuda import fused_quorum_reference

# Role encoding (device plane). Learners are not a role: they sit in peer
# slots with voter_mask=False.
ROLE_FOLLOWER = 0
ROLE_CANDIDATE = 1
ROLE_LEADER = 2
ROLE_INACTIVE = 3  # unallocated group slot

LAUNCHES = 0  # fused-tick launches since import (or since a caller reset it)

# The fused tick's spans (on a card only), in the order they run
TICK_SPANS = ("tick.check", "tick.alloc", "tick.launch", "tick.unpack")
# span name -> [count, ns] of the spans entered since import (or since
# reset_spans()), a row added as a name is first entered; only while a
# profiler records, so over what it traced
SPANS: defaultdict[str, list[int]] = defaultdict(lambda: [0, 0])


def tracing() -> bool:
    """Whether a torch profiler records in this process: spans are
    entered, and ``SPANS`` counts, exactly then.  A module flag of
    torch's that the profiler sets on entry and clears on exit; a torch
    without it reads False here (``tests/test_torch_plane_spans.py``
    asserts it is there)."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def reset_spans() -> None:
    """Empty ``SPANS``."""
    SPANS.clear()


class Span:
    """One span of a host loop, entered only while :func:`tracing`: a
    profiler range named ``name``, nested under whatever range is open,
    with ``tick`` (the tick index, a request's identifier) as its
    keyword input (the trace keeps it under ``record_shapes``); and its
    count and host nanoseconds added to ``SPANS[name]``.  It reads no
    tensor and waits on nothing.

    The range is torch's RecordFunction entered straight from C++:
    1.6-1.7 us a range with a profiler recording on the H100's host,
    where ``torch.profiler.record_function`` (through the op
    dispatcher) takes 10-12 us.  It is looked up here, so a torch
    without it fails a traced run only."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, tick: Optional[int] = None):
        self.name = name
        rf = torch._C._profiler._RecordFunctionFast
        self.rf = rf(name) if tick is None else rf(name, (), {"tick": tick})

    def __enter__(self) -> "Span":
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        row = SPANS[self.name]
        row[0] += 1
        row[1] += ns


class _NoSpan:
    """What a span is while no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


def no_span(name: str, tick: Optional[int] = None) -> _NoSpan:
    """The span that enters no range, reads no clock and counts
    nothing."""
    return _NO_SPAN


def spans():
    """What a loop enters its spans with, read once a pass:
    :class:`Span` while :func:`tracing`, else :func:`no_span`."""
    return Span if tracing() else no_span


@dataclass
class GroupState:
    """Structure-of-arrays consensus state for G groups x P peer slots —
    this node's local view of each group it takes part in.  Field names
    and order are those of the JAX package's GroupState."""

    role: torch.Tensor           # int32 [G]
    commit_rel: torch.Tensor     # int32 [G]  committed index - base
    pending_rel: torch.Tensor    # int32 [G]  first index of current leadership
    match_rel: torch.Tensor      # int32 [G,P] acked matchIndex - base (self slot = lastLog)
    granted: torch.Tensor        # bool  [G,P] votes granted this election round
    voter_mask: torch.Tensor     # bool  [G,P] voters in current conf
    old_voter_mask: torch.Tensor  # bool [G,P] voters in old conf (joint) else False
    elect_deadline: torch.Tensor  # int32 [G] ms: follower election-timeout deadline
    hb_deadline: torch.Tensor    # int32 [G] ms: leader next-heartbeat time
    last_ack: torch.Tensor       # int32 [G,P] ms: last response time per peer
    snap_deadline: torch.Tensor  # int32 [G] ms: next snapshot due
    quiescent: torch.Tensor      # bool [G] hibernating group: beats and
    # election timeouts suppressed; step_down stays live
    witness_mask: torch.Tensor   # bool [G,P] witness voters (either config)
    stepdown_deadline: torch.Tensor  # int32 [G] ms: leader's next periodic
    # stepdown/priority check
    fence_start: torch.Tensor    # int32 [G] ms: earliest pending read-fence
    # start time, NEG_INF when no fence is pending

    @staticmethod
    def zeros(g: int, p: int, device) -> "GroupState":
        def i32(shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=device)

        def b(shape):
            return torch.zeros(shape, dtype=torch.bool, device=device)

        return GroupState(
            role=i32((g,), ROLE_INACTIVE),
            commit_rel=i32((g,)),
            pending_rel=i32((g,), 1),
            match_rel=i32((g, p)),
            granted=b((g, p)),
            voter_mask=b((g, p)),
            old_voter_mask=b((g, p)),
            elect_deadline=i32((g,)),
            hb_deadline=i32((g,)),
            last_ack=i32((g, p)),
            snap_deadline=i32((g,)),
            quiescent=b((g,)),
            witness_mask=b((g, p)),
            stepdown_deadline=i32((g,)),
            fence_start=i32((g,), NEG_INF_I32),
        )


_BOOL_FIELDS = frozenset(("granted", "voter_mask", "old_voter_mask",
                          "quiescent", "witness_mask"))
_PLANES = frozenset(("match_rel", "granted", "voter_mask", "old_voter_mask",
                     "last_ack", "witness_mask"))  # [G, P]; the rest [G]


@dataclass
class TickParams:
    """Protocol parameters: int32 scalars (engine-wide) or [G] rows
    (per-group NodeOptions timeouts); either shape broadcasts."""

    election_timeout_ms: torch.Tensor  # int32 scalar or [G]
    heartbeat_ms: torch.Tensor         # int32 scalar or [G]
    lease_ms: torch.Tensor             # int32 scalar or [G]
    snapshot_ms: torch.Tensor          # int32 scalar or [G]; 0 = disabled

    @staticmethod
    def make(election_timeout_ms, heartbeat_ms, lease_ms, snapshot_ms=0, *,
             device) -> "TickParams":
        def i32(x):
            return torch.as_tensor(np.array(x, dtype=np.int32),
                                   device=device)

        return TickParams(i32(election_timeout_ms), i32(heartbeat_ms),
                          i32(lease_ms), i32(snapshot_ms))


@dataclass
class TickOutputs:
    """Per-tick event masks + advanced indexes the host applies."""

    commit_rel: torch.Tensor     # int32 [G] new commit (== old where unchanged)
    commit_advanced: torch.Tensor  # bool [G]
    elected: torch.Tensor        # bool [G] candidate reached vote quorum
    election_due: torch.Tensor   # bool [G] follower/candidate election timer fired
    step_down: torch.Tensor      # bool [G] leader lost quorum within lease window
    hb_due: torch.Tensor         # bool [G] leader heartbeat due this tick
    lease_valid: torch.Tensor    # bool [G] leader lease currently valid (for reads)
    snap_due: torch.Tensor       # bool [G] snapshot interval elapsed (any role)
    q_ack: torch.Tensor          # int32 [G] q-th newest voter ack time
    stepdown_due: torch.Tensor   # bool [G] leader's periodic stepdown check fired
    fence_ok: torch.Tensor       # bool [G] pending read fence satisfied


# The packed outputs: the int32 rows, then the bool rows (one byte per
# group each), in this order; the fused tick writes them so, and the
# engine fetches them in one copy.
PACKED_I32 = ("commit_rel", "q_ack")
PACKED_BOOL = ("commit_advanced", "elected", "election_due", "step_down",
               "hb_due", "lease_valid", "snap_due", "stepdown_due",
               "fence_ok")


def packed_nbytes(g: int) -> int:
    """Bytes of the packed outputs of G groups."""
    return 4 * g * len(PACKED_I32) + g * len(PACKED_BOOL)


def unpack_outputs(buf: torch.Tensor, g: int) -> TickOutputs:
    """TickOutputs as views into a packed uint8 buffer of G groups."""
    n_i = 4 * g * len(PACKED_I32)
    ints = buf[:n_i].view(torch.int32).view(len(PACKED_I32), g)
    bools = buf[n_i:].view(torch.bool).view(len(PACKED_BOOL), g)
    return TickOutputs(**{k: ints[i] for i, k in enumerate(PACKED_I32)},
                       **{k: bools[i] for i, k in enumerate(PACKED_BOOL)})


def unpack_outputs_numpy(host: np.ndarray, g: int) -> dict[str, np.ndarray]:
    """The packed outputs' rows as numpy views of a host byte buffer."""
    n_i = 4 * g * len(PACKED_I32)
    ints = host[:n_i].view(np.int32).reshape(len(PACKED_I32), g)
    bools = host[n_i:].view(bool).reshape(len(PACKED_BOOL), g)
    return {**{k: ints[i] for i, k in enumerate(PACKED_I32)},
            **{k: bools[i] for i, k in enumerate(PACKED_BOOL)}}


def raft_tick(state: GroupState, now_ms, params: TickParams
              ) -> tuple[GroupState, TickOutputs]:
    """Advance all groups one tick.  Pure: the input state is not
    modified.  ``now_ms`` is a Python int or a 0-d int32 tensor.  The
    fused tick on CUDA, the plain version on the CPU; never falls back
    from one to the other."""
    # the fused tick's spans; the plain version has none
    sp = spans() if state.match_rel.device.type == "cuda" else no_span
    with sp("tick.check"):
        dev = _tick_device(state, params)
        if dev.type == "cpu":
            return raft_tick_reference(state, now_ms, params)
        args = _fused_tick_args(state, now_ms, params)
    g = args[2]
    with sp("tick.alloc"):
        out = torch.empty(packed_nbytes(g), dtype=torch.uint8, device=dev)
        deadlines = torch.empty((3, g), dtype=torch.int32, device=dev)
    with sp("tick.launch"):
        _fused_tick_call(dev, args, out, deadlines)
    with sp("tick.unpack"):
        outputs = unpack_outputs(out, g)
        new_state = dataclasses.replace(
            state, commit_rel=outputs.commit_rel, hb_deadline=deadlines[0],
            snap_deadline=deadlines[1], stepdown_deadline=deadlines[2])
    return new_state, outputs


def raft_tick_outputs(state: GroupState, now_ms, params: TickParams,
                      out: Optional[torch.Tensor] = None) -> TickOutputs:
    """Outputs-only tick — what the engine consumes (its numpy mirrors
    are the state of record between ticks).  ``out``, a uint8 buffer of
    :func:`packed_nbytes` bytes on the state's device, receives the
    packed outputs (the fused tick writes them there; the plain version
    copies them in), and the result is views into it."""
    dev = _tick_device(state, params)
    g = state.role.shape[0]
    if out is not None:
        if (out.dtype != torch.uint8 or tuple(out.shape)
                != (packed_nbytes(g),) or out.device != dev
                or not out.is_contiguous()):
            raise ValueError(f"raft_tick_outputs: out must be a contiguous "
                             f"uint8 [{packed_nbytes(g)}] tensor on {dev}")
    if dev.type == "cpu":
        outputs = raft_tick_reference(state, now_ms, params)[1]
        if out is None:
            return outputs
        packed = unpack_outputs(out, g)
        for f in fields(TickOutputs):
            getattr(packed, f.name).copy_(getattr(outputs, f.name))
        return packed
    if out is None:
        out = torch.empty(packed_nbytes(g), dtype=torch.uint8, device=dev)
    _launch_fused_tick(state, now_ms, params, out, None)
    return unpack_outputs(out, g)


def _tick_device(state: GroupState, params: TickParams) -> torch.device:
    """The device of the tick's tensors: every field of the state and
    the parameters on one device, and one that has a tick."""
    dev = state.match_rel.device
    for t in (*(getattr(state, f.name) for f in fields(GroupState)),
              *(getattr(params, f.name) for f in fields(TickParams))):
        if t.device != dev:
            raise ValueError(f"raft_tick: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"raft_tick: unsupported device {dev}")
    return dev


def _launch_fused_tick(state: GroupState, now_ms, params: TickParams,
                       out: torch.Tensor, deadlines) -> None:
    """One launch of the fused tick: the packed outputs into ``out`` and,
    when ``deadlines`` ([3, G] int32) is given, the advanced hb,
    snapshot and stepdown deadline rows into it."""
    sp = spans()
    with sp("tick.check"):
        args = _fused_tick_args(state, now_ms, params)
    with sp("tick.launch"):
        _fused_tick_call(state.match_rel.device, args, out, deadlines)


def _fused_tick_args(state: GroupState, now_ms, params: TickParams
                     ) -> tuple[list, int, int, int]:
    """The fused tick's checks of every field: (the state's and the
    parameters' pointers, now as int32, G, P)."""
    if state.match_rel.dim() != 2:
        raise ValueError(f"raft_tick: match_rel must be [G, P], got "
                         f"{tuple(state.match_rel.shape)}")
    g, p = state.match_rel.shape
    if not 1 <= p <= quorum_cuda.MAX_PEERS:
        raise ValueError(f"raft_tick: P={p} peer slots; the kernel takes "
                         f"1..{quorum_cuda.MAX_PEERS}")
    quorum_cuda.check_launch_size(g, p)
    ptrs = []
    for f in fields(GroupState):
        t = getattr(state, f.name)
        dtype = torch.bool if f.name in _BOOL_FIELDS else torch.int32
        shape = (g, p) if f.name in _PLANES else (g,)
        if t.dtype != dtype:
            raise TypeError(f"raft_tick: {f.name} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"raft_tick: {f.name} must be contiguous "
                             f"{list(shape)}, got {list(t.shape)}")
        ptrs.append(t.data_ptr())
    for f in fields(TickParams):
        t = getattr(params, f.name)
        if t.dtype != torch.int32:
            raise TypeError(f"raft_tick: {f.name} must be torch.int32, "
                            f"got {t.dtype}")
        if tuple(t.shape) not in ((), (g,)) or not t.is_contiguous():
            raise ValueError(f"raft_tick: {f.name} must be a scalar or a "
                             f"contiguous [{g}] row, got {list(t.shape)}")
        ptrs += [t.data_ptr(), t.dim()]  # stride 0 for a scalar, 1 for a row
    # a 0-d tensor is read by value; a Python int (the engine's host
    # clock) wraps to int32 as torch casts it
    # graftcheck: allow(host-sync) — the tick's clock, read once by value
    now = (int(now_ms) + 2**31) % 2**32 - 2**31
    return ptrs, now, g, p


def _fused_tick_call(dev: torch.device, args, out: torch.Tensor,
                     deadlines) -> None:
    """The launch itself, on ``dev``'s current stream, with the checked
    ``args`` of :func:`_fused_tick_args`."""
    ptrs, now, g, p = args
    new = ([deadlines[i].data_ptr() for i in range(3)]
           if deadlines is not None else [None] * 3)
    if g == 0:
        return
    lib = quorum_cuda.load()
    with torch.cuda.device(dev):
        rc = lib.tpuraft_fused_tick(
            *ptrs, now, out.data_ptr(), *new, g, p,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_tick kernel launch failed: cudaError "
                           f"{rc} (G={g}, P={p})")
    global LAUNCHES
    LAUNCHES += 1


def raft_tick_reference(state: GroupState, now_ms, params: TickParams
                        ) -> tuple[GroupState, TickOutputs]:
    """The plain version of the tick: torch ops on the state's device
    (the fused tick must equal it bit for bit)."""
    now = now_ms
    is_leader = state.role == ROLE_LEADER
    is_follower = state.role == ROLE_FOLLOWER
    is_candidate = state.role == ROLE_CANDIDATE

    # The three [G,P] -> [G] quorum reductions.
    quorum_idx, vote_ok, q_ack = fused_quorum_reference(
        state.match_rel, state.granted, state.last_ack,
        state.voter_mask, state.old_voter_mask)

    # --- commit advancement (BallotBox#commitAt, vectorized) ---------------
    # Entries before pending_rel belong to prior leaderships: never counted
    # (the Raft §5.4.2 current-term commit gate).  The commit point is
    # clamped to the best data-replica match for witness confs, after the
    # reductions, so they stay witness-agnostic.
    quorum_idx = witness_commit_clamp(
        quorum_idx, state.match_rel, state.voter_mask,
        state.old_voter_mask, state.witness_mask)
    can_commit = is_leader & (quorum_idx >= state.pending_rel)
    new_commit = torch.where(
        can_commit, torch.maximum(state.commit_rel, quorum_idx),
        state.commit_rel)
    commit_advanced = new_commit > state.commit_rel

    # --- election tally and timeout ----------------------------------------
    elected = is_candidate & vote_ok
    awake = ~state.quiescent
    election_due = (is_follower | is_candidate) & awake & (
        now >= state.elect_deadline)

    # --- leader lease / step-down (NodeImpl#checkDeadNodes) ----------------
    # The NEG gate means "no data", not "dead quorum"; `now - q_ack` may
    # wrap for NEG rows, which the gate masks out.
    have_quorum_ack = q_ack > NEG_INF_I32
    lease_valid = is_leader & have_quorum_ack & (
        now - q_ack < params.lease_ms)
    step_down = is_leader & have_quorum_ack & (
        now - q_ack >= params.election_timeout_ms)

    # --- periodic stepdown/priority lane (stepDownTimer, eto/2) ------------
    stepdown_due = is_leader & awake & (now >= state.stepdown_deadline)
    new_stepdown_deadline = torch.where(
        stepdown_due,
        now + torch.clamp_min(params.election_timeout_ms // 2, 1),
        state.stepdown_deadline)

    # --- device read-fence tally (ReadConfirmBatcher rounds) ---------------
    fence_ok = is_leader & (state.fence_start > NEG_INF_I32) & have_quorum_ack & (
        q_ack >= state.fence_start)

    # --- heartbeat scheduling ---------------------------------------------
    hb_due = is_leader & awake & (now >= state.hb_deadline)
    new_hb_deadline = torch.where(hb_due, now + params.heartbeat_ms,
                                  state.hb_deadline)

    # --- snapshot cadence (snapshotTimer); 0 disables ----------------------
    snap_due = (state.role != ROLE_INACTIVE) & (params.snapshot_ms > 0) & (
        now >= state.snap_deadline)
    new_snap_deadline = torch.where(snap_due, now + params.snapshot_ms,
                                    state.snap_deadline)

    new_state = GroupState(
        role=state.role,
        commit_rel=new_commit,
        pending_rel=state.pending_rel,
        match_rel=state.match_rel,
        granted=state.granted,
        voter_mask=state.voter_mask,
        old_voter_mask=state.old_voter_mask,
        elect_deadline=state.elect_deadline,
        hb_deadline=new_hb_deadline,
        last_ack=state.last_ack,
        snap_deadline=new_snap_deadline,
        quiescent=state.quiescent,
        witness_mask=state.witness_mask,
        stepdown_deadline=new_stepdown_deadline,
        fence_start=state.fence_start,
    )
    outputs = TickOutputs(
        commit_rel=new_commit,
        commit_advanced=commit_advanced,
        elected=elected,
        election_due=election_due,
        step_down=step_down,
        hb_due=hb_due,
        lease_valid=lease_valid,
        snap_due=snap_due,
        q_ack=q_ack,
        stepdown_due=stepdown_due,
        fence_ok=fence_ok,
    )
    return new_state, outputs


def witness_lanes_available() -> bool:
    """Does the loaded device plane carry the witness/priority/fence
    parity lanes?  An engine-backed store consults this before it
    accepts a witness conf."""
    return ("witness_mask" in GroupState.__dataclass_fields__
            and "fence_ok" in TickOutputs.__dataclass_fields__)


# -- carry-over between the JAX package's state and the port's ---------------

def group_state_from_numpy(state_fields: Mapping[str, np.ndarray],
                           device) -> GroupState:
    """GroupState from numpy arrays keyed by field name (e.g. each field
    of the JAX package's GroupState through ``np.asarray``): bool fields
    become torch.bool, the others int32."""
    out = {}
    for f in fields(GroupState):
        a = np.asarray(state_fields[f.name])
        a = a.astype(bool) if f.name in _BOOL_FIELDS else a.astype(np.int32)
        out[f.name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GroupState(**out)


def tick_params_from_numpy(election_timeout_ms, heartbeat_ms, lease_ms,
                           snapshot_ms=0, *, device) -> TickParams:
    """TickParams from numpy scalars or [G] rows (the JAX package's
    TickParams fields through ``np.asarray``)."""
    return TickParams.make(election_timeout_ms, heartbeat_ms, lease_ms,
                           snapshot_ms, device=device)


def outputs_to_numpy(out) -> dict[str, np.ndarray]:
    """Every field of a TickOutputs or GroupState as a host numpy array."""
    return {f.name: getattr(out, f.name).cpu().numpy() for f in fields(out)}
