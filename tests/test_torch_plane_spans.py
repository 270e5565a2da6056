"""The commit plane's spans and counters (``tpuraft_torch/ops/tick.py``
``Span``, ``SPANS``; ``device_plane._Plane``'s submit and drain).

A ``_Plane`` at G=256, P=4, 3 voters on the CPU runs N ticks under
``torch.profiler`` inside a caller's range: every tick has one
``plane.submit`` under that range, with its children and every span
carrying its tick's index; the counters count N submits and hold the
children within their parent.  With no profiler, the loop enters no
profiler range, reads no span clock and leaves the counters as they
were, and the commit rows are the same either way.  On a card (no JAX
here):
    python -m pytest --noconftest -m gpu tests/test_torch_plane_spans.py
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from tpuraft_torch.device_plane import SPAN_NAMES, _Plane, plane_advances
from tpuraft_torch.ops import tick as ttick

G, P, VOTERS, BATCH, N, DEPTH, SEED = 256, 4, 3, 4, 24, 4, 3
CALLER = "caller.window"
SUBMIT_CHILDREN = ("plane.acks_add", "plane.stage", "plane.tick",
                   "plane.fetch", "plane.retire")
DRAIN_CHILDREN = ("plane.wait", "plane.row")
ON_A_CARD = ("plane.upload", *ttick.TICK_SPANS)

gpu_case = pytest.param("cuda", marks=pytest.mark.gpu)


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused tick has no CPU mode")


def _plane(device="cpu", n=N):
    adv = plane_advances(G, P, VOTERS, BATCH, 2 * n, SEED)
    plane = _Plane(G, P, VOTERS, torch.device(device), adv, True)
    plane._window(DEPTH)
    return plane


def _traced(plane, first, n, device="cpu", record_shapes=False):
    """Ticks ``first`` .. ``first + n - 1`` under a profiler, inside the
    caller's range, then drained there too; the profile."""
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                record_shapes=record_shapes) as prof:
        with torch.profiler.record_function(CALLER):
            for i in range(first, first + n):
                plane.submit(i)
            plane.drain_all()
    return prof


def test_every_submit_is_one_span_under_the_callers_range():
    ttick.reset_spans()
    prof = _traced(_plane(), 0, N)
    events = [e for e in prof.events() if e.name.startswith(("plane.",
                                                             "tick."))]
    submits = [e for e in events if e.name == "plane.submit"]
    assert len(submits) == N
    assert all(e.cpu_parent is not None and e.cpu_parent.name == CALLER
               for e in submits)
    for e in submits:
        kids = [c.name for c in e.cpu_children]
        assert kids == list(SUBMIT_CHILDREN), kids
    # the plain tick on the CPU: no upload, no fused-tick spans
    assert not [e for e in events
                if e.name == "plane.upload" or e.name.startswith("tick.")]
    drains = [e for e in events if e.name == "plane.drain"]
    assert len(drains) == N
    for e in drains:
        assert e.cpu_parent.name in ("plane.retire", CALLER)
        assert [c.name for c in e.cpu_children] == list(DRAIN_CHILDREN)


def test_every_plane_span_carries_its_tick_index():
    prof = _traced(_plane(), 5, N, record_shapes=True)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith("plane."):
            by_name.setdefault(e.name, []).append(e.kwinputs)
    ticks = [{"tick": i} for i in range(5, 5 + N)]
    for name in ("plane.submit",) + SUBMIT_CHILDREN:
        assert by_name[name] == ticks, name
    for name in ("plane.drain",) + DRAIN_CHILDREN:  # drained in order
        assert by_name[name] == ticks, name
    assert set(by_name) == {"plane.submit", "plane.drain", *SUBMIT_CHILDREN,
                            *DRAIN_CHILDREN}


def test_the_counters_count_each_submit_and_hold_children_within():
    ttick.reset_spans()
    _traced(_plane(), 0, N)
    spans = {k: tuple(v) for k, v in ttick.SPANS.items()}
    assert spans["plane.submit"][0] == N
    for name in SUBMIT_CHILDREN + ("plane.drain",) + DRAIN_CHILDREN:
        assert spans[name][0] == N, name
        assert spans[name][1] > 0, name
    assert sum(spans[c][1] for c in SUBMIT_CHILDREN) <= \
        spans["plane.submit"][1]
    assert sum(spans[c][1] for c in DRAIN_CHILDREN) <= \
        spans["plane.drain"][1]
    for name in ON_A_CARD:
        assert name not in spans, name


@pytest.mark.parametrize("device", ["cpu", gpu_case])
def test_with_no_profiler_the_loop_records_nothing(monkeypatch, device):
    _need(device)

    def refuse(*a, **k):
        raise AssertionError("a span's range or clock with no profiler")

    plane = _plane(device)  # set-up outside the refusals
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    # the spans' clock, and only theirs: the loop's latencies keep theirs
    monkeypatch.setattr(ttick, "time",
                        types.SimpleNamespace(perf_counter_ns=refuse))
    ttick.reset_spans()
    ttick.SPANS["plane.submit"][:] = [7, 11]  # left as it was
    before = {k: list(v) for k, v in ttick.SPANS.items()}
    assert not ttick.tracing()
    launches = ttick.LAUNCHES
    for i in range(N):
        plane.submit(i)
    plane.drain_all()
    assert plane.submitted == len(plane.rows) == N
    assert ttick.LAUNCHES - launches == (N if device == "cuda" else 0)
    assert ttick.SPANS == before
    ttick.reset_spans()


def test_the_torch_internals_the_spans_use_are_there():
    # a torch that renames either fails here, not in the untraced loop
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert callable(torch._C._profiler._RecordFunctionFast)
    assert not ttick.tracing()
    assert ttick.spans() is ttick.no_span
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        assert ttick.tracing()
        assert ttick.spans() is ttick.Span
    assert not ttick.tracing()


def test_commit_rows_are_the_same_with_spans_on_and_off():
    off = _plane()
    for i in range(2 * N):
        off.submit(i)
    off.drain_all()
    on = _plane()
    for i in range(N):
        on.submit(i)
    _traced(on, N, N)
    np.testing.assert_array_equal(np.stack(on.rows), np.stack(off.rows))
    assert len(on.rows) == 2 * N
    np.testing.assert_array_equal(on.last_commit, off.last_commit)


def test_reset_spans_zeroes_the_table():
    _traced(_plane(), 0, 4)
    assert ttick.SPANS["plane.submit"][0] > 0
    assert set(ttick.SPANS) <= set(SPAN_NAMES)
    ttick.reset_spans()
    assert not ttick.SPANS
    assert ttick.SPANS["plane.submit"] == [0, 0]
    ttick.reset_spans()


# ---- on a card --------------------------------------------------------------


@pytest.mark.gpu
def test_the_fused_path_records_its_tick_spans_once_a_tick():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused tick has no CPU mode")
    cpu = _plane()
    for i in range(N):
        cpu.submit(i)
    cpu.drain_all()
    ttick.reset_spans()
    plane = _plane("cuda")
    prof = _traced(plane, 0, N, "cuda")
    np.testing.assert_array_equal(np.stack(plane.rows), np.stack(cpu.rows))
    for name in ("plane.submit", *ON_A_CARD, "plane.drain", "plane.wait"):
        assert ttick.SPANS[name][0] == N, name
    ticks = [e for e in prof.events() if e.name == "plane.tick"]
    assert len(ticks) == N
    for e in ticks:
        assert [c.name for c in e.cpu_children if c.name.startswith(
            "tick.")] == list(ttick.TICK_SPANS)
    # the engine's outputs-only tick shares the check and the launch
    ttick.reset_spans()
    out = torch.empty(ttick.packed_nbytes(G), dtype=torch.uint8,
                      device="cuda")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        ttick.raft_tick_outputs(plane.state, 0, plane.params, out)
    torch.cuda.synchronize()
    assert ttick.SPANS["tick.check"][0] == ttick.SPANS["tick.launch"][0] == 1
    assert "tick.alloc" not in ttick.SPANS
    ttick.reset_spans()
