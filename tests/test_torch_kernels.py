"""The contracts around the port's fused tick and deadline fold.

Here on the CPU: every field view of the tick's staging buffer
(``pinned_staging``) and of its packed outputs lies at the kernel's
alignment and inside its buffer, at several G and P, ragged G included;
the fold's work buffer starts at rest and ``deadline_fold`` refuses any
other buffer.  On a card (``gpu``): the fused tick and the fused quorum
against their plain versions at every P from 1 to 32 on ragged G with
joint and witness rows, and the fold's kernel against its plain version
back to back on one buffer and inside a CUDA graph of 100 folds.

This file imports no JAX.  On a machine with a card:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpuraft_torch.ops import deadline_fold as dfold
from tpuraft_torch.ops import quorum_cuda
from tpuraft_torch.ops import tick as ttick
from tpuraft_torch.parallel.mesh import pinned_staging

# (G, P): the store's shape, phase 5's, ragged G (no multiple of 4 or
# 16), one group, P from 1 to 32
SHAPES = ((2048, 4), (1028, 8), (2053, 5), (1, 1), (37, 3), (16421, 16),
          (999, 32), (4099, 2))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _tick_fields(g, p):
    """The engine's staging fields of one shard (_TickStaging's order)."""
    from tpuraft_torch.core.engine import _BOOL_FIELDS, _I32_FIELDS

    return [(name, dtype, (g, p) if rank == 2 else (g,))
            for dtype, specs in ((torch.int32, _I32_FIELDS),
                                 (torch.bool, _BOOL_FIELDS))
            for name, rank in specs]


@pytest.mark.parametrize("g,p", SHAPES)
def test_staging_views_meet_the_kernels_alignment(g, p):
    """Each staged field is a contiguous typed view of the byte buffer,
    on its element size's alignment, inside the buffer and beside no
    other field: the tick's, and the fold's six rows."""
    fold_fields = ([(n, torch.int32, (g,)) for n in (
        "role", "elect_deadline", "hb_deadline", "stepdown_deadline")]
        + [(n, torch.bool, (g,)) for n in ("quiescent", "has_ctrl")])
    for fields in (_tick_fields(g, p), fold_fields):
        host, dev, hv, dv = pinned_staging(fields, torch.device("cpu"))
        base, end = dev.data_ptr(), dev.data_ptr() + dev.numel()
        spans = []
        for name, dtype, shape in fields:
            t = dv[name]
            assert t.dtype == dtype and tuple(t.shape) == shape, name
            assert t.is_contiguous(), name
            a = t.data_ptr()
            assert a % _itemsize(dtype) == 0, (name, a)
            assert base <= a and a + t.nbytes <= end, name
            assert hv[name].ctypes.data == a, name  # the host view is it
            spans.append((a, a + t.nbytes))
        spans.sort()
        assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("g,p", SHAPES)
def test_packed_output_rows_meet_the_kernels_alignment(g, p):
    """The packed outputs' row views: int32 rows on 4 bytes, every row
    inside the buffer, none overlapping, in the engine's order."""
    buf = torch.empty(ttick.packed_nbytes(g), dtype=torch.uint8)
    out = ttick.unpack_outputs(buf, g)
    spans = []
    for name in (*ttick.PACKED_I32, *ttick.PACKED_BOOL):
        t = getattr(out, name)
        assert t.is_contiguous() and tuple(t.shape) == (g,), name
        assert t.data_ptr() % t.element_size() == 0, name
        spans.append((t.data_ptr() - buf.data_ptr(), t.nbytes))
    offs = [0]
    for _, n in spans:
        offs.append(offs[-1] + n)
    assert [a for a, _ in spans] == offs[:-1]
    assert offs[-1] == buf.numel()


def test_fold_work_buffer_starts_at_rest():
    """Every word 0xFFFFFFFF: the key's and the ticket's rest, which each
    fold leaves as it found it; on the CPU the buffer takes the result."""
    buf = dfold.fold_work_buffer("cpu")
    assert buf.dtype == torch.int32 and tuple(buf.shape) == (3,)
    assert buf.view(torch.uint8).tolist() == [0xFF] * 12
    rng = np.random.default_rng(3)
    rows = _fold_rows(rng, 100)
    got = dfold.deadline_fold(*rows, out=buf)
    assert int(got) == int(dfold.deadline_fold_reference(*rows))
    assert got.data_ptr() == buf.data_ptr()


def test_deadline_fold_refuses_other_buffers():
    """Only a buffer of fold_work_buffer reaches the kernel: a plain
    tensor of the right type and shape, a view of a work buffer, a wrong
    type or shape, a buffer on another device all raise."""
    rng = np.random.default_rng(4)
    rows = _fold_rows(rng, 64)
    work = dfold.fold_work_buffer("cpu")
    for bad in (torch.full((3,), -1, dtype=torch.int32),
                torch.empty(3, dtype=torch.int32), work[:], work.clone(),
                torch.full((3,), -1, dtype=torch.int64),
                torch.full((4,), -1, dtype=torch.int32),
                torch.full((1, 3), -1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="fold_work_buffer"):
            dfold.deadline_fold(*rows, out=bad)
    meta = [r.to("meta") for r in rows]
    with pytest.raises(ValueError):
        dfold.deadline_fold(*meta, out=work)


def test_fold_staging_uses_a_work_buffer():
    from tpuraft_torch.parallel.mesh import _FoldStaging

    st = _FoldStaging(16, torch.device("cpu"), slice(0, 16))
    assert dfold._WORK.get(id(st.out)) is st.out


def _fold_rows(rng, g):
    return [torch.from_numpy(x) for x in (
        rng.integers(0, 4, g).astype(np.int32), rng.random(g) < 0.3,
        rng.random(g) < 0.7,
        rng.integers(-(2**31), 2**31 - 1, g, dtype=np.int64).astype(np.int32),
        rng.integers(0, 1 << 30, g).astype(np.int32),
        rng.integers(0, 1 << 30, g).astype(np.int32))]


# ---- on a card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_fused_tick_matches_plain_at_every_p_on_ragged_g():
    """P = 1..32, each at a ragged G (no multiple of 16, so the last
    block is part full) and at a whole one, edge rows (joint, witness, empty, wrapping
    deadlines), scalar and row parameters: every output and deadline row
    bit for bit, through raft_tick and raft_tick_outputs."""
    dev = _card()
    from chip_smoke import edge_now, edge_tick_fields, edge_tick_params

    rng = np.random.default_rng(21)
    before, n = ttick.LAUNCHES, 0
    for p in range(1, quorum_cuda.MAX_PEERS + 1):
        for g in (16 * int(rng.integers(1, 200)) + int(rng.integers(1, 16)),
                  256 * int(rng.integers(1, 9))):
            prm = (999, 100, 900, 700) if p % 3 == 0 else \
                edge_tick_params(rng, g)
            params = ttick.tick_params_from_numpy(*prm, device=dev)
            state = ttick.group_state_from_numpy(
                edge_tick_fields(rng, g, p), device=dev)
            now = edge_now(rng)
            new, out = ttick.raft_tick(state, now, params)
            packed = ttick.raft_tick_outputs(
                state, now, params, out=torch.full(
                    (ttick.packed_nbytes(g),), 0xAB, dtype=torch.uint8,
                    device=dev))
            want_new, want = ttick.raft_tick_reference(state, now, params)
            torch.cuda.synchronize()
            for got, ref in ((out, want), (packed, want), (new, want_new)):
                for f in dataclasses.fields(ref):
                    a, b = getattr(got, f.name), getattr(ref, f.name)
                    assert a.is_cuda and a.dtype == b.dtype
                    assert torch.equal(a, b), f"{f.name} P={p} G={g}"
            n += 2
    assert ttick.LAUNCHES == before + n


@pytest.mark.gpu
def test_fused_quorum_matches_plain_at_every_p_on_ragged_g():
    dev = _card()
    from chip_smoke import quorum_inputs

    rng = np.random.default_rng(22)
    for p in range(1, quorum_cuda.MAX_PEERS + 1):
        g = 16 * int(rng.integers(1, 300)) + int(rng.integers(1, 16))
        case = [torch.from_numpy(a).to(dev)
                for a in quorum_inputs(rng, g, p)]
        got = quorum_cuda.fused_quorum(*case)
        want = quorum_cuda.fused_quorum_reference(*case)
        torch.cuda.synchronize()
        for t, w in zip(got, want):
            assert torch.equal(t, w), f"P={p} G={g}"


@pytest.mark.gpu
def test_fold_back_to_back_and_in_a_graph_on_one_buffer():
    """100 folds on one work buffer, one stream, no wait in between, each
    result kept on the card: equal to the plain version, the sentinel
    among them; then a CUDA graph of 100 folds replayed twice on the
    buffer, and the buffer at rest after it."""
    dev = _card()
    rng = np.random.default_rng(23)
    buf = dfold.fold_work_buffer(dev)
    cases, want = [], []
    for i in range(100):
        g = int(rng.choice([1, 255, 256, 257, 8192, 8193, 70_000]))
        rows = _fold_rows(rng, g)
        if i % 10 == 9:  # nothing scheduled: the sentinel
            rows[2] = torch.zeros(g, dtype=torch.bool)
        cases.append([r.to(dev) for r in rows])
        want.append(int(dfold.deadline_fold_reference(*rows)))
    got = torch.empty(100, dtype=torch.int32, device=dev)
    before = dfold.LAUNCHES
    for i, rows in enumerate(cases):
        got[i:i + 1].copy_(dfold.deadline_fold(*rows, out=buf).view(1))
    assert got.cpu().tolist() == want
    assert dfold.LAUNCHES - before == 100
    assert int(dfold.DEADLINE_NONE_I32) in want

    rows = cases[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dfold.deadline_fold(*rows, out=buf)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            dfold.deadline_fold(*rows, out=buf)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert int(buf[0]) == want[0]
        assert buf[1:].view(torch.uint8).tolist() == [0xFF] * 8
