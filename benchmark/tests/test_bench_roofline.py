"""The fused tick's byte count, at the shapes PERF.md's kernel table
bounds, and its table of operands against the port's dataclasses."""

import dataclasses

import pytest

from benchmark.core import roofline


@pytest.mark.parametrize("g,p,param_rows,deadlines,us", [
    (16384, 8, True, False, 0.79230090),
    (2048, 4, True, False, 0.06969313),
    (64, 4, True, False, 0.00217791),
    (16421, 16, True, False, 1.26466209),
])
def test_bound_at_the_kernel_tables_shapes(g, p, param_rows, deadlines, us):
    n = roofline.fused_tick_bytes(g, p, param_rows, deadlines)
    assert roofline.least_seconds(n) * 1e6 == pytest.approx(us, abs=5e-9)


def test_the_planes_tick():
    # raft_tick at 65,536 x 8 with scalar parameters: 158 B a group
    assert roofline.fused_tick_bytes(65536, 8) == 65536 * 158 + 16


def test_operands_match_the_ports_dataclasses():
    from tpuraft_torch.ops import tick

    g, p = 7, 5
    st = tick.GroupState.zeros(g, p, "cpu")
    assert [f.name for f in dataclasses.fields(st)] == list(
        roofline.STATE_FIELDS)
    for f in dataclasses.fields(st):
        t = getattr(st, f.name)
        size, rank = roofline.STATE_FIELDS[f.name]
        assert t.element_size() == size and t.dim() == rank, f.name
    assert [f.name for f in dataclasses.fields(tick.TickParams)] == list(
        roofline.PARAM_FIELDS)
    assert {f.name for f in dataclasses.fields(tick.TickOutputs)} == set(
        roofline.OUTPUT_FIELDS)
    assert tick.packed_nbytes(g) == sum(roofline.OUTPUT_FIELDS.values()) * g
    _, out = tick.raft_tick(st, 0, tick.TickParams.make(
        1000, 100, 900, device="cpu"))
    for name, size in roofline.OUTPUT_FIELDS.items():
        assert getattr(out, name).element_size() == size, name
