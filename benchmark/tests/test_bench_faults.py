"""The comparison fails what it should: the controls (the reference with
a guarantee broken, in the program's place) and the program with its
timed path broken underneath, each driven through the rest of a run."""

import dataclasses

import pytest

from benchmark import control
from benchmark.tests import tiny


def _broken_tick(how):
    import torch

    from tpuraft_torch.ops.tick import raft_tick

    def tick(state, now_ms, params):
        new, out = raft_tick(state, now_ms, params)
        commit = out.commit_rel.clone()
        g = commit.shape[0]
        if how == "unchanged":
            commit = state.commit_rel
        elif how == "half":
            commit[g // 2:] = state.commit_rel[g // 2:]
        elif how == "altered":
            commit[g // 3] += 1
        elif how == "quorum_of_one":  # the leader's own match commits
            low = torch.iinfo(torch.int32).min
            top = torch.where(state.voter_mask, state.match_rel,
                              low).max(dim=1).values
            commit = torch.maximum(state.commit_rel, top)
        return (dataclasses.replace(new, commit_rel=commit),
                dataclasses.replace(out, commit_rel=commit))

    return tick


@pytest.mark.parametrize("how", ["unchanged", "half", "altered",
                                 "quorum_of_one"])
@pytest.mark.parametrize("name", ["plane.g64k.uniform", "plane.g64k.zipf"])
def test_a_broken_plane_is_not_correct(name, how):
    with control.tick_replaced(_broken_tick(how)):
        out, _ = tiny.run(tiny.cell(name), seconds=0.3)
    assert not out["correct"] and out["checks"]["bad_rows"]["value"] > 0


def test_the_plane_control_is_not_correct():
    for name in ("plane.g64k.uniform", "plane.g64k.zipf"):
        checks = control.plane_control(tiny.cell(name), 5, 0.3, "cpu")
        assert checks["bad_rows"][0] > 0
