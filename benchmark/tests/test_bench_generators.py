"""The traffic repeats exactly from a seed."""

import numpy as np

from benchmark.core import acks


UNIFORM = {"kind": "uniform", "min_entries": 1, "max_entries": 4,
           "max_lag_ticks": 3}
ZIPF = {"kind": "zipf", "appends_per_tick": 512, "theta": 0.99,
        "max_lag_ticks": 3}


def test_plane_acks_repeat_from_a_seed():
    for kind in (UNIFORM, ZIPF):
        r1 = acks.make_ring(kind, 1024, 4, 3, 8, 2**33 + 99)
        r2 = acks.make_ring(kind, 1024, 4, 3, 8, 2**33 + 99)
        r3 = acks.make_ring(kind, 1024, 4, 3, 8, 2**33 + 100)
        assert np.array_equal(r1, r2) and not np.array_equal(r1, r3)
        assert not r1[:, :, 3:].any()


def test_plane_followers_trail_the_leader():
    for kind in (UNIFORM, ZIPF):
        ring = acks.make_ring(kind, 4096, 4, 3, 16, 5)
        assert ring.dtype == np.int16 and ring.min() >= 0
        m = np.cumsum(ring.astype(np.int64), axis=0)
        lead = m[:, :, 0]
        for f in (1, 2):
            assert (m[:, :, f] <= lead).all()
            assert (m[3:, :, f] >= lead[:-3]).all()   # at most 3 behind
            assert np.array_equal(m[-1, :, f], lead[-1])  # caught up
        # the commit (the middle of three) is often neither end's
        mid = np.sort(m[:, :, :3], axis=2)[:, :, 1]
        assert (mid != lead).any() and (mid != m[:, :, :3].min(axis=2)).any()


def test_plane_acks_shapes():
    u = acks.make_ring(UNIFORM, 512, 4, 3, 4, 1)
    assert u[:, :, 0].min() >= 1 and u[:, :, 0].max() <= 4
    z = acks.make_ring({**ZIPF, "appends_per_tick": 4096}, 65536, 4, 3, 2,
                       1)
    assert (z[:, :, 0].sum(axis=1) == 4096).all()
    assert (z[0, :, 0] > 0).mean() < 0.1  # most rows unchanged a tick
    view = acks.RingView(u)
    assert np.array_equal(view[5], u[1])
