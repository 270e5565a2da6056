"""The port's native log engine (``native://``) and shared meta journal
(``multimeta://``) on the CPU.

Port copies of the JAX package's native:// and multimeta cases of
tests/test_storage.py, built from and loaded out of tpuraft_torch/native,
and differentials against the JAX package, each held exactly: a seeded
script of appends, truncations and resets through both packages' native
log engines, seeded ``{term, votedFor}`` saves through both shared meta
journals and then a reopen, and data directories written by each package
opened by the other.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

import tpuraft.entity as jentity
import tpuraft_torch.entity as tentity
from tpuraft_torch.entity import EntryType, LogEntry, LogId, PeerId


@pytest.fixture(scope="module", autouse=True)
def _built():
    """Both packages' engines built (each from its own sources)."""
    from tpuraft.storage.native_log import ensure_built as jbuild
    from tpuraft_torch.storage.native_log import ensure_built

    ensure_built()
    jbuild()


def mk_entries(first, count, term=1, size=16):
    return [
        LogEntry(type=EntryType.DATA, id=LogId(first + i, term), data=bytes(size))
        for i in range(count)
    ]


class _BaseLogStorageSuite:
    """The generic LogStorage battery (the port's copy of
    tests/test_storage.py's)."""

    def mk(self, tmp_path):
        raise NotImplementedError

    def test_empty(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        assert s.first_log_index() == 1
        assert s.last_log_index() == 0
        assert s.get_entry(1) is None
        s.shutdown()

    def test_append_get(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 10))
        assert s.last_log_index() == 10
        e = s.get_entry(7)
        assert e and e.id == LogId(7, 1)
        assert s.get_term(7) == 1
        s.shutdown()

    def test_truncate_suffix(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 10))
        s.truncate_suffix(6)
        assert s.last_log_index() == 6
        assert s.get_entry(7) is None
        s.append_entries(mk_entries(7, 2, term=2))
        assert s.get_term(8) == 2
        s.shutdown()

    def test_truncate_prefix(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 10))
        s.truncate_prefix(5)
        assert s.first_log_index() == 5
        assert s.last_log_index() == 10
        s.shutdown()

    def test_reset(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 5))
        s.reset(100)
        assert s.first_log_index() == 100
        assert s.last_log_index() == 99
        s.append_entries(mk_entries(100, 3, term=9))
        assert s.get_term(101) == 9
        s.shutdown()


class TestNativeLogStorage(_BaseLogStorageSuite):
    """The C++ engine must pass the same suite as the Python impl, plus
    recovery and cross-engine interop (same on-disk format)."""

    def mk(self, tmp_path):
        from tpuraft_torch.storage.native_log import NativeLogStorage
        return NativeLogStorage(str(tmp_path / "log"), segment_max_bytes=512)

    def test_restart_recovery(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 20, size=40))  # spans segments
        s.shutdown()
        s2 = self.mk(tmp_path)
        s2.init()
        assert s2.last_log_index() == 20
        assert s2.get_entry(15).id == LogId(15, 1)
        s2.shutdown()

    def test_torn_write_recovery(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 3, size=40))
        s.shutdown()
        seg = sorted((tmp_path / "log").glob("seg_*.log"))[0]
        data = seg.read_bytes()
        seg.write_bytes(data[:-10])
        s2 = self.mk(tmp_path)
        s2.init()
        assert s2.last_log_index() == 2
        assert s2.get_entry(2) is not None
        s2.shutdown()

    def test_corrupt_entry_detected(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 3, size=40))
        s.shutdown()
        seg = sorted((tmp_path / "log").glob("seg_*.log"))[0]
        data = bytearray(seg.read_bytes())
        data[-5] ^= 0xFF  # flip a byte in the last entry's payload
        seg.write_bytes(bytes(data))
        s2 = self.mk(tmp_path)
        s2.init()
        assert s2.last_log_index() == 2  # CRC scan drops the bad tail entry
        s2.shutdown()

    def test_non_contiguous_append_rejected(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 3))
        with pytest.raises(ValueError):
            s.append_entries(mk_entries(7, 1))
        s.shutdown()

    def test_conf_sidecar(self, tmp_path):
        s = self.mk(tmp_path)
        s.init()
        ents = mk_entries(1, 6)
        ents[2] = LogEntry(type=EntryType.CONFIGURATION, id=LogId(3, 1),
                           peers=[PeerId.parse("127.0.0.1:8001")])
        s.append_entries(ents)
        assert s.configuration_indexes() == [3]
        s.shutdown()
        s2 = self.mk(tmp_path)
        s2.init()
        assert s2.configuration_indexes() == [3]
        e = s2.get_entry(3)
        assert e.is_configuration() and e.peers == [PeerId.parse("127.0.0.1:8001")]
        s2.shutdown()

    def test_interop_with_python_engine(self, tmp_path):
        """Write with C++, read+extend with Python, read back with C++."""
        from tpuraft_torch.storage.log_storage import FileLogStorage
        s = self.mk(tmp_path)
        s.init()
        s.append_entries(mk_entries(1, 10, size=40))
        s.shutdown()
        p = FileLogStorage(str(tmp_path / "log"), segment_max_bytes=512)
        p.init()
        assert p.last_log_index() == 10
        p.append_entries(mk_entries(11, 5, term=2, size=40))
        p.shutdown()
        s2 = self.mk(tmp_path)
        s2.init()
        assert s2.last_log_index() == 15
        assert s2.get_term(12) == 2
        s2.shutdown()

    def test_uri_factory(self, tmp_path):
        from tpuraft_torch.storage.log_storage import create_log_storage
        s = create_log_storage(f"native://{tmp_path}/log")
        s.init()
        s.append_entries(mk_entries(1, 3))
        assert s.last_log_index() == 3
        s.shutdown()


class TestMultiMetaStorage:
    """Shared {term, votedFor} journal with group-commit fsync
    (storage/meta_multilog.py; reference: LocalRaftMetaStorage semantics
    at multi-raft density — SURVEY.md §3.1 'synced on change')."""

    def test_roundtrip_many_groups(self, tmp_path):
        from tpuraft_torch.storage.meta_multilog import MultiRaftMetaStorage

        stores = [MultiRaftMetaStorage(str(tmp_path), f"g{i}")
                  for i in range(8)]
        for s in stores:
            s.init()
        for i, s in enumerate(stores):
            s.set_term_and_voted_for(i + 1, PeerId.parse(f"1.2.3.4:{80 + i}"))
        for s in stores:
            s.shutdown()
        back = [MultiRaftMetaStorage(str(tmp_path), f"g{i}")
                for i in range(8)]
        for i, s in enumerate(back):
            s.init()
            assert s.term == i + 1
            assert s.voted_for == PeerId.parse(f"1.2.3.4:{80 + i}")
        for s in back:
            s.shutdown()

    async def test_group_commit_coalesces_fsyncs(self, tmp_path):
        """N groups persisting concurrently must share fsync rounds —
        the whole point of the journal (r4 weak #5: durable-meta
        election herds)."""
        from tpuraft_torch.storage.meta_multilog import MultiRaftMetaStorage

        G = 64
        stores = [MultiRaftMetaStorage(str(tmp_path), f"g{i}")
                  for i in range(G)]
        for s in stores:
            s.init()
        jnl = stores[0]._jnl
        sync0 = jnl.sync_count
        await asyncio.gather(*(
            s.save_async(5, PeerId.parse("1.2.3.4:80")) for s in stores))
        rounds = jnl.sync_count - sync0
        assert rounds < G / 4, rounds  # far fewer fsyncs than groups
        for s in stores:
            s.shutdown()

    def test_torn_tail_truncated_beyond_watermark(self, tmp_path):
        from tpuraft_torch.storage.meta_multilog import MetaJournal

        j = MetaJournal(str(tmp_path))
        j.stage("g1", 3, PeerId.parse("1.2.3.4:80"))
        j.sync()
        # watermark still covers only the fsynced prefix recorded at
        # open; simulate crash AFTER an unsynced stage: chop bytes
        j.stage("g1", 4, PeerId.parse("1.2.3.4:81"))
        path = tmp_path / "meta.jnl"
        j._f.flush()
        j._f = None  # simulate crash (skip close's sync+watermark)
        data = path.read_bytes()
        path.write_bytes(data[:-3])
        j2 = MetaJournal(str(tmp_path))
        term, voted = j2.get("g1")
        assert term == 3  # torn record dropped, synced one survives
        j2.close()

    def test_corruption_below_watermark_is_loud(self, tmp_path):
        from tpuraft_torch.storage.log_storage import CorruptLogError
        from tpuraft_torch.storage.meta_multilog import MetaJournal

        j = MetaJournal(str(tmp_path))
        j.stage("g1", 3, PeerId.parse("1.2.3.4:80"))
        j.sync()
        j.close()  # clean close advances the watermark
        path = tmp_path / "meta.jnl"
        data = bytearray(path.read_bytes())
        data[5] ^= 0xFF
        path.write_bytes(bytes(data))
        with pytest.raises(CorruptLogError):
            MetaJournal(str(tmp_path))

    def test_compaction_keeps_latest_values(self, tmp_path):
        from tpuraft_torch.storage.meta_multilog import MetaJournal

        j = MetaJournal(str(tmp_path))
        j.COMPACT_MIN_BYTES = 512  # force compaction early
        for term in range(1, 200):
            j.stage("g1", term, PeerId.parse("1.2.3.4:80"))
            j.stage("g2", term, PeerId.parse("1.2.3.4:81"))
            j.sync()
        assert (tmp_path / "meta.jnl").stat().st_size < 4096  # compacted
        j.close()
        j2 = MetaJournal(str(tmp_path))
        assert j2.get("g1") == (199, PeerId.parse("1.2.3.4:80"))
        assert j2.get("g2") == (199, PeerId.parse("1.2.3.4:81"))
        j2.close()


# -- differentials against the JAX package ----------------------------------------

_PEERS = ["10.0.0.1:8001", "10.0.0.2:8002", "10.0.0.3:8003",
          "10.0.0.4:8004:1"]


def log_script(seed: int, n_groups: int, n_ops: int) -> list[tuple]:
    """A seeded script of log operations over n_groups groups: appends of
    DATA, NO_OP and CONFIGURATION entries (random sizes and bytes, terms
    that never fall), suffix and prefix truncations and resets, each
    drawn inside the group's current [first, last] as a raft log sees
    them."""
    rng = np.random.default_rng(seed)
    state = [[1, 0, 1] for _ in range(n_groups)]  # first, last, term
    ops = []
    for _ in range(n_ops):
        g = int(rng.integers(n_groups))
        first, last, term = state[g]
        kind = int(rng.integers(10))
        if kind < 6 or last < first:
            term += int(rng.integers(2))
            ents = []
            for i in range(int(rng.integers(1, 8))):
                t = int(rng.integers(3))
                peers = None
                if t == EntryType.CONFIGURATION:
                    pick = rng.choice(len(_PEERS), 3, replace=False)
                    peers = [_PEERS[int(j)] for j in pick]
                data = rng.bytes(int(rng.integers(0, 200))) \
                    if t == EntryType.DATA else b""
                ents.append((t, last + 1 + i, term, data, peers))
            ops.append(("append", g, ents, bool(rng.integers(2))))
            last += len(ents)
        elif kind < 8:
            last = int(rng.integers(first - 1, last + 1))
            ops.append(("truncate_suffix", g, last))
        elif kind == 8:
            first = int(rng.integers(first, last + 2))
            ops.append(("truncate_prefix", g, first))
        else:
            first = last + int(rng.integers(1, 50))
            last = first - 1
            ops.append(("reset", g, first))
        state[g] = [first, last, term]
    return ops


def to_entries(pkg, ents) -> list:
    return [pkg.LogEntry(type=pkg.EntryType(t), id=pkg.LogId(i, term),
                         data=data,
                         peers=None if peers is None
                         else [pkg.PeerId.parse(p) for p in peers])
            for t, i, term, data, peers in ents]


def entry_row(e) -> tuple:
    """A package-neutral image of one entry."""
    return (int(e.type), e.id.index, e.id.term, bytes(e.data),
            None if e.peers is None else [str(p) for p in e.peers],
            None if e.old_peers is None else [str(p) for p in e.old_peers])


def apply_log_op(pkg, storages, op) -> tuple:
    """One op on its group's storage; returns its (first, last) after."""
    name, g, arg = op[0], op[1], op[2]
    s = storages[g]
    if name == "append":
        s.append_entries(to_entries(pkg, arg), sync=op[3])
    else:
        getattr(s, name)(arg)
    return s.first_log_index(), s.last_log_index()


def log_image(storages) -> list:
    """Every group's [first, last], entries and configuration indexes."""
    out = []
    for s in storages:
        first, last = s.first_log_index(), s.last_log_index()
        out.append((first, last,
                    [entry_row(s.get_entry(i)) for i in range(first, last + 1)],
                    list(s.configuration_indexes())))
    return out


def test_native_log_script_matches_jax(tmp_path):
    """One seeded script through both packages' native:// engines (one
    directory per group, small segments so they rotate): every op's
    (first, last), then every entry, the same; again after a reopen."""
    import tpuraft.storage.native_log as jlog
    import tpuraft_torch.storage.native_log as tlog

    n_groups = 6
    ops = log_script(7, n_groups, 150)

    def open_all(mod, root):
        ss = [mod.NativeLogStorage(str(root / f"g{g}"), segment_max_bytes=2048)
              for g in range(n_groups)]
        for s in ss:
            s.init()
        return ss

    js, ts = open_all(jlog, tmp_path / "jax"), open_all(tlog, tmp_path / "torch")
    assert [apply_log_op(jentity, js, op) for op in ops] == \
        [apply_log_op(tentity, ts, op) for op in ops]
    image = log_image(js)
    assert log_image(ts) == image
    assert sum(len(g[2]) for g in image) > 0
    for s in js + ts:
        s.shutdown()
    js, ts = open_all(jlog, tmp_path / "jax"), open_all(tlog, tmp_path / "torch")
    try:
        assert log_image(js) == log_image(ts) == image
    finally:
        for s in js + ts:
            s.shutdown()


def test_native_log_directories_open_across_packages(tmp_path):
    """A native:// directory written by each package opens in the other
    with every entry equal, and the other package extends it."""
    import tpuraft.storage.native_log as jlog
    import tpuraft_torch.storage.native_log as tlog

    ops = log_script(3, 1, 40)
    images = {}
    for writer, pkg in ((jlog, jentity), (tlog, tentity)):
        s = writer.NativeLogStorage(str(tmp_path / writer.__name__), 1024)
        s.init()
        for op in ops:
            apply_log_op(pkg, [s], op)
        images[writer.__name__] = log_image([s])
        s.shutdown()
    assert images[jlog.__name__] == images[tlog.__name__]
    for reader, pkg, written in ((tlog, tentity, jlog), (jlog, jentity, tlog)):
        path = str(tmp_path / written.__name__)
        s = reader.NativeLogStorage(path, 1024)
        s.init()
        assert log_image([s]) == images[written.__name__]
        last = s.last_log_index()
        s.append_entries(to_entries(pkg, [(1, last + 1, 99, b"x", None)]))
        s.shutdown()
        back = written.NativeLogStorage(path, 1024)
        back.init()
        try:
            assert back.last_log_index() == last + 1
            assert back.get_term(last + 1) == 99
        finally:
            back.shutdown()


def meta_script(seed: int, n_groups: int, n_ops: int) -> list[tuple]:
    """Seeded {term, votedFor} saves: a group's term moves forward (or
    repeats, or steps back, which the journal must refuse to apply) and
    its vote goes to a peer or to nobody."""
    rng = np.random.default_rng(seed)
    terms = [0] * n_groups
    ops = []
    for _ in range(n_ops):
        g = int(rng.integers(n_groups))
        terms[g] = max(0, terms[g] + int(rng.integers(-1, 3)))
        voted = "" if rng.random() < 0.2 else \
            _PEERS[int(rng.integers(len(_PEERS)))]
        ops.append((g, terms[g], voted))
    return ops


def _peer(pkg, s: str):
    return pkg.PeerId.parse(s) if s else pkg.EMPTY_PEER


def test_multimeta_saves_match_jax_then_reopen(tmp_path):
    """Seeded saves through both packages' shared meta journals: the
    same {term, votedFor} after every save, after a reopen, and the same
    journal bytes on disk."""
    import tpuraft.storage.meta_multilog as jmeta
    import tpuraft_torch.storage.meta_multilog as tmeta

    n_groups = 24
    ops = meta_script(11, n_groups, 400)

    def open_all(mod, root):
        ss = [mod.MultiRaftMetaStorage(str(root), f"r{g}")
              for g in range(n_groups)]
        for s in ss:
            s.init()
        return ss

    def image(ss):
        return [(s.term, str(s.voted_for)) for s in ss]

    out = {}
    for mod, pkg in ((jmeta, jentity), (tmeta, tentity)):
        ss = open_all(mod, tmp_path / mod.__name__)
        seen = []
        for g, term, voted in ops:
            ss[g].set_term_and_voted_for(term, _peer(pkg, voted))
            seen.append((ss[g].term, str(ss[g].voted_for)))
        out[mod.__name__] = (seen, image(ss))
        for s in ss:
            s.shutdown()
    assert out[tmeta.__name__] == out[jmeta.__name__]
    final = out[jmeta.__name__][1]
    assert any(t > 0 for t, _ in final)
    for mod in (jmeta, tmeta):
        ss = open_all(mod, tmp_path / mod.__name__)
        try:
            assert image(ss) == final
        finally:
            for s in ss:
                s.shutdown()
    jbytes = sorted((p.name, p.read_bytes())
                    for p in (tmp_path / jmeta.__name__).iterdir())
    tbytes = sorted((p.name, p.read_bytes())
                    for p in (tmp_path / tmeta.__name__).iterdir())
    assert tbytes == jbytes


def test_multimeta_directories_open_across_packages(tmp_path):
    """A shared meta journal written by each package reopens in the
    other with every group's {term, votedFor}."""
    import tpuraft.storage.meta_multilog as jmeta
    import tpuraft_torch.storage.meta_multilog as tmeta

    ops = meta_script(5, 8, 120)
    for writer, wpkg, reader, rpkg in ((jmeta, jentity, tmeta, tentity),
                                       (tmeta, tentity, jmeta, jentity)):
        root = str(tmp_path / writer.__name__)
        ss = [writer.MultiRaftMetaStorage(root, f"r{g}") for g in range(8)]
        for s in ss:
            s.init()
        for g, term, voted in ops:
            ss[g].set_term_and_voted_for(term, _peer(wpkg, voted))
        want = [(s.term, str(s.voted_for)) for s in ss]
        for s in ss:
            s.shutdown()
        back = [reader.MultiRaftMetaStorage(root, f"r{g}") for g in range(8)]
        for s in back:
            s.init()
        try:
            assert [(s.term, str(s.voted_for)) for s in back] == want
            back[0].set_term_and_voted_for(want[0][0] + 1,
                                           _peer(rpkg, _PEERS[0]))
        finally:
            for s in back:
                s.shutdown()
        again = writer.MultiRaftMetaStorage(root, "r0")
        again.init()
        assert (again.term, str(again.voted_for)) == \
            (want[0][0] + 1, _PEERS[0])
        again.shutdown()
