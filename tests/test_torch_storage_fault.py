"""The port's storage fault plane (tpuraft_torch/storage/fault.py) on the
CPU, against the JAX package's.

- Port copies of the JAX package's ``tests/test_storage_fault.py`` (the
  power-loss crash harnesses over FileLogStorage, MetaJournal and the
  native multilog through the port's own native build, durable bit rot,
  quotas and ENOSPC), ``tests/test_nemesis.py`` (the nemesis runner and
  FaultInjectingTransport) and ``tests/test_gray_failure.py`` (health
  scoring, ChaosDir latency and stall injection, topology limps,
  evacuation, shedding, the PD's health view).  The gray-failure stores
  take an explicit disk budget, as every durable store of the port's
  tests does: a statvfs-derived one reads a nearly full shared
  filesystem as FULL, and the store turns SICK for ``disk_full``.
- A differential: one seeded script of writes, fsyncs, renames,
  truncates, removes and crash points runs under the JAX package's
  ChaosDir and then under the port's, once for every mode of
  CRASH_MODES; the surviving bytes of every file after every crash are
  equal, bit for bit.

Each package's ChaosDir patches ``builtins.open`` and ``os.*`` process
wide while installed, so no two are ever installed at once, and an
autouse fixture fails any test that leaves one installed.
"""

from __future__ import annotations

import asyncio
import builtins
import contextlib
import io
import os
import random
import struct
import threading
import time

import pytest

from tpuraft.storage import fault as ref_fault
from tpuraft_torch.entity import EMPTY_PEER, EntryType, LogEntry, LogId, PeerId
from tpuraft_torch.errors import RaftError
from tpuraft_torch.rpc.fault import FaultInjectingTransport
from tpuraft_torch.rpc.transport import RpcError, TransportBase
from tpuraft_torch.storage.fault import (
    CRASH_MODES,
    ChaosDir,
    NativeJournalTracker,
)
from tpuraft_torch.storage.log_storage import CorruptLogError, FileLogStorage
from tpuraft_torch.storage.meta_multilog import MetaJournal
from tpuraft_torch.storage.multilog import MultiLogStorage
from tpuraft_torch.util.health import (
    DEGRADED,
    HEALTHY,
    SICK,
    DiskLatencyProbe,
    HealthOptions,
    HealthTracker,
)
from tpuraft_torch.util.nemesis import NemesisAction, SkipFault, run_nemesis


# ===========================================================================
# Port copy of tests/test_storage_fault.py
# ===========================================================================


def _entry(index: int, gen: int, term: int = 1) -> LogEntry:
    return LogEntry(type=EntryType.DATA, id=LogId(index, term),
                    data=b"g%03d-i%06d" % (gen, index))


# ---------------------------------------------------------------------------
# FileLogStorage under ChaosDir
# ---------------------------------------------------------------------------


def _filelog_lifetime(root: str, rng: random.Random, gens: int) -> int:
    """One directory, ``gens`` crash generations; returns crash count."""
    first, entries, acked_last = 1, {}, 0

    def staged_last():
        return max(entries) if entries else first - 1

    with ChaosDir(root) as chaos:
        for gen in range(gens):
            st = FileLogStorage(os.path.join(root, "log"),
                                segment_max_bytes=200)
            st.init()  # must tolerate whatever the crash left
            rf, rl = st.first_log_index(), st.last_log_index()
            assert rf == first, f"gen {gen}: first {rf} != {first}"
            assert acked_last <= rl <= staged_last(), \
                f"gen {gen}: last {rl} not in [{acked_last}, {staged_last()}]"
            for i in range(rf, rl + 1):
                e = st.get_entry(i)
                assert e is not None and e.data == entries[i], \
                    f"gen {gen}: entry {i} mismatch"
            # recovered state is durable (init re-fsyncs + watermarks)
            for i in list(entries):
                if i > rl:
                    del entries[i]
            acked_last = rl

            for _ in range(rng.randrange(1, 5)):
                op = rng.random()
                if op < 0.70 or not entries:
                    n = rng.randrange(1, 6)
                    batch = [_entry(staged_last() + 1 + k, gen)
                             for k in range(n)]
                    st.append_entries(batch, sync=True)  # fsynced => acked
                    for e in batch:
                        entries[e.id.index] = e.data
                    acked_last = staged_last()
                elif op < 0.85 and acked_last >= first:
                    keep = rng.randrange(first - 1, staged_last() + 1)
                    st.truncate_suffix(keep)  # fsynced by contract
                    for i in list(entries):
                        if i > keep:
                            del entries[i]
                    acked_last = min(acked_last, keep)
                elif op < 0.95 and staged_last() > first:
                    cut = rng.randrange(first, staged_last() + 1)
                    st.truncate_prefix(cut)  # meta fsynced by contract
                    first = max(first, cut)
                    for i in list(entries):
                        if i < first:
                            del entries[i]
                    acked_last = max(acked_last, first - 1)
                else:
                    nxt = staged_last() + rng.randrange(1, 10)
                    st.reset(nxt)
                    first, entries, acked_last = nxt, {}, nxt - 1

            if rng.random() < 0.7:
                # the in-flight append the power interrupts: staged
                # bytes on disk, fsync never completed — on-disk
                # identical to a crash mid sync=True append
                n = rng.randrange(1, 5)
                batch = [_entry(staged_last() + 1 + k, gen, term=2)
                         for k in range(n)]
                st.append_entries(batch, sync=False)
                for e in batch:
                    entries[e.id.index] = e.data

            plan = chaos.capture_crash(rng)   # power dies here
            st.shutdown()                     # in-proc cleanup only...
            chaos.apply_crash(plan)           # ...discarded by the image
        return chaos.crash_count


def test_filelog_power_loss_recovery():
    import tempfile

    crashes = 0
    for seed in range(3):
        with tempfile.TemporaryDirectory() as tmp:
            crashes += _filelog_lifetime(
                os.path.join(tmp, f"flog{seed}"),
                random.Random(1000 + seed), gens=20)
    assert crashes >= 60


# ---------------------------------------------------------------------------
# MetaJournal under ChaosDir
# ---------------------------------------------------------------------------


def _meta_lifetime(root: str, rng: random.Random, gens: int) -> int:
    groups = [f"r{i}" for i in range(4)]
    history = {g: [(0, "")] for g in groups}   # staged (term, voted) per group
    acked = {g: 0 for g in groups}             # index into history[g]
    term = {g: 0 for g in groups}

    with ChaosDir(root) as chaos:
        for gen in range(gens):
            j = MetaJournal(root)
            j.COMPACT_MIN_BYTES = 512  # force compaction under chaos
            for g in groups:
                t, voted = j.get(g)
                v = "" if voted.is_empty() else str(voted)
                hist = history[g]
                assert (t, v) in hist, f"gen {gen}: {g} has unknown {t}/{v}"
                pos = hist.index((t, v))
                assert pos >= acked[g], \
                    f"gen {gen}: {g} regressed below acked " \
                    f"({t} < {hist[acked[g]][0]})"
                # recovered value is durable now (reopen fsync + wm)
                history[g] = [(t, v)]
                acked[g] = 0
                term[g] = max(term[g], t)

            for _ in range(rng.randrange(2, 8)):
                g = rng.choice(groups)
                term[g] += rng.randrange(1, 3)
                voted = PeerId.parse(f"10.0.0.{rng.randrange(1, 5)}:80") \
                    if rng.random() < 0.8 else EMPTY_PEER
                j.stage(g, term[g], voted)
                history[g].append(
                    (term[g], "" if voted.is_empty() else str(voted)))
                if rng.random() < 0.4:
                    j.sync()  # group-commit round: everything staged acks
                    for gg in groups:
                        acked[gg] = len(history[gg]) - 1

            plan = chaos.capture_crash(rng)
            j.close()
            chaos.apply_crash(plan)
        return chaos.crash_count


def test_meta_journal_power_loss_recovery():
    import tempfile

    crashes = 0
    for seed in range(4):
        with tempfile.TemporaryDirectory() as tmp:
            crashes += _meta_lifetime(
                os.path.join(tmp, f"meta{seed}"),
                random.Random(2000 + seed), gens=20)
    assert crashes >= 80


# ---------------------------------------------------------------------------
# native multilog under tail imaging
# ---------------------------------------------------------------------------


class _GroupModel:
    def __init__(self) -> None:
        self.first = 1
        self.acked_first = 1
        self.entries: dict[int, bytes] = {}
        self.acked_last = 0

    def staged_last(self) -> int:
        return max(self.entries) if self.entries else self.first - 1


def _native_lifetime(base: str, rng: random.Random, gens: int) -> int:
    names = [f"g{i}" for i in range(3)]
    model = {n: _GroupModel() for n in names}
    gids: dict[str, int] = {}
    live = os.path.join(base, "gen0")
    crashes = 0

    for gen in range(gens):
        stores = {n: MultiLogStorage(live, n) for n in names}
        for n in names:
            stores[n].init()  # shared engine; recovery scan runs once
        eng = stores[names[0]].engine
        eng.sync()  # registrations of any new names ack immediately
        for n in names:
            if n in gids:
                assert stores[n]._gid == gids[n], \
                    f"gen {gen}: acked group {n} changed gid " \
                    f"{gids[n]} -> {stores[n]._gid} (orphan/shadow)"
            else:
                gids[n] = stores[n]._gid

        tracker = NativeJournalTracker(live)
        tracker.note_sync()  # the recovered image IS the durable state

        for n in names:
            m, s = model[n], stores[n]
            rf, rl = s.first_log_index(), s.last_log_index()
            assert m.acked_first <= rf, \
                f"gen {gen}: {n} first {rf} below acked {m.acked_first}"
            assert rf <= max(m.first, m.acked_first), \
                f"gen {gen}: {n} first {rf} beyond staged {m.first}"
            assert m.acked_last <= rl, \
                f"gen {gen}: {n} last {rl} below acked {m.acked_last}"
            assert rl <= m.staged_last() or not m.entries, \
                f"gen {gen}: {n} last {rl} beyond staged {m.staged_last()}"
            for i in range(rf, rl + 1):
                e = s.get_entry(i)
                assert e is not None and e.data == m.entries[i], \
                    f"gen {gen}: {n} entry {i} mismatch"
            m.first = rf
            m.acked_first = rf
            for i in list(m.entries):
                if i < rf or i > rl:
                    del m.entries[i]
            m.acked_last = rl

        synced = False
        for _ in range(rng.randrange(2, 6)):
            n = rng.choice(names)
            m, s = model[n], stores[n]
            op = rng.random()
            if op < 0.60 or not m.entries:
                cnt = rng.randrange(1, 5)
                batch = [_entry(m.staged_last() + 1 + k, gen)
                         for k in range(cnt)]
                s.append_entries(batch, sync=False)  # staged, not acked
                for e in batch:
                    m.entries[e.id.index] = e.data
            elif op < 0.75:
                eng.sync()
                tracker.note_sync()
                for mm in model.values():
                    mm.acked_last = mm.staged_last()
                    mm.acked_first = mm.first
                synced = True
            elif op < 0.85 and m.acked_last >= m.first:
                keep = rng.randrange(m.first - 1, m.staged_last() + 1)
                s.truncate_suffix(keep)  # fsyncs everything staged
                tracker.note_sync()
                for i in list(m.entries):
                    if i > keep:
                        del m.entries[i]
                for mm in model.values():
                    mm.acked_last = mm.staged_last()
                    mm.acked_first = mm.first
            elif op < 0.95 and m.staged_last() > m.first:
                cut = rng.randrange(m.first, m.staged_last() + 1)
                s.truncate_prefix(cut)  # lazily durable control record
                m.first = max(m.first, cut)
                # keep entries down to acked_first: a crash can lose the
                # staged trunc record and legitimately revive them
                for i in list(m.entries):
                    if i < m.acked_first:
                        del m.entries[i]
            else:
                nxt = m.staged_last() + rng.randrange(1, 8)
                s.reset(nxt)  # fsyncs everything staged
                tracker.note_sync()
                m.first = m.acked_first = nxt
                m.entries = {}
                m.acked_last = nxt - 1
                for mm in model.values():
                    mm.acked_last = mm.staged_last()
        del synced

        nxt_dir = os.path.join(base, f"gen{gen + 1}")
        tracker.crash_image(nxt_dir, rng)  # power dies here
        for s in stores.values():
            s.shutdown()  # releases/closes the live engine afterwards
        live = nxt_dir
        crashes += 1
    return crashes


def test_native_multilog_power_loss_recovery(tmp_path):
    crashes = 0
    for seed in range(4):
        crashes += _native_lifetime(
            str(tmp_path / f"nat{seed}"), random.Random(3000 + seed),
            gens=30)
    assert crashes >= 120


# ---------------------------------------------------------------------------
# explicit contract tests
# ---------------------------------------------------------------------------


def test_torn_tail_truncated_at_last_crc_valid_record(tmp_path):
    """A torn unsynced tail recovers by CRC truncation — acked prefix
    intact, no exception, no garbage read."""
    root = str(tmp_path / "torn")
    rng = random.Random(7)
    with ChaosDir(root, modes=(("torn-write", 1.0),)) as chaos:
        st = FileLogStorage(os.path.join(root, "log"))
        st.init()
        st.append_entries([_entry(i, 0) for i in range(1, 6)], sync=True)
        st.append_entries([_entry(i, 0) for i in range(6, 9)], sync=False)
        plan = chaos.capture_crash(rng)
        st.shutdown()
        chaos.apply_crash(plan)
        st2 = FileLogStorage(os.path.join(root, "log"))
        st2.init()
        assert 5 <= st2.last_log_index() <= 8
        for i in range(1, st2.last_log_index() + 1):
            assert st2.get_entry(i).data == _entry(i, 0).data
        st2.shutdown()


def test_bit_flip_in_unsynced_tail_is_truncated(tmp_path):
    root = str(tmp_path / "flip")
    rng = random.Random(11)
    with ChaosDir(root, modes=(("bit-flip", 1.0),)) as chaos:
        st = FileLogStorage(os.path.join(root, "log"))
        st.init()
        st.append_entries([_entry(i, 0) for i in range(1, 4)], sync=True)
        st.append_entries([_entry(i, 0) for i in range(4, 9)], sync=False)
        plan = chaos.capture_crash(rng)
        st.shutdown()
        chaos.apply_crash(plan)
        st2 = FileLogStorage(os.path.join(root, "log"))
        st2.init()  # must not raise: flip is in the unsynced region
        assert st2.last_log_index() >= 3
        for i in range(1, st2.last_log_index() + 1):
            assert st2.get_entry(i).data == _entry(i, 0).data
        st2.shutdown()


def test_durable_bit_rot_fails_loudly_filelog(tmp_path):
    """Corruption BELOW the durability watermark is not a torn tail:
    startup must refuse to truncate acked entries."""
    d = str(tmp_path / "rot")
    st = FileLogStorage(d)
    st.init()
    st.append_entries([_entry(i, 0) for i in range(1, 6)], sync=True)
    st.shutdown()  # advances the watermark over everything
    seg = next(n for n in os.listdir(d) if n.startswith("seg_"))
    p = os.path.join(d, seg)
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0x40
    open(p, "wb").write(bytes(blob))
    st2 = FileLogStorage(d)
    try:
        st2.init()
        raise AssertionError("durable-region rot went undetected")
    except CorruptLogError:
        pass


def test_multilog_get_crc_guards_read_path(tmp_path):
    """Bit rot in a live, indexed record: tlm_get must fail loudly
    (CorruptLogError), not hand garbage (or a silent hole) upward."""
    d = str(tmp_path / "mrot")
    s = MultiLogStorage(d, "g")
    s.init()
    s.append_entries([_entry(i, 0) for i in range(1, 4)], sync=True)
    jnl = next(n for n in sorted(os.listdir(d))
               if n.startswith("journal_"))
    p = os.path.join(d, jnl)
    blob = bytearray(open(p, "rb").read())
    blob[30] ^= 0x10  # inside the first record's payload
    open(p, "wb").write(bytes(blob))
    try:
        s.get_entry(1)
        raise AssertionError("rotted record served without complaint")
    except CorruptLogError:
        pass
    finally:
        s.shutdown()


def test_multilog_len_rot_on_live_record_fails_loudly(tmp_path):
    """A len field rotted HIGH on a live, indexed record must surface
    as corruption (CorruptLogError), not read as a missing-entry hole
    via a short payload read."""
    d = str(tmp_path / "lenrot")
    s = MultiLogStorage(d, "g")
    s.init()
    s.append_entries([_entry(i, 0) for i in range(1, 3)], sync=True)
    jnl = next(n for n in sorted(os.listdir(d))
               if n.startswith("journal_"))
    p = os.path.join(d, jnl)
    blob = bytearray(open(p, "rb").read())
    blob[3] |= 0x40  # inflate the first record's len field past the file
    open(p, "wb").write(bytes(blob))
    try:
        s.get_entry(1)
        raise AssertionError("len-rotted record read as a hole")
    except CorruptLogError:
        pass
    finally:
        s.shutdown()


def test_multilog_unreadable_registry_fails_open_not_truncates(tmp_path):
    """A registry that cannot be READ must fail the engine open loudly
    (retryable) — scanning journals against a partial registry would
    read every acked record as orphan garbage and truncate them."""
    d = str(tmp_path / "regdead")
    s = MultiLogStorage(d, "g")
    s.init()
    s.append_entries([_entry(1, 0)], sync=True)
    s.shutdown()
    jsize = os.path.getsize(os.path.join(d, next(
        n for n in sorted(os.listdir(d)) if n.startswith("journal_"))))
    reg = os.path.join(d, "groups")
    os.remove(reg)
    os.mkdir(reg)  # open(O_RDWR) now fails EISDIR: unreadable registry
    s2 = MultiLogStorage(d, "g")
    try:
        s2.init()
        raise AssertionError("open succeeded against unreadable registry")
    except IOError:
        pass
    # the acked journal bytes must be untouched by the failed open
    jnl = next(n for n in sorted(os.listdir(d))
               if n.startswith("journal_"))
    assert os.path.getsize(os.path.join(d, jnl)) == jsize
    os.rmdir(reg)


def test_multilog_registry_gid_alias_is_truncated(tmp_path):
    """A flipped gid in the registry's unsynced tail must not alias an
    acked gid (shadowing another group's log): the sequential-gid scan
    truncates the tail at the deviation."""
    d = str(tmp_path / "reg")
    sa, sb = MultiLogStorage(d, "a"), MultiLogStorage(d, "b")
    sa.init(), sb.init()
    sa.engine.sync()  # both registrations acked
    gid_a, gid_b = sa._gid, sb._gid
    sa.shutdown(), sb.shutdown()
    # forge a tail record claiming gid_a for a different name (what a
    # partial-page writeback bit flip can leave behind)
    with open(os.path.join(d, "groups"), "ab") as f:
        f.write(struct.pack("<II", gid_a, 1) + b"z")
    sa2, sz = MultiLogStorage(d, "a"), MultiLogStorage(d, "z")
    sa2.init(), sz.init()
    try:
        assert sa2._gid == gid_a
        assert sz._gid not in (gid_a, gid_b), "alias adopted: shadowing"
    finally:
        sa2.shutdown(), sz.shutdown()


def test_multilog_registry_tolerates_legacy_gid_gaps(tmp_path):
    """Registries written before register_group rolled next_gid back on
    a failed append can hold gid GAPS in their durable region; the
    alias guard must accept those (strictly increasing), not truncate
    acked registrations on upgrade."""
    d = str(tmp_path / "gap")
    sa, sb = MultiLogStorage(d, "a"), MultiLogStorage(d, "b")
    sa.init(), sb.init()
    gid_a, gid_b = sa._gid, sb._gid
    sa.engine.sync()
    sa.shutdown(), sb.shutdown()
    # legacy gap: a registration that consumed gid_b+1 without a record,
    # then a later group registered at gid_b+2
    with open(os.path.join(d, "groups"), "ab") as f:
        f.write(struct.pack("<II", gid_b + 2, 1) + b"c")
    sa2 = MultiLogStorage(d, "a")
    sb2 = MultiLogStorage(d, "b")
    sc2 = MultiLogStorage(d, "c")
    sd2 = MultiLogStorage(d, "dnew")
    for s in (sa2, sb2, sc2, sd2):
        s.init()
    try:
        assert sa2._gid == gid_a and sb2._gid == gid_b
        assert sc2._gid == gid_b + 2, "gap-following record truncated"
        assert sd2._gid == gid_b + 3  # next_gid resumed past the gap
    finally:
        for s in (sa2, sb2, sc2, sd2):
            s.shutdown()


def test_multilog_orphan_journal_records_are_torn(tmp_path):
    """Journal records whose registration never became durable are an
    unsynced tail by construction: recovery truncates them instead of
    adopting records for an unregistered gid."""
    import shutil

    d = str(tmp_path / "orph")
    sa = MultiLogStorage(d, "a")
    sa.init()
    sa.append_entries([_entry(1, 0)], sync=True)   # a: acked
    reg_durable = os.path.getsize(os.path.join(d, "groups"))
    sb = MultiLogStorage(d, "b")
    sb.init()                                       # b: registration staged
    sb.append_entries([_entry(1, 0), _entry(2, 0)], sync=False)
    # power loss: journal pages survived writeback, registry tail didn't
    img = str(tmp_path / "orph_img")
    shutil.copytree(d, img)
    with open(os.path.join(img, "groups"), "r+b") as f:
        f.truncate(reg_durable)
    sa.shutdown(), sb.shutdown()
    ra, rb = MultiLogStorage(img, "a"), MultiLogStorage(img, "b")
    ra.init(), rb.init()
    try:
        assert ra.last_log_index() == 1
        assert ra.get_entry(1).data == _entry(1, 0).data
        # b's staged-only records were truncated with its registration;
        # the re-registered b starts empty (no adopted orphan records)
        assert rb.last_log_index() == 0
        assert rb.get_entry(1) is None
    finally:
        ra.shutdown(), rb.shutdown()


async def test_reboot_after_compaction_keeps_acked_suffix(tmp_path):
    """Regression for the amnesiac-reboot bug the power-loss soak found:
    after snapshot compaction prunes the entry AT the snapshot index
    (margin 0, first == S+1), the next boot's set_snapshot saw term 0
    there, called it divergence, and RESET the log — silently dropping
    the whole acked suffix.  Two stores rebooting in one fault window
    then break quorum intersection and un-commit acked writes."""
    from tpuraft_torch.conf import Configuration, ConfigurationEntry
    from tpuraft_torch.storage.log_manager import LogManager

    d = str(tmp_path / "lm")
    conf = ConfigurationEntry(
        LogId(0, 0), Configuration.parse("1.1.1.1:1,1.1.1.2:1,1.1.1.3:1"))

    st = FileLogStorage(d)
    lm = LogManager(st)
    await lm.init()
    await lm.append_entries_follower(
        0, 0, [_entry(i, 0, term=3) for i in range(1, 11)])
    # snapshot at 5 (margin 0): prunes entries <= 5, first becomes 6
    await lm.set_snapshot(LogId(5, 3), conf)
    assert lm.first_log_index() == 6 and lm.last_log_index() == 10
    await lm.shutdown()

    # reboot: snapshot load replays set_snapshot on the compacted log
    st2 = FileLogStorage(d)
    lm2 = LogManager(st2)
    await lm2.init()
    await lm2.set_snapshot(LogId(5, 3), conf)
    assert lm2.last_log_index() == 10, \
        "acked suffix dropped on reboot after compaction"
    for i in range(6, 11):
        assert lm2.get_term(i) == 3
    assert lm2.check_consistency().is_ok()
    await lm2.shutdown()

    # the true-divergence case still resets: entry AT the snapshot index
    # present with a DIFFERENT term (install-snapshot over a stale log)
    st3 = FileLogStorage(str(tmp_path / "lm3"))
    lm3 = LogManager(st3)
    await lm3.init()
    await lm3.append_entries_follower(
        0, 0, [_entry(i, 0, term=2) for i in range(1, 11)])
    await lm3.set_snapshot(LogId(7, 5), conf)   # term 5 != stored term 2
    assert lm3.last_log_index() == 7            # stale tail dropped
    assert lm3.first_log_index() == 8
    await lm3.shutdown()


def test_chaosdir_lost_fsync_and_survival(tmp_path):
    """Sanity of the model itself: unsynced bytes vanish under
    lost-fsync; fsynced bytes always survive."""
    root = str(tmp_path / "model")
    rng = random.Random(5)
    with ChaosDir(root, modes=(("lost-fsync", 1.0),)) as chaos:
        p = os.path.join(root, "f.bin")
        f = open(p, "wb")
        f.write(b"durable")
        f.flush()
        os.fsync(f.fileno())
        f.write(b"+volatile")
        f.flush()
        f.close()
        assert open(p, "rb").read() == b"durable+volatile"
        chaos.crash(rng)
        assert open(p, "rb").read() == b"durable"


# ---------------------------------------------------------------------------
# disk-pressure fault plane: quota / ENOSPC (ISSUE 17)
# ---------------------------------------------------------------------------


def test_chaosdir_quota_partial_write_then_enospc(tmp_path):
    """The capacity fault plane itself: a write crossing the budget
    commits the fitting prefix (short write) then fails ENOSPC; deletes
    refund the budget."""
    import errno as _errno

    root = str(tmp_path / "quota")
    with ChaosDir(root) as chaos:
        p = os.path.join(root, "f.bin")
        with open(p, "wb") as f:
            f.write(b"x" * 60)
        chaos.set_quota(100)
        try:
            with open(p, "ab") as f:
                f.write(b"y" * 80)
            raise AssertionError("over-budget write admitted whole")
        except OSError as e:
            assert e.errno == _errno.ENOSPC
        # the fitting 40-byte prefix landed before the error
        assert os.path.getsize(p) == 100
        assert chaos.enospc_counts.get("write", 0) == 1
        limit, used = chaos.quota_state()
        assert limit == 100 and used >= 100
        # refund on remove: the budget frees and writes admit again
        os.remove(p)
        with open(os.path.join(root, "g.bin"), "wb") as f:
            f.write(b"z" * 50)
        assert os.path.getsize(os.path.join(root, "g.bin")) == 50


def test_chaosdir_quota_shrink_and_burst(tmp_path):
    """quota-shrink-over-time tightens the wall; seeded bursts fail
    writes wholesale regardless of budget and heal at rate 0."""
    root = str(tmp_path / "sq")
    with ChaosDir(root) as chaos:
        chaos.set_quota(1000)
        assert chaos.shrink_quota(400) == 600
        p = os.path.join(root, "f.bin")
        with open(p, "wb") as f:
            f.write(b"a" * 500)
        try:
            with open(p, "ab") as f:
                f.write(b"b" * 200)
            raise AssertionError("shrunk quota not enforced")
        except OSError:
            pass
        chaos.set_enospc_burst(1.0, seed=9)
        try:
            with open(os.path.join(root, "h.bin"), "wb") as f:
                f.write(b"c")
            raise AssertionError("burst rate 1.0 admitted a write")
        except OSError:
            pass
        assert chaos.enospc_counts.get("burst", 0) >= 1
        chaos.set_enospc_burst(0.0)
        chaos.clear_quota()
        with open(os.path.join(root, "h.bin"), "wb") as f:
            f.write(b"c" * 300)  # healed


def test_chaosdir_quota_rename_enospc(tmp_path):
    """Creating a fresh directory entry on a full tree fails ENOSPC
    (the path snapshot commit / meta compaction renames exercise)."""
    root = str(tmp_path / "rq")
    with ChaosDir(root) as chaos:
        src = os.path.join(root, "src.bin")
        with open(src, "wb") as f:
            f.write(b"x" * 100)
        chaos.set_quota(100)  # exactly full
        try:
            os.rename(src, os.path.join(root, "dst.bin"))
            raise AssertionError("rename to fresh entry on full tree")
        except OSError:
            pass
        assert chaos.enospc_counts.get("rename", 0) == 1
        # replacing an EXISTING entry stays allowed (no new inode)
        dst = os.path.join(root, "src.bin")  # self-replace: dst exists
        os.replace(src, dst)


def test_filelog_enospc_append_fails_clean_and_retries(tmp_path):
    """An append that dies ENOSPC leaves the storage view unchanged
    (no phantom index advance) and the SAME batch retries cleanly after
    space frees — partial garbage at the tail is overwritten, never
    served."""
    root = str(tmp_path / "flq")
    with ChaosDir(root) as chaos:
        st = FileLogStorage(os.path.join(root, "log"))
        st.init()
        st.append_entries([_entry(i, 0) for i in range(1, 6)], sync=True)
        base = st.last_log_index()
        chaos.set_quota(chaos.quota_state()[1] + 20)  # ~half an entry
        batch = [_entry(base + 1, 1), _entry(base + 2, 1)]
        try:
            st.append_entries(batch, sync=True)
            raise AssertionError("ENOSPC append reported success")
        except OSError:
            pass
        assert st.last_log_index() == base
        for i in range(1, base + 1):
            assert st.get_entry(i).data == _entry(i, 0).data
        chaos.clear_quota()
        st.append_entries(batch, sync=True)  # same batch, now fits
        assert st.last_log_index() == base + 2
        for e in batch:
            assert st.get_entry(e.id.index).data == e.data
        st.shutdown()
        # and the healed tail survives a reopen (no torn garbage kept)
        st2 = FileLogStorage(os.path.join(root, "log"))
        st2.init()
        assert st2.last_log_index() == base + 2
        st2.shutdown()


def test_filelog_shutdown_and_reopen_on_full_disk(tmp_path):
    """A store must SHUT DOWN and BOOT on a genuinely full disk: the
    non-sync watermark saves (init scan, clean shutdown) only advance a
    stale-LOW-safe optimization, so ENOSPC on ``synced.tmp`` must not
    propagate.  Caught by the 300s --disk-pressure --power-loss soak:
    the power-loss kill's graceful stop died mid-shutdown on the
    watermark write and the store never came back."""
    root = str(tmp_path / "flfull")
    with ChaosDir(root) as chaos:
        st = FileLogStorage(os.path.join(root, "log"))
        st.init()
        st.append_entries([_entry(i, 0) for i in range(1, 8)], sync=True)
        chaos.set_quota(chaos.quota_state()[1])  # zero headroom
        st.shutdown()                            # must not raise
        # boot on the still-full disk: init's watermark refresh is also
        # best-effort; the log itself is read back intact
        st2 = FileLogStorage(os.path.join(root, "log"))
        st2.init()
        assert st2.last_log_index() == 7
        for i in range(1, 8):
            assert st2.get_entry(i).data == _entry(i, 0).data
        st2.shutdown()
    # and with the quota lifted the watermark heals on the next cycle
    st3 = FileLogStorage(os.path.join(root, "log"))
    st3.init()
    assert st3.last_log_index() == 7
    st3.shutdown()


def test_meta_journal_close_on_full_disk(tmp_path):
    """MetaJournal.close() on a full disk: the fsync lands (durability
    holds), the watermark save is best-effort, close does not raise,
    and the values replay on reopen."""
    root = str(tmp_path / "mjfull")
    with ChaosDir(root) as chaos:
        j = MetaJournal(root)
        j.stage("g1", 7, PeerId.parse("127.0.0.1:1"))
        j.sync()
        chaos.set_quota(chaos.quota_state()[1])  # zero headroom
        try:
            # the staged append itself fails ENOSPC (the vote-save
            # handler surfaces that as a refused grant) — the landed
            # prefix is torn-tail garbage the replay discards
            j.stage("g2", 9, PeerId.parse("127.0.0.1:2"))
        except OSError:
            pass
        j.close()     # must not raise (watermark tmp hits ENOSPC)
    j2 = MetaJournal(root)
    term, voted = j2.get("g1")
    assert term == 7 and str(voted) == "127.0.0.1:1"
    j2.close()


def test_native_quota_mirror_enospc(tmp_path):
    """The native multilog's quota mirror: attach_quota installs the
    engine fault gate; appends past the journal budget fail ENOSPC,
    acked entries stay readable, clear_quota heals."""
    d = str(tmp_path / "natq")
    s = MultiLogStorage(d, "g")
    s.init()
    s.append_entries([_entry(i, 0) for i in range(1, 4)], sync=True)
    tracker = NativeJournalTracker(d)
    tracker.attach_quota(s.engine, limit_bytes=tracker._dir_usage() + 16)
    try:
        s.append_entries([_entry(4, 0)], sync=True)
        raise AssertionError("native append past journal budget")
    except OSError:
        pass
    assert s.last_log_index() == 3
    for i in range(1, 4):
        assert s.get_entry(i).data == _entry(i, 0).data
    tracker.clear_quota()
    s.append_entries([_entry(4, 0)], sync=True)
    assert s.get_entry(4).data == _entry(4, 0).data
    # burst mirror: whole-op seeded failures, rate 0 heals
    tracker.attach_quota(s.engine, burst_rate=1.0, seed=3)
    try:
        s.append_entries([_entry(5, 0)], sync=True)
        raise AssertionError("burst rate 1.0 admitted a native append")
    except OSError:
        pass
    tracker.attach_quota(s.engine, burst_rate=0.0)
    s.append_entries([_entry(5, 0)], sync=True)
    s.shutdown()


def test_snapshot_save_enospc_keeps_old_snapshot(tmp_path):
    """ENOSPC mid snapshot save: the previous snapshot stays loadable,
    the aborted temp is swept, and the save succeeds once space frees."""
    from tpuraft_torch.rpc.messages import SnapshotMeta
    from tpuraft_torch.storage.snapshot import LocalSnapshotStorage

    root = str(tmp_path / "snapq")
    with ChaosDir(root) as chaos:
        stor = LocalSnapshotStorage(os.path.join(root, "snap"))
        stor.init()
        w = stor.create()
        w.write_file("kv", b"gen1" * 50)
        stor.commit(w, SnapshotMeta(last_included_index=10,
                                    last_included_term=1))
        assert stor.open().load_meta().last_included_index == 10

        chaos.set_quota(chaos.quota_state()[1] + 30)
        w2 = stor.create()
        try:
            w2.write_file("kv", b"gen2" * 200)
            raise AssertionError("over-budget snapshot write admitted")
        except OSError:
            pass
        # old snapshot intact, correct bytes
        r = stor.open()
        assert r.load_meta().last_included_index == 10
        assert r.read_file("kv") == b"gen1" * 50

        chaos.clear_quota()
        stor.init()  # sweeps the aborted temp dir
        w3 = stor.create()
        w3.write_file("kv", b"gen2" * 200)
        stor.commit(w3, SnapshotMeta(last_included_index=20,
                                     last_included_term=1))
        assert stor.open().load_meta().last_included_index == 20


def test_snapshot_storage_init_sweeps_orphans(tmp_path):
    """init() removes crash-orphaned snapshot_<N> dirs: stale older
    dirs the post-commit prune never got to, and unreadable newer dirs
    whose manifest never became durable."""
    from tpuraft_torch.rpc.messages import SnapshotMeta
    from tpuraft_torch.storage.snapshot import LocalSnapshotStorage

    root = str(tmp_path / "sweep")
    stor = LocalSnapshotStorage(root)
    stor.init()
    w = stor.create()
    w.write_file("kv", b"live")
    stor.commit(w, SnapshotMeta(last_included_index=10,
                                last_included_term=1))
    # stale older dir (prune-after-replace never ran) + manifestless
    # newer dir (replace landed, manifest lost to the crash)
    os.makedirs(os.path.join(root, "snapshot_5"))
    with open(os.path.join(root, "snapshot_5", "kv"), "wb") as f:
        f.write(b"stale")
    os.makedirs(os.path.join(root, "snapshot_20"))

    stor2 = LocalSnapshotStorage(root)
    stor2.init()
    names = sorted(n for n in os.listdir(root) if n.startswith("snapshot_"))
    assert names == ["snapshot_10"], names
    assert stor2.open().read_file("kv") == b"live"

    # nothing loadable at all -> keep everything for forensics
    root2 = str(tmp_path / "sweep2")
    os.makedirs(os.path.join(root2, "snapshot_7"))
    s3 = LocalSnapshotStorage(root2)
    s3.init()
    assert os.path.isdir(os.path.join(root2, "snapshot_7"))


def test_meta_journal_enospc_mid_compaction(tmp_path):
    """ENOSPC during the journal's compaction rewrite must not fail the
    sync round or hurt the journal: values stay readable, the partial
    tmp is dropped, and compaction succeeds after space frees."""
    root = str(tmp_path / "mjq")
    with ChaosDir(root) as chaos:
        j = MetaJournal(root)
        j.COMPACT_MIN_BYTES = 512
        peer = PeerId.parse("10.0.0.1:80")
        # pile up garbage records well past the compaction threshold
        for t in range(1, 120):
            j.stage("g0", t, peer)
            j.stage("g1", t, peer)
        chaos.set_quota(chaos.quota_state()[1])  # zero headroom
        j.sync()   # fsync ok (bytes already staged); compaction dies
        assert j.get("g0") == (119, peer)
        assert j.get("g1") == (119, peer)
        assert not os.path.exists(os.path.join(root, "meta.jnl.tmp"))
        # journal still ACCEPTS overwrites of staged bytes... heal and
        # prove full service: stage + sync + eventual compaction
        chaos.clear_quota()
        j.stage("g0", 200, peer)
        j.sync()
        assert j.get("g0") == (200, peer)
        j.close()
        j2 = MetaJournal(root)
        assert j2.get("g0") == (200, peer)
        assert j2.get("g1") == (119, peer)
        j2.close()


def test_disk_budget_thresholds_hysteresis_resume():
    from tpuraft_torch.util.health import (
        PRESSURE_FULL,
        PRESSURE_NEAR_FULL,
        PRESSURE_OK,
        DiskBudget,
        DiskBudgetOptions,
    )

    b = DiskBudget(DiskBudgetOptions(budget_bytes=1000, worsen_after=1,
                                     recover_after=2))
    b.note_append(500)
    assert b.evaluate() == PRESSURE_OK
    b.note_append(350)            # 850/1000 >= 0.80
    assert b.evaluate() == PRESSURE_NEAR_FULL
    b.note_append(100)            # 950/1000 >= 0.92
    assert b.evaluate() == PRESSURE_FULL
    # recovery is hysteretic: reclaim must PROVE space recover_after
    # consecutive rounds before pressure relaxes (then: one resume)
    b.note_reclaimed(500)         # 450/1000
    assert b.evaluate() == PRESSURE_FULL
    assert b.evaluate() == PRESSURE_OK
    c = b.counters()
    assert c["disk_pressure_resumes"] == 1
    assert c["disk_reclaimed_bytes"] == 500
    # reconcile re-bases the estimate (rmtree deletes the hot path
    # never saw), and set_budget adopts an operator resize
    b.reconcile(900)
    assert b.used_bytes() == 900
    b.set_budget(2000)
    assert b.evaluate() == PRESSURE_OK   # 900/2000: headroom again
    assert b.capacity_bytes() == 2000


def test_disk_budget_enospc_latch_pins_full():
    """An observed ENOSPC pins raw FULL for enospc_latch_rounds no
    matter what the byte estimate says — the errno outranks it."""
    from tpuraft_torch.util.health import (
        PRESSURE_FULL,
        PRESSURE_OK,
        DiskBudget,
        DiskBudgetOptions,
    )

    b = DiskBudget(DiskBudgetOptions(budget_bytes=1000, worsen_after=1,
                                     recover_after=1, enospc_latch_rounds=2))
    b.note_append(10)             # estimate says: nearly empty
    assert b.evaluate() == PRESSURE_OK
    b.note_enospc()
    assert b.evaluate() == PRESSURE_FULL
    assert b.evaluate() == PRESSURE_FULL     # latch round 2
    assert b.evaluate() == PRESSURE_OK       # latch expired, estimate rules
    assert b.counters()["disk_enospc_events"] == 1
    assert b.counters()["disk_pressure_resumes"] == 1


async def test_log_manager_enospc_flush_rolls_back_frontier(tmp_path):
    """Regression for the non-contiguous-append wedge the disk-pressure
    soak found: a flush that dies ENOSPC must fail its waiters AND roll
    the in-memory frontier back to what storage holds — otherwise the
    next append passes the in-memory contiguity check, trips storage's
    gap check, and the node is wedged in ERROR forever."""
    from tpuraft_torch.errors import RaftException
    from tpuraft_torch.storage.log_manager import LogManager

    root = str(tmp_path / "lmq")
    with ChaosDir(root) as chaos:
        st = FileLogStorage(os.path.join(root, "log"))
        lm = LogManager(st)
        await lm.init()
        await lm.append_entries_follower(
            0, 0, [_entry(i, 0, term=2) for i in range(1, 6)])
        assert lm.last_log_index() == 5
        chaos.set_quota(chaos.quota_state()[1] + 10)
        try:
            await lm.append_entries_follower(
                5, 2, [_entry(i, 0, term=2) for i in range(6, 9)])
            raise AssertionError("ENOSPC flush reported success")
        except RaftException:
            pass
        # frontier converged back onto storage: no phantom suffix
        assert lm.last_log_index() == st.last_log_index()
        # heal -> the SAME entries re-append cleanly (leader retry)
        chaos.clear_quota()
        base = lm.last_log_index()
        ok = await lm.append_entries_follower(
            base, 2, [_entry(i, 0, term=2) for i in range(base + 1, 9)])
        assert ok and lm.last_log_index() == 8
        assert lm.check_consistency().is_ok()
        for i in range(1, 9):
            assert lm.get_term(i) == 2
        await lm.shutdown()


def _filelog_quota_crash_lifetime(root: str, rng: random.Random,
                                  gens: int) -> int:
    """Seeded-crash matrix with quota faults layered in: every
    generation runs under a shifting byte budget (including seeded
    ENOSPC bursts), appends tolerate ENOSPC without model drift, and a
    power-loss crash ends the generation.  Invariants are the usual
    acked floor / staged ceiling / byte-match set."""
    first, entries, acked_last = 1, {}, 0

    def staged_last():
        return max(entries) if entries else first - 1

    with ChaosDir(root) as chaos:
        for gen in range(gens):
            chaos.clear_quota()
            chaos.set_enospc_burst(0.0)
            st = FileLogStorage(os.path.join(root, "log"),
                                segment_max_bytes=200)
            st.init()
            rf, rl = st.first_log_index(), st.last_log_index()
            assert rf == first, f"gen {gen}: first {rf} != {first}"
            assert acked_last <= rl <= staged_last(), \
                f"gen {gen}: last {rl} not in [{acked_last}, {staged_last()}]"
            for i in range(rf, rl + 1):
                e = st.get_entry(i)
                assert e is not None and e.data == entries[i], \
                    f"gen {gen}: entry {i} mismatch"
            for i in list(entries):
                if i > rl:
                    del entries[i]
            acked_last = rl

            # quota fault for this generation: tight budget, seeded
            # burst, or free-running (the original matrix)
            mode = rng.random()
            if mode < 0.4:
                chaos.set_quota(chaos.quota_state()[1]
                                + rng.randrange(0, 400))
            elif mode < 0.6:
                chaos.set_enospc_burst(0.3, seed=rng.randrange(1 << 30))

            for _ in range(rng.randrange(1, 5)):
                n = rng.randrange(1, 6)
                batch = [_entry(staged_last() + 1 + k, gen)
                         for k in range(n)]
                try:
                    st.append_entries(batch, sync=True)
                except OSError:
                    # ENOSPC: storage contract says the view advanced
                    # only to what landed whole — adopt ITS frontier
                    # (landed entries are staged, NOT acked: the batch
                    # fsync never ran)
                    landed = st.last_log_index()
                    for e in batch:
                        if e.id.index <= landed:
                            entries[e.id.index] = e.data
                    if rng.random() < 0.5:
                        chaos.clear_quota()
                        chaos.set_enospc_burst(0.0)
                    continue
                for e in batch:
                    entries[e.id.index] = e.data
                acked_last = staged_last()

            if rng.random() < 0.5:
                batch = [_entry(staged_last() + 1 + k, gen, term=2)
                         for k in range(rng.randrange(1, 4))]
                try:
                    st.append_entries(batch, sync=False)
                    for e in batch:
                        entries[e.id.index] = e.data
                except OSError:
                    landed = st.last_log_index()
                    for e in batch:
                        if e.id.index <= landed:
                            entries[e.id.index] = e.data

            plan = chaos.capture_crash(rng)   # power dies (quota live)
            # the faults die with the power: shutdown's own writes are
            # discarded by the image anyway, but they must not blow up
            # the harness on the still-armed quota
            chaos.clear_quota()
            chaos.set_enospc_burst(0.0)
            st.shutdown()
            chaos.apply_crash(plan)
        return chaos.crash_count


def test_filelog_quota_crash_matrix():
    import tempfile

    crashes = 0
    for seed in range(3):
        with tempfile.TemporaryDirectory() as tmp:
            crashes += _filelog_quota_crash_lifetime(
                os.path.join(tmp, f"qlog{seed}"),
                random.Random(4000 + seed), gens=20)
    assert crashes >= 60


# ===========================================================================
# Port copy of tests/test_nemesis.py
# ===========================================================================


def _rng(seed=0):
    return random.Random(seed)


async def test_nemesis_applies_dwells_heals():
    events = []

    async def apply():
        events.append("apply")

    async def heal():
        events.append("heal")

    a = NemesisAction("a", apply, heal, dwell_s=0.0)
    timeline = await run_nemesis([a], duration_s=0.2, rng=_rng(),
                                 pause_s=0.05)
    assert a.applied >= 1 and len(timeline) == a.applied
    # strict alternation: every applied fault healed before the next
    assert events == ["apply", "heal"] * a.applied


async def test_nemesis_heals_after_apply_failure():
    """apply() may PARTIALLY take effect before raising: the nemesis
    must heal best-effort so a botched fault can't linger, and the
    drive keeps going."""
    state = {"applied": 0, "healed": 0}

    async def bad_apply():
        state["applied"] += 1
        raise RuntimeError("fault half-applied")

    async def heal():
        state["healed"] += 1

    a = NemesisAction("bad", bad_apply, heal, dwell_s=0.0)
    timeline = await run_nemesis([a], duration_s=0.15, rng=_rng(),
                                 pause_s=0.03)
    assert state["applied"] >= 1
    assert state["healed"] == state["applied"]   # healed on EVERY failure
    assert timeline == [] and a.applied == 0     # never recorded as applied


async def test_nemesis_check_runs_on_apply_failure_path_too():
    """A recovery failure that a best-effort heal swallowed must still
    abort the drive via the check hook — not hide in a log line."""
    async def bad_apply():
        raise RuntimeError("apply died half-way")

    async def heal():
        pass

    async def check():
        raise AssertionError("store never recovered")

    a = NemesisAction("pl", bad_apply, heal, dwell_s=0.0, check=check)
    try:
        await run_nemesis([a], duration_s=5.0, rng=_rng(), pause_s=0.01)
        raise AssertionError("swallowed recovery failure did not abort")
    except AssertionError as e:
        assert "never recovered" in str(e)


async def test_nemesis_heal_failure_after_apply_error_is_swallowed():
    async def bad_apply():
        raise RuntimeError("apply blew up")

    async def bad_heal():
        raise RuntimeError("heal blew up too")

    a = NemesisAction("worse", bad_apply, bad_heal, dwell_s=0.0)
    # neither error may escape: the drive rides through
    timeline = await run_nemesis([a], duration_s=0.1, rng=_rng(),
                                 pause_s=0.03)
    assert timeline == []


async def test_nemesis_skipfault_does_not_heal():
    healed = []

    async def skip():
        raise SkipFault

    async def heal():
        healed.append(1)

    a = NemesisAction("skip", skip, heal, dwell_s=0.0)
    timeline = await run_nemesis([a], duration_s=0.1, rng=_rng(),
                                 pause_s=0.03)
    assert timeline == [] and not healed and a.applied == 0


async def test_nemesis_check_runs_after_heal_and_aborts_on_violation():
    order = []

    async def apply():
        order.append("apply")

    async def heal():
        order.append("heal")

    async def check():
        order.append("check")
        if order.count("check") == 2:
            raise AssertionError("recovery invariant violated")

    a = NemesisAction("chk", apply, heal, dwell_s=0.0, check=check)
    try:
        await run_nemesis([a], duration_s=5.0, rng=_rng(), pause_s=0.01)
        raise AssertionError("invariant violation did not abort the drive")
    except AssertionError as e:
        assert "recovery invariant" in str(e)
    assert order == ["apply", "heal", "check"] * 2


# ---------------------------------------------------------------------------
# FaultInjectingTransport
# ---------------------------------------------------------------------------


class _EchoTransport(TransportBase):
    def __init__(self):
        self.endpoint = "127.0.0.1:1"
        self.calls = []
        self.closed = False

    async def call(self, dst, method, request, timeout_ms=None):
        self.calls.append((dst, method, request))
        return ("ok", dst, request)

    async def close(self):
        self.closed = True


async def test_fault_transport_block_is_one_way_per_destination():
    inner = _EchoTransport()
    t = FaultInjectingTransport(inner, seed=1)
    t.block("b:1")
    try:
        await t.call("b:1", "m", 1, timeout_ms=10)
        raise AssertionError("blocked dst answered")
    except RpcError as e:
        assert e.status.code == RaftError.EHOSTDOWN
    # other destinations unaffected
    assert (await t.call("c:1", "m", 2))[1] == "c:1"
    # unblock restores exactly the named destination
    t.unblock("b:1")
    assert (await t.call("b:1", "m", 3))[1] == "b:1"
    assert [c[0] for c in inner.calls] == ["c:1", "b:1"]


async def test_fault_transport_drop_rate_and_heal():
    inner = _EchoTransport()
    t = FaultInjectingTransport(inner, seed=7)
    t.set_drop_rate(1.0)
    for _ in range(3):
        try:
            await t.call("d:1", "m", 0, timeout_ms=5)
            raise AssertionError("100% drop rate let a call through")
        except RpcError:
            pass
    assert inner.calls == []
    t.set_drop_rate(0.0)
    assert (await t.call("d:1", "m", 1))[0] == "ok"

    # heal() clears every partition at once
    t.block("x:1")
    t.block("y:1")
    t.heal()
    await t.call("x:1", "m", 2)
    await t.call("y:1", "m", 3)
    assert len(inner.calls) == 3


async def test_fault_transport_delay_and_close_passthrough():
    inner = _EchoTransport()
    t = FaultInjectingTransport(inner, seed=3)
    t.set_delay_ms(5)
    t0 = asyncio.get_running_loop().time()
    await t.call("z:1", "m", 1)
    assert asyncio.get_running_loop().time() - t0 >= 0.004
    await t.close()
    assert inner.closed


async def test_fault_transport_duplicates_execute_twice_at_receiver():
    """Duplication semantics: the receiver EXECUTES both copies (raft
    handlers must be idempotent); the caller sees exactly one response."""
    inner = _EchoTransport()
    t = FaultInjectingTransport(inner, seed=5)
    t.set_duplicate_rate(1.0)
    resp = await t.call("d:1", "m", 42, timeout_ms=50)
    assert resp[0] == "ok"           # one response to the caller
    await asyncio.sleep(0.01)        # let the duplicate task land
    assert len(inner.calls) == 2, "duplicate was not delivered"
    assert inner.calls[0] == inner.calls[1] == ("d:1", "m", 42)
    # turning it off restores exactly-once delivery
    t.set_duplicate_rate(0.0)
    await t.call("d:1", "m", 43, timeout_ms=50)
    await asyncio.sleep(0.01)
    assert len(inner.calls) == 3


class _SlowEchoTransport(_EchoTransport):
    """Echo with a tiny service time so reorder delays actually let a
    later frame overtake an earlier one."""

    async def call(self, dst, method, request, timeout_ms=None):
        await asyncio.sleep(0.001)
        return await super().call(dst, method, request, timeout_ms)


async def test_fault_transport_bounded_reordering():
    """A held frame is overtaken by later frames — but delivery stays
    bounded: with reordering off again, order is restored."""
    inner = _SlowEchoTransport()
    t = FaultInjectingTransport(inner, seed=1)
    t.set_reorder(1.0, max_delay_ms=30.0)

    async def one(i):
        await t.call("r:1", "m", i, timeout_ms=200)

    # submit 0 first, then (reordering only 0's window) 1..3 with
    # per-submit jitter: the seeded holds shuffle arrival order
    await asyncio.gather(*(one(i) for i in range(4)))
    arrived = [req for (_dst, _m, req) in inner.calls]
    assert sorted(arrived) == [0, 1, 2, 3], "frames lost or duplicated"
    assert arrived != [0, 1, 2, 3], \
        "reorder_rate=1.0 delivered strictly in order (seed=1)"
    # bounded: disable and confirm in-order delivery resumes
    inner.calls.clear()
    t.set_reorder(0.0)
    for i in range(3):
        await t.call("r:1", "m", i, timeout_ms=200)
    assert [req for (_d, _m, req) in inner.calls] == [0, 1, 2]


async def test_inproc_network_duplication_and_reordering():
    """The in-proc fabric (TestCluster / soak) exposes the same two
    faults so the churn soak's noise action covers both fabrics."""
    from tpuraft_torch.rpc.transport import InProcNetwork, RpcServer

    net = InProcNetwork()
    server = RpcServer("s:1")
    seen = []

    async def handler(req):
        seen.append(req)
        return req

    server.register("echo", handler)
    net.bind(server)
    net.set_duplicate_rate(1.0)
    resp = await net.call("c:1", "s:1", "echo", 7, timeout_ms=100)
    assert resp == 7
    await asyncio.sleep(0.01)
    assert seen == [7, 7], "in-proc duplicate not delivered"

    seen.clear()
    net.set_duplicate_rate(0.0)
    net.set_reorder(1.0, max_delay_ms=25.0)
    await asyncio.gather(*(net.call("c:1", "s:1", "echo", i,
                                    timeout_ms=300) for i in range(4)))
    assert sorted(seen) == [0, 1, 2, 3]
    assert seen != [0, 1, 2, 3], \
        "in-proc reorder_rate=1.0 delivered strictly in order"
    net.set_reorder(0.0)


# ---------------------------------------------------------------------------
# NetworkTopology: per-link geo shaping + heal()/heal_topology() split
# ---------------------------------------------------------------------------


def _geo_topology(seed=0, clock=None):
    from tpuraft_torch.rpc.topology import LinkProfile, NetworkTopology

    kw = {"seed": seed}
    if clock is not None:
        kw["clock"] = clock
    topo = NetworkTopology(**kw)
    topo.set_zone("a:1", "z0")
    topo.set_zone("b:1", "z1")
    topo.set_zone("c:1", "z1")
    topo.set_link("z0", "z1", LinkProfile(latency_ms=20.0), symmetric=False)
    topo.set_link("z1", "z0", LinkProfile(latency_ms=5.0), symmetric=False)
    return topo


def test_topology_asymmetric_latency_and_zone_lookup():
    topo = _geo_topology()
    assert topo.zone_of("a:1") == "z0" and topo.zone_of("c:1") == "z1"
    d_fwd, drop_fwd = topo.plan("a:1", "b:1")
    d_rev, drop_rev = topo.plan("b:1", "a:1")
    assert not drop_fwd and not drop_rev
    assert abs(d_fwd - 0.020) < 1e-9, "z0->z1 must take the 20ms row"
    assert abs(d_rev - 0.005) < 1e-9, "z1->z0 must take the ASYMMETRIC 5ms row"
    # intra-zone rides the (zero) default link
    d_local, _ = topo.plan("b:1", "c:1")
    assert d_local == 0.0


def test_topology_one_way_zone_partition_and_degrade():
    topo = _geo_topology()
    topo.partition_zone("z0", one_way=True)
    _, dropped = topo.plan("a:1", "b:1")
    assert dropped, "z0 outbound must drop under one-way partition"
    _, dropped_in = topo.plan("b:1", "a:1")
    assert not dropped_in, "one-way partition must let inbound flow"
    topo.heal_events()
    _, dropped = topo.plan("a:1", "b:1")
    assert not dropped
    # degrade-WAN multiplies inter-zone latency, base shape untouched
    topo.degrade_wan(latency_x=10.0, extra_loss=0.0)
    d, _ = topo.plan("a:1", "b:1")
    assert abs(d - 0.200) < 1e-9
    topo.heal_events()
    d, _ = topo.plan("a:1", "b:1")
    assert abs(d - 0.020) < 1e-9


def test_topology_bandwidth_bucket_queues_bursts():
    now = [0.0]
    topo = _geo_topology(clock=lambda: now[0])
    from tpuraft_torch.rpc.topology import LinkProfile

    # 8 kbps = 1000 bytes/s: a 500-byte frame serializes in 0.5s
    topo.set_link("z0", "z1", LinkProfile(bandwidth_kbps=8.0))
    d1, _ = topo.plan("a:1", "b:1", nbytes=500)
    d2, _ = topo.plan("a:1", "b:1", nbytes=500)
    assert abs(d1 - 0.5) < 1e-9
    assert abs(d2 - 1.0) < 1e-9, "second frame queues behind the first"
    now[0] += 2.0  # bucket drains with wall time
    d3, _ = topo.plan("a:1", "b:1", nbytes=500)
    assert abs(d3 - 0.5) < 1e-9
    assert topo.counters["shaped_bytes"] == 1500


def test_topology_flap_square_wave():
    now = [0.0]
    from tpuraft_torch.rpc.topology import NetworkTopology

    topo = NetworkTopology(seed=3, clock=lambda: now[0])
    topo.set_zone("a:1", "z0")
    topo.set_zone("b:1", "z1")
    topo.flap("z0", "z1", period_s=1.0, duty=0.5)
    # scan a full period: must see BOTH up and down phases
    outcomes = set()
    for i in range(10):
        now[0] = i * 0.1
        _, dropped = topo.plan("a:1", "b:1")
        outcomes.add(dropped)
    assert outcomes == {True, False}, "flap must alternate up/down"
    topo.heal_events()
    now[0] = 0.35
    for i in range(10):
        now[0] += 0.1
        assert topo.plan("a:1", "b:1")[1] is False


async def test_fault_transport_heal_does_not_stomp_topology():
    """The satellite contract: nemesis-layer heal() and topology
    shaping compose.  heal() clears blocks but leaves topology events;
    heal_topology() clears topology events but leaves blocks."""
    inner = _EchoTransport()
    inner.endpoint = "a:1"
    t = FaultInjectingTransport(inner, seed=2)
    topo = _geo_topology()
    t.set_topology(topo)
    topo.partition_zone("z0", one_way=True)
    t.block("c:1")

    async def dropped(dst):
        try:
            await t.call(dst, "m", 0, timeout_ms=5)
            return False
        except RpcError:
            return True

    assert await dropped("b:1")          # topology partition
    assert await dropped("c:1")          # nemesis block (c is z1: also
    #                                      partitioned — check after heal)
    t.heal()                             # nemesis heal...
    assert await dropped("b:1"), "heal() must NOT clear the zone partition"
    t.heal_topology()                    # ...then topology heal
    assert not await dropped("b:1")
    # now only the nemesis block could remain — heal() already cleared
    # it; re-block and verify heal_topology leaves it alone
    t.block("c:1")
    topo.partition_zone("z0", one_way=True)
    t.heal_topology()
    assert await dropped("c:1"), "heal_topology() must NOT clear blocks"
    t.unblock("c:1")
    assert not await dropped("c:1")


async def test_inproc_network_topology_and_heal_split():
    """Same composition contract on the in-proc fabric the soak uses."""
    from tpuraft_torch.rpc.transport import InProcNetwork, RpcServer

    net = InProcNetwork()
    server = RpcServer("b:1")
    server.register("echo", _async_identity)
    net.bind(server)
    topo = _geo_topology()
    net.set_topology(topo)
    t0 = asyncio.get_running_loop().time()
    assert await net.call("a:1", "b:1", "echo", 7, timeout_ms=500) == 7
    assert asyncio.get_running_loop().time() - t0 >= 0.018, \
        "inter-zone call must pay the 20ms base latency"
    topo.partition_zone("z0", one_way=True)
    net.partition_one_way({"x:1"}, {"b:1"})
    try:
        await net.call("a:1", "b:1", "echo", 8, timeout_ms=20)
        raise AssertionError("partitioned zone answered")
    except RpcError:
        pass
    net.heal()      # nemesis heal keeps the zone partition
    try:
        await net.call("a:1", "b:1", "echo", 9, timeout_ms=20)
        raise AssertionError("heal() cleared the topology partition")
    except RpcError:
        pass
    net.heal_topology()
    assert await net.call("a:1", "b:1", "echo", 10, timeout_ms=500) == 10


async def _async_identity(req):
    return req


def test_topology_seeded_determinism_and_describe():
    from tpuraft_torch.rpc.topology import LinkProfile, NetworkTopology

    def run(seed):
        topo = NetworkTopology(seed=seed)
        topo.set_zone("a:1", "z0")
        topo.set_zone("b:1", "z1")
        topo.set_link("z0", "z1",
                      LinkProfile(latency_ms=1.0, jitter_ms=5.0, loss=0.3))
        return [topo.plan("a:1", "b:1") for _ in range(50)], topo

    outs1, topo = run(11)
    outs2, _ = run(11)
    outs3, _ = run(12)
    assert outs1 == outs2, "same seed must replay byte-identically"
    assert outs1 != outs3
    assert any(d for _, d in outs1) and any(not d for _, d in outs1)
    text = topo.describe()
    assert "zone z0" in text and "counters" in text and "loss=0.3" in text


# ===========================================================================
# Port copy of tests/test_gray_failure.py
# ===========================================================================


# ---------------------------------------------------------------------------
# HealthTracker scoring: thresholds + hysteresis (seeded, deterministic)
# ---------------------------------------------------------------------------


def test_hysteresis_worsens_fast_recovers_slow():
    """Score transitions are evaluation-counted: worsen after 2
    consecutive bad rounds, recover only after 5 consecutive good ones
    — one writeback spike never flips the level, and a recovering
    store must PROVE health before the mitigation brake releases."""
    t = HealthTracker(HealthOptions(worsen_after=2, recover_after=5))
    assert t.score() == HEALTHY
    # one sick sample + one evaluation: still HEALTHY (hysteresis)
    t.disk.note(0.5)
    assert t.evaluate() == HEALTHY
    # second consecutive sick round crosses worsen_after
    assert t.evaluate() == SICK
    assert t.cause == "disk"
    # now recover the EMA below every threshold
    for _ in range(60):
        t.disk.note(0.0005)
    # four good rounds: still SICK (recover_after=5)
    for _ in range(4):
        assert t.evaluate() == SICK
    # the fifth releases
    assert t.evaluate() == HEALTHY


def test_degraded_level_does_not_reach_sick():
    t = HealthTracker(HealthOptions(worsen_after=1))
    for _ in range(20):
        t.disk.note(0.05)   # 50ms: over degraded (25), under sick (120)
    assert t.evaluate() == DEGRADED
    for _ in range(10):
        assert t.evaluate() == DEGRADED
    assert t.score() == DEGRADED


def test_disk_stall_detected_via_inflight_age():
    """A fully hung fsync never completes a sample, so the EMA alone
    would stay clean forever — the probe's in-flight age catches it."""
    clock = [0.0]
    t = HealthTracker(HealthOptions(worsen_after=2, disk_stall_ms=500.0),
                      clock=lambda: clock[0])
    # healthy history
    for _ in range(10):
        tok = t.disk.begin()
        clock[0] += 0.001
        t.disk.end(tok)
    assert t.evaluate() == HEALTHY
    # a flush begins... and never ends
    t.disk.begin()
    clock[0] += 0.3
    assert t.evaluate() == HEALTHY      # under the stall bound
    clock[0] += 0.3                     # 600ms in flight now
    assert t.evaluate() == HEALTHY      # hysteresis round 1
    assert t.evaluate() == SICK
    assert t.cause == "stall"


def test_apply_backlog_scores():
    t = HealthTracker(HealthOptions(worsen_after=1, apply_degraded=100,
                                    apply_sick=1000))
    for _ in range(30):
        t.note_apply_depth(400)
    assert t.evaluate() == DEGRADED
    for _ in range(30):
        t.note_apply_depth(5000)
    assert t.evaluate() == SICK
    assert t.cause == "apply"


def test_peer_scores_from_rtts():
    t = HealthTracker(HealthOptions(worsen_after=2, peer_degraded_ms=50,
                                    peer_sick_ms=250))
    for _ in range(10):
        t.note_peer_rtt("a:1", 0.005)   # 5ms: healthy
        t.note_peer_rtt("b:1", 0.100)   # 100ms: degraded
        t.note_peer_rtt("c:1", 0.400)   # 400ms: sick
    for _ in range(3):
        t.evaluate()
    assert t.peer_score("a:1") == HEALTHY
    assert t.peer_score("b:1") == DEGRADED
    assert t.peer_score("c:1") == SICK
    assert t.slow_peers() == ["b:1", "c:1"]
    # an endpoint never heard from defaults healthy
    assert t.peer_score("zz:9") == HEALTHY


def test_disk_ema_fed_in_thread_only_not_by_round_waits():
    """Regression (gray A/B bench): end-to-end round time includes
    executor-queue wait, so one co-hosted store's slow disk saturating
    the shared executor scored EVERY store sick and triggered a
    mutual-evacuation leadership storm.  begin/end feed only the
    stall-age signal; the EMA comes exclusively from note()'s in-thread
    measurements."""
    clock = [0.0]
    p = DiskLatencyProbe(clock=lambda: clock[0])
    tok = p.begin()
    clock[0] += 5.0          # five seconds queued behind a neighbor
    p.end(tok)
    ema, age, n = p.snapshot()
    assert n == 0 and ema == 0.0, \
        "round wait must not contaminate the disk EMA"
    p.note(0.002)
    ema, _age, n = p.snapshot()
    assert n == 1 and abs(ema - 2.0) < 1e-9


async def test_sick_store_refuses_timeout_now():
    """Regression (gray A/B bench): a SICK store must not ACCEPT
    leadership — two slow stores evacuating at each other ping-ponged
    every lease.  Refusing TimeoutNow is always safe: the transfer
    times out and the old leader's watchdog resumes."""
    from tpuraft_torch.core.node import Node, State
    from tpuraft_torch.entity import PeerId
    from tpuraft_torch.options import NodeOptions
    from tpuraft_torch.rpc.messages import TimeoutNowRequest

    t = HealthTracker(HealthOptions(worsen_after=1))
    node = Node.__new__(Node)
    node._lock = asyncio.Lock()
    node.current_term = 3
    node.state = State.FOLLOWER
    node.options = NodeOptions(health=t)
    node.group_id = "g"
    node.server_id = PeerId.parse("127.0.0.1:9001")
    req = TimeoutNowRequest(group_id="g", server_id="127.0.0.1:9002",
                            peer_id="127.0.0.1:9001", term=3)
    for _ in range(5):
        t.disk.note(0.5)
    t.evaluate()
    assert t.score() == SICK
    resp = await node.handle_timeout_now(req)
    assert resp.success is False, "SICK store accepted leadership"


def test_probe_is_thread_safe_under_concurrent_feeders():
    """The disk probe is the one tracker piece fed from executor
    threads (multilog fsync timing) — hammer it from 4 threads while
    snapshotting."""
    p = DiskLatencyProbe()
    stop = threading.Event()

    def feed():
        while not stop.is_set():
            tok = p.begin()
            p.end(tok)
            p.note(0.001)

    threads = [threading.Thread(target=feed) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        for _ in range(200):
            ema, age, n = p.snapshot()
            assert ema >= 0.0 and age >= 0.0
    finally:
        stop.set()
        for th in threads:
            th.join()
    ema, age, n = p.snapshot()
    assert n > 0


# ---------------------------------------------------------------------------
# fail-slow injection: ChaosDir latency faults
# ---------------------------------------------------------------------------


def test_chaosdir_set_slow_delays_fsync_and_write(tmp_path):
    import os

    from tpuraft_torch.storage.fault import ChaosDir

    root = tmp_path / "slow"
    with ChaosDir(str(root)) as cd:
        cd.set_slow(fsync_ms=40, write_ms=10, seed=7)
        path = root / "f.bin"
        t0 = time.perf_counter()
        with open(str(path), "wb") as f:
            f.write(b"x" * 64)
            f.flush()
            os.fsync(f.fileno())
        dur = time.perf_counter() - t0
        assert dur >= 0.045, f"latency injection missing ({dur * 1e3:.1f}ms)"
        assert cd.slow_counts.get("fsync_slowed", 0) >= 1
        assert cd.slow_counts.get("write_slowed", 0) >= 1
        cd.heal_slow()
        t0 = time.perf_counter()
        with open(str(path), "wb") as f:
            f.write(b"y" * 64)
            f.flush()
            os.fsync(f.fileno())
        assert time.perf_counter() - t0 < 0.03, "heal_slow did not clear"


def test_chaosdir_stall_fsync_blocks_until_heal(tmp_path):
    import os

    from tpuraft_torch.storage.fault import ChaosDir

    root = tmp_path / "stall"
    with ChaosDir(str(root)) as cd:
        path = root / "f.bin"
        f = open(str(path), "wb")  # noqa: SIM115 — fsynced across threads
        f.write(b"x")
        f.flush()
        cd.stall_fsync()
        done = threading.Event()

        def sync():
            os.fsync(f.fileno())
            done.set()

        th = threading.Thread(target=sync)
        th.start()
        try:
            assert not done.wait(0.15), "stalled fsync completed"
            cd.heal_slow()
            assert done.wait(2.0), "healed fsync still stuck"
        finally:
            cd.heal_slow()
            th.join()
            f.close()
        assert cd.slow_counts.get("fsync_stalled", 0) == 1


def test_chaosdir_uninstall_releases_stalled_fsync(tmp_path):
    """A leaked stall must not wedge executor threads past the chaos
    drive: uninstall() heals."""
    import os

    from tpuraft_torch.storage.fault import ChaosDir

    root = tmp_path / "leak"
    cd = ChaosDir(str(root)).install()
    path = root / "f.bin"
    f = open(str(path), "wb")  # noqa: SIM115
    f.write(b"x")
    f.flush()
    cd.stall_fsync()
    done = threading.Event()
    th = threading.Thread(target=lambda: (os.fsync(f.fileno()), done.set()))
    th.start()
    try:
        assert not done.wait(0.1)
        cd.uninstall()
        assert done.wait(2.0), "uninstall did not release the stall"
    finally:
        th.join()
        f.close()


# ---------------------------------------------------------------------------
# fail-slow injection: per-endpoint topology events
# ---------------------------------------------------------------------------


def test_topology_endpoint_degrade_both_directions_and_heal():
    from tpuraft_torch.rpc.topology import NetworkTopology

    topo = NetworkTopology(seed=3)
    topo.degrade_endpoint("a:1", latency_ms=50, jitter_ms=0)
    # frames TOUCHING a:1 pay the limp, both directions
    d1, drop1 = topo.plan("a:1", "b:1")
    d2, drop2 = topo.plan("b:1", "a:1")
    assert not drop1 and not drop2
    assert d1 >= 0.05 and d2 >= 0.05
    # frames between healthy endpoints are untouched
    d3, _ = topo.plan("b:1", "c:1")
    assert d3 == 0.0
    assert topo.counters["ep_shaped"] == 2
    topo.heal_events()
    d4, _ = topo.plan("a:1", "b:1")
    assert d4 == 0.0
    assert not topo.endpoint_degraded("a:1")


def test_topology_endpoint_limp_composes_with_zone_link():
    """The endpoint limp is ADDITIVE on the zone link — one store can
    crawl while its zone's base shape stays intact for its siblings."""
    from tpuraft_torch.rpc.topology import LinkProfile, NetworkTopology

    topo = NetworkTopology(seed=5)
    for ep, z in (("a:1", "z0"), ("b:1", "z0"), ("c:1", "z1")):
        topo.set_zone(ep, z)
    topo.set_link("z0", "z1", LinkProfile(latency_ms=10), symmetric=True)
    topo.degrade_endpoint("a:1", latency_ms=100, jitter_ms=0)
    d_limped, _ = topo.plan("a:1", "c:1")
    d_healthy, _ = topo.plan("b:1", "c:1")
    assert abs(d_healthy - 0.010) < 1e-9
    assert abs(d_limped - 0.110) < 1e-9


def test_topology_stall_endpoint_delivers_late_not_never():
    from tpuraft_torch.rpc.topology import NetworkTopology

    topo = NetworkTopology(seed=1)
    topo.stall_endpoint("a:1", stall_ms=800)
    delay, dropped = topo.plan("b:1", "a:1")
    assert not dropped, "stall must deliver (late), not drop"
    assert delay >= 0.8


def test_topology_endpoint_loss_seeded_replay():
    from tpuraft_torch.rpc.topology import NetworkTopology

    def run(seed):
        topo = NetworkTopology(seed=seed)
        topo.degrade_endpoint("a:1", latency_ms=5, jitter_ms=5, loss=0.3)
        return [topo.plan("a:1", "b:1") for _ in range(64)]

    assert run(9) == run(9), "same seed must replay byte-identically"
    assert run(9) != run(10)


# ---------------------------------------------------------------------------
# leadership evacuation: rate-bounded, hysteretic, health-target-aware
# ---------------------------------------------------------------------------


@contextlib.asynccontextmanager
async def _kv_cluster(tmp_path, n_regions=4, **opt_overrides):
    from tests.test_torch_kv import DISK_BUDGET, KVTestCluster
    from tpuraft_torch.rheakv.metadata import Region

    regions = [Region(id=k + 1,
                      start_key=b"k%02d" % k if k else b"",
                      end_key=b"k%02d" % (k + 1) if k + 1 < n_regions
                      else b"")
               for k in range(n_regions)]
    c = KVTestCluster(n_stores=3, tmp_path=tmp_path, regions=regions,
                      store_opts={"disk_budget_bytes": DISK_BUDGET})
    # the gray knobs ride StoreEngineOptions; KVTestCluster builds them
    # internally, so patch post-construction before start
    orig = c.start_store

    async def start_store(ep):
        store = await orig(ep)
        for k, v in opt_overrides.items():
            setattr(store.opts, k, v)
        return store

    c.start_store = start_store
    await c.start_all()
    try:
        yield c
    finally:
        await c.stop_all()


async def _concentrate_leadership(c, ep, n_regions):
    """Transfer every region's leadership onto store ``ep``."""
    from tpuraft_torch.entity import PeerId

    target = PeerId.parse(ep)
    for rid in range(1, n_regions + 1):
        engine = await c.wait_region_leader(rid)
        if engine.store_engine.server_id.endpoint == ep:
            continue
        st = await engine.node.transfer_leadership_to(target)
        assert st.is_ok(), f"transfer of region {rid}: {st}"
    # wait until the target actually leads everything
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if sorted(c.stores[ep].leader_region_ids()) == \
                list(range(1, n_regions + 1)):
            return
        await asyncio.sleep(0.05)
    raise AssertionError(
        f"leadership never concentrated on {ep}: "
        f"{c.stores[ep].leader_region_ids()}")


def _force_level(store, level: str) -> None:
    """Deterministically drive the store's tracker to a level."""
    ms = {HEALTHY: 0.0002, DEGRADED: 0.05, SICK: 0.4}[level]
    for _ in range(40):
        store.health.disk.note(ms)
    for _ in range(max(store.health.opts.worsen_after,
                       store.health.opts.recover_after) + 1):
        store.health.evaluate()
    assert store.health.score() == level


async def test_evacuation_rate_bounded_and_cooldown(tmp_path):
    """Acceptance criterion: a SICK store moves at most
    ``evacuation_rate`` leaders per evaluation round, and a region it
    just moved (or tried to) is cooled down for
    ``evacuation_cooldown_rounds`` rounds."""
    # park the background health loop (huge eval interval): this test
    # drives _evacuate_leaders() by hand, and a concurrent REAL round
    # against the forced-SICK tracker would break the count arithmetic
    async with _kv_cluster(tmp_path, n_regions=4, evacuation_rate=2,
                           evacuation_cooldown_rounds=100,
                           health_eval_interval_ms=3_600_000) as c:
        ep0 = c.endpoints[0]
        await _concentrate_leadership(c, ep0, 4)
        store = c.stores[ep0]
        _force_level(store, SICK)
        # round 1: exactly evacuation_rate transfers
        moved = await store._evacuate_leaders()
        assert moved == 2
        assert store.evacuations == 2
        # round 2 (same _evac_round: cooldown horizon far ahead): the 2
        # still-led regions move, the 2 cooled ones are skipped
        moved = await store._evacuate_leaders()
        assert moved == 2
        assert store.evacuations == 4
        # round 3: everything either moved or cooled — nothing happens
        moved = await store._evacuate_leaders()
        assert moved == 0
        assert store.evacuations == 4


async def test_degraded_recovering_store_keeps_its_leaders(tmp_path):
    """Acceptance criterion (no flapping): a store that went SICK,
    evacuated, and is now RECOVERING through DEGRADED keeps the leaders
    it still holds — the health loop only evacuates at SICK, and the
    recover_after hysteresis keeps a noisy store from oscillating."""
    async with _kv_cluster(tmp_path, n_regions=4, evacuation_rate=1,
                           health_eval_interval_ms=40) as c:
        ep0 = c.endpoints[0]
        await _concentrate_leadership(c, ep0, 4)
        store = c.stores[ep0]
        _force_level(store, SICK)
        # let the REAL health loop evacuate at its bounded rate
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline and store.evacuations == 0:
            store.health.disk.note(0.4)   # fault still active
            await asyncio.sleep(0.05)
        assert store.evacuations > 0, "SICK store never evacuated"
        # the disk recovers: good samples drive the score to DEGRADED
        # territory and beyond — while DEGRADED, NO further evacuation
        for _ in range(40):
            store.health.disk.note(0.05)   # degraded-level latency
        for _ in range(store.health.opts.recover_after + 2):
            store.health.evaluate()
        assert store.health.score() == DEGRADED
        # evacuations ordered during the SICK phase land asynchronously
        # (the leadership transfer completes off the health loop — on a
        # loaded host well after the score recovered): let leadership
        # settle before snapshotting what the store still holds
        led_before = store.leader_region_ids()
        settle_deadline = time.monotonic() + 8
        stable_since = time.monotonic()
        while time.monotonic() < settle_deadline:
            store.health.disk.note(0.05)   # keep the score DEGRADED
            await asyncio.sleep(0.05)
            cur = store.leader_region_ids()
            if cur != led_before:
                led_before = cur
                stable_since = time.monotonic()
            elif time.monotonic() - stable_since > 0.6:
                break
        evac_before = store.evacuations
        feed_until = time.monotonic() + 1.5
        while time.monotonic() < feed_until:
            store.health.disk.note(0.05)   # still degraded, recovering
            await asyncio.sleep(0.03)
        assert store.evacuations == evac_before, \
            "DEGRADED-but-recovering store evacuated (flapping)"
        assert store.leader_region_ids() == led_before, \
            "DEGRADED store lost leaders it should have kept"


async def test_evacuation_targets_healthiest_peer(tmp_path):
    """The transfer target skips peers the tracker scores SICK and
    prefers HEALTHY over DEGRADED."""
    async with _kv_cluster(tmp_path, n_regions=1) as c:
        ep0, ep1, ep2 = c.endpoints
        await _concentrate_leadership(c, ep0, 1)
        store = c.stores[ep0]
        engine = store.get_region_engine(1)

        def feed_until(pred, feeds):
            # the LIVE hub keeps folding real (fast) beat RTTs into the
            # same EMAs, so keep feeding until the score holds
            deadline = time.monotonic() + 8
            while time.monotonic() < deadline and not pred():
                for ep, rtt in feeds:
                    for _ in range(8):
                        store.health.note_peer_rtt(ep, rtt)
                store.health.evaluate()
            assert pred(), {e: store.health.peer_score(e)
                            for e in (ep1, ep2)}

        # score ep1 SICK while ep2 stays no worse than DEGRADED — and
        # tolerate a loaded host where the hub's REAL beat RTTs shove
        # ep2 over the sick bound transiently: keep feeding until the
        # intended state holds at the instant of the pick
        deadline = time.monotonic() + 10
        target = None
        while time.monotonic() < deadline and target is None:
            for _ in range(8):
                store.health.note_peer_rtt(ep1, 0.400)
                store.health.note_peer_rtt(ep2, 0.100)
            store.health.evaluate()
            if store.health.peer_score(ep1) == SICK \
                    and store.health.peer_score(ep2) != SICK:
                target = store._pick_evacuation_target(engine)
            await asyncio.sleep(0)
        assert target is not None, \
            {e: store.health.peer_score(e) for e in (ep1, ep2)}
        assert target.endpoint == ep2, \
            "must pick the non-sick peer over the sick one"
        # with BOTH peers sick there is no target at all
        feed_until(lambda: store.health.peer_score(ep1) == SICK
                   and store.health.peer_score(ep2) == SICK,
                   [(ep1, 0.400), (ep2, 0.400)])
        assert store._pick_evacuation_target(engine) is None


# ---------------------------------------------------------------------------
# serving-plane degradation: shed instead of queue
# ---------------------------------------------------------------------------


async def test_sick_store_sheds_batches_with_retry_after(tmp_path):
    from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
    from tpuraft_torch.rheakv.kv_service import (
        ERR_STORE_BUSY,
        KVCommandBatchRequest,
        decode_batch_reply,
        encode_batch_item,
    )

    async with _kv_cluster(tmp_path, n_regions=1,
                           shed_backlog_items=8) as c:
        engine = await c.wait_region_leader(1)
        store = engine.store_engine
        region = engine.region
        item = encode_batch_item(
            1, region.epoch.conf_ver, region.epoch.version,
            KVOperation(KVOp.PUT, b"k", b"v").encode())
        # healthy: no shed, whatever the backlog
        store.kv_processor.inflight_items = 10_000
        resp = await store.kv_processor.handle_batch(
            KVCommandBatchRequest(items=[item]))
        code, _m, _r, _g = decode_batch_reply(resp.items[0])
        assert code == 0
        # SICK + backlog over the bound: per-item EBUSY + retry-after,
        # nothing admitted to the propose pipe
        store.kv_processor.inflight_items = 10_000
        _force_level(store, SICK)
        resp = await store.kv_processor.handle_batch(
            KVCommandBatchRequest(items=[item, item]))
        for blob in resp.items:
            code, msg, _r, _g = decode_batch_reply(blob)
            assert code == ERR_STORE_BUSY
            assert "retry-after-ms=" in msg
        assert store.kv_processor.shed_items == 2
        assert store.kv_processor.inflight_items == 10_000  # untouched
        # SICK but the pipe is empty: still serves (deadline-aware —
        # shed only once queueing would add the fatal wait)
        store.kv_processor.inflight_items = 0
        resp = await store.kv_processor.handle_batch(
            KVCommandBatchRequest(items=[item]))
        code, _m, _r, _g = decode_batch_reply(resp.items[0])
        assert code == 0


def test_client_treats_shed_bounce_as_retryable():
    from tpuraft_torch.rheakv.client import RheaKVStore, _Retry
    from tpuraft_torch.rheakv.kv_service import ERR_STORE_BUSY, encode_batch_reply
    from tpuraft_torch.rheakv.metadata import Region
    from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient

    region = Region(id=1, peers=["127.0.0.1:9001", "127.0.0.1:9002"])
    kv = RheaKVStore(FakePlacementDriverClient([region]), transport=None)
    kv._leaders[1] = "127.0.0.1:9001"
    out = kv._decode_outcome(
        region, "127.0.0.1:9001",
        encode_batch_reply(ERR_STORE_BUSY,
                           "store sick: shedding (retry-after-ms=250)"))
    assert isinstance(out, _Retry)
    assert 1 not in kv._leaders, \
        "a shedding store's leader hint must drop (evacuation moves it)"


# ---------------------------------------------------------------------------
# client: jittered backoff + slow-replica read routing
# ---------------------------------------------------------------------------


def test_backoff_jitter_is_seeded_and_bounded():
    from tpuraft_torch.rheakv.client import RheaKVStore
    from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient

    def series(seed):
        kv = RheaKVStore(FakePlacementDriverClient([]), transport=None,
                         retry_interval_ms=100, jitter_seed=seed)
        return [kv._backoff_s(a) for a in range(8)]

    s1, s2, s3 = series(7), series(7), series(8)
    assert s1 == s2, "same seed must give the same backoff series"
    assert s1 != s3
    for attempt, val in enumerate(s1):
        base = 0.1 * (attempt + 1)
        assert 0.5 * base <= val < 1.5 * base


def test_read_candidates_route_off_slow_replicas():
    from tpuraft_torch.rheakv.client import RheaKVStore
    from tpuraft_torch.rheakv.metadata import Region
    from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient

    peers = ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003"]
    region = Region(id=1, peers=list(peers))
    kv = RheaKVStore(FakePlacementDriverClient([region]), transport=None,
                     read_from="follower")
    kv._leaders[1] = peers[0]
    # endpoint 9002 observed slow (gray), the others fast
    kv._ep_lat_ms = {"127.0.0.1:9001": 2.0, "127.0.0.1:9002": 300.0,
                     "127.0.0.1:9003": 3.0}
    for attempt in range(6):
        cands = kv._read_candidates(region, attempt)
        followers = [c for c in cands if c != peers[0]]
        assert followers[-1] == peers[1] or peers[1] not in followers[:1], \
            f"slow follower probed first: {cands}"
        assert cands.index(peers[2]) < cands.index(peers[1]), \
            f"slow replica not deprioritized: {cands}"
    # with no latency data the rotation is untouched
    kv._ep_lat_ms = {}
    seen_first = {kv._read_candidates(region, 0)[0] for _ in range(6)}
    assert len(seen_first) > 1, "rotation must still spread"


def test_any_mode_reads_also_route_off_slow_replicas():
    from tpuraft_torch.rheakv.client import RheaKVStore
    from tpuraft_torch.rheakv.metadata import Region
    from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient

    peers = ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003"]
    region = Region(id=1, peers=list(peers))
    kv = RheaKVStore(FakePlacementDriverClient([region]), transport=None,
                     read_from="any")
    kv._ep_lat_ms = {"127.0.0.1:9001": 2.0, "127.0.0.1:9002": 250.0,
                     "127.0.0.1:9003": 3.0}
    for _ in range(6):
        eps = kv._read_endpoints_for(region)
        assert eps[-1] == peers[1], \
            f"'any' fan-out did not push the gray replica last: {eps}"


def test_ep_latency_ema_not_fed_by_shed_bounces():
    """Review finding: a SICK store's instant ERR_STORE_BUSY bounces
    must not drag its latency EMA back under the slow floor — only
    SERVED replies feed the EMA."""
    from tpuraft_torch.rheakv.client import RheaKVStore, _StoreSender
    from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
    from tpuraft_torch.rheakv.kv_service import (
        ERR_STORE_BUSY,
        KVCommandBatchResponse,
        encode_batch_reply,
    )
    from tpuraft_torch.rheakv.metadata import Region
    from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient

    class ShedTransport:
        async def call(self, dst, method, request, timeout_ms=None):
            bounce = encode_batch_reply(ERR_STORE_BUSY, "shedding")
            return KVCommandBatchResponse(
                items=[bounce] * len(request.items))

    region = Region(id=1, peers=["127.0.0.1:9001"])
    kv = RheaKVStore(FakePlacementDriverClient([region]),
                     transport=ShedTransport())
    kv._ep_lat_ms["127.0.0.1:9001"] = 300.0   # learned while limping

    async def run():
        sender = _StoreSender(kv, "127.0.0.1:9001")
        fut = sender.submit(region, "127.0.0.1:9001",
                            KVOperation(KVOp.PUT, b"k", b"v"))
        await asyncio.wait_for(fut, 2.0)

    asyncio.run(run())
    assert kv._ep_lat_ms["127.0.0.1:9001"] == 300.0, \
        "shed bounce fed the EMA and erased the gray signal"


# ---------------------------------------------------------------------------
# PD: SICK-aware placement + drain
# ---------------------------------------------------------------------------


def _stats(cooldown=0.0):
    from tpuraft_torch.rheakv.pd_server import ClusterStatsManager

    s = ClusterStatsManager(split_threshold_keys=0)
    s._grace_until = 0.0
    return s


def test_pd_never_targets_a_sick_store():
    from tpuraft_torch.rheakv.metadata import Region

    s = _stats()
    region = Region(id=1, peers=["a:1", "b:1", "c:1"])
    leaders = {1: "a:1", 2: "a:1", 3: "a:1", 4: "a:1"}
    # without health, b or c gets the move (a leads 4, they lead 0)
    t = s.pick_transfer_target(region, "a:1", leaders, cooldown_s=10.0)
    assert t in ("b:1", "c:1")
    # with b SICK, the move lands on c (fresh manager: no cooldown)
    s2 = _stats()
    t = s2.pick_transfer_target(region, "a:1", leaders, cooldown_s=10.0,
                                health={"b:1": "sick"})
    assert t == "c:1"
    # everyone else sick: nowhere to go
    s3 = _stats()
    t = s3.pick_transfer_target(region, "a:1", leaders, cooldown_s=10.0,
                                health={"b:1": "sick", "c:1": "sick"})
    assert t is None


def test_pd_drains_sick_leader_without_imbalance():
    """Balanced leader counts normally suppress transfers (< 2 diff);
    a SICK leader store is drained anyway — onto a healthy peer."""
    from tpuraft_torch.rheakv.metadata import Region

    s = _stats()
    region = Region(id=1, peers=["a:1", "b:1", "c:1"])
    leaders = {1: "a:1", 2: "b:1", 3: "c:1"}   # perfectly balanced
    assert s.pick_transfer_target(region, "a:1", leaders,
                                  cooldown_s=10.0) is None
    s2 = _stats()
    t = s2.pick_transfer_target(region, "a:1", leaders, cooldown_s=10.0,
                                health={"a:1": "sick"})
    assert t in ("b:1", "c:1"), "sick leader must drain"
    # degraded peers lose the tie to healthy ones during a drain
    s3 = _stats()
    t = s3.pick_transfer_target(region, "a:1", leaders, cooldown_s=10.0,
                                health={"a:1": "sick", "b:1": "degraded"})
    assert t == "c:1"
    # and the cooldown still paces repeated drains of one region
    t = s3.pick_transfer_target(region, "a:1", leaders, cooldown_s=10.0,
                                health={"a:1": "sick"})
    assert t is None, "drain must respect the per-region cooldown"


async def test_pre_health_pd_client_override_still_heartbeats(tmp_path):
    """API compat: a PD-client subclass whose store_heartbeat_batch
    predates the health kwarg must keep receiving heartbeats (probed by
    signature at construction) — the naive call would raise TypeError
    into the retry loop and silently starve the PD forever."""
    from tpuraft_torch.rheakv.metadata import Region
    from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
    from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions
    from tpuraft_torch.rpc.transport import (
        InProcNetwork,
        InProcTransport,
        RpcServer,
    )

    class LegacyPD(FakePlacementDriverClient):
        batches = 0

        async def store_heartbeat_batch(self, meta, deltas, full=False):
            LegacyPD.batches += 1
            return [], False

    ep = "127.0.0.1:6777"
    net = InProcNetwork()
    server = RpcServer(ep)
    net.bind(server)
    net.start_endpoint(ep)
    store = StoreEngine(
        StoreEngineOptions(server_id=ep,
                           initial_regions=[Region(id=1, peers=[ep])],
                           heartbeat_interval_ms=30),
        server, InProcTransport(net, ep),
        pd_client=LegacyPD([]))
    assert store._pd_health_kwarg is False
    await store.start()
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and LegacyPD.batches == 0:
            await asyncio.sleep(0.05)
        assert LegacyPD.batches > 0, \
            "legacy PD client never received a heartbeat"
    finally:
        await store.shutdown()


def test_pd_server_tracks_and_clears_store_health():
    from tpuraft_torch.rheakv.pd_server import PlacementDriverServer

    srv = PlacementDriverServer.__new__(PlacementDriverServer)
    srv._store_health = {}
    srv._note_store_health("a:1", "sick")
    assert srv._store_health == {"a:1": "sick"}
    srv._note_store_health("a:1", "healthy")
    assert srv._store_health == {"a:1": "healthy"}
    # "" = store stopped reporting scores: never leave a stale verdict
    srv._note_store_health("a:1", "")
    assert srv._store_health == {}


# ---------------------------------------------------------------------------
# node: SICK election gate (bounded deferral, then liveness wins)
# ---------------------------------------------------------------------------


def test_sick_store_defers_elections_boundedly():
    from tpuraft_torch.core.node import Node
    from tpuraft_torch.entity import ElectionPriority, PeerId
    from tpuraft_torch.options import NodeOptions

    t = HealthTracker(HealthOptions(worsen_after=1))
    node = Node.__new__(Node)
    node.options = NodeOptions(health=t, sick_election_rounds=2)
    node.server_id = PeerId.parse("127.0.0.1:9001")
    node._sick_election_skips = 0
    node._election_round = 0
    node.target_priority = ElectionPriority.DISABLED
    # healthy: elections run
    assert node._allow_launch_election() is True
    # sick: defer exactly sick_election_rounds rounds...
    for _ in range(5):
        t.disk.note(0.5)
    t.evaluate()
    assert t.score() == SICK
    assert node._allow_launch_election() is False
    assert node._allow_launch_election() is False
    # ...then liveness wins (every peer may be worse off)
    assert node._allow_launch_election() is True
    # recovery resets the skip budget
    for _ in range(60):
        t.disk.note(0.0002)
    for _ in range(t.opts.recover_after + 1):
        t.evaluate()
    assert t.score() == HEALTHY
    assert node._allow_launch_election() is True
    assert node._sick_election_skips == 0


# ---------------------------------------------------------------------------
# end-to-end: a slow disk on a leader is detected through REAL signals
# ---------------------------------------------------------------------------


async def test_slow_disk_scores_sick_through_real_flush_path(tmp_path):
    """No synthetic samples: ChaosDir latency on the leader store's
    data dir, real KV writes, and the tracker must reach SICK from the
    LogManager's own flush timing."""
    import os

    from tpuraft_torch.storage.fault import ChaosDir

    # interposition must be live BEFORE the stores open their files
    # (files opened earlier are not tracked), so install for every
    # store dir up front and arm only the leader's
    chaos = {}
    for i in range(3):
        ep = f"127.0.0.1:{6000 + i}"
        ip, port = ep.rsplit(":", 1)
        chaos[ep] = ChaosDir(
            os.path.join(str(tmp_path), f"{ip}_{port}")).install()
    try:
        async with _kv_cluster(tmp_path, n_regions=1,
                               health_eval_interval_ms=60) as c:
            engine = await c.wait_region_leader(1)
            store = engine.store_engine
            cd = chaos[store.server_id.endpoint]
            cd.set_slow(fsync_ms=200, write_ms=10, seed=3)
            deadline = time.monotonic() + 12
            while time.monotonic() < deadline \
                    and store.health.score() != SICK:
                try:
                    await asyncio.wait_for(
                        engine.raft_store.put(b"k", b"v"), 2.0)
                except Exception:
                    pass   # slow is the point
                await asyncio.sleep(0.02)
            cd.heal_slow()   # let shutdown proceed at disk speed
            assert store.health.score() == SICK, store.health.describe()
            assert store.health.cause in ("disk", "stall")
    finally:
        for cd in chaos.values():
            cd.uninstall()


# ===========================================================================
# The two packages' ChaosDir, one after the other, on one seeded script
# ===========================================================================

_GENUINE = {"open": io.open, "os_open": os.open, "os_close": os.close,
            "fsync": os.fsync, "replace": os.replace, "rename": os.rename,
            "remove": os.remove, "unlink": os.unlink}


def _bindings() -> dict:
    return {"open": builtins.open, "os_open": os.open, "os_close": os.close,
            "fsync": os.fsync, "replace": os.replace, "rename": os.rename,
            "remove": os.remove, "unlink": os.unlink}


@pytest.fixture(autouse=True)
def _no_interposer_left_installed():
    """Every test leaves open and os.* as it found them: a leaked
    install would patch every later test of this worker."""
    assert _bindings() == _GENUINE, "an interposer was installed already"
    yield
    leaked = _bindings() != _GENUINE
    for name, fn in _GENUINE.items():
        if name == "open":
            builtins.open = fn
        else:
            setattr(os, name.removeprefix("os_"), fn)
    assert not leaked, "the test left an interposer installed"


_FILES = ("a.log", "b.log", "sub/c.log", "sub/meta")


def _tree(root: str) -> dict[str, bytes]:
    """Every file under root by relative path, read past any
    interposer (io.open is the genuine open)."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with io.open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return dict(sorted(out.items()))


def _chaos_script(chaos_dir, root: str, mode: str, seed: int,
                  steps: int = 400) -> dict:
    """One seeded script under ``chaos_dir`` (a package's ChaosDir class)
    restricted to one crash mode: appends and rewrites with and without
    fsync, temp-file renames with and without a directory fsync,
    truncates, removes, and power-loss crashes.  Returns the surviving
    files after every crash, the injection counts and the crash count."""
    script, menu = random.Random(seed), random.Random(seed + 1)
    images = []
    os.makedirs(os.path.join(root, "sub"))
    with chaos_dir(root, modes=((mode, 1.0),)) as cd:

        def dir_fsync(path):
            fd = os.open(os.path.dirname(path), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

        for _ in range(steps):
            op = script.random()
            path = os.path.join(root, script.choice(_FILES))
            sync = script.random() < 0.4
            if op < 0.45:
                with open(path, "ab") as f:
                    for _ in range(script.randrange(1, 4)):
                        f.write(script.randbytes(script.randrange(1, 96)))
                    if sync:
                        f.flush()
                        os.fsync(f.fileno())
            elif op < 0.60:
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(script.randbytes(script.randrange(0, 160)))
                    if sync:
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(tmp, path)
                if script.random() < 0.5:
                    dir_fsync(path)
            elif op < 0.70 and os.path.exists(path):
                with open(path, "r+b") as f:
                    f.truncate(script.randrange(os.path.getsize(path) + 1))
                    if sync:
                        os.fsync(f.fileno())
            elif op < 0.76 and os.path.exists(path):
                os.remove(path)
            elif op < 0.82 and os.path.exists(path):
                dst = os.path.join(root, script.choice(_FILES))
                if dst != path:
                    os.rename(path, dst)
                    if sync:
                        dir_fsync(dst)
            elif op >= 0.90:
                cd.crash(menu)
                images.append(_tree(root))
        return {"images": images, "injected": dict(cd.injected),
                "crashes": cd.crash_count}


@pytest.mark.parametrize("mode", [m for m, _ in ref_fault.CRASH_MODES])
def test_chaosdir_crash_images_match_the_jax_package(tmp_path, mode):
    assert [m for m, _ in CRASH_MODES] == \
        [m for m, _ in ref_fault.CRASH_MODES]
    runs = {}
    for name, chaos_dir in (("jax", ref_fault.ChaosDir),
                            ("port", ChaosDir)):
        runs[name] = _chaos_script(chaos_dir, str(tmp_path / name), mode,
                                   seed=sum(map(ord, mode)))
        assert _bindings() == _GENUINE, f"{name} left its interposer"
    ref, port = runs["jax"], runs["port"]
    assert ref["crashes"] == port["crashes"] >= 20, ref["crashes"]
    assert ref["injected"].get(mode, 0) > 0, ref["injected"]
    assert port["injected"] == ref["injected"]
    for i, (a, b) in enumerate(zip(ref["images"], port["images"])):
        assert a == b, f"crash {i}: the surviving files differ"
    assert len(ref["images"]) == len(port["images"])
