"""Crash-consistency fault injection for the storage plane.

Mirrors what ``rpc/fault.py`` + ``util/nemesis.py`` do for the network:
an injection surface for the *durability* faults the advisor keeps
finding by inspection (torn tails, lost fsyncs, registry/journal
ordering) — made mechanically reproducible.  Two layers:

``ChaosDir`` + ``FaultInjectingFile``
    Live interposition over the Python storage planes (FileLogStorage,
    MetaJournal, snapshots): while installed, every ``open``/``os.fsync``
    /``os.replace``/``os.remove`` under the tracked root is observed and
    the *proven-durable* content of each file is modeled in memory
    (bytes covered by a completed fsync).  "Simulate power loss now"
    materializes the durable-only image, with seeded injections in the
    unsynced suffix:

    - **lost fsync**    buffered-but-unsynced bytes discarded entirely
    - **torn write**    a random prefix of the unsynced suffix survives
                        (can cut mid-record — CRC framing must catch it)
    - **short write**   cut at a write-op boundary plus a partial op
    - **bit flip**      the suffix survives with one bit corrupted
                        (partial-page writeback garbage)
    - **writeback-all** everything survives (the lucky crash)

    All injections stay in the *unsynced* region: that is what a real
    power loss can legally do.  Corrupting fsynced bytes is a different
    fault class (bit rot) and must fail loudly (CorruptLogError), never
    be silently truncated — tests cover it separately.

``NativeJournalTracker``
    The native multilog engine (native/multilog.cc) does fd-level I/O
    in C++, out of reach of Python interposition.  Its durable floor is
    still externally observable: staged bytes hit the fd immediately
    (plain ``write``), so journal file sizes captured *immediately
    after a tlm_sync round* are exactly the proven-durable bytes, and
    rotation fsyncs outgoing files (only the newest journal and the
    ``groups`` registry can carry an unsynced tail).  ``crash_image``
    copies the live directory and applies the same injection menu to
    those tails.

Model simplifications (documented, deliberate):
  - deletes and directory renames are applied durably at once (the
    interesting hazards here are content-level, and every rename in the
    storage plane is followed by a directory fsync);
  - a rename whose source was never fsynced may materialize the
    destination EMPTY at crash (rename durable, content not) or keep
    the old destination (rename lost) — both legal, both injected.
"""

from __future__ import annotations

import builtins
import errno
import os
import random
import shutil
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Optional

# injection menu: (mode, default weight)
CRASH_MODES: tuple[tuple[str, float], ...] = (
    ("lost-fsync", 0.30),
    ("torn-write", 0.30),
    ("short-write", 0.15),
    ("bit-flip", 0.10),
    ("writeback-all", 0.15),
)


def _pick_mode(rng, modes=CRASH_MODES) -> str:
    names = [m for m, _ in modes]
    weights = [w for _, w in modes]
    return rng.choices(names, weights=weights)[0]


def _flip_bit(blob: bytes, lo: int, rng) -> bytes:
    """Flip one random bit at offset >= lo (no-op if the region is empty)."""
    if lo >= len(blob):
        return blob
    i = rng.randrange(lo, len(blob))
    b = bytearray(blob)
    b[i] ^= 1 << rng.randrange(8)
    return bytes(b)


def _injected_suffix(durable: bytes, live: bytes, boundaries: list[int],
                     rng, modes=CRASH_MODES) -> tuple[bytes, str]:
    """Choose what survives of ``live`` given ``durable`` is proven.

    Requires durable to be a prefix of live (the append-only common
    case); callers handle the rewrite case separately.
    """
    mode = _pick_mode(rng, modes)
    d = len(durable)
    if mode == "lost-fsync":
        return durable, mode
    if mode == "writeback-all":
        return live, mode
    if mode == "bit-flip":
        return _flip_bit(live, d, rng), mode
    if mode == "short-write":
        # cut at a recorded write-op boundary, then a partial op
        past = [b for b in boundaries if b > d]
        if past:
            start = rng.choice([d] + past[:-1])
            end = min((b for b in past if b > start), default=len(live))
            cut = rng.randrange(start, end + 1)
            return live[:cut], mode
        mode = "torn-write"
    # torn-write: any byte of the suffix
    cut = rng.randrange(d, len(live) + 1)
    return live[:cut], mode


# ---------------------------------------------------------------------------
# live interposition (Python storage planes)
# ---------------------------------------------------------------------------


@dataclass
class _PathState:
    """Durable model of one tracked file."""

    durable: bytes = b""
    # end offsets of write ops since the last fsync (short-write cuts);
    # bounded — old boundaries matter less than recent ones
    boundaries: list = field(default_factory=list)
    min_dirty: int = 1 << 62      # lowest offset written since last fsync
    ever_synced: bool = False
    # pre-rename durable content of this path (rename-lost outcome)
    prev: Optional[bytes] = None

    def note_write(self, pos: int, end: int) -> None:
        self.min_dirty = min(self.min_dirty, pos)
        self.boundaries.append(end)
        if len(self.boundaries) > 64:
            del self.boundaries[0]

    def clear_dirty(self) -> None:
        self.boundaries.clear()
        self.min_dirty = 1 << 62
        self.prev = None


class FaultInjectingFile:
    """Transparent file proxy that reports writes/truncates to its
    :class:`ChaosDir`.  Everything else delegates to the real file."""

    def __init__(self, real, path: str, owner: "ChaosDir"):
        self._real = real
        self._path = path
        self._owner = owner

    # -- write-path interceptions -------------------------------------------

    def write(self, data):
        self._owner._slow_sleep("write")
        pos = self._real.tell()
        admitted = self._owner._quota_admit(self._path, pos, len(data))
        if admitted < len(data):
            # partial write at the quota boundary: a real disk commits
            # what fit before returning the short count / ENOSPC, so the
            # admitted prefix LANDS (and is modeled) before the error
            if admitted > 0:
                self._real.write(bytes(memoryview(data)[:admitted]))
                self._owner._note_write(self._path, pos, pos + admitted)
            raise OSError(errno.ENOSPC,
                          f"no space left on device (chaos quota): "
                          f"{self._path}")
        n = self._real.write(data)
        self._owner._note_write(self._path, pos, pos + len(data))
        return n

    def truncate(self, size=None):
        try:
            pre = os.path.getsize(self._path)
        except OSError:
            pre = 0
        r = self._real.truncate(size)
        new = self._real.tell() if size is None else size
        self._owner._quota_refund(pre - new)
        self._owner._note_truncate(self._path, new)
        return r

    def close(self):
        self._owner._note_close(self)
        return self._real.close()

    # -- passthrough ---------------------------------------------------------

    def fileno(self):
        return self._real.fileno()

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return iter(self._real)


class _Interposer:
    """Process-wide patch of open/os.* that dispatches tracked paths to
    their owning ChaosDir.  Installed while >= 1 ChaosDir is active."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self._dirs: dict[str, "ChaosDir"] = {}   # root -> owner
        self._fds: dict[int, object] = {}        # fd -> wrapper | "dir"
        self._real: dict[str, object] = {}

    # -- root registry -------------------------------------------------------

    def add(self, cd: "ChaosDir") -> None:
        with self.lock:
            if cd.root in self._dirs:
                raise ValueError(f"ChaosDir already active for {cd.root}")
            first = not self._dirs
            self._dirs[cd.root] = cd
            if first:
                self._install()

    def remove(self, cd: "ChaosDir") -> None:
        with self.lock:
            if cd.root not in self._dirs or self._dirs[cd.root] is not cd:
                return  # idempotent: double-uninstall must be harmless
            del self._dirs[cd.root]
            kept = {}
            for fd, w in self._fds.items():
                ent = w() if isinstance(w, weakref.ref) else w
                if ent is None:
                    continue  # wrapper GC'd: drop the stale entry
                if getattr(ent, "_owner", None) is cd:
                    continue
                kept[fd] = w
            self._fds = kept
            if not self._dirs:
                self._uninstall()

    def owner(self, path) -> Optional["ChaosDir"]:
        try:
            p = os.path.abspath(os.fspath(path))
        except TypeError:
            return None
        with self.lock:
            for root, cd in self._dirs.items():
                if p == root or p.startswith(root + os.sep):
                    return cd
        return None

    # -- patch plumbing ------------------------------------------------------

    def _install(self) -> None:
        self._real = {
            "open": builtins.open,
            "os_open": os.open,
            "os_close": os.close,
            "fsync": os.fsync,
            "replace": os.replace,
            "rename": os.rename,
            "remove": os.remove,
            "unlink": os.unlink,
        }
        builtins.open = self._open          # type: ignore[assignment]
        os.open = self._os_open             # type: ignore[assignment]
        os.close = self._os_close           # type: ignore[assignment]
        os.fsync = self._fsync              # type: ignore[assignment]
        os.replace = self._replace          # type: ignore[assignment]
        os.rename = self._rename            # type: ignore[assignment]
        os.remove = self._remove            # type: ignore[assignment]
        os.unlink = self._remove            # type: ignore[assignment]

    def _uninstall(self) -> None:
        builtins.open = self._real["open"]  # type: ignore[assignment]
        os.open = self._real["os_open"]     # type: ignore[assignment]
        os.close = self._real["os_close"]   # type: ignore[assignment]
        os.fsync = self._real["fsync"]      # type: ignore[assignment]
        os.replace = self._real["replace"]  # type: ignore[assignment]
        os.rename = self._real["rename"]    # type: ignore[assignment]
        os.remove = self._real["remove"]    # type: ignore[assignment]
        os.unlink = self._real["unlink"]    # type: ignore[assignment]
        self._fds.clear()
        # _real is deliberately KEPT: a thread already inside a patched
        # dispatcher (past its lock) still needs self._real[...] — the
        # retained entries are the genuine os/builtins functions, so a
        # late call through them is exactly a real call.  The next
        # install() overwrites them from the (restored) live bindings.

    def real_open(self, *a, **kw):
        return (self._real.get("open") or builtins.open)(*a, **kw)

    # -- dispatchers ----------------------------------------------------------

    def _open(self, file, mode="r", *a, **kw):
        owner = None
        if isinstance(file, (str, bytes, os.PathLike)) \
                and not isinstance(file, bytes) and "b" in mode:
            owner = self.owner(file)
        pre = None
        if owner is not None:
            # snapshot BEFORE the real open (a "w" mode truncates, but
            # the old content stays durable until the next fsync)...
            pre = owner._pre_open(os.path.abspath(os.fspath(file)))
        f = self._real["open"](file, mode, *a, **kw)
        if owner is None:
            return f
        path = os.path.abspath(os.fspath(file))
        wrapped = FaultInjectingFile(f, path, owner)
        with self.lock:
            # weakref: a wrapper abandoned without close() (the
            # open(...).read() idiom) must not pin its fd for the whole
            # interposition lifetime — GC closes the real file, and the
            # dead entry is dropped at next lookup
            self._fds[f.fileno()] = weakref.ref(wrapped)
        # ...and only register state once the open SUCCEEDED: a failed
        # probe of a missing file must not leave phantom model state
        # that a later crash would materialize as an empty file
        owner._post_open(path, pre)
        return wrapped

    def _os_open(self, path, flags, *a, **kw):
        fd = self._real["os_open"](path, flags, *a, **kw)
        try:
            owner = self.owner(path)
            if owner is not None and os.path.isdir(path):
                with self.lock:
                    self._fds[fd] = ("dir", owner,
                                     os.path.abspath(os.fspath(path)))
        except Exception:
            pass
        return fd

    def _os_close(self, fd):
        with self.lock:
            self._fds.pop(fd, None)
        return self._real["os_close"](fd)

    def _fsync(self, fd):
        with self.lock:
            ent = self._fds.get(fd)
            if isinstance(ent, weakref.ref):
                ent = ent()
                if ent is None:
                    self._fds.pop(fd, None)  # wrapper GC'd; fd reused
        if ent is None:
            return self._real["fsync"](fd)
        if isinstance(ent, tuple):  # ("dir", owner, path)
            # a completed directory fsync COMMITS renames/creates in it:
            # the rename-lost crash outcome is only legal before this
            ent[1]._note_dir_fsync(ent[2])
            return None
        # fail-slow injection: the sleep happens on the CALLING thread
        # (executor threads for the storage planes), exactly where a
        # real stalling disk would park it — durability modeling only
        # proceeds once the "disk" comes back
        ent._owner._slow_sleep("fsync")
        ent._owner._note_fsync(ent._path)
        return None      # modeled; skip the real (slow) fsync

    def _replace(self, src, dst, **kw):
        return self._renamish("replace", src, dst, **kw)

    def _rename(self, src, dst, **kw):
        return self._renamish("rename", src, dst, **kw)

    def _renamish(self, which, src, dst, **kw):
        owner = self.owner(dst) or self.owner(src)
        freed = 0
        if owner is not None:
            owner._quota_admit_rename(os.path.abspath(os.fspath(src)),
                                      os.path.abspath(os.fspath(dst)))
            try:  # replacing an existing file frees its bytes
                if os.path.isfile(dst):
                    freed = os.path.getsize(dst)
            except OSError:
                pass
        r = self._real[which](src, dst, **kw)
        if owner is not None:
            owner._quota_refund(freed)
            owner._note_replace(os.path.abspath(os.fspath(src)),
                                os.path.abspath(os.fspath(dst)))
        return r

    def _remove(self, path, **kw):
        owner = self.owner(path)
        freed = 0
        if owner is not None:
            try:
                freed = os.path.getsize(path)
            except OSError:
                pass
        r = self._real["remove"](path, **kw)
        if owner is not None:
            owner._quota_refund(freed)
            owner._note_remove(os.path.abspath(os.fspath(path)))
        return r


_INTERPOSER = _Interposer()


class ChaosDir:
    """Durable-state model + power-loss materialization for one
    directory tree of Python-side storage files.

    Use as a context manager (or ``install()``/``uninstall()``) around
    the storage objects' lifetime — files must be opened while the
    interposition is active to be tracked.  Pre-existing files are
    snapshot as fully durable at install time.
    """

    def __init__(self, root: str, modes=CRASH_MODES):
        self.root = os.path.abspath(root)
        self.modes = modes
        self._lock = threading.RLock()
        self._files: dict[str, _PathState] = {}
        self.crash_count = 0
        self.injected: dict[str, int] = {}
        # -- fail-slow injection (gray failures) -----------------------------
        # per-call latency for fsync/write under this root, plus a full
        # fsync hang: a stalling disk keeps the store "alive" to every
        # liveness check while everything it leads limps.  Sleeps run on
        # the CALLING thread (see _Interposer._fsync) — the executor
        # threads a real slow disk would park.  Seeded jitter keeps
        # drives replayable.
        self._slow_fsync_ms = 0.0      # guarded-by: _lock
        self._slow_write_ms = 0.0      # guarded-by: _lock
        self._slow_jitter_ms = 0.0     # guarded-by: _lock
        self._slow_rng = random.Random(0)  # guarded-by: _lock
        # open = fsyncs proceed; cleared by stall_fsync() so every fsync
        # under this root BLOCKS until heal_slow() (the hung-disk mode)
        self._fsync_gate = threading.Event()
        self._fsync_gate.set()
        self.slow_counts: dict[str, int] = {}
        # -- capacity faults (ENOSPC) ----------------------------------------
        # byte budget across the tree, charged at write/append/rename;
        # once exceeded writes fail ENOSPC with the fitting prefix
        # committed (real short writes).  Usage is tracked by extension
        # bytes and lazily re-based from the live tree — deletes that
        # bypass the interposer (shutil.rmtree) are picked up on the
        # next over-budget admission, which is how reclaim un-wedges a
        # full store without an explicit refund hook.
        self._quota_limit: Optional[int] = None   # guarded-by: _lock
        self._quota_used = 0                      # guarded-by: _lock
        self._quota_refreshed = 0.0               # guarded-by: _lock
        self._burst_rate = 0.0                    # guarded-by: _lock
        self._burst_rng = random.Random(0)        # guarded-by: _lock
        self.enospc_counts: dict[str, int] = {}   # guarded-by: _lock

    # -- lifecycle ------------------------------------------------------------

    def install(self) -> "ChaosDir":
        os.makedirs(self.root, exist_ok=True)
        with self._lock:
            for dirpath, _dirs, names in os.walk(self.root):
                for n in names:
                    p = os.path.join(dirpath, n)
                    st = self._files.setdefault(p, _PathState())
                    st.durable = self._read_live(p)
                    st.ever_synced = True
        _INTERPOSER.add(self)
        return self

    def uninstall(self) -> None:
        # release any thread parked on a stalled fsync: a leaked stall
        # would wedge executor threads past the chaos drive's lifetime
        self.heal_slow()
        _INTERPOSER.remove(self)

    def __enter__(self) -> "ChaosDir":
        return self.install()

    # -- fail-slow injection (gray failures) ---------------------------------

    def set_slow(self, fsync_ms: float = 0.0, write_ms: float = 0.0,
                 jitter_ms: float = 0.0, seed: int = 0) -> None:
        """Per-call latency: every fsync/write under the root sleeps
        ``base + uniform(0, jitter)`` ms on its calling thread.  Use a
        high fsync_ms for a burst disk stall, moderate values for the
        sustained slow-disk mode; ``heal_slow`` clears everything."""
        with self._lock:
            self._slow_fsync_ms = fsync_ms
            self._slow_write_ms = write_ms
            self._slow_jitter_ms = jitter_ms
            self._slow_rng = random.Random(seed)

    def stall_fsync(self) -> None:
        """Full fsync hang: every fsync under the root BLOCKS (on its
        calling thread) until :meth:`heal_slow`.  The worst gray
        failure — writes buffer, nothing durably completes, the store
        answers everything that needs no disk."""
        self._fsync_gate.clear()

    def heal_slow(self) -> None:
        """Clear all latency faults and release stalled fsyncs."""
        with self._lock:
            self._slow_fsync_ms = 0.0
            self._slow_write_ms = 0.0
            self._slow_jitter_ms = 0.0
        self._fsync_gate.set()

    def _slow_sleep(self, kind: str) -> None:
        """Dispatcher hook (interposer fsync / wrapped write): apply the
        configured latency OUTSIDE the model lock — sleeping under it
        would stall event-loop readers behind the fake disk."""
        if kind == "fsync" and not self._fsync_gate.is_set():
            with self._lock:
                self.slow_counts["fsync_stalled"] = \
                    self.slow_counts.get("fsync_stalled", 0) + 1
            self._fsync_gate.wait()
            return
        with self._lock:
            base = self._slow_fsync_ms if kind == "fsync" \
                else self._slow_write_ms
            if base <= 0:
                return  # jitter rides a configured base, never alone
            delay = base
            if self._slow_jitter_ms > 0:
                delay += self._slow_rng.uniform(0.0, self._slow_jitter_ms)
            self.slow_counts[f"{kind}_slowed"] = \
                self.slow_counts.get(f"{kind}_slowed", 0) + 1
        time.sleep(delay / 1000.0)

    # -- capacity faults (ENOSPC) --------------------------------------------

    def set_quota(self, limit_bytes: int) -> None:
        """Byte budget for the whole tree: current usage is measured
        now, and any write/append/rename that would grow the tree past
        the budget fails ENOSPC — with the fitting prefix of the write
        committed first (real disks do short writes at the boundary).
        Overwrites within a file's current size are free."""
        with self._lock:
            self._quota_limit = max(0, int(limit_bytes))
            self._quota_used = self._disk_usage_locked()
            self._quota_refreshed = time.monotonic()

    def shrink_quota(self, delta_bytes: int) -> int:
        """Tighten the budget by ``delta_bytes`` (quota-shrink-over-time
        nemesis); returns the new limit.  No-op without a quota."""
        with self._lock:
            if self._quota_limit is None:
                return 0
            self._quota_limit = max(0, self._quota_limit - int(delta_bytes))
            return self._quota_limit

    def clear_quota(self) -> None:
        """Lift the byte budget (bursts configured separately)."""
        with self._lock:
            self._quota_limit = None

    def set_enospc_burst(self, rate: float, seed: int = 0) -> None:
        """Seeded intermittent ENOSPC: each write/rename under the root
        independently fails with probability ``rate`` (whole-op, no
        partial).  ``rate=0`` heals.  Models transient quota races /
        reservation failures rather than a genuinely full disk."""
        with self._lock:
            self._burst_rate = max(0.0, float(rate))
            self._burst_rng = random.Random(seed)

    def quota_state(self) -> tuple[Optional[int], int]:
        """(limit, used-estimate) snapshot for assertions/telemetry."""
        with self._lock:
            return self._quota_limit, self._quota_used

    def _disk_usage_locked(self) -> int:
        total = 0
        for dirpath, _dirs, names in os.walk(self.root):
            for n in names:
                try:
                    total += os.path.getsize(os.path.join(dirpath, n))
                except OSError:
                    pass
        return total

    def _refresh_quota_used_locked(self) -> None:
        # re-base from the live tree (rate-limited: this runs on every
        # over-budget admission, and full stores see write storms)
        now = time.monotonic()
        if now - self._quota_refreshed < 0.05:
            return
        self._quota_refreshed = now
        self._quota_used = self._disk_usage_locked()

    def _quota_admit(self, path: str, pos: int, n: int) -> int:
        """How many of the ``n`` bytes at ``pos`` may land (wrapped-file
        write hook).  Charges only extension bytes past the file's
        current size; returns ``n`` when unconstrained."""
        with self._lock:
            if self._burst_rate > 0.0 \
                    and self._burst_rng.random() < self._burst_rate:
                self.enospc_counts["burst"] = \
                    self.enospc_counts.get("burst", 0) + 1
                return 0
            if self._quota_limit is None:
                return n
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            ext = pos + n - size
            if ext <= 0:
                return n
            free = self._quota_limit - self._quota_used
            if ext > free:
                # maybe stale: reclaim deletes (rmtree) bypass the
                # interposer — re-measure before refusing
                self._refresh_quota_used_locked()
                free = self._quota_limit - self._quota_used
            if ext <= free:
                self._quota_used += ext
                return n
            self.enospc_counts["write"] = \
                self.enospc_counts.get("write", 0) + 1
            fits = max(0, free)
            self._quota_used += fits
            return n - (ext - fits)

    def _quota_refund(self, nbytes: int) -> None:
        """Bytes freed by a tracked remove/truncate/replace-overwrite.
        (rmtree deletes bypass the interposer and are picked up by the
        lazy re-measure in :meth:`_quota_admit` instead.)"""
        if nbytes <= 0:
            return
        with self._lock:
            if self._quota_limit is not None:
                self._quota_used = max(0, self._quota_used - nbytes)

    def _quota_admit_rename(self, src: str, dst: str) -> None:
        """Pre-op gate for rename/replace under the root: creating a
        fresh directory entry on a full disk fails ENOSPC (and bursts
        hit renames too — meta compaction / snapshot commit exercise
        their failure paths)."""
        with self._lock:
            key = None
            if self._burst_rate > 0.0 \
                    and self._burst_rng.random() < self._burst_rate:
                key = "burst"
            elif self._quota_limit is not None \
                    and not os.path.lexists(dst):
                if self._quota_used >= self._quota_limit:
                    self._refresh_quota_used_locked()
                if self._quota_used >= self._quota_limit:
                    key = "rename"
            if key is not None:
                self.enospc_counts[key] = self.enospc_counts.get(key, 0) + 1
                raise OSError(errno.ENOSPC,
                              f"no space left on device (chaos quota): "
                              f"rename to {dst}")

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- observation hooks (called by the interposer) -------------------------

    def _pre_open(self, path: str) -> Optional[_PathState]:
        """Capture what an untracked existing file held before the real
        open can truncate it (it was durable before we ever saw it);
        returns the state to register IF the open succeeds."""
        with self._lock:
            st = self._files.get(path)
            if st is not None:
                if os.path.exists(path):
                    return st
                # deleted behind our back (shutil.rmtree uses dir_fd-
                # relative unlinks that bypass the path dispatch):
                # deletions are modeled durable, so a recreation at the
                # same path starts FRESH — carrying the stale durable
                # content forward would let a crash roll the new file
                # back to a dead epoch (an illegal image: e.g. an old
                # kv_data inside a newly committed snapshot)
                self._files.pop(path, None)
            st = _PathState()
            if os.path.exists(path):
                st.durable = self._read_live(path)
                st.ever_synced = True
            return st

    def _post_open(self, path: str, st: Optional[_PathState]) -> None:
        with self._lock:
            if st is not None:
                self._files.setdefault(path, st)

    def _note_write(self, path: str, pos: int, end: int) -> None:
        with self._lock:
            self._files.setdefault(path, _PathState()).note_write(pos, end)

    def _note_truncate(self, path: str, size: int) -> None:
        # live view changed; durability unchanged until the next fsync —
        # but the dirty frontier must drop so that fsync re-reads from
        # the truncation point, not past stale durable bytes
        with self._lock:
            st = self._files.get(path)
            if st is not None:
                st.min_dirty = min(st.min_dirty, size)

    def _note_fsync(self, path: str) -> None:
        with self._lock:
            st = self._files.setdefault(path, _PathState())
            # delta read from the dirty frontier: journals grow by
            # appending, and re-reading the whole file per fsync would
            # make a long soak O(n^2) in file size
            lo = min(st.min_dirty, len(st.durable))
            if lo <= 0:
                st.durable = self._read_live(path)
            else:
                st.durable = st.durable[:lo] + self._read_live(path, lo)
            st.ever_synced = True
            st.clear_dirty()

    def _note_dir_fsync(self, dir_path: str) -> None:
        with self._lock:
            for p, st in self._files.items():
                if os.path.dirname(p) == dir_path:
                    st.prev = None

    def _note_close(self, wrapped: FaultInjectingFile) -> None:
        try:
            fd = wrapped._real.fileno()
        except ValueError:
            return
        with _INTERPOSER.lock:
            _INTERPOSER._fds.pop(fd, None)

    def _note_replace(self, src: str, dst: str) -> None:
        with self._lock:
            if os.path.isdir(dst):
                # directory rename (snapshot commit): re-key children;
                # modeled immediately durable (commit fsyncs the root)
                moved = [p for p in self._files
                         if p == src or p.startswith(src + os.sep)]
                for p in moved:
                    self._files[dst + p[len(src):]] = self._files.pop(p)
                return
            sst = self._files.pop(src, None)
            old = self._files.get(dst)
            st = _PathState()
            # rename itself is modeled durable, but the CONTENT carried
            # over is only what was fsynced of src; the old destination
            # durable content is kept as the rename-lost outcome
            st.durable = sst.durable if sst is not None else b""
            st.ever_synced = True
            st.prev = old.durable if old is not None and old.ever_synced \
                else None
            self._files[dst] = st

    def _note_remove(self, path: str) -> None:
        with self._lock:
            self._files.pop(path, None)

    # -- durable image --------------------------------------------------------

    def _read_live(self, path: str, offset: int = 0) -> bytes:
        with _INTERPOSER.lock:
            ropen = _INTERPOSER.real_open
        try:
            with ropen(path, "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read()
        except FileNotFoundError:
            return b""

    def capture_crash(self, rng) -> dict[str, Optional[bytes]]:
        """Decide the power-loss outcome NOW (reads live bytes, applies
        the seeded injection menu); returns {path: surviving_bytes or
        None-for-deleted}.  Apply later with :meth:`apply_crash` — the
        split lets a caller capture at the crash instant, cleanly shut
        the store down, then discard everything the shutdown wrote."""
        plan: dict[str, Optional[bytes]] = {}
        with self._lock:
            for path, st in sorted(self._files.items()):
                if not os.path.exists(path):
                    # deleted behind our back (dir_fd-relative unlink):
                    # deletion is modeled durable — stays deleted
                    plan[path] = None
                    continue
                live = self._read_live(path)
                if st.prev is not None and rng.random() < 0.25:
                    chosen, mode = st.prev, "rename-lost"
                elif live == st.durable:
                    chosen, mode = live, "stable"
                elif st.durable == live[:len(st.durable)]:
                    chosen, mode = _injected_suffix(
                        st.durable, live, st.boundaries, rng, self.modes)
                else:
                    # rewrite/truncate in flight: old or new image
                    chosen = st.durable if rng.random() < 0.5 else live
                    mode = "old-or-new"
                if chosen == b"" and not st.ever_synced \
                        and rng.random() < 0.5:
                    plan[path] = None  # never-synced create: may vanish
                    mode = "unlinked"
                else:
                    plan[path] = chosen
                if mode not in ("stable",):
                    self.injected[mode] = self.injected.get(mode, 0) + 1
        return plan

    def apply_crash(self, plan: dict[str, Optional[bytes]]) -> None:
        """Materialize a captured power-loss image in place and reset
        the durable model to it (surviving bytes are re-proven by the
        recovery fsync discipline on reopen)."""
        with self._lock, _INTERPOSER.lock:
            ropen = _INTERPOSER.real_open
            remove = _INTERPOSER._real.get("remove", os.remove)
            # files created after the capture died with the power
            for path in list(self._files):
                if path not in plan:
                    self._files.pop(path, None)
                    try:
                        remove(path)
                    except FileNotFoundError:
                        pass
            for path, blob in plan.items():
                st = self._files.setdefault(path, _PathState())
                if blob is None:
                    self._files.pop(path, None)
                    try:
                        remove(path)
                    except FileNotFoundError:
                        pass
                    continue
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with ropen(path, "wb") as f:
                    f.write(blob)
                st.durable = blob
                st.ever_synced = True
                st.clear_dirty()
            self.crash_count += 1

    def crash(self, rng) -> dict[str, Optional[bytes]]:
        """capture + apply in one step (power loss right now)."""
        plan = self.capture_crash(rng)
        self.apply_crash(plan)
        return plan


# ---------------------------------------------------------------------------
# native multilog journal (C++ fd-level I/O — imaged, not interposed)
# ---------------------------------------------------------------------------


class NativeJournalTracker:
    """Externally tracks the durable floor of a native multilog dir.

    Call :meth:`note_sync` immediately after every ``tlm_sync`` round
    (before further appends): staged bytes are fd-visible, so the file
    sizes at that instant are exactly the proven-durable bytes.  Only
    the newest journal and the ``groups`` registry can carry an
    unsynced tail (rotation fsyncs outgoing files).
    """

    def __init__(self, dir_path: str, modes=CRASH_MODES):
        self.dir = dir_path
        self.modes = modes
        self.floors: dict[str, int] = {}
        # -- capacity mirror (ENOSPC) ----------------------------------------
        # the C++ fd writes are unpatachable, so the quota is enforced
        # one layer up: MultiLogStorage._stage consults the engine's
        # ``fault_gate`` before tlm_append.  Single-threaded per store
        # loop + engine lock upstream — no lock needed here.
        self._quota_limit: Optional[int] = None
        self._quota_used = 0
        self._burst_rate = 0.0
        self._burst_rng = random.Random(0)
        self.enospc_counts: dict[str, int] = {}

    # -- capacity faults (ENOSPC), mirroring ChaosDir ------------------------

    def attach_quota(self, engine, limit_bytes: Optional[int] = None,
                     burst_rate: float = 0.0, seed: int = 0) -> None:
        """Install this tracker as the engine's append fault gate (see
        ``MultiLogEngine.fault_gate``) with an optional byte budget over
        the journal dir and/or a seeded intermittent ENOSPC burst."""
        if limit_bytes is not None:
            self._quota_limit = max(0, int(limit_bytes))
            self._quota_used = self._dir_usage()
        self._burst_rate = max(0.0, float(burst_rate))
        self._burst_rng = random.Random(seed)
        engine.fault_gate = self.charge_append

    def clear_quota(self) -> None:
        self._quota_limit = None
        self._burst_rate = 0.0

    def _dir_usage(self) -> int:
        total = 0
        try:
            for n in os.listdir(self.dir):
                try:
                    total += os.path.getsize(os.path.join(self.dir, n))
                except OSError:
                    pass
        except OSError:
            pass
        return total

    def charge_append(self, nbytes: int) -> None:
        """Engine fault gate: account ``nbytes`` about to be staged and
        raise ENOSPC once the journal dir would exceed the budget (the
        native append is all-or-nothing, so no partial admission)."""
        if self._burst_rate > 0.0 \
                and self._burst_rng.random() < self._burst_rate:
            self.enospc_counts["burst"] = \
                self.enospc_counts.get("burst", 0) + 1
            raise OSError(errno.ENOSPC,
                          "no space left on device (chaos burst): "
                          f"{self.dir}")
        if self._quota_limit is None:
            return
        if self._quota_used + nbytes > self._quota_limit:
            # journal GC deletes files underneath us — re-measure
            # before refusing, so reclaim un-wedges the quota
            self._quota_used = self._dir_usage()
        if self._quota_used + nbytes > self._quota_limit:
            self.enospc_counts["append"] = \
                self.enospc_counts.get("append", 0) + 1
            raise OSError(errno.ENOSPC,
                          "no space left on device (chaos quota): "
                          f"{self.dir}")
        self._quota_used += nbytes

    def _journals(self, root: Optional[str] = None) -> list[str]:
        root = root or self.dir
        return sorted(n for n in os.listdir(root)
                      if n.startswith("journal_") and n.endswith(".log"))

    def note_sync(self) -> None:
        self.floors = {
            n: os.path.getsize(os.path.join(self.dir, n))
            for n in self._journals()}
        reg = os.path.join(self.dir, "groups")
        if os.path.exists(reg):
            self.floors["groups"] = os.path.getsize(reg)

    def crash_image(self, dst: str, rng) -> dict[str, str]:
        """Copy the live dir to ``dst`` and inject a power-loss outcome
        into the unsynced tails.  Returns {filename: mode}.  The live
        engine must be quiescent (no concurrent appends) for the copy
        to be a consistent instant."""
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(self.dir, dst)
        report: dict[str, str] = {}
        names = self._journals(dst)
        for i, n in enumerate(names):
            path = os.path.join(dst, n)
            size = os.path.getsize(path)
            if i < len(names) - 1:
                # rotation fsyncs outgoing files: fully durable even if
                # the floor snapshot predates the rotation
                continue
            floor = min(self.floors.get(n, 0), size)
            report[n] = self._tear(path, floor, rng)
        reg = os.path.join(dst, "groups")
        if os.path.exists(reg):
            floor = min(self.floors.get("groups", 0),
                        os.path.getsize(reg))
            report["groups"] = self._tear(reg, floor, rng)
        return report

    def _tear(self, path: str, floor: int, rng) -> str:
        with open(path, "rb") as f:
            live = f.read()
        if len(live) <= floor:
            return "stable"
        chosen, mode = _injected_suffix(live[:floor], live, [], rng,
                                        self.modes)
        with open(path, "wb") as f:
            f.write(chosen)
        return mode
