"""Shared build-or-dlopen logic for the native C++ engines.

Used by multilog / logstore / transport / kvstore loaders.  Three
deployment shapes must all work:

  1. dev checkout (toolchain + writable dir): rebuild when sources are
     newer than the .so, under a cross-process flock so concurrently
     spawned stores never dlopen a half-written file;
  2. read-only install (no writable dir — the flock file itself cannot
     be created): nobody can be mid-build either, so dlopen the
     existing .so directly;
  3. toolchain-free host (make missing/failing): fall back to an
     existing .so with a warning instead of refusing to open storage.
"""

from __future__ import annotations

import glob
import logging
import os
import subprocess

LOG = logging.getLogger("tpuraft.native_build")


def _sources_mtime(native_dir: str) -> float:
    newest = 0.0
    for pat in ("*.cc", "*.h", "Makefile"):
        for p in glob.glob(os.path.join(native_dir, pat)):
            try:
                newest = max(newest, os.path.getmtime(p))
            except OSError:
                pass
    return newest


def _so_current(native_dir: str, path: str) -> bool:
    try:
        return os.path.getmtime(path) >= _sources_mtime(native_dir)
    except OSError:
        return False  # .so missing


def ensure_built(native_dir: str, lib_path: str, target: str | None = None,
                 timeout: float = 120.0) -> str:
    """Return the path of an up-to-date ``lib_path``, rebuilding via
    ``make -C native_dir`` only when sources are newer than the .so.

    A ``lib_path`` outside ``native_dir`` is a prebuilt override (the
    TPURAFT_NATIVE_*_LIB env vars): returned as-is, never rebuilt."""
    native_dir = os.path.normpath(native_dir)
    path = lib_path
    if os.path.dirname(os.path.normpath(path)) != native_dir:
        return path
    lock_path = os.path.join(native_dir, ".build.lock")
    try:
        lock = open(lock_path, "w")
    except OSError:
        # unwritable package dir (read-only install): no process can be
        # mid-build here, so the existing .so cannot be half-written
        if os.path.exists(path):
            if not _so_current(native_dir, path):
                LOG.warning("%s: package dir read-only and %s is older "
                            "than sources; dlopening it anyway", native_dir,
                            os.path.basename(path))
            return path
        raise
    import fcntl

    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # re-check under the lock: a concurrent spawner may have just
        # finished the build while we waited
        if _so_current(native_dir, path):
            return path
        cmd = ["make", "-C", native_dir] + ([target] if target else [])
        try:
            subprocess.run(cmd, check=True, timeout=timeout,
                           capture_output=True)
        except (OSError, subprocess.SubprocessError) as exc:
            if os.path.exists(path):
                LOG.warning("native build failed (%s); falling back to "
                            "existing %s", exc, path)
                return path
            raise
    return path
