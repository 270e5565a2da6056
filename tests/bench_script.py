"""Run a root bench script as a child, as its user does: helpers for
the tests of the port's bench family against the JAX package's."""

import contextlib
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def records() -> dict:
    """The committed benchmark records, by digest."""
    out = {}
    for pat in ("BENCH_*.json", "MULTICHIP_*.json"):
        for path in glob.glob(os.path.join(REPO, pat)):
            with open(path, "rb") as f:
                out[os.path.basename(path)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def start(script, *args, env=None, cwd=REPO) -> subprocess.Popen:
    """``python3 script args`` from the repo root (or ``cwd``), output
    captured."""
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, script), *args], cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))


def has_room(path: str) -> bool:
    """Whether a store's statvfs-derived disk budget reads ``path``'s
    filesystem as well under its near-full mark (80 % used): at least
    half of it and 1 GiB available to an unprivileged writer."""
    sv = os.statvfs(path)
    free = sv.f_bavail * sv.f_frsize
    return sv.f_blocks > 0 and free >= 1 << 30 \
        and sv.f_bavail >= sv.f_blocks // 2


@contextlib.contextmanager
def roomy_dir(tmp_path):
    """A directory for the data of stores that read their capacity from
    statvfs (a bench script's stores take no explicit budget): a fresh
    one under /dev/shm where that filesystem has room, else ``tmp_path``
    (a full filesystem turns every store SICK, and it sheds writes).
    Yields (path, whether it has room); removes what it made."""
    shm = "/dev/shm"
    if os.path.isdir(shm) and os.access(shm, os.W_OK) and has_room(shm):
        path = tempfile.mkdtemp(prefix="tpuraft_bench_test_", dir=shm)
        try:
            yield path, True
        finally:
            shutil.rmtree(path, ignore_errors=True)
    else:
        yield str(tmp_path), has_room(str(tmp_path))


def finish(proc, timeout=150) -> tuple[int, str, str]:
    """The child's exit code, stdout and stderr."""
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def result_row(out: str) -> dict:
    """The one ``RESULT {...}`` row of a child's stdout."""
    rows = [json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
            if ln.startswith("RESULT ")]
    assert len(rows) == 1, out
    return rows[0]
