"""Run a root bench script as a child, as its user does: helpers for
the tests of the port's bench family against the JAX package's."""

import glob
import hashlib
import json
import os
import subprocess
import sys

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


def start(script, *args, env=None) -> subprocess.Popen:
    """``python3 script args`` from the repo root, output captured."""
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, script), *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))


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
