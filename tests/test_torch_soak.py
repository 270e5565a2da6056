"""The port's chaos soak runner (tpuraft_torch/examples/soak.py) on the
CPU: the port copy of tests/test_examples.py's short soak, the engine
soak (every store a torch MultiRaftEngine ticking on the CPU over the
shared multilog journal, multimeta and quiescence) proven linearizable
under the default nemesis, the card as the engines' default device, and
the up-front refusal of the modes whose modules are not ported."""

from __future__ import annotations

import asyncio
import functools
import inspect
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from tpuraft_torch.examples import soak

ROOT = Path(__file__).resolve().parent.parent


async def test_soak_runner_short():
    """The chaos soak runner (examples/soak.py): 8s of nemesis faults
    under load, history proven linearizable, faults actually fired."""
    from tpuraft_torch.examples.soak import run_soak

    with tempfile.TemporaryDirectory() as d:
        r = await asyncio.wait_for(
            run_soak(duration_s=8, n_stores=3, n_keys=4, seed=3,
                     data_path=d, verbose=False), 110)
    assert r["linearizable"], r
    assert r["ops"] > 50, r
    assert sum(r["faults"].values()) >= 2, r


async def test_engine_soak_on_the_cpu_is_linearizable(tmp_path,
                                                     monkeypatch):
    """--regions 8 --engine --quiesce --kv-batching, seed 5, for 10 s:
    3 stores, each driving its 8 regions from one port engine on the
    CPU over the multilog journal and the multimeta journal, under
    leader kills, one-way partitions, drops and delays; the history is
    linearizable."""
    from tests.test_torch_kv import DISK_BUDGET
    from tpuraft_torch.storage import multilog

    # an explicit disk budget: a statvfs-derived one reads a nearly
    # full shared filesystem as FULL, and every store sheds its writes
    monkeypatch.setattr(soak, "StoreEngineOptions", functools.partial(
        soak.StoreEngineOptions, disk_budget_bytes=DISK_BUDGET))
    r = await asyncio.wait_for(soak.run_soak(
        duration_s=10, n_stores=3, n_keys=4, seed=5,
        data_path=str(tmp_path), verbose=False, n_regions=8, engine=True,
        quiesce=True, kv_batching=True, device="cpu"), 150)
    assert r["linearizable"], r
    assert r["completed"] > 100 and sum(r["faults"].values()) >= 2, r
    stores = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert len(stores) == 3
    for name in stores:  # each store's regions share one journal
        assert (tmp_path / name / "mlog").is_dir()
        assert (tmp_path / name / "meta").is_dir()
        assert not list((tmp_path / name).glob("r*/log"))
    assert not multilog._engines  # every store released its engine


def test_the_card_is_the_default_device():
    """The soak's engines tick on the card unless the caller passes
    device="cpu"; the CLI has no switch for it."""
    for fn in (soak.run_soak, soak.SoakCluster.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    c = soak.SoakCluster(3, "", n_regions=2, engine=True)
    assert c.device == "cuda"


_UNPORTED = [["--transport", "native"], ["--power-loss"], ["--gray"],
             ["--disk-pressure"], ["--hotspot"], ["--lifecycle"]]


@pytest.mark.parametrize("flags", _UNPORTED, ids=lambda f: f[0].lstrip("-"))
def test_unported_modes_are_refused_up_front(monkeypatch, capsys, flags):
    """Each mode that reaches an unported module (fault planes, native
    transport, placement driver) is refused by the CLI before any store
    boots or any directory is made."""
    def boot(*a, **kw):
        raise AssertionError("booted a refused mode")

    for name in ("run_soak", "run_hotspot_soak", "run_lifecycle_soak"):
        monkeypatch.setattr(soak, name, boot)
    monkeypatch.setattr(soak.tempfile, "mkdtemp", boot)
    monkeypatch.setattr(sys, "argv", ["soak", "--duration", "1", *flags])
    with pytest.raises(SystemExit) as exc:
        soak.main()
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP A9" in err and " ".join(flags) in err


def test_cli_refuses_unported_modes_together():
    proc = subprocess.run(
        [sys.executable, "-m", "tpuraft_torch.examples.soak", "--gray",
         "--power-loss", "--regions", "1024", "--engine"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "--power-loss, --gray: not ported" in proc.stderr
    assert proc.stdout == ""
