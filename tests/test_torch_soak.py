"""The port's chaos soak runner (tpuraft_torch/examples/soak.py) on the
CPU: the port copy of tests/test_examples.py's short soak, the engine
soak (every store a torch MultiRaftEngine ticking on the CPU over the
shared multilog journal, multimeta and quiescence) proven linearizable
under the default nemesis, the lifecycle, hotspot and native-transport
soaks, the card as the engines' default device, and the storage fault
plane's modes (--power-loss, --gray, --disk-pressure) with the
reference's own refusal of --gray with the engine."""

from __future__ import annotations

import asyncio
import functools
import inspect
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

from tpuraft_torch import options
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


# the lifecycle soak's duration on the CPU: the shortest that passed
# lifecycle_ok in every one of 10 trials run 6 at a time
LIFECYCLE_SECS = 10


async def test_lifecycle_soak_on_the_cpu(tmp_path, monkeypatch):
    """--lifecycle --regions 12 --seed 11 for LIFECYCLE_SECS: 4 stores
    (the fourth empty), each driving its regions from one port engine on
    the CPU, and a lifecycle-enabled PD in the same process under a
    shifting zipfian hotspot: heat splits, cold merges and cross-store
    moves all happen, the keyspace stays covered, no acknowledged write
    is lost and the cold groups hibernate."""
    from tests.test_torch_kv import DISK_BUDGET

    monkeypatch.setattr(soak, "StoreEngineOptions", functools.partial(
        soak.StoreEngineOptions, disk_budget_bytes=DISK_BUDGET))
    # the engine's numpy tick, the one the JAX package's engine runs on a
    # CPU host: with the torch tick's plain version each tick costs 4-5x
    # as much, the soak's one event loop serves a fraction of the ops,
    # and under six-way load the PD's hot detector (8 live reporters)
    # lost the race to the cold merges in 5 of 12 runs (ROADMAP queue C)
    monkeypatch.setattr(options, "TickOptions", functools.partial(
        options.TickOptions, backend="numpy"))
    r = await asyncio.wait_for(soak.run_lifecycle_soak(
        LIFECYCLE_SECS, 4, 12, 11, str(tmp_path), False, device="cpu"), 110)
    assert r["lifecycle_ok"], r
    assert r["heat_splits_ordered"] > 0 and r["merges_completed"] > 0
    assert r["moves_applied"] > 0 and r["coverage_errors"] == []
    assert r["linearizable"] and r["hibernate_ok"], r


async def test_lifecycle_soak_learns_regions_past_an_early_merge(
        tmp_path, monkeypatch):
    """The lifecycle soak's wait for its initial regions ends when the
    PD's regions tile the keyspace, not when it holds 12 of them: here
    region 6's leader reports only after the PD has finished a cold
    merge of the regions it already knew, so it never holds 12, and
    the soak still starts its traffic and keeps the keyspace covered.
    (A card's slow store starts spread the first reports out so.)"""
    from tests.test_torch_kv import DISK_BUDGET
    from tpuraft_torch.rheakv.pd_server import PlacementDriverServer
    from tpuraft_torch.rheakv.store_engine import StoreEngine

    monkeypatch.setattr(soak, "StoreEngineOptions", functools.partial(
        soak.StoreEngineOptions, disk_budget_bytes=DISK_BUDGET))
    monkeypatch.setattr(options, "TickOptions", functools.partial(
        options.TickOptions, backend="numpy"))
    pds, most_held = [], [0]
    pd_start = PlacementDriverServer.start

    async def pd_watched(self, *a, **kw):
        pds.append(self)
        return await pd_start(self, *a, **kw)

    leader_ids = StoreEngine.leader_region_ids

    def late_region_6(self):
        ids = leader_ids(self)
        if pds and pds[0].merges_completed < 1:
            most_held[0] = max(most_held[0], len(pds[0].fsm.regions))
            return [rid for rid in ids if rid != 6]
        return ids

    monkeypatch.setattr(PlacementDriverServer, "start", pd_watched)
    monkeypatch.setattr(StoreEngine, "leader_region_ids", late_region_6)
    r = await asyncio.wait_for(soak.run_lifecycle_soak(
        4, 4, 12, 11, str(tmp_path), False, device="cpu"), 110)
    assert 0 < most_held[0] < 12
    assert r["merges_completed"] > 0 and r["coverage_errors"] == [], r
    assert r["linearizable"], r


# the lifecycle soak with its traffic held until the PD's cold merges
# are done: the soak's own merge floor, and the floor it had before it
# counted the hot detector's population (max(4, regions // 2) = 6 at 12)
MERGE_FIRST_SECS = 20
_MERGE_FLOORS = {"soak": None, "half_the_regions": 6}


@pytest.mark.parametrize("floor", list(_MERGE_FLOORS))
async def test_lifecycle_soak_heats_after_the_merges_are_done(
        tmp_path, monkeypatch, floor):
    """The lifecycle soak with every put and get held until the PD has
    merged the cold fleet down to its floor: the hotspot heats only
    after the merges, the schedule that stopped a card run at 12 -> 6
    regions. The PD's hot detector needs ``hot_min_population`` regions
    reporting heat before it flags any, and a heat split needs a flag:
    the soak's floor keeps that many regions, so the hotspot still
    splits; a floor of 6 leaves too few, and no region ever splits."""
    from tests.test_torch_kv import DISK_BUDGET
    from tpuraft_torch.rheakv import pd_server
    from tpuraft_torch.rheakv.pd_server import (ClusterStatsManager,
                                                PlacementDriverServer)

    monkeypatch.setattr(soak, "StoreEngineOptions", functools.partial(
        soak.StoreEngineOptions, disk_budget_bytes=DISK_BUDGET))
    monkeypatch.setattr(options, "TickOptions", functools.partial(
        options.TickOptions, backend="numpy"))
    if _MERGE_FLOORS[floor] is not None:
        pd_options = pd_server.PlacementDriverOptions

        def floored(*a, **kw):  # over the soak's own keyword
            kw["lifecycle_min_regions"] = _MERGE_FLOORS[floor]
            return pd_options(*a, **kw)

        monkeypatch.setattr(pd_server, "PlacementDriverOptions", floored)
    pds, at_traffic = [], []
    pd_start = PlacementDriverServer.start

    async def pd_watched(self, *a, **kw):
        pds.append(self)
        return await pd_start(self, *a, **kw)

    async def merged_down():
        pd, t0 = pds[0], time.monotonic()
        while (len(pd.fsm.regions) > pd.opts.lifecycle_min_regions
               or pd.fsm.pending_merges):
            assert time.monotonic() - t0 < 60, "the merges never settled"
            await asyncio.sleep(0.05)
        if not at_traffic:
            at_traffic.append(len(pd.fsm.regions))

    class MergedFirst(soak.RheaKVStore):
        async def put(self, *a, **kw):
            await merged_down()
            return await super().put(*a, **kw)

        async def get(self, *a, **kw):
            await merged_down()
            return await super().get(*a, **kw)

    monkeypatch.setattr(PlacementDriverServer, "start", pd_watched)
    monkeypatch.setattr(soak, "RheaKVStore", MergedFirst)
    r = await asyncio.wait_for(soak.run_lifecycle_soak(
        MERGE_FIRST_SECS, 4, 12, 11, str(tmp_path), False, device="cpu"),
        150)
    assert at_traffic == [pds[0].opts.lifecycle_min_regions], at_traffic
    assert r["linearizable"] and r["coverage_errors"] == [], r
    if floor == "soak":
        assert at_traffic[0] >= ClusterStatsManager.hot_min_population
        assert r["heat_splits_ordered"] > 0, r
        assert r["lifecycle_ok"], r
    else:
        assert at_traffic[0] < ClusterStatsManager.hot_min_population
        assert r["heat_splits_ordered"] == 0, r


async def test_hotspot_soak_on_the_cpu(tmp_path, monkeypatch):
    """--hotspot --regions 24 --seed 7 for 10 s: a PD in the same
    process ranks the 3 regions of a zipfian hotspot top-K and flags
    the shifted hot set within 3 heartbeat rounds; the history per key
    stays linearizable."""
    from tests.test_torch_kv import DISK_BUDGET

    monkeypatch.setattr(soak, "StoreEngineOptions", functools.partial(
        soak.StoreEngineOptions, disk_budget_bytes=DISK_BUDGET))
    r = await asyncio.wait_for(soak.run_hotspot_soak(
        10, 3, 24, 7, str(tmp_path), False), 110)
    assert r["hotspot_ok"] and r["phase_a_topk_ok"], r
    assert r["linearizable"], r


async def test_native_transport_soak_on_the_cpu(tmp_path, monkeypatch):
    """--transport native for 8 s: 3 stores over the port's C++ epoll
    transport and native KV engines, faults injected at each store's
    transport, the history linearizable."""
    from tests.test_torch_kv import DISK_BUDGET

    monkeypatch.setattr(soak, "StoreEngineOptions", functools.partial(
        soak.StoreEngineOptions, disk_budget_bytes=DISK_BUDGET))
    r = await asyncio.wait_for(soak.run_soak(
        duration_s=8, n_stores=3, n_keys=4, seed=3,
        data_path=str(tmp_path), verbose=False, transport="native"), 110)
    assert r["linearizable"], r
    assert r["ops"] > 50 and sum(r["faults"].values()) >= 2, r


def test_the_card_is_the_default_device():
    """The soak's engines tick on the card unless the caller passes
    device="cpu"; the CLI has no switch for it."""
    for fn in (soak.run_soak, soak.run_lifecycle_soak,
               soak.SoakCluster.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    c = soak.SoakCluster(3, "", n_regions=2, engine=True)
    assert c.device == "cuda"


def test_lifecycle_soak_without_a_card_exits_with_the_engine_error(
        tmp_path):
    """--lifecycle runs every engine on the card: without one the CLI
    exits non-zero with the engine's error, and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the soak would run")
    proc = subprocess.run(
        [sys.executable, "-m", "tpuraft_torch.examples.soak", "--lifecycle",
         "--duration", "1", "--data", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "lifecycle_ok" not in proc.stdout


# each storage-fault mode and the counter that shows its faults landed
_FAULT_MODES = {
    "power_loss": lambda r: r["power_loss_crashes"],
    "gray": lambda r: sum(r["gray"]["slow_injections"].values()),
    "disk_pressure": lambda r: r["disk"]["enospc_observed"],
}


def _upweighted(action, name: str, weight: float):
    """The nemesis action class with one action's draw weight set."""

    def make(what, *a, **kw):
        if what == name:
            kw["weight"] = weight
        return action(what, *a, **kw)

    return make


@pytest.mark.parametrize("mode", list(_FAULT_MODES))
async def test_storage_fault_soak_on_the_cpu(tmp_path, monkeypatch, mode):
    """--power-loss, --gray and --disk-pressure (seed 3, 8 s) through
    the port's storage fault plane: every store's directory under a
    ChaosDir, power-loss crash images, fail-slow fsyncs and writes, or a
    standing byte quota with ENOSPC; the history is linearizable and the
    mode's faults landed."""
    from tests.test_torch_kv import DISK_BUDGET

    monkeypatch.setattr(soak, "StoreEngineOptions", functools.partial(
        soak.StoreEngineOptions, disk_budget_bytes=DISK_BUDGET))
    if mode == "power_loss":
        # the power-loss action at draw weight 4.5, three times the
        # soak's 1.5: at 1.5 the 8-10 draws of an 8 s run held none in 3
        # of 20 runs of the JAX package's soak and 1 of 20 of the port's
        # (every history linearizable), so the gate below rested on the
        # draw
        monkeypatch.setattr(soak, "NemesisAction", _upweighted(
            soak.NemesisAction, "power-loss", 4.5))
    r = await asyncio.wait_for(soak.run_soak(
        duration_s=8, n_stores=3, n_keys=4, seed=3,
        data_path=str(tmp_path), verbose=False, **{mode: True}), 110)
    assert r["linearizable"], r
    assert _FAULT_MODES[mode](r) > 0, r
    assert r.get("disk_pressure_ok", True), r


def test_cli_refuses_gray_with_the_engine_as_the_reference_does(tmp_path):
    """--gray --engine: the port's CLI fails with the JAX package's own
    refusal (the fault plane reaches the Python storage planes only,
    not the multilog's fd-level fsyncs) and prints no result."""
    from examples import soak as ref_soak

    with pytest.raises(ValueError) as ref:
        asyncio.run(ref_soak.run_soak(1, 3, 4, 0, str(tmp_path), False,
                                      engine=True, gray=True))
    proc = subprocess.run(
        [sys.executable, "-m", "tpuraft_torch.examples.soak", "--gray",
         "--engine", "--duration", "1", "--data", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stderr.rstrip().endswith(f"ValueError: {ref.value}")
    assert proc.stdout == ""
