"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each
cell names a configuration (its ``file`` under ``benchmark/configs/``)
and a traffic mix (``benchmark/traffic/<traffic>.json``).  A
configuration names its runner (``benchmark/runners/<runner>.py``), and
every metric, end-to-end or per layer, is read by
``benchmark/metrics/<name>.py``.  A later cell or metric is added by
adding such files and entries; no file here changes for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_spec(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload`` with its configuration, its traffic
    and the metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _applies(m, workload) and m["moves"] in names]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def runner(config: dict):
    """The runner module a configuration names."""
    return importlib.import_module(f"benchmark.runners.{config['runner']}")


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", metric_name + ".py")
    mod_name = "benchmark_metric_" + metric_name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
