#!/usr/bin/env python3
"""The port's pre-merge perf gate: short runs of the port's benches at
the calibrated shapes must not fall more than a threshold (default
20 %) under a calibration taken on the same device.  The counterpart of
``bench_gate.py``, over the ``bench_torch_*`` scripts, with the engines
on ``cuda:0``.

Absolute rows, each against its calibration:

  e2e_commits_per_sec      ``bench_torch_e2e.py``: store processes,
                           the engine-backed commit path
  engine_ticks_per_sec     ``bench_torch_multichip.py --engine-shape``:
                           the single-device engine tick rate
  kv_ops_per_sec           ``bench_torch_region_density.py``: the whole
                           RheaKV serving stack at ``gate_regions``
  kv_read_ops_per_sec      the same at a 95/5 read mix
  kv_write_ops_per_sec     the same, pure writes from 256 workers
  kv_mp_write_ops_per_sec  ``bench_torch_multiproc.py``: the same write
                           shape with every store an OS process

Same-session rows, run only when ``kv_ops_per_sec`` reads OK, each
against a measurement of this session (environment threshold, default):

  kv_ops_traced            5 %-sampled tracing vs the untraced kv row
                           (BENCH_GATE_TRACE_THRESHOLD, 0.05)
  kv_ops_heat_overhead     the kv row vs a ``--no-heat`` run
                           (BENCH_GATE_HEAT_THRESHOLD, 0.03)
  kv_ops_disk_guard        the kv row vs a ``--no-disk-guard`` run
                           (BENCH_GATE_DISK_THRESHOLD, 0.02)
  kv_ops_clocked           a ``--chaos-clock`` run vs the kv row
                           (BENCH_GATE_CLOCK_THRESHOLD, 0.02)
  kv_ops_lifecycle_overhead a ``--lifecycle-pd`` run vs the kv row
                           (BENCH_GATE_LIFECYCLE_THRESHOLD, 0.03)

A row's floor is its calibration x (1 - threshold).  A run under the
floor is run again, up to BENCH_GATE_RETRIES (2) more times, and the
best counts.  Runs last BENCH_GATE_DURATION (6) seconds.

The calibration is the port's own file, ``BENCH_TORCH_GATE.json`` (or
``--calibration PATH``): the shapes and the recorded values under
``e2e`` and ``kv``, and the device they were taken on (the card's name
and power limit as nvidia-smi gives them, or ``cpu``).  ``--record``
runs each absolute row twice and stores the best; it fills the shapes
it finds missing with the committed ones below.  The gate falls back to
nothing: a missing file, a missing row calibration or a calibration of
another device is exit 2.

Exit 0: every row passed.  1: a regression.  2: the gate could not run
(no calibration, another device, a bench that failed; without a card
and without ``--cpu`` the engines' "no CUDA device" error).  Every
row's report prints as one JSON line at the end.

    python3 bench_torch_gate.py --record     # calibrate on this card
    python3 bench_torch_gate.py              # gate against it
    python3 bench_torch_gate.py --cpu --calibration PATH  # engines on the CPU
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CALIBRATION = os.path.join(REPO, "BENCH_TORCH_GATE.json")

# the committed shapes: BENCH_E2E.json's and BENCH_REGIONS.json's gate
# keys, and the multiproc row's runner defaults
E2E_SHAPE = {"groups": 256, "stores": 3, "window_per_group": 8,
             "payload_bytes": 16, "gate_engine_groups": 1024,
             "gate_engine_duration_s": 2.0}
KV_SHAPE = {"gate_regions": 128, "gate_eto_ms": 1000,
            "gate_mp_regions": 128, "gate_mp_eto_ms": 10000}

# same-session rows: (name, threshold variable, its default, the
# measured run's knobs, the comparator run's knobs or None for the kv
# row's own measurement, the report key the comparator goes under)
SAME_SESSION = (
    ("kv_ops_traced", "BENCH_GATE_TRACE_THRESHOLD", "0.05",
     {"trace_sample": 0.05}, None, "untraced"),
    ("kv_ops_heat_overhead", "BENCH_GATE_HEAT_THRESHOLD", "0.03",
     {}, {"heat_off": True}, "heat_off"),
    ("kv_ops_disk_guard", "BENCH_GATE_DISK_THRESHOLD", "0.02",
     {}, {"disk_guard_off": True}, "disk_guard_off"),
    ("kv_ops_clocked", "BENCH_GATE_CLOCK_THRESHOLD", "0.02",
     {"chaos_clock": True}, None, "uninjected"),
    ("kv_ops_lifecycle_overhead", "BENCH_GATE_LIFECYCLE_THRESHOLD", "0.03",
     {"lifecycle_pd": True}, None, "fake_pd"),
)


def _env() -> dict:
    """The children's environment: this one, the repo on the path, and
    no JAX_PLATFORMS (no port script reads it)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    return env


def _read_row(out_path: str, key: str, what: str) -> float:
    with open(out_path) as f:
        row = json.load(f).get(key, {})
    if "ops_per_sec" not in row:
        raise RuntimeError(f"{what} produced no {key}.ops_per_sec")
    return float(row["ops_per_sec"])


def _run_e2e_once(extra: dict, duration: float, cpu: bool = False) -> float:
    """One short ``bench_torch_e2e.py`` run at the calibrated shape;
    returns commits/s or raises RuntimeError when the bench fails."""
    with tempfile.TemporaryDirectory(prefix="tpuraft_torch_gate_") as d:
        out_path = os.path.join(d, "gate.json")
        cmd = [sys.executable, os.path.join(REPO, "bench_torch_e2e.py"),
               "--groups", str(extra.get("groups", 64)),
               "--stores", str(extra.get("stores", 3)),
               "--window", str(extra.get("window_per_group", 8)),
               "--payload", str(extra.get("payload_bytes", 16)),
               "--duration", str(duration), "--warmup", "2",
               "--skip-brk", "--out", out_path] + (["--cpu"] if cpu else [])
        print("bench-gate:", " ".join(cmd), flush=True)
        rc = subprocess.call(cmd, env=_env())
        if rc != 0 or not os.path.exists(out_path):
            raise RuntimeError(f"bench run failed (rc={rc})")
        with open(out_path) as f:
            return float(json.load(f)["value"])


def _run_kv_once(extra: dict, duration: float,
                 read_frac: float = -1.0,
                 trace_sample: float = 0.0,
                 heat_off: bool = False,
                 disk_guard_off: bool = False,
                 chaos_clock: bool = False,
                 lifecycle_pd: bool = False,
                 workers: int = 0,
                 cpu: bool = False) -> float:
    """One short ``bench_torch_region_density.py`` run at the gate shape;
    returns KV ops/s through the whole serving stack.  The knobs pick the
    read mix, the worker count and the same-session rows' A/B switches;
    the row is read under the key the script files it by."""
    regions = int(extra.get("gate_regions", 128))
    with tempfile.TemporaryDirectory(prefix="tpuraft_torch_gate_kv_") as d:
        out_path = os.path.join(d, "gate_regions.json")
        cmd = [sys.executable,
               os.path.join(REPO, "bench_torch_region_density.py"),
               "--regions", str(regions),
               "--duration", str(duration),
               "--election-timeout-ms", str(extra.get("gate_eto_ms", 1000)),
               "--out", out_path]
        key = "row" if regions == 1024 else f"row_{regions}"
        if workers > 0:
            cmd += ["--workers", str(workers)]
            if workers != 24:
                key += f"_w{workers}"
        if read_frac >= 0:
            cmd += ["--read-frac", str(read_frac)]
            key += f"_r{int(round(read_frac * 100))}"
        if trace_sample > 0:
            cmd += ["--trace-sample", str(trace_sample)]
        for on, flag, suffix in ((heat_off, "--no-heat", "_noheat"),
                                 (disk_guard_off, "--no-disk-guard", "_nodg"),
                                 (chaos_clock, "--chaos-clock", "_ck"),
                                 (lifecycle_pd, "--lifecycle-pd", "_lcpd")):
            if on:
                cmd.append(flag)
                key += suffix
        if cpu:
            cmd.append("--cpu")
        print("bench-gate:", " ".join(cmd), flush=True)
        rc = subprocess.call(cmd, env=_env())
        if rc != 0 or not os.path.exists(out_path):
            raise RuntimeError(f"kv bench run failed (rc={rc})")
        return _read_row(out_path, key, "kv bench")


def _run_mp_once(extra: dict, duration: float) -> float:
    """One short ``bench_torch_multiproc.py`` run at the gate shape: the
    stores are OS processes serving the pure-write shape over real
    sockets; returns cross-process KV ops/s.  No engine runs in it, so
    it takes no ``--cpu``."""
    regions = int(extra.get("gate_mp_regions", 128))
    with tempfile.TemporaryDirectory(prefix="tpuraft_torch_gate_mp_") as d:
        out_path = os.path.join(d, "gate_mp.json")
        cmd = [sys.executable, os.path.join(REPO, "bench_torch_multiproc.py"),
               "--regions", str(regions),
               "--duration", str(duration),
               "--workers", "256",
               # a long election timeout keeps the timers' standing load
               # flat, so the short window measures serving
               "--election-timeout-ms",
               str(extra.get("gate_mp_eto_ms", 10000)),
               "--out", out_path]
        key = ("row_mp" if regions == 1024 else f"row_mp_{regions}") \
            + "_w256_r0"
        print("bench-gate:", " ".join(cmd), flush=True)
        rc = subprocess.call(cmd, env=_env())
        if rc != 0 or not os.path.exists(out_path):
            raise RuntimeError(f"mp bench run failed (rc={rc})")
        return _read_row(out_path, key, "mp bench")


def _run_engine_once(extra: dict, cpu: bool = False) -> float:
    """One ``bench_torch_multichip.py --engine-shape`` run: the single
    engine's tick rate at the leader-heavy shape, every tick one fused-
    tick launch on the card."""
    cmd = [sys.executable, os.path.join(REPO, "bench_torch_multichip.py"),
           "--engine-shape",
           "--groups", str(extra.get("gate_engine_groups", 1024)),
           "--duration", str(extra.get("gate_engine_duration_s", 2.0))] \
        + (["--cpu"] if cpu else [])
    print("bench-gate:", " ".join(cmd), flush=True)
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"engine shape bench failed "
                           f"(rc={out.returncode}): {out.stderr[-300:]}")
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return float(json.loads(
                line[len("RESULT "):])["engine_ticks_per_sec"])
    raise RuntimeError("engine shape bench produced no RESULT line")


def _gate(name: str, committed: float, run_once, threshold: float,
          retries: int) -> tuple[int, dict]:
    """Best of up to 1 + ``retries`` runs against committed x (1 -
    threshold), stopping at the first that reaches it; a run that raises
    RuntimeError makes the row BROKEN.  Returns (exit code, report)."""
    floor = committed * (1.0 - threshold)
    best, runs = 0.0, 0
    try:
        for attempt in range(1 + max(0, retries)):
            best = max(best, run_once())
            runs = attempt + 1
            if best >= floor:
                break
            if attempt < retries:
                print(f"bench-gate[{name}]: {best:.1f} < floor {floor:.1f}, "
                      f"retrying ({attempt + 1}/{retries})", flush=True)
    except RuntimeError as exc:
        print(f"bench-gate[{name}]: {exc}")
        return 2, {"gate": name, "verdict": "BROKEN", "error": str(exc)}
    verdict = "OK" if best >= floor else "REGRESSION"
    report = {
        "gate": name,
        "committed": committed,
        "measured": round(best, 1),
        "floor": round(floor, 1),
        "threshold": threshold,
        "runs": runs,
        "verdict": verdict,
    }
    return (0 if verdict == "OK" else 1), report


def device_name(cpu: bool):
    """What a calibration is taken on: ``cpu``, or the first card's name
    and power limit as nvidia-smi gives them (None where it reads no
    card: the benches then fail with the engines' own error)."""
    if cpu:
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0].strip() if smi.returncode == 0 and lines else None


def _write_json(path: str, data: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def record(path: str, cal: dict, device, duration: float,
           cpu: bool) -> int:
    """Best of two short runs of each absolute row, stored beside the
    device they ran on."""
    e2e = cal.setdefault("e2e", {})
    kv = cal.setdefault("kv", {})
    for extra, shape in ((e2e, E2E_SHAPE), (kv, KV_SHAPE)):
        for k, v in shape.items():
            extra.setdefault(k, v)
    try:
        e2e_best = max(_run_e2e_once(e2e, duration, cpu=cpu)
                       for _ in range(2))
        kv_best = max(_run_kv_once(kv, duration, cpu=cpu) for _ in range(2))
        read_best = max(_run_kv_once(kv, duration, read_frac=0.95, cpu=cpu)
                        for _ in range(2))
        write_best = max(_run_kv_once(kv, duration, read_frac=0.0,
                                      workers=256, cpu=cpu)
                         for _ in range(2))
        mp_best = max(_run_mp_once(kv, duration) for _ in range(2))
        engine_best = max(_run_engine_once(e2e, cpu=cpu) for _ in range(2))
    except RuntimeError as exc:
        print(f"bench-gate: {exc}")
        return 2
    e2e["gate_commits_per_sec"] = round(e2e_best, 1)
    e2e["gate_engine_ticks_per_sec"] = round(engine_best, 1)
    e2e["gate_duration_s"] = duration
    kv["gate_kv_ops_per_sec"] = round(kv_best, 1)
    kv["gate_read_ops_per_sec"] = round(read_best, 1)
    kv["gate_write_ops_per_sec"] = round(write_best, 1)
    kv["gate_mp_write_ops_per_sec"] = round(mp_best, 1)
    kv["gate_duration_s"] = duration
    cal["device"] = device
    _write_json(path, cal)
    print(json.dumps({"gate": "recorded", "device": device,
                      **{k: v for k, v in (*e2e.items(), *kv.items())
                         if k.endswith("_per_sec")},
                      "duration_s": duration}))
    return 0


def _say_wall(name: str, rep: dict, t0: float) -> None:
    print(f"bench-gate[{name}]: {rep['verdict']} in "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def _absolute(reports: list, name: str, extra: dict, key: str, run_once,
              threshold: float, retries: int) -> int:
    """An absolute row against its calibration ``extra[key]``; BROKEN
    where there is none."""
    t0 = time.monotonic()
    if key not in extra:
        print(f"bench-gate[{name}]: no calibration "
              f"(run `python3 bench_torch_gate.py --record`)")
        rc, rep = 2, {"gate": name, "verdict": "BROKEN",
                      "error": f"no {key} calibration"}
    else:
        rc, rep = _gate(name, float(extra[key]), run_once, threshold,
                        retries)
    reports.append(rep)
    _say_wall(name, rep, t0)
    return rc


def _same_session(reports: list, kv_rep: dict, kv: dict, duration: float,
                  retries: int, cpu: bool) -> int:
    """The same-session rows, each against the kv row's measurement or a
    comparator run of this session."""
    worst = 0
    for name, var, default, knobs, comparator, as_key in SAME_SESSION:
        t0 = time.monotonic()
        threshold = float(os.environ.get(var, default))
        if comparator is None:
            base = float(kv_rep["measured"])
            shown = kv_rep["measured"]
        else:
            try:
                base = _run_kv_once(kv, duration, cpu=cpu, **comparator)
            except RuntimeError as exc:
                print(f"bench-gate[{name}]: {exc}")
                worst = 2
                reports.append({"gate": name, "verdict": "BROKEN",
                                "error": str(exc)})
                _say_wall(name, reports[-1], t0)
                continue
            shown = round(base, 1)
        rc, rep = _gate(name, base,
                        lambda kw=knobs: _run_kv_once(kv, duration, cpu=cpu,
                                                      **kw),
                        threshold, retries)
        rep[as_key] = shown
        reports.append(rep)
        worst = max(worst, rc)
        _say_wall(name, rep, t0)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--record", action="store_true",
                    help="(re)calibrate every absolute row on this device")
    ap.add_argument("--cpu", action="store_true",
                    help="the engines on the CPU (a rehearsal; calibrates "
                         "and gates against a 'cpu' calibration)")
    ap.add_argument("--calibration", default=DEFAULT_CALIBRATION,
                    help="the calibration file (default: "
                         "BENCH_TORCH_GATE.json at the root)")
    args = ap.parse_args(argv)
    threshold = float(os.environ.get("BENCH_GATE_THRESHOLD", "0.20"))
    duration = float(os.environ.get("BENCH_GATE_DURATION", "6"))
    retries = int(os.environ.get("BENCH_GATE_RETRIES", "2"))
    device = device_name(args.cpu)
    path = os.path.abspath(args.calibration)
    cal = {}
    if os.path.exists(path):
        with open(path) as f:
            cal = json.load(f)
    if args.record:
        return record(path, cal, device, duration, args.cpu)
    if not cal:
        print(f"bench-gate: no calibration at {path} "
              f"(run `python3 bench_torch_gate.py --record`)")
        return 2
    if device is not None and cal.get("device") != device:
        print(f"bench-gate: the calibration was taken on "
              f"{cal.get('device')!r}, this is {device!r} "
              f"(run `python3 bench_torch_gate.py --record` here)")
        return 2
    e2e, kv, cpu = cal.get("e2e", {}), cal.get("kv", {}), args.cpu
    reports: list = []
    worst = max(
        _absolute(reports, "e2e_commits_per_sec", e2e, "gate_commits_per_sec",
                  lambda: _run_e2e_once(e2e, duration, cpu=cpu),
                  threshold, retries),
        _absolute(reports, "engine_ticks_per_sec", e2e,
                  "gate_engine_ticks_per_sec",
                  lambda: _run_engine_once(e2e, cpu=cpu), threshold, retries),
        _absolute(reports, "kv_ops_per_sec", kv, "gate_kv_ops_per_sec",
                  lambda: _run_kv_once(kv, duration, cpu=cpu),
                  threshold, retries))
    if reports[-1]["verdict"] == "OK":
        worst = max(worst, _same_session(reports, reports[-1], kv, duration,
                                         retries, cpu))
    worst = max(
        worst,
        _absolute(reports, "kv_read_ops_per_sec", kv, "gate_read_ops_per_sec",
                  lambda: _run_kv_once(kv, duration, read_frac=0.95, cpu=cpu),
                  threshold, retries),
        _absolute(reports, "kv_write_ops_per_sec", kv,
                  "gate_write_ops_per_sec",
                  lambda: _run_kv_once(kv, duration, read_frac=0.0,
                                       workers=256, cpu=cpu),
                  threshold, retries),
        _absolute(reports, "kv_mp_write_ops_per_sec", kv,
                  "gate_mp_write_ops_per_sec",
                  lambda: _run_mp_once(kv, duration), threshold, retries))
    for rep in reports:
        print(json.dumps(rep))
    return worst


if __name__ == "__main__":
    sys.exit(main())
