"""Multi-process RheaKV cluster supervisor: real OS processes per store.

The process-fabric half of the serving plane: every store (and,
optionally, every PD member) runs as its own OS process — its own
CPython, its own GIL, its own event loop — started from
``examples.rheakv_server`` / ``examples.pd_server`` mains.  This is the
topology the paper's deployment section assumes (one store per host),
and the one every committed cross-process bench row uses: a
single-process multi-store loop shares one interpreter, so its numbers
carry a "client and servers contend for one core" asterisk that this
fabric retires.

Pieces:

- :class:`StoreProcess` — one supervised child: spawn, READY-line
  readiness probe, SIGTERM drain / SIGKILL crash, exit reaping,
  ``/proc/<pid>/stat`` CPU attribution, ``/metrics`` scrape.
- :class:`ProcSupervisor` — a set of StoreProcesses with crash
  detection and supervised restart (exponential backoff), plus
  cluster-wide readiness / drain / stop.
- ``--soak`` CLI — a short chaos soak: concurrent client load, leader
  SIGKILL mid-run, supervised restart, and the recorded client history
  checked linearizable (``tpuraft.util.linearizability``).

Tests wrap this through ``tests/proc_cluster.py`` (ephemeral ports +
pytest teardown); benches through ``examples/rheakv_bench_multiproc``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from collections import deque
from typing import Optional

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def free_endpoints(n: int, host: str = "127.0.0.1") -> list[str]:
    """Reserve ``n`` distinct free ports and return host:port endpoints.

    The sockets are closed before the children bind — the usual
    best-effort race every multi-process test harness accepts (ports
    come from the ephemeral range; collisions surface as a failed
    READY probe, not silent misbehavior)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
        return [f"{host}:{s.getsockname()[1]}" for s in socks]
    finally:
        for s in socks:
            s.close()


# graftcheck: loop-confined — the reader thread only ever touches the
# threading primitives (ready Event, tail deque, info dict assignment);
# all process control and asyncio integration happen on the caller's
# loop via run_in_executor
class StoreProcess:
    """One supervised server child (a store, or a PD member).

    ``argv`` is the full child command line (``sys.executable -m ...``
    is prepended by the caller via :func:`server_argv` /
    :func:`pd_argv`).  stdout is line-buffered into a diagnostic tail;
    a ``READY {json}`` line arms the readiness event, ``DRAINED
    {json}`` records the drain verdict.
    """

    def __init__(self, endpoint: str, argv: list[str],
                 name: Optional[str] = None, tail_lines: int = 60):
        self.endpoint = endpoint
        self.name = name or endpoint
        self.argv = list(argv)
        self.proc: Optional[subprocess.Popen] = None
        self.ready = threading.Event()
        self.info: dict = {}          # parsed READY payload
        self.drained: Optional[dict] = None   # parsed DRAINED payload
        self.tail: deque[str] = deque(maxlen=tail_lines)
        self.spawns = 0
        self._reader: Optional[threading.Thread] = None
        self._t0 = 0.0

    # -- lifecycle -------------------------------------------------------

    def spawn(self) -> None:
        assert self.proc is None or self.proc.poll() is not None
        self.ready.clear()
        self.drained = None
        self.info = {}
        self.spawns += 1
        self._t0 = time.monotonic()
        self.proc = subprocess.Popen(
            self.argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        self._reader = threading.Thread(
            target=self._read_stdout, args=(self.proc,),
            name=f"stdout-{self.name}", daemon=True)
        self._reader.start()

    def _read_stdout(self, proc: subprocess.Popen) -> None:
        for line in proc.stdout:   # EOF on child exit
            line = line.rstrip("\n")
            self.tail.append(line)
            if line.startswith("READY "):
                try:
                    self.info = json.loads(line[len("READY "):])
                except ValueError:
                    self.info = {}
                self.ready.set()
            elif line.startswith("DRAINED "):
                try:
                    self.drained = json.loads(line[len("DRAINED "):])
                except ValueError:
                    self.drained = {"clean": False}
        proc.stdout.close()

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def returncode(self) -> Optional[int]:
        return self.proc.poll() if self.proc is not None else None

    async def wait_ready(self, timeout_s: float = 30.0) -> dict:
        """Await the child's READY line (readiness probe: client traffic
        must not be pointed at a store that has not printed it)."""
        loop = asyncio.get_running_loop()
        ok = await loop.run_in_executor(
            None, self.ready.wait, timeout_s)
        if not ok:
            raise TimeoutError(
                f"{self.name}: no READY within {timeout_s}s "
                f"(rc={self.returncode()}, tail={list(self.tail)[-5:]})")
        return self.info

    def terminate(self) -> None:
        """SIGTERM: the child drains (in-flight acks, new work bounced)
        and exits 0."""
        if self.alive():
            self.proc.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        """SIGKILL: crash-stop, no drain — the supervised-restart path."""
        if self.alive():
            self.proc.kill()

    async def wait_exit(self, timeout_s: float = 30.0) -> int:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self.proc.wait, timeout_s)

    # -- observability ---------------------------------------------------

    def cpu_seconds(self) -> Optional[float]:
        """utime+stime burned by THIS child (``/proc/<pid>/stat``) —
        the per-store CPU attribution the committed bench rows carry."""
        if not self.alive():
            return None
        try:
            with open(f"/proc/{self.proc.pid}/stat") as f:
                fields = f.read().rsplit(") ", 1)[1].split()
            # fields[11]/[12] are utime/stime (post-comm offsets 14/15)
            return (int(fields[11]) + int(fields[12])) / _CLK_TCK
        except (OSError, IndexError, ValueError):
            return None

    def scrape_metrics(self) -> dict[str, float]:
        """Blocking GET /metrics on the child's ephemeral metrics port
        (from its READY payload), parsed into {name: value}.  Call via
        run_in_executor from async code."""
        port = self.info.get("metrics_port")
        if not port:
            return {}
        out: dict[str, float] = {}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5.0) as resp:
            for raw in resp.read().decode().splitlines():
                if not raw or raw.startswith("#"):
                    continue
                name, _, val = raw.rpartition(" ")
                try:
                    out[name] = float(val)
                except ValueError:
                    continue
        return out


def server_argv(endpoint: str, stores: list[str], regions: int, data: str,
                transport: str = "tcp", store: str = "memory",
                log_scheme: str = "file", pd: str = "",
                eto_ms: int = 1000, apply_lane: bool = False,
                engine: bool = False,
                drain_timeout_s: float = 10.0, boot_delay_s: float = 0.0,
                metrics_port: Optional[int] = 0) -> list[str]:
    """Command line for one ``examples.rheakv_server`` child."""
    argv = [sys.executable, "-m", "tpuraft_torch.examples.rheakv_server",
            "--serve", endpoint, "--stores", ",".join(stores),
            "--regions", str(regions), "--data", data,
            "--transport", transport, "--store", store,
            "--log-scheme", log_scheme,
            "--eto-ms", str(eto_ms),
            "--drain-timeout", str(drain_timeout_s)]
    if pd:
        argv += ["--pd", pd]
    if apply_lane:
        argv += ["--apply-lane"]
    if engine:
        argv += ["--engine"]
    if boot_delay_s:
        argv += ["--boot-delay", str(boot_delay_s)]
    if metrics_port is not None:
        argv += ["--metrics-port", str(metrics_port)]
    return argv


def pd_argv(endpoint: str, pd_endpoints: list[str], data: str,
            transport: str = "tcp", seed_regions: int = 0,
            split_keys: int = 0) -> list[str]:
    """Command line for one ``examples.pd_server`` child."""
    argv = [sys.executable, "-m", "tpuraft_torch.examples.pd_server",
            "--serve", endpoint, "--pd", ",".join(pd_endpoints),
            "--data", data, "--transport", transport]
    if seed_regions:
        argv += ["--seed-regions", str(seed_regions)]
    if split_keys:
        argv += ["--split-keys", str(split_keys)]
    return argv


# graftcheck: loop-confined — procs list and restart bookkeeping are
# touched only from the supervising event loop; the children are OS
# processes reached via signals
class ProcSupervisor:
    """A set of :class:`StoreProcess` children under one supervisor:
    spawn-all / ready-all / drain-all, crash detection, and supervised
    restart with exponential backoff (0.2s doubling to 2s) — the
    fabric's answer to SIGKILL: the store comes back, replays its raft
    log, and rejoins; nothing acked is lost.

    A restart-storm circuit breaker guards the respawn path: a child
    that crashes ``storm_threshold`` times inside a rolling
    ``storm_window_s`` window is marked FAILED (``self.failed``) and
    left down — crash loops (poisoned journal, full volume) need an
    operator, not another respawn."""

    #: restart-storm circuit breaker defaults: a child that crashes
    #: STORM_THRESHOLD times inside a rolling STORM_WINDOW_S window is
    #: marked FAILED and no longer respawned — a store crash-looping on
    #: a poisoned journal or a full volume otherwise burns CPU forever
    #: while masquerading as "supervised" in every scrape.
    STORM_THRESHOLD = 5
    STORM_WINDOW_S = 30.0

    def __init__(self, procs: list[StoreProcess],
                 storm_threshold: Optional[int] = None,
                 storm_window_s: Optional[float] = None):
        self.procs = list(procs)
        self.restarts = 0
        self.storm_threshold = (self.STORM_THRESHOLD
                                if storm_threshold is None
                                else storm_threshold)
        self.storm_window_s = (self.STORM_WINDOW_S
                               if storm_window_s is None
                               else storm_window_s)
        self.failed: dict[str, str] = {}   # endpoint -> reason
        self._watch: Optional[asyncio.Task] = None
        self._stopping = False
        self._backoff: dict[str, float] = {}
        self._crash_times: dict[str, deque[float]] = {}

    def by_endpoint(self, endpoint: str) -> StoreProcess:
        for p in self.procs:
            if p.endpoint == endpoint:
                return p
        raise KeyError(endpoint)

    async def start(self, ready_timeout_s: float = 30.0) -> None:
        for p in self.procs:
            p.spawn()
        await self.wait_all_ready(ready_timeout_s)

    async def wait_all_ready(self, timeout_s: float = 30.0) -> None:
        await asyncio.gather(*(p.wait_ready(timeout_s)
                               for p in self.procs))

    def supervise(self) -> None:
        """Arm the crash watcher: any child that exits while the
        supervisor is not stopping gets respawned after backoff."""
        if self._watch is None or self._watch.done():
            self._watch = asyncio.ensure_future(self._watch_loop())

    async def _watch_loop(self) -> None:
        try:
            while not self._stopping:
                for p in self.procs:
                    if p.endpoint in self.failed:
                        continue
                    if p.proc is not None and not p.alive():
                        now = time.monotonic()
                        crashes = self._crash_times.setdefault(
                            p.endpoint, deque())
                        crashes.append(now)
                        while crashes and \
                                now - crashes[0] > self.storm_window_s:
                            crashes.popleft()
                        if len(crashes) >= self.storm_threshold:
                            reason = (f"{len(crashes)} crashes in "
                                      f"{self.storm_window_s:.0f}s "
                                      f"(last rc={p.returncode()})")
                            self.failed[p.endpoint] = reason
                            print(f"supervisor: {p.name} FAILED — "
                                  f"restart storm: {reason}; not "
                                  f"respawning", flush=True)
                            continue
                        delay = self._backoff.get(p.endpoint, 0.2)
                        self._backoff[p.endpoint] = min(delay * 2, 2.0)
                        self.restarts += 1
                        print(f"supervisor: {p.name} exited "
                              f"rc={p.returncode()}; restarting in "
                              f"{delay:.1f}s", flush=True)
                        await asyncio.sleep(delay)
                        if self._stopping:
                            return
                        p.spawn()
                await asyncio.sleep(0.1)
        except asyncio.CancelledError:
            return

    async def stop(self, drain_timeout_s: float = 15.0) -> None:
        """SIGTERM everything (clean drain), SIGKILL stragglers."""
        self._stopping = True
        if self._watch is not None:
            self._watch.cancel()
            self._watch = None
        for p in self.procs:
            p.terminate()
        deadline = time.monotonic() + drain_timeout_s

        async def reap(p: StoreProcess) -> None:
            if p.proc is None:
                return
            try:
                await p.wait_exit(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                await p.wait_exit(5.0)

        await asyncio.gather(*(reap(p) for p in self.procs))

    def cpu_seconds(self) -> dict[str, Optional[float]]:
        return {p.name: p.cpu_seconds() for p in self.procs}

    async def scrape_all(self) -> dict[str, dict[str, float]]:
        loop = asyncio.get_running_loop()

        async def one(p: StoreProcess):
            try:
                return p.name, await loop.run_in_executor(
                    None, p.scrape_metrics)
            except Exception:  # noqa: BLE001 — scrape is best-effort
                return p.name, {}

        out = dict(await asyncio.gather(
            *(one(p) for p in self.procs if p.alive())))
        # circuit-broken children are still part of the fleet view: a
        # FAILED store scrapes as a sentinel row, not a silent absence
        for p in self.procs:
            if p.endpoint in self.failed:
                out[p.name] = {"proc_supervisor_failed": 1.0}
        return out


# ---------------------------------------------------------------------------
# --soak: short multi-process chaos soak (leader SIGKILL + supervised
# restart under concurrent load, history checked linearizable)
# ---------------------------------------------------------------------------

async def _soak(seconds: float, stores_n: int, regions: int, data: str,
                transport: str, apply_lane: bool,
                engine: bool = False) -> int:
    from tpuraft_torch.examples.rheakv_server import client_for
    from tpuraft_torch.util.linearizability import History, check_history

    endpoints = free_endpoints(stores_n)
    sup = ProcSupervisor([
        StoreProcess(ep, server_argv(
            ep, endpoints, regions, data, transport=transport,
            eto_ms=500, apply_lane=apply_lane, engine=engine,
            metrics_port=None))
        for ep in endpoints])
    await sup.start()
    sup.supervise()
    if transport == "native":
        from tpuraft_torch.rpc.native_tcp import NativeTcpTransport
        tp = NativeTcpTransport()
    else:
        from tpuraft_torch.rpc.tcp import TcpTransport
        tp = TcpTransport()
    kv = client_for(endpoints, regions, transport=tp, max_retries=12)
    await kv.start()

    h = History()
    stop = asyncio.Event()
    keys = [b"soak-%d" % i for i in range(4)]

    async def worker(cid: int) -> None:
        n = 0
        while not stop.is_set():
            n += 1
            key = keys[n % len(keys)]
            if n % 2 == 0:
                val = b"c%d-%d" % (cid, n)
                tok = h.invoke(cid, "w", (key, val))
                try:
                    await asyncio.wait_for(kv.put(key, val), 6.0)
                    h.complete(tok, True)
                except Exception:  # noqa: BLE001 — indeterminate op
                    pass
            else:
                tok = h.invoke(cid, "r", (key,))
                try:
                    v = await asyncio.wait_for(kv.get(key), 6.0)
                    h.complete(tok, v)
                except Exception:  # noqa: BLE001 — indeterminate op
                    pass
            await asyncio.sleep(0.003)

    workers = [asyncio.ensure_future(worker(i)) for i in range(4)]
    await asyncio.sleep(max(1.0, seconds / 3))
    # SIGKILL whichever store the client believes leads region 1 (fall
    # back to the first store): crash-stop, then the supervisor's
    # restart brings it back and raft-log replay restores it
    victim_peer = kv._leaders.get(1)
    victim_ep = ":".join(victim_peer.split("/", 1)[0].split(":")[:2]) \
        if victim_peer else endpoints[0]
    victim = sup.by_endpoint(victim_ep)
    print(f"soak: SIGKILL leader store {victim_ep}", flush=True)
    victim.kill()
    await asyncio.sleep(max(1.0, seconds / 3))
    await victim.wait_ready(30.0)      # supervised restart came back
    await asyncio.sleep(max(1.0, seconds / 3))
    stop.set()
    await asyncio.gather(*workers)

    ops = h.ops()
    done = sum(1 for o in ops if o.ret is not None)
    rep = check_history(h)
    cpu = sup.cpu_seconds()
    await kv.shutdown()
    await tp.close()
    await sup.stop()
    print(json.dumps({
        "soak_seconds": seconds, "stores": stores_n, "regions": regions,
        "ops_total": len(ops), "ops_done": done,
        "restarts": sup.restarts,
        "failed_stores": dict(sup.failed),
        "linearizable": bool(rep.ok),
        "cpu_seconds": cpu}, indent=2), flush=True)
    if not rep.ok:
        print(f"HISTORY NOT LINEARIZABLE: {rep}", file=sys.stderr)
        return 1
    if done < 50:
        print(f"too few completed ops: {done}", file=sys.stderr)
        return 1
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--soak", action="store_true",
                    help="run the multi-process chaos soak")
    ap.add_argument("--seconds", type=float, default=9.0)
    ap.add_argument("--stores", type=int, default=3)
    ap.add_argument("--regions", type=int, default=2)
    ap.add_argument("--data", default="/tmp/tpuraft-proc-soak")
    ap.add_argument("--transport", choices=["tcp", "native"],
                    default="tcp")
    ap.add_argument("--apply-lane", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="children drive their region nodes from ONE "
                         "MultiRaftEngine each (fused [G] tick) instead "
                         "of per-node timers")
    args = ap.parse_args()
    if not args.soak:
        ap.error("nothing to do (pass --soak)")
    import shutil
    shutil.rmtree(args.data, ignore_errors=True)
    rc = asyncio.run(_soak(args.seconds, args.stores, args.regions,
                           args.data, args.transport, args.apply_lane,
                           engine=args.engine))
    sys.exit(rc)


if __name__ == "__main__":
    main()
