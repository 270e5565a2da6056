"""Admin CLI: cluster operations against a live raft group over TCP.

Reference parity: the operator surface of ``CliService`` (SURVEY.md
§3.1 "CLI service & processors") as a command-line tool, the way the
reference's jraft-example tooling drives CliServiceImpl.

    python -m examples.admin --group counter \\
        --peers 127.0.0.1:8081,127.0.0.1:8082,127.0.0.1:8083 <command>

Commands:
    leader                    print the current leader
    peers                     print voters (and learners)
    snapshot <peer>           trigger an on-demand snapshot on <peer>
    transfer <peer>           transfer leadership to <peer>
    add-peer <peer>           add a voter
    remove-peer <peer>        remove a voter
    add-witness <peer>        add a WITNESS voter (votes, stores no
                              log payload, never leads — geo 2+1)
    remove-witness <peer>     remove a witness voter
    change-peers <p1,p2,...>  arbitrary membership change (tokens may
                              carry /witness or /learner suffixes)
    add-learners <p1,...>     add read-only replicas
    remove-learners <p1,...>  remove read-only replicas
    reset-learners <p1,...>   replace the learner set atomically
    reset-learners none       clear the learner set
    metrics [endpoint]        scrape live metrics (Prometheus text)
                              from one store (default: first peer that
                              answers) over the admin transport
    storage [endpoint]        disk-pressure dashboard: per-store disk
                              usage, pressure level, ENOSPC count and
                              the reclaim/shed/resume counters, parsed
                              from the same metrics plane (default:
                              every peer; docs/operations.md
                              "Disk-pressure runbook")
    clocks [endpoint]         clock-discipline dashboard: per-store
                              sentinel verdict (OK / SUSPECT), worst
                              estimated peer skew, fenced-lease count
                              and the per-peer skew estimates the beat
                              probes produced (default: every peer;
                              docs/operations.md "Clock discipline
                              runbook")

PD (fleet) commands take --pd instead of --group/--peers:
    cluster [K]               print the PD leader's ClusterView: top-K
                              hot/cold regions, per-zone rates, store
                              health roster, hibernation fraction
    regions                   per-region lifecycle view: keyspace range,
                              epoch (version/conf_ver), leader, heat
                              score and replica placement for EVERY
                              region, plus pending merges and the PD's
                              recent lifecycle decisions (heat splits /
                              cold merges / cross-store moves;
                              docs/operations.md "Region lifecycle
                              runbook")
    pd-metrics                scrape the PD leader's Prometheus text
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.cli_service import CliService, describe_status
from tpuraft_torch.entity import PeerId
from tpuraft_torch.errors import RaftError
from tpuraft_torch.rpc.tcp import TcpTransport


def _report(st) -> int:
    """Print the op outcome; exit 0 = done, 3 = busy (safe to just
    retry), 1 = definite failure (inspect before retrying)."""
    if st.is_ok():
        print("OK")
        return 0
    print(describe_status(st), file=sys.stderr)
    return 3 if st.raft_error == RaftError.EBUSY else 1


def _print_cluster_view(view: dict) -> None:
    hib = view.get("hibernation", {})
    print(f"cluster: {view.get('regions', 0)} regions, "
          f"{len(view.get('stores', []))} stores, "
          f"hibernation {hib.get('quiescent', 0)}/"
          f"{hib.get('replicas', 0)} "
          f"({100.0 * hib.get('fraction', 0.0):.1f}%), "
          f"pd term {view.get('term', 0)}")
    for s in view.get("stores", []):
        health = s.get("health") or "healthy?"
        zone = s.get("zone") or "-"
        print(f"  store {s['endpoint']:<22} zone={zone:<10} "
              f"health={health:<9} leaders={s.get('leaders', 0):<5} "
              f"quiescent={s.get('replicas_quiescent', 0)}/"
              f"{s.get('replicas', 0)}")
    for z, zr in sorted(view.get("zone_rates", {}).items()):
        print(f"  zone {z or '-':<10} writes/s={zr.get('writes_s', 0)} "
              f"reads/s={zr.get('reads_s', 0)}")
    if view.get("sick_stores"):
        print("  SICK stores:", ", ".join(view["sick_stores"]))
    for title, key in (("hot", "hot"), ("cold", "cold")):
        rows = view.get(key, [])
        if not rows:
            continue
        print(f"  {title} regions:")
        for r in rows:
            flag = " HOT" if r["region"] in view.get("hot_flagged", []) \
                else ""
            print(f"    region {r['region']:<8} score={r['score']:<8} "
                  f"w/s={r['writes_s']:<7} r/s={r['reads_s']:<7} "
                  f"keys={r['keys']:<8} leader={r['leader']}{flag}")


def _prom_values(text: str) -> dict:
    """Flatten Prometheus exposition text to {metric_name: value},
    ignoring labels (the admin scrape targets one store at a time)."""
    vals: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value = line.rsplit(None, 1)
            vals[name_part.split("{", 1)[0]] = float(value)
        except ValueError:
            continue
    return vals


def _fmt_key(k: bytes, end: bool = False) -> str:
    if not k:
        # an empty key means -inf as a start bound, +inf as an end bound
        return "+inf" if end else "-inf"
    try:
        return k.decode("ascii")
    except UnicodeDecodeError:
        return k.hex()


def _print_regions_view(regions: list, view: dict) -> None:
    heat = {r["region"]: r
            for r in view.get("hot", []) + view.get("cold", [])}
    hot_flagged = set(view.get("hot_flagged", []))
    leaders = {r["region"]: r.get("leader", "") for r in heat.values()}
    lc = view.get("lifecycle")
    pending = (lc or {}).get("pending_merges", {})
    print(f"regions: {len(regions)} "
          f"(lifecycle {'ON' if lc is not None else 'off'}, "
          f"{len(pending)} pending merge(s))")
    for r in sorted(regions, key=lambda r: r.start_key):
        h = heat.get(r.id)
        score = f"{h['score']:<6}" if h else "-     "
        rates = (f"w/s={h['writes_s']:<7} r/s={h['reads_s']:<7} "
                 f"keys={h['keys']:<7}" if h
                 else "w/s=-       r/s=-       keys=-      ")
        flags = ""
        if r.id in hot_flagged:
            flags += " HOT"
        if str(r.id) in pending or r.id in pending:
            flags += f" MERGING->{pending.get(str(r.id), pending.get(r.id))}"
        print(f"  region {r.id:<8} "
              f"[{_fmt_key(r.start_key)} .. "
              f"{_fmt_key(r.end_key, end=True)}) "
              f"v{r.epoch.version}/c{r.epoch.conf_ver} "
              f"leader={leaders.get(r.id, '') or '?':<22} "
              f"score={score} {rates}{flags}")
        print(f"    peers: {', '.join(r.peers) or '-'}")
    if lc is None:
        print("  (lifecycle engine off or pre-lifecycle PD: no "
              "placement decisions to show)")
        return
    print(f"  actuations: heat_splits={lc.get('heat_splits_ordered', 0)} "
          f"merges={lc.get('merges_completed', 0)}"
          f"/{lc.get('merges_ordered', 0)} ordered "
          f"moves={lc.get('moves_ordered', 0)} "
          f"retired={lc.get('retired_regions', 0)}")
    recent = lc.get("recent", [])
    if recent:
        print("  recent decisions (oldest first):")
        for d in recent:
            extra = {k: v for k, v in d.items()
                     if k not in ("kind", "term", "region")}
            detail = " ".join(f"{k}={v}" for k, v in extra.items())
            print(f"    term {d.get('term', '?'):<4} "
                  f"{d.get('kind', '?'):<11} region {d.get('region', '?')}"
                  f"  {detail}")


_PRESSURE_NAMES = {0: "OK", 1: "NEAR_FULL", 2: "FULL"}


def _print_storage_row(ep: str, vals: dict) -> None:
    def v(name, default=0.0):
        return vals.get("tpuraft_" + name, default)

    if "tpuraft_disk_capacity_bytes" not in vals:
        print(f"  store {ep:<22} disk guard off (no disk_* metrics)")
        return
    used = v("disk_used_bytes")
    cap = v("disk_capacity_bytes")
    pct = f"{100.0 * used / cap:.1f}%" if cap > 0 else "-"
    level = _PRESSURE_NAMES.get(int(v("disk_pressure_level")), "?")
    print(f"  store {ep:<22} {level:<9} "
          f"used={int(used)}/{int(cap)}B ({pct})")
    print(f"    enospc={int(v('disk_enospc_events')):<6} "
          f"reclaims={int(v('disk_reclaims')):<5} "
          f"reclaim_rounds={int(v('disk_reclaim_rounds')):<5} "
          f"shed_writes={int(v('kv_disk_shed_items')):<6} "
          f"resumes={int(v('disk_pressure_resumes'))}")
    print(f"    rounds: near_full={int(v('disk_near_full_rounds'))} "
          f"full={int(v('disk_full_rounds'))} "
          f"reconciles={int(v('disk_reconciles'))}  bytes: "
          f"appended={int(v('disk_appended_bytes'))} "
          f"reclaimed={int(v('disk_reclaimed_bytes'))}")


_PEER_SKEW_PREFIX = "tpuraft_clock_peer_skew_s_"


def _print_clock_row(ep: str, vals: dict) -> None:
    if "tpuraft_clock_suspect" not in vals:
        print(f"  store {ep:<22} no clock sentinel "
              f"(pre-time-chaos build)")
        return
    suspect = vals["tpuraft_clock_suspect"] > 0
    verdict = "SUSPECT" if suspect else "OK"
    print(f"  store {ep:<22} {verdict:<8} "
          f"max|skew|={vals.get('tpuraft_clock_max_abs_skew_s', 0.0):.3f}s "
          f"leases_fenced={int(vals.get('tpuraft_clock_lease_fenced', 0))}")
    # per-peer estimates (gauge names carry the sanitized peer
    # endpoint: tpuraft_clock_peer_skew_s_127_0_0_1_6301)
    for name, v in sorted(vals.items()):
        if name.startswith(_PEER_SKEW_PREFIX):
            peer = name[len(_PEER_SKEW_PREFIX):]
            print(f"    peer {peer:<24} skew={v:+.3f}s")


async def _run_pd(args) -> int:
    """PD-targeted commands (``--pd`` endpoints, no raft group conf)."""
    import json

    from tpuraft_torch.rheakv.pd_client import RemotePlacementDriverClient
    from tpuraft_torch.rpc.transport import RpcError

    transport = TcpTransport()
    pd = RemotePlacementDriverClient(
        transport, [e for e in args.pd.split(",") if e])
    cmd = args.command[0]
    try:
        if cmd == "cluster":
            top_k = int(args.command[1]) if len(args.command) > 1 else 8
            view = await pd.cluster_describe(top_k=top_k)
            if view is None:
                print("error: PD does not serve pd_cluster_describe "
                      "(pre-observability build)", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(view, indent=1))
            else:
                _print_cluster_view(view)
        elif cmd == "regions":
            view = await pd.cluster_describe(top_k=64)
            if view is None:
                print("error: PD does not serve pd_cluster_describe "
                      "(pre-observability build)", file=sys.stderr)
                return 1
            regions = await pd.list_regions()
            if args.json:
                print(json.dumps({
                    "regions": [{
                        "id": r.id,
                        "start_key": _fmt_key(r.start_key),
                        "end_key": _fmt_key(r.end_key, end=True),
                        "version": r.epoch.version,
                        "conf_ver": r.epoch.conf_ver,
                        "peers": list(r.peers),
                    } for r in sorted(regions,
                                      key=lambda r: r.start_key)],
                    "lifecycle": view.get("lifecycle"),
                }, indent=1))
            else:
                _print_regions_view(regions, view)
        else:  # pd-metrics
            text = await pd.describe_metrics()
            if text is None:
                print("error: PD does not serve pd_describe_metrics "
                      "(pre-observability build)", file=sys.stderr)
                return 1
            print(text, end="")
        return 0
    except (RpcError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await transport.close()


async def run(args) -> int:
    from tpuraft_torch.rpc.transport import RpcError

    cmd0 = args.command[0]
    if cmd0 in ("cluster", "regions", "pd-metrics"):
        if not args.pd:
            print(f"{cmd0} needs --pd (comma-separated PD endpoints)",
                  file=sys.stderr)
            return 2
        return await _run_pd(args)
    if not args.group or not args.peers:
        print(f"{cmd0} needs --group and --peers", file=sys.stderr)
        return 2
    try:
        conf = Configuration.parse(args.peers)
    except ValueError as e:
        print(f"error: bad --peers: {e}", file=sys.stderr)
        return 2
    transport = TcpTransport()
    cli = CliService(transport)
    rc = 0
    try:
        cmd = args.command[0]
        if cmd == "leader":
            leader = await cli.get_leader(args.group, conf)
            if leader is None:
                print("error: no leader found")
                return 1
            print(leader)
        elif cmd == "peers":
            full = await cli.get_configuration(args.group, conf)
            print("voters:", ",".join(
                f"{p}/witness" if full.is_witness(p) else str(p)
                for p in full.peers))
            if full.learners:
                print("learners:", ",".join(str(p) for p in full.learners))
        elif cmd == "metrics":
            targets = ([args.command[1]] if len(args.command) > 1
                       else [p.endpoint for p in conf.list_all()])
            last_err = None
            for ep in targets:
                # a bare endpoint or a PeerId string both work
                ep = ":".join(ep.split("/", 1)[0].split(":")[:2])
                try:
                    print(await cli.describe_metrics(ep), end="")
                    break
                except RpcError as e:
                    last_err = e
            else:
                print(f"error: no store answered describe_metrics: "
                      f"{last_err.status if last_err else '?'}",
                      file=sys.stderr)
                rc = 1
        elif cmd == "storage":
            # disk-pressure dashboard: unlike `metrics` (first peer
            # that answers) this renders EVERY reachable store — the
            # operator question is "which store is under pressure",
            # not "what does one store say"
            targets = ([args.command[1]] if len(args.command) > 1
                       else [p.endpoint for p in conf.list_all()])
            answered = 0
            print(f"storage pressure ({len(targets)} store(s)):")
            for ep in targets:
                ep = ":".join(ep.split("/", 1)[0].split(":")[:2])
                try:
                    text = await cli.describe_metrics(ep)
                except RpcError as e:
                    print(f"  store {ep:<22} unreachable "
                          f"({e.status.raft_error.name})")
                    continue
                answered += 1
                _print_storage_row(ep, _prom_values(text))
            if not answered:
                print("error: no store answered describe_metrics",
                      file=sys.stderr)
                rc = 1
        elif cmd == "clocks":
            # clock-discipline dashboard: like `storage`, every
            # reachable store renders — the operator question is
            # "whose clock is off and by how much", answered by each
            # store's OWN sentinel estimate of its peers
            targets = ([args.command[1]] if len(args.command) > 1
                       else [p.endpoint for p in conf.list_all()])
            answered = 0
            print(f"clock discipline ({len(targets)} store(s)):")
            for ep in targets:
                ep = ":".join(ep.split("/", 1)[0].split(":")[:2])
                try:
                    text = await cli.describe_metrics(ep)
                except RpcError as e:
                    print(f"  store {ep:<22} unreachable "
                          f"({e.status.raft_error.name})")
                    continue
                answered += 1
                _print_clock_row(ep, _prom_values(text))
            if not answered:
                print("error: no store answered describe_metrics",
                      file=sys.stderr)
                rc = 1
        elif cmd in ("snapshot", "transfer", "add-peer", "remove-peer",
                     "add-witness", "remove-witness"):
            if len(args.command) < 2:
                print(f"{cmd} needs a peer argument", file=sys.stderr)
                return 2
            peer = PeerId.parse(args.command[1])
            if cmd == "snapshot":
                st = await cli.snapshot(args.group, peer)
            elif cmd == "transfer":
                st = await cli.transfer_leader(args.group, conf, peer)
            elif cmd == "add-peer":
                st = await cli.add_peer(args.group, conf, peer)
            elif cmd == "add-witness":
                st = await cli.add_witness(args.group, conf, peer)
            elif cmd == "remove-witness":
                st = await cli.remove_witness(args.group, conf, peer)
            else:
                st = await cli.remove_peer(args.group, conf, peer)
            rc = _report(st)
        elif cmd == "change-peers":
            if len(args.command) < 2:
                print("change-peers needs a conf argument", file=sys.stderr)
                return 2
            new_conf = Configuration.parse(args.command[1])
            st = await cli.change_peers(args.group, conf, new_conf)
            rc = _report(st)
        elif cmd in ("add-learners", "remove-learners", "reset-learners"):
            if len(args.command) < 2:
                print(f"{cmd} needs a peer-list argument "
                      "('none' clears the set for reset-learners)",
                      file=sys.stderr)
                return 2
            arg = args.command[1]
            clear = arg in ("none", "") and cmd == "reset-learners"
            learners = ([] if clear else
                        [PeerId.parse(t) for t in arg.split(",") if t])
            if not learners and not clear:
                print(f"{cmd} needs at least one peer", file=sys.stderr)
                return 2
            op = {"add-learners": cli.add_learners,
                  "remove-learners": cli.remove_learners,
                  "reset-learners": cli.reset_learners}[cmd]
            st = await op(args.group, conf, learners)
            rc = _report(st)
        else:
            print(f"unknown command: {cmd}", file=sys.stderr)
            rc = 2
    except RpcError as e:
        print(f"error: {e.status}", file=sys.stderr)
        rc = 1
    except ValueError as e:  # malformed peer argument
        print(f"error: {e}", file=sys.stderr)
        rc = 2
    finally:
        await transport.close()
    return rc


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--group", default="", help="raft group id")
    ap.add_argument("--peers", default="",
                    help="comma-separated cluster conf (ip:port,...)")
    ap.add_argument("--pd", default="",
                    help="comma-separated PD endpoints (for the "
                         "cluster / pd-metrics commands)")
    ap.add_argument("--json", action="store_true",
                    help="print the cluster view as raw JSON")
    ap.add_argument("command", nargs="+",
                    help="leader | peers | snapshot <peer> | transfer <peer>"
                         " | add-peer <peer> | remove-peer <peer>"
                         " | add-witness <peer> | remove-witness <peer>"
                         " | change-peers <p1,p2,...>"
                         " | add-learners <p1,...> | remove-learners <p1,...>"
                         " | reset-learners <p1,...> | metrics [endpoint]"
                         " | storage [endpoint] | clocks [endpoint]"
                         " | cluster [K] | pd-metrics")
    sys.exit(asyncio.run(run(ap.parse_args())))


if __name__ == "__main__":
    main()
