"""NetworkTopology: a per-link WAN shape for chaos fabrics.

The soak's fault plane used to be GLOBAL knobs (one delay, one drop
rate for the whole fabric) — fine for same-host chaos, useless for the
geo regime CD-Raft targets: cross-domain sites with *asymmetric* WAN
latencies, partial partitions, and links that flap rather than fail.
This module models that surface once, and both fabrics consult it:

- endpoints are tagged with a **zone** (``set_zone``);
- a zones x zones matrix of :class:`LinkProfile` rows gives each
  DIRECTED zone pair its base latency, jitter, loss rate, and a
  bandwidth cap (token-bucket serialization delay), so ``z0 -> z1``
  and ``z1 -> z0`` can differ (asymmetric routes);
- dynamic events — :meth:`degrade` (WAN brown-out), :meth:`partition`
  (one-way zone partition), :meth:`flap` (periodic up/down square
  wave) — OVERLAY the base matrix and are cleared by
  :meth:`heal_events` without touching the base shape, so nemesis-layer
  noise (drop/delay knobs, per-endpoint blocks) and topology shaping
  compose without stomping each other.

Everything random is drawn from one seeded ``random.Random`` so a
seeded chaos drive replays byte-identically; per-outcome counters are
surfaced through :meth:`describe` (util/describer registration is the
caller's choice — the soak registers its topology).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field, replace
from random import Random
from typing import Optional


@dataclass(frozen=True)
class LinkProfile:
    """One DIRECTED zone->zone link's shape."""

    latency_ms: float = 0.0     # base one-way transit latency
    jitter_ms: float = 0.0      # uniform extra in [0, jitter_ms)
    loss: float = 0.0           # per-frame drop probability
    bandwidth_kbps: float = 0.0  # 0 = uncapped; else serialization delay

    def degraded(self, latency_x: float = 1.0, extra_loss: float = 0.0,
                 bandwidth_x: float = 1.0) -> "LinkProfile":
        """A browned-out variant of this link (used by degrade events)."""
        return replace(
            self,
            latency_ms=self.latency_ms * latency_x,
            jitter_ms=self.jitter_ms * latency_x,
            loss=min(1.0, self.loss + extra_loss),
            bandwidth_kbps=(self.bandwidth_kbps * bandwidth_x
                            if self.bandwidth_kbps else 0.0))


@dataclass
class _Flap:
    period_s: float
    duty: float       # fraction of the period the link is UP
    phase: float      # seeded start offset so flaps don't align


# graftcheck: loop-confined — consulted only from transport call paths
# on the owning event loop; plan() mutates the token buckets there
class NetworkTopology:
    """Zones x zones link-shape matrix + dynamic fault events.

    ``plan(src, dst, nbytes)`` is the single consultation point: it
    returns ``(delay_s, dropped)`` for one frame, folding base shape,
    degrade overlays, one-way zone partitions, flap state, and the
    per-link bandwidth token bucket.  The TRANSPORT sleeps/drops; the
    topology only decides.
    """

    def __init__(self, seed: int = 0, clock=time.monotonic):
        self._zones: dict[str, str] = {}          # endpoint -> zone
        self._links: dict[tuple[str, str], LinkProfile] = {}
        self._default = LinkProfile()
        self._rng = Random(seed)
        self._clock = clock
        # dynamic overlays (cleared by heal_events, NOT by fabric heal())
        self._degraded: dict[tuple[str, str], LinkProfile] = {}
        self._partitioned: set[tuple[str, str]] = set()   # one-way
        self._flaps: dict[tuple[str, str], _Flap] = {}
        # per-ENDPOINT degrade (gray failures): one store's links limp —
        # extra latency/jitter/loss ADDED to every frame touching the
        # endpoint, both directions — while its zone stays healthy.
        # endpoint -> (latency_ms, jitter_ms, loss)
        self._ep_degraded: dict[str, tuple[float, float, float]] = {}
        # per-link bandwidth token bucket: link -> busy-until timestamp
        self._busy_until: dict[tuple[str, str], float] = {}
        self.counters: dict[str, int] = {
            "frames": 0, "delayed": 0, "dropped_loss": 0,
            "dropped_partition": 0, "dropped_flap": 0, "shaped_bytes": 0,
        }

    # -- static shape --------------------------------------------------------

    def set_zone(self, endpoint: str, zone: str) -> None:
        self._zones[endpoint] = zone

    def zone_of(self, endpoint: str) -> str:
        return self._zones.get(endpoint, "")

    def zones(self) -> list[str]:
        return sorted(set(self._zones.values()))

    def set_default_link(self, profile: LinkProfile) -> None:
        self._default = profile

    def set_link(self, src_zone: str, dst_zone: str, profile: LinkProfile,
                 symmetric: bool = False) -> None:
        """Shape the DIRECTED src->dst zone link; ``symmetric=True``
        also sets the reverse direction (asymmetric WANs set each
        direction separately)."""
        self._links[(src_zone, dst_zone)] = profile
        if symmetric:
            self._links[(dst_zone, src_zone)] = profile

    def link(self, src_zone: str, dst_zone: str) -> LinkProfile:
        """Effective profile (degrade overlay wins over base)."""
        key = (src_zone, dst_zone)
        over = self._degraded.get(key)
        if over is not None:
            return over
        return self._links.get(key, self._default)

    # -- dynamic events (the nemesis menu's verbs) ---------------------------

    def degrade(self, src_zone: str, dst_zone: str,
                latency_x: float = 10.0, extra_loss: float = 0.02,
                bandwidth_x: float = 0.25, symmetric: bool = True) -> None:
        """WAN brown-out: overlay a degraded variant of the base link."""
        base = self._links.get((src_zone, dst_zone), self._default)
        self._degraded[(src_zone, dst_zone)] = base.degraded(
            latency_x, extra_loss, bandwidth_x)
        if symmetric:
            rbase = self._links.get((dst_zone, src_zone), self._default)
            self._degraded[(dst_zone, src_zone)] = rbase.degraded(
                latency_x, extra_loss, bandwidth_x)

    def degrade_wan(self, latency_x: float = 10.0, extra_loss: float = 0.02,
                    bandwidth_x: float = 0.25) -> None:
        """Brown out every INTER-zone link at once (intra-zone spared)."""
        for a in self.zones():
            for b in self.zones():
                if a != b:
                    self.degrade(a, b, latency_x, extra_loss, bandwidth_x,
                                 symmetric=False)

    def partition(self, src_zone: str, dst_zone: str) -> None:
        """One-way zone partition: frames src->dst drop; dst->src flows."""
        self._partitioned.add((src_zone, dst_zone))

    def partition_zone(self, zone: str, one_way: bool = False) -> None:
        """Cut a zone off from every other zone (one_way=True drops only
        the zone's OUTBOUND frames — the classic asymmetric partition)."""
        for other in self.zones():
            if other == zone:
                continue
            self.partition(zone, other)
            if not one_way:
                self.partition(other, zone)

    def flap(self, src_zone: str, dst_zone: str, period_s: float = 1.0,
             duty: float = 0.5, symmetric: bool = True) -> None:
        """Flapping link: up for ``duty`` of each period, down otherwise,
        phase-shifted by the seeded rng so concurrent flaps interleave."""
        f = _Flap(period_s, duty, self._rng.random() * period_s)
        self._flaps[(src_zone, dst_zone)] = f
        if symmetric:
            self._flaps[(dst_zone, src_zone)] = f

    def degrade_endpoint(self, endpoint: str, latency_ms: float = 25.0,
                         jitter_ms: float = 10.0, loss: float = 0.0) -> None:
        """Gray-failure verb: ONE endpoint's links limp (both
        directions) while its zone — and every zone link — stays
        healthy.  The classic fail-slow network shape: a saturated NIC/
        CPU on one store adds latency to everything it touches, and no
        zone-level check sees it."""
        self._ep_degraded[endpoint] = (latency_ms, jitter_ms, loss)

    def stall_endpoint(self, endpoint: str, stall_ms: float = 1500.0,
                       loss: float = 0.0) -> None:
        """Stalled (NOT dead) endpoint: frames to/from it are delivered
        after ``stall_ms`` — long past any heartbeat cadence, short of
        forever.  Distinct from a partition: acks eventually arrive, so
        naive liveness checks keep passing while latency detonates."""
        self.degrade_endpoint(endpoint, latency_ms=stall_ms, jitter_ms=0.0,
                              loss=loss)

    def heal_endpoint(self, endpoint: str) -> None:
        self._ep_degraded.pop(endpoint, None)

    def endpoint_degraded(self, endpoint: str) -> bool:
        return endpoint in self._ep_degraded

    def heal_events(self) -> None:
        """Clear every DYNAMIC event (degrades, partitions, flaps,
        endpoint limps); the base zone matrix — the deployment's real
        shape — stays."""
        self._degraded.clear()
        self._partitioned.clear()
        self._flaps.clear()
        self._ep_degraded.clear()

    # -- the consultation point ----------------------------------------------

    def plan(self, src_ep: str, dst_ep: str, nbytes: int = 256
             ) -> tuple[float, bool]:
        """Decide one frame's fate: returns ``(delay_s, dropped)``.

        Mutates only the bandwidth token bucket; all randomness comes
        from the seeded rng, so identical call sequences replay."""
        sz, dz = self.zone_of(src_ep), self.zone_of(dst_ep)
        key = (sz, dz)
        self.counters["frames"] += 1
        if key in self._partitioned:
            self.counters["dropped_partition"] += 1
            return 0.0, True
        flap_state = self._flaps.get(key)
        if flap_state is not None:
            t = (self._clock() + flap_state.phase) % flap_state.period_s
            if t >= flap_state.duty * flap_state.period_s:
                self.counters["dropped_flap"] += 1
                return 0.0, True
        prof = self.link(sz, dz)
        # per-endpoint limp: additive on top of whatever the zone link
        # says, applied once per degraded endpoint the frame touches
        ep_lat = ep_jit = ep_loss = 0.0
        for ep in (src_ep, dst_ep):
            shape = self._ep_degraded.get(ep)
            if shape is not None:
                ep_lat += shape[0]
                ep_jit += shape[1]
                ep_loss = max(ep_loss, shape[2])
        loss = max(prof.loss, ep_loss) if ep_loss else prof.loss
        if loss > 0 and self._rng.random() < loss:
            self.counters["dropped_loss"] += 1
            return 0.0, True
        delay = (prof.latency_ms + ep_lat) / 1000.0
        if prof.jitter_ms > 0:
            delay += self._rng.random() * prof.jitter_ms / 1000.0
        if ep_jit > 0:
            delay += self._rng.random() * ep_jit / 1000.0
        if ep_lat > 0:
            self.counters["ep_shaped"] = self.counters.get("ep_shaped",
                                                           0) + 1
        if prof.bandwidth_kbps > 0:
            # token-bucket serialization: consecutive frames queue behind
            # the link's busy horizon, so a burst sees growing delays
            now = self._clock()
            ser = nbytes * 8.0 / (prof.bandwidth_kbps * 1000.0)
            start = max(now, self._busy_until.get(key, 0.0))
            self._busy_until[key] = start + ser
            delay += (start - now) + ser
            self.counters["shaped_bytes"] += nbytes
        if delay > 0:
            self.counters["delayed"] += 1
        return delay, False

    async def traverse(self, src_ep: str, dst_ep: str, request,
                       timeout_ms: Optional[float]) -> None:
        """The ONE transit implementation both fabrics share
        (InProcNetwork.call and FaultInjectingTransport.call): sleep
        the planned delay, and on a drop wait the loopback's standard
        lost-request interval then raise — so both fabrics keep
        byte-identical WAN semantics instead of drifting copies."""
        from tpuraft_torch.errors import RaftError, Status
        from tpuraft_torch.rpc.transport import RpcError

        delay_s, dropped = self.plan(src_ep, dst_ep,
                                     approx_frame_bytes(request))
        if delay_s > 0:
            await asyncio.sleep(delay_s)
        if dropped:
            # match the loopback's drop behavior: a lost request is only
            # detected after a wait, so callers' timeout/backoff engages
            wait_ms = min(timeout_ms, 50.0) if timeout_ms else 50.0
            await asyncio.sleep(wait_ms / 1000.0)
            raise RpcError(Status.error(
                RaftError.EHOSTDOWN,
                f"topology drop {src_ep} -> {dst_ep}"))

    # -- observability -------------------------------------------------------

    def describe(self) -> str:
        lines = [f"NetworkTopology<{len(self._zones)} endpoints, "
                 f"{len(self.zones())} zones>:"]
        for z in self.zones():
            eps = sorted(e for e, zz in self._zones.items() if zz == z)
            lines.append(f"  zone {z}: {', '.join(eps)}")
        for (a, b), p in sorted(self._links.items()):
            lines.append(
                f"  link {a}->{b}: {p.latency_ms}ms ±{p.jitter_ms}ms "
                f"loss={p.loss} bw={p.bandwidth_kbps or 'inf'}kbps")
        if self._degraded:
            lines.append(f"  degraded: {sorted(self._degraded)}")
        if self._partitioned:
            lines.append(f"  partitioned (one-way): "
                         f"{sorted(self._partitioned)}")
        if self._flaps:
            lines.append(f"  flapping: {sorted(self._flaps)}")
        if self._ep_degraded:
            lines.append(f"  endpoint-degraded: {sorted(self._ep_degraded)}")
        lines.append(f"  counters: {self.counters}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return f"NetworkTopology<{len(self.zones())} zones>"


def build_geo_topology(endpoints: list[str], zones: int, seed: int = 0,
                       intra_ms: float = 0.2, base_wan_ms: float = 3.0,
                       jitter_ms: float = 1.0, loss: float = 0.001,
                       clock=time.monotonic) -> NetworkTopology:
    """The canonical geo shape the soak and bench share: endpoints
    round-robin into ``zones`` zones, near-zero intra-zone links, and
    ASYMMETRIC inter-zone WAN links — each direction draws its own
    base latency from the seeded rng (0.7x-1.6x of ``base_wan_ms``),
    so z0->z1 and z1->z0 genuinely differ, plus jitter and a small
    steady loss rate."""
    topo = NetworkTopology(seed=seed, clock=clock)
    names = [f"z{i}" for i in range(zones)]
    for i, ep in enumerate(endpoints):
        topo.set_zone(ep, names[i % zones])
    rng = Random(seed ^ 0x9E3779B9)
    intra = LinkProfile(latency_ms=intra_ms)
    for a in names:
        topo.set_link(a, a, intra)
    for a in names:
        for b in names:
            if a == b:
                continue
            lat = base_wan_ms * (0.7 + 0.9 * rng.random())
            topo.set_link(a, b, LinkProfile(
                latency_ms=lat, jitter_ms=jitter_ms, loss=loss))
    return topo


def approx_frame_bytes(request) -> int:
    """Cheap size estimate for bandwidth shaping: entry-bearing
    AppendEntries frames dominate WAN bytes, so count their encoded
    entries; everything else is a small control frame."""
    entries = getattr(request, "entries", None)
    if entries:
        try:
            return 128 + sum(len(e.encode()) for e in entries)
        except Exception:  # noqa: BLE001 — estimate, never fail a send
            return 1024
    items = getattr(request, "items", None) or getattr(request, "beats", None)
    if items:
        return 64 + 96 * len(items)
    return 256
