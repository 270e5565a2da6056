"""Placement driver clients: fake (static, pd-less) and remote.

Reference parity: ``rhea:client/pd/AbstractPlacementDriverClient`` with
``FakePlacementDriverClient`` (static conf, no PD cluster) and
``RemotePlacementDriverClient`` (region metadata served by the PD's own
raft group) — SURVEY.md §3.2 "PD client".
"""

from __future__ import annotations

import logging
from typing import Optional

from tpuraft_torch.rheakv.metadata import Region, StoreMeta

LOG = logging.getLogger(__name__)


class PlacementDriverClient:
    """Region metadata source + store-side reporting sink."""

    async def list_regions(self) -> list[Region]:
        raise NotImplementedError

    async def get_store_metas(self) -> list[StoreMeta]:
        return []

    # -- store-side hooks ----------------------------------------------------

    async def report_split(self, parent: Region, child: Region) -> None:
        pass

    async def report_merge(self, source_region_id: int,
                           target_region_id: int) -> None:
        """Lifecycle plane: a completed merge (source sealed, absorbed,
        retired) — no-op for PD-less clients; the static view has no
        merge policy that could have ordered one."""

    async def store_heartbeat(self, meta: StoreMeta,
                              health: str = "") -> None:
        pass

    async def region_heartbeat(self, region: Region, leader: str,
                               metrics: Optional[dict] = None) -> list:
        """Returns PD instructions (e.g. split orders); empty by default."""
        return []

    async def store_heartbeat_batch(
            self, meta: StoreMeta,
            deltas: list[tuple[Region, str, int]],
            full: bool = False, health: str = "",
            heat: Optional[list] = None,
            occupancy: Optional[tuple] = None) -> tuple[list, bool]:
        """Delta-batched reporting: ONE call per interval carrying only
        the CHANGED (region, leader, approximate_keys) rows.  Returns
        (instructions, need_full).  ``health`` is the store's
        self-reported gray-failure level (trailing wire field; "" on
        stores without scoring).  ``heat`` is the noise-gated list of
        (region_id, writes_s, reads_s, bytes_in_s, bytes_out_s) rows
        and ``occupancy`` the (replicas, replicas_quiescent) pair —
        both trailing wire fields of the fleet observability plane.
        Default: decompose into the legacy per-region calls — PD-less /
        legacy clients keep exact semantics while batch-aware clients
        override with one RPC.  need_full is always True here: a legacy
        PD has no delta state and runs its policy (split re-issue,
        leader balancing) off the per-region reports, so every round
        must carry EVERY led region — delta-only reporting would starve
        it, and a failed-over legacy PD leader would stay cold forever
        (it cannot ask for a resync the way the batch protocol can)."""
        meta = StoreMeta(id=meta.id, endpoint=meta.endpoint,
                         regions=[r.copy() for (r, _l, _k) in deltas],
                         zone=meta.zone)
        # legacy decomposition deliberately DROPS health/heat/occupancy:
        # the per-region protocol (and the subclasses that implement
        # it) predates them, and a legacy PD has no drain/heat policy
        # to feed anyway
        await self.store_heartbeat(meta)
        instructions: list = []
        for region, leader, keys in deltas:
            instructions.extend(await self.region_heartbeat(
                region, leader, {"approximate_keys": keys}))
        return instructions, True

    async def cluster_describe(self, top_k: int = 8) -> Optional[dict]:
        """Fleet observability: the PD leader's folded ClusterView as a
        dict (see pd_server.PlacementDriverServer._build_cluster_view).
        None = this client has no PD to ask (PD-less deployments)."""
        return None

    async def describe_metrics(self) -> Optional[str]:
        """Fleet observability: the PD leader's Prometheus text
        (pd_describe_metrics).  None = no PD / pre-observability PD."""
        return None

    async def shutdown(self) -> None:
        pass


class FakePlacementDriverClient(PlacementDriverClient):
    """PD-less mode: the initial region layout is the whole truth; splits
    reported by stores are folded into the static view."""

    def __init__(self, regions: list[Region]):
        self._regions: dict[int, Region] = {r.id: r.copy() for r in regions}

    async def list_regions(self) -> list[Region]:
        return [r.copy() for r in self._regions.values()]

    async def report_split(self, parent: Region, child: Region) -> None:
        self._regions[parent.id] = parent.copy()
        self._regions[child.id] = child.copy()


class RemotePlacementDriverClient(PlacementDriverClient):
    """Talks to the PD server cluster over the shared transport.

    The PD is itself a 1-group raft app (reference:
    ``pd:PlacementDriverServer``); requests go to its leader via the
    pd_* RPC methods (see tpuraft.rheakv.pd_server).
    """

    def __init__(self, transport, pd_endpoints: list[str],
                 timeout_ms: float = 3000):
        self._transport = transport
        self._endpoints = list(pd_endpoints)
        self._timeout_ms = timeout_ms
        self._leader: Optional[str] = None
        # does the PD serve pd_store_heartbeat_batch?  Optimistic until
        # an ENOMETHOD proves otherwise (a pre-delta-batch PD), then the
        # legacy per-region decomposition takes over permanently.
        self._batch_ok = True

    async def _call(self, method: str, request):
        from tpuraft_torch.rpc.transport import RpcError

        rotation = ([self._leader] if self._leader else []) + [
            e for e in self._endpoints if e != self._leader]
        last: Optional[Exception] = None
        next_ep: Optional[str] = None
        # enough attempts to probe every endpoint AND follow a redirect
        # back to one already probed (it may have won the election since)
        for _ in range(2 * len(rotation) + 2):
            ep = next_ep if next_ep is not None else (
                rotation.pop(0) if rotation else None)
            next_ep = None
            if ep is None:
                break
            try:
                resp = await self._transport.call(ep, method, request,
                                                  self._timeout_ms)
            except RpcError as e:
                last = e
                self._leader = None
                continue
            if getattr(resp, "redirect", ""):
                next_ep = resp.redirect
                self._leader = resp.redirect
                continue
            if getattr(resp, "success", True):
                self._leader = ep
                return resp
            last = RuntimeError(getattr(resp, "msg", "pd error"))
            self._leader = None
        raise last if last else RuntimeError("no PD endpoints")

    async def list_regions(self) -> list[Region]:
        from tpuraft_torch.rheakv.pd_messages import ListRegionsRequest

        resp = await self._call("pd_list_regions", ListRegionsRequest())
        return [Region.decode(b) for b in resp.regions]

    async def get_store_metas(self) -> list[StoreMeta]:
        from tpuraft_torch.rheakv.pd_messages import ListStoresRequest

        resp = await self._call("pd_list_stores", ListStoresRequest())
        out = []
        for blob in resp.stores:
            import struct

            from tpuraft_torch.rheakv.pd_messages import decode_store_meta

            sid, ep, zone = decode_store_meta(blob)
            out.append(StoreMeta(id=sid, endpoint=ep, zone=zone))
        return out

    async def report_split(self, parent: Region, child: Region) -> None:
        from tpuraft_torch.rheakv.pd_messages import ReportSplitRequest

        await self._call("pd_report_split", ReportSplitRequest(
            parent=parent.encode(), child=child.encode()))

    async def report_merge(self, source_region_id: int,
                           target_region_id: int) -> None:
        from tpuraft_torch.rheakv.pd_messages import ReportMergeRequest
        from tpuraft_torch.rpc.transport import RpcError, is_no_method

        try:
            await self._call("pd_report_merge", ReportMergeRequest(
                source_region_id=source_region_id,
                target_region_id=target_region_id))
        except RpcError as e:
            if is_no_method(e):
                return  # pre-lifecycle PD (it never orders merges either)
            raise

    async def store_heartbeat(self, meta: StoreMeta,
                              health: str = "") -> None:
        from tpuraft_torch.rheakv.pd_messages import StoreHeartbeatRequest

        await self._call("pd_store_heartbeat", StoreHeartbeatRequest(
            store_id=meta.id, endpoint=meta.endpoint,
            regions=[r.encode() for r in meta.regions],
            zone=meta.zone, health=health))

    async def region_heartbeat(self, region: Region, leader: str,
                               metrics: Optional[dict] = None) -> list:
        from tpuraft_torch.rheakv.pd_messages import (
            Instruction,
            RegionHeartbeatRequest,
        )

        keys = (metrics or {}).get("approximate_keys", 0)
        resp = await self._call("pd_region_heartbeat", RegionHeartbeatRequest(
            region=region.encode(), leader=leader, approximate_keys=keys))
        return [Instruction.decode(b) for b in resp.instructions]

    async def store_heartbeat_batch(
            self, meta: StoreMeta,
            deltas: list[tuple[Region, str, int]],
            full: bool = False, health: str = "",
            heat: Optional[list] = None,
            occupancy: Optional[tuple] = None) -> tuple[list, bool]:
        from tpuraft_torch.rheakv.pd_messages import (
            Instruction,
            StoreHeartbeatBatchRequest,
            encode_region_delta,
        )
        from tpuraft_torch.rpc.transport import RpcError, is_no_method
        from tpuraft_torch.util.heat import encode_heat_rows

        if not self._batch_ok:
            return await super().store_heartbeat_batch(
                meta, deltas, full, health=health)
        replicas, quiescent = occupancy or (0, 0)
        req = StoreHeartbeatBatchRequest(
            store_id=meta.id, endpoint=meta.endpoint,
            deltas=[encode_region_delta(r.encode(), leader, keys)
                    for (r, leader, keys) in deltas],
            full=full, zone=meta.zone, health=health,
            heat=encode_heat_rows(heat or []),
            replicas=replicas, replicas_quiescent=quiescent)
        try:
            resp = await self._call("pd_store_heartbeat_batch", req)
        except RpcError as e:
            if is_no_method(e):
                self._batch_ok = False
                return await super().store_heartbeat_batch(
                    meta, deltas, full, health=health)
            raise
        return ([Instruction.decode(b) for b in resp.instructions],
                bool(getattr(resp, "need_full", False)))

    async def cluster_describe(self, top_k: int = 8) -> Optional[dict]:
        import json

        from tpuraft_torch.rheakv.pd_messages import ClusterDescribeRequest
        from tpuraft_torch.rpc.transport import RpcError, is_no_method

        try:
            resp = await self._call("pd_cluster_describe",
                                    ClusterDescribeRequest(top_k=top_k))
        except RpcError as e:
            if is_no_method(e):
                return None  # pre-observability PD
            raise
        return json.loads(resp.view_json) if resp.view_json else None

    async def describe_metrics(self) -> Optional[str]:
        from tpuraft_torch.rpc.cli_messages import DescribeMetricsRequest
        from tpuraft_torch.rpc.transport import RpcError, is_no_method

        try:
            resp = await self._call("pd_describe_metrics",
                                    DescribeMetricsRequest())
        except RpcError as e:
            if is_no_method(e):
                return None  # pre-observability PD
            raise
        return resp.text
