"""Transport: async RPC interface + in-process loopback with fault injection.

Reference parity: ``core:rpc/RaftClientService`` / processors bound to one
shared RpcServer multiplexing many groups (SURVEY.md §2 L2, §3.1).  The
in-proc implementation is the analog of the reference's signature test
pattern — ``TestCluster``: N real nodes in one process, real protocol,
loopback "network" with kill/partition/delay/drop injection (§5).

Routing: requests carry (group_id, peer_id); an :class:`RpcServer`
registered per endpoint dispatches to per-group handlers (NodeManager).
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, Awaitable, Callable, Optional

from tpuraft_torch.errors import RaftError, Status


class RpcError(Exception):
    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status


def is_no_method(e: RpcError) -> bool:
    """True when the receiver has no handler for the requested method —
    the capability probe the batch planes (send plane, heartbeat hub)
    key their per-item fallback on.  The dedicated ENOMETHOD code is
    authoritative; the substring is a compat net for receivers older
    than the code itself."""
    return (e.status.code == RaftError.ENOMETHOD
            or "no handler" in e.status.error_msg)


class RpcServer:
    """One per process endpoint; multiplexes all raft groups on it.

    Handlers: method name -> async fn(request) -> response.  The node
    manager registers one handler set and routes by request.group_id
    (reference: NodeManager + per-request processors on a shared server).
    """

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self._handlers: dict[str, Callable[[Any], Awaitable[Any]]] = {}
        self.running = False

    def register(self, method: str, handler: Callable[[Any], Awaitable[Any]]) -> None:
        self._handlers[method] = handler

    async def dispatch(self, method: str, request: Any) -> Any:
        h = self._handlers.get(method)
        if h is None:
            raise RpcError(Status.error(RaftError.ENOMETHOD, f"no handler {method}"))
        return await h(request)

    async def serve_framed_payload(self, seq: int, payload: bytes,
                                   response_flag: int, error_flag: int
                                   ) -> tuple[int, bytes]:
        """Decode a wire request payload (u16 method_len | method |
        message), dispatch it, and encode the response envelope.
        Shared by every framed transport backend (asyncio TCP, native
        epoll); returns (flags, encoded_response)."""
        import logging
        import struct

        from tpuraft_torch.rpc.messages import (
            ErrorResponse,
            decode_message,
            encode_message,
        )

        flags = response_flag
        try:
            (mlen,) = struct.unpack_from("<H", payload, 0)
            method = payload[2:2 + mlen].decode()
            request = decode_message(memoryview(payload)[2 + mlen:])
            response = await self.dispatch(method, request)
        except asyncio.CancelledError:
            raise
        except RpcError as e:
            flags |= error_flag
            response = ErrorResponse(e.status.code, e.status.error_msg)
        except Exception as e:  # noqa: BLE001 — handler bug must not kill conn
            logging.getLogger(__name__).exception(
                "rpc handler failed (seq=%d)", seq)
            flags |= error_flag
            response = ErrorResponse(int(RaftError.EINTERNAL), repr(e))
        try:
            blob = encode_message(response)
        except Exception as e:  # noqa: BLE001
            flags |= error_flag
            blob = encode_message(
                ErrorResponse(int(RaftError.EINTERNAL),
                              f"unencodable response: {e!r}"))
        return flags, blob


class InProcNetwork:
    """Shared fabric for in-process transports; owns fault injection.

    Test API (TestCluster-style):
      net.partition({"a:1"}, {"b:1","c:1"})  — split-brain
      net.isolate("a:1") / net.heal()
      net.set_delay_ms(5), net.set_drop_rate(0.1)
      net.stop_endpoint(ep) / start_endpoint(ep)  — crash/restart
    """

    def __init__(self) -> None:
        self._servers: dict[str, RpcServer] = {}
        self._blocked_pairs: set[tuple[str, str]] = set()
        self._down: set[str] = set()
        self.delay_ms: float = 0.0
        self.drop_rate: float = 0.0
        self.duplicate_rate: float = 0.0
        self.reorder_rate: float = 0.0
        self.reorder_max_delay_ms: float = 10.0
        self._rng = random.Random(0)
        # geo shaping: a NetworkTopology (tpuraft/rpc/topology.py) adds
        # per-link zone x zone latency/jitter/loss/bandwidth on top of
        # the global knobs; healed separately via heal_topology()
        self.topology = None

    # -- server registry -----------------------------------------------------

    def bind(self, server: RpcServer) -> None:
        self._servers[server.endpoint] = server
        server.running = True

    def unbind(self, endpoint: str) -> None:
        s = self._servers.pop(endpoint, None)
        if s:
            s.running = False

    # -- fault injection -----------------------------------------------------

    def partition(self, side_a: set[str], side_b: set[str]) -> None:
        for a in side_a:
            for b in side_b:
                self._blocked_pairs.add((a, b))
                self._blocked_pairs.add((b, a))

    def partition_one_way(self, src: set[str], dst: set[str]) -> None:
        """Asymmetric partition: src -> dst dropped, dst -> src flows."""
        for a in src:
            for b in dst:
                self._blocked_pairs.add((a, b))

    def isolate(self, endpoint: str) -> None:
        others = set(self._servers) - {endpoint}
        self.partition({endpoint}, others)

    def heal(self) -> None:
        """Heal the NEMESIS layer only (partitions); the topology's
        shape and dynamic events survive — see heal_topology()."""
        self._blocked_pairs.clear()

    def set_topology(self, topology) -> None:
        self.topology = topology

    def heal_topology(self) -> None:
        """Clear the topology's DYNAMIC events (degrades / zone
        partitions / flaps); nemesis partitions and the base zone
        matrix stay."""
        if self.topology is not None:
            self.topology.heal_events()

    def stop_endpoint(self, endpoint: str) -> None:
        self._down.add(endpoint)

    def start_endpoint(self, endpoint: str) -> None:
        self._down.discard(endpoint)

    def set_delay_ms(self, ms: float) -> None:
        self.delay_ms = ms

    def set_drop_rate(self, rate: float) -> None:
        self.drop_rate = rate

    def set_duplicate_rate(self, rate: float) -> None:
        """Deliver (and execute) a frame twice with probability ``rate``;
        the duplicate's response is discarded."""
        self.duplicate_rate = rate

    def set_reorder(self, rate: float, max_delay_ms: float = 10.0) -> None:
        """Hold a frame for a seeded random bounded interval with
        probability ``rate`` so later frames overtake it."""
        self.reorder_rate = rate
        self.reorder_max_delay_ms = max_delay_ms

    # -- the "wire" ----------------------------------------------------------

    async def call(self, src: str, dst: str, method: str, request: Any,
                   timeout_ms: float) -> Any:
        if self.topology is not None:
            await self.topology.traverse(src, dst, request, timeout_ms)
        if self.reorder_rate and self._rng.random() < self.reorder_rate:
            await asyncio.sleep(
                self._rng.uniform(0.0, self.reorder_max_delay_ms) / 1000.0)
        if self.delay_ms:
            await asyncio.sleep(self.delay_ms / 1000.0)
        if (
            dst not in self._servers
            or dst in self._down
            or src in self._down
            or (src, dst) in self._blocked_pairs
            or (self.drop_rate and self._rng.random() < self.drop_rate)
        ):
            # unreachable: behave like a connect/request timeout
            await asyncio.sleep(min(timeout_ms, 50) / 1000.0)
            raise RpcError(
                Status.error(RaftError.EHOSTDOWN, f"{dst} unreachable from {src}"))
        server = self._servers[dst]
        if self.duplicate_rate and self._rng.random() < self.duplicate_rate:
            # the wire delivered the frame twice: the receiver executes
            # both copies; the duplicate's response evaporates
            dup = asyncio.ensure_future(asyncio.wait_for(
                server.dispatch(method, request), timeout_ms / 1000.0))
            dup.add_done_callback(lambda t: t.cancelled() or t.exception())
        try:
            return await asyncio.wait_for(
                server.dispatch(method, request), timeout_ms / 1000.0)
        except asyncio.TimeoutError:
            raise RpcError(Status.error(RaftError.ETIMEDOUT, f"{method} to {dst}"))


class TransportBase:
    """RaftClientService surface shared by every transport backend
    (in-proc loopback, TCP/DCN): ``call`` plus typed helpers."""

    endpoint: str

    async def call(self, dst: str, method: str, request: Any,
                   timeout_ms: Optional[float] = None) -> Any:
        raise NotImplementedError

    # typed helpers (reference: RaftClientService methods)

    async def append_entries(self, dst: str, req, timeout_ms=None):
        return await self.call(dst, "append_entries", req, timeout_ms)

    async def request_vote(self, dst: str, req, timeout_ms=None):
        return await self.call(dst, "request_vote", req, timeout_ms)

    async def install_snapshot(self, dst: str, req, timeout_ms=None):
        return await self.call(dst, "install_snapshot", req, timeout_ms)

    async def timeout_now(self, dst: str, req, timeout_ms=None):
        return await self.call(dst, "timeout_now", req, timeout_ms)

    async def read_index(self, dst: str, req, timeout_ms=None):
        return await self.call(dst, "read_index", req, timeout_ms)

    async def get_file(self, dst: str, req, timeout_ms=None):
        return await self.call(dst, "get_file", req, timeout_ms)


class InProcTransport(TransportBase):
    """The RaftClientService bound to one local endpoint."""

    def __init__(self, network: InProcNetwork, endpoint: str,
                 default_timeout_ms: float = 1000.0):
        self._net = network
        self.endpoint = endpoint
        self._timeout_ms = default_timeout_ms

    async def call(self, dst: str, method: str, request: Any,
                   timeout_ms: Optional[float] = None) -> Any:
        return await self._net.call(
            self.endpoint, dst, method, request,
            timeout_ms if timeout_ms is not None else self._timeout_ms)

