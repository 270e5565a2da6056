"""TCP transport: the real-network protocol plane (host<->host over DCN).

Reference parity: SOFABolt's Netty TCP server/client with custom framing
and connection pooling (SURVEY.md §3.1 "RPC layer", §6 "Distributed
communication backend").  One server port multiplexes every raft group,
CLI processor and KV service in the process (NodeManager registers its
handlers on :class:`TcpRpcServer` exactly as it does on the in-proc
``RpcServer``); clients keep one pooled connection per destination with
pipelined request/response correlation by sequence number.

Frame format (little-endian):
    u32 payload_len | u64 seq | u8 flags | payload
    flags bit0: response, bit1: error (payload is ErrorResponse)
    request payload:  u16 method_len | method utf8 | encode_message(msg)
    response payload: encode_message(msg)

The consensus *math* plane rides ICI via XLA collectives
(tpuraft.parallel); this module is only the protocol envelope.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Any, Optional

from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rpc.messages import ErrorResponse, decode_message, encode_message
from tpuraft_torch.rpc.transport import RpcError, RpcServer, TransportBase

LOG = logging.getLogger(__name__)

_HDR = struct.Struct("<IQB")
_F_RESPONSE = 1
_F_ERROR = 2
MAX_FRAME = 256 * 1024 * 1024  # sanity bound (snapshot chunks are ~MBs)


def _split_endpoint(endpoint: str) -> tuple[str, int]:
    host, port = endpoint.rsplit(":", 1)
    return host, int(port)


async def _read_frame(reader: asyncio.StreamReader) -> tuple[int, int, bytes]:
    hdr = await reader.readexactly(_HDR.size)
    length, seq, flags = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise ConnectionError(f"oversized frame: {length}")
    payload = await reader.readexactly(length) if length else b""
    return seq, flags, payload


def _frame(seq: int, flags: int, payload: bytes) -> bytes:
    return _HDR.pack(len(payload), seq, flags) + payload


class TcpRpcServer(RpcServer):
    """One TCP listener per process endpoint; shares the handler registry
    (and therefore NodeManager/CLI/KV processor wiring) with RpcServer."""

    def __init__(self, endpoint: str, bind_host: Optional[str] = None):
        super().__init__(endpoint)
        self._bind_host = bind_host
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set[asyncio.Task] = set()

    @property
    def bound_port(self) -> int:
        """Actual listening port (useful when binding port 0 in tests)."""
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        host, port = _split_endpoint(self.endpoint)
        self._server = await asyncio.start_server(
            self._on_connection, self._bind_host or host, port)
        self.running = True

    async def stop(self) -> None:
        self.running = False
        if self._server is not None:
            self._server.close()
        # cancel live connection handlers BEFORE wait_closed(): since 3.12
        # wait_closed() waits for handlers, which block reading from
        # still-connected clients
        for t in list(self._conn_tasks):
            t.cancel()
        for t in list(self._conn_tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._conn_tasks.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        write_lock = asyncio.Lock()
        pending: set[asyncio.Task] = set()
        try:
            while True:
                seq, _flags, payload = await _read_frame(reader)
                # concurrent dispatch: a slow handler (snapshot chunk,
                # big append) must not head-of-line-block heartbeats;
                # the raft protocol itself is safe under reordering
                # (term + prev_log checks; pipelined replicator resolves
                # out-of-order responses)
                t = asyncio.ensure_future(
                    self._serve_one(seq, payload, writer, write_lock))
                pending.add(t)
                t.add_done_callback(pending.discard)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        finally:
            for t in pending:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            if task is not None:
                self._conn_tasks.discard(task)

    async def _serve_one(self, seq: int, payload: bytes,
                         writer: asyncio.StreamWriter,
                         write_lock: asyncio.Lock) -> None:
        flags, blob = await self.serve_framed_payload(
            seq, payload, _F_RESPONSE, _F_ERROR)
        async with write_lock:
            try:
                writer.write(_frame(seq, flags, blob))
                await writer.drain()
            except (ConnectionError, OSError):
                pass  # peer went away; it will retry


class _Connection:
    """One pooled, pipelined client connection."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.pending: dict[int, asyncio.Future] = {}
        self.write_lock = asyncio.Lock()
        self.reader_task = asyncio.ensure_future(self._read_loop())
        self.closed = False

    async def _read_loop(self) -> None:
        try:
            while True:
                seq, flags, payload = await _read_frame(self.reader)
                fut = self.pending.pop(seq, None)
                if fut is None or fut.done():
                    continue
                if flags & _F_ERROR:
                    err = decode_message(payload)
                    fut.set_exception(
                        RpcError(Status(err.code, err.msg)))
                else:
                    fut.set_result(decode_message(payload))
        except asyncio.CancelledError:
            self._fail_all(ConnectionError("connection closed"))
            raise
        except Exception as e:  # noqa: BLE001 — incl. decode errors: a
            # frame that fails decode_message means protocol desync; the
            # stream position is unrecoverable, so fail+close like a
            # connection error (otherwise the pool would keep handing out
            # a wedged connection whose reader task is dead)
            self._fail_all(e)

    def _fail_all(self, exc: Exception) -> None:
        self.closed = True
        # close the socket here too: the pool overwrites failed
        # connections without awaiting close(), and StreamReaderProtocol
        # keeps the transport registered on EOF (CLOSE_WAIT leak otherwise)
        self.writer.close()
        status = Status.error(RaftError.EHOSTDOWN, f"connection lost: {exc}")
        for fut in self.pending.values():
            if not fut.done():
                fut.set_exception(RpcError(status))
        self.pending.clear()

    async def close(self) -> None:
        self.closed = True
        self.reader_task.cancel()
        try:
            await self.reader_task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


class TcpTransport(TransportBase):
    """Client side: one auto-reconnecting pipelined connection per dst."""

    def __init__(self, endpoint: str = "client:0",
                 default_timeout_ms: float = 1000.0,
                 connect_timeout_ms: float = 1000.0):
        self.endpoint = endpoint
        self._timeout_ms = default_timeout_ms
        self._connect_timeout_ms = connect_timeout_ms
        self._conns: dict[str, _Connection] = {}
        self._conn_locks: dict[str, asyncio.Lock] = {}
        self._seq = 0

    async def _get_connection(self, dst: str) -> _Connection:
        conn = self._conns.get(dst)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(dst, asyncio.Lock())
        async with lock:
            conn = self._conns.get(dst)
            if conn is not None and not conn.closed:
                return conn
            host, port = _split_endpoint(dst)
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port),
                    self._connect_timeout_ms / 1000.0)
            except (OSError, asyncio.TimeoutError) as e:
                raise RpcError(Status.error(
                    RaftError.EHOSTDOWN, f"connect {dst}: {e}")) from e
            conn = _Connection(reader, writer)
            self._conns[dst] = conn
            return conn

    async def call(self, dst: str, method: str, request: Any,
                   timeout_ms: Optional[float] = None) -> Any:
        timeout = (timeout_ms if timeout_ms is not None
                   else self._timeout_ms) / 1000.0
        conn = await self._get_connection(dst)
        m = method.encode()
        # encode BEFORE registering the future: a codec failure must raise
        # cleanly, not orphan a pending entry
        payload = struct.pack("<H", len(m)) + m + encode_message(request)
        self._seq += 1
        seq = self._seq
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        conn.pending[seq] = fut
        try:
            async with conn.write_lock:
                conn.writer.write(_frame(seq, 0, payload))
                await conn.writer.drain()
        except (ConnectionError, OSError) as e:
            conn.pending.pop(seq, None)
            await conn.close()
            # only evict OUR connection: a concurrent caller may already
            # have replaced it with a fresh healthy one
            if self._conns.get(dst) is conn:
                self._conns.pop(dst, None)
            raise RpcError(Status.error(
                RaftError.EHOSTDOWN, f"send to {dst}: {e}")) from e
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            conn.pending.pop(seq, None)
            raise RpcError(Status.error(
                RaftError.ETIMEDOUT, f"{method} to {dst}"))

    async def close(self) -> None:
        for conn in list(self._conns.values()):
            await conn.close()
        self._conns.clear()
