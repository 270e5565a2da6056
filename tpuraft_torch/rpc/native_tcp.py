"""asyncio bindings for the C++ epoll transport (native/transport.cc).

Reference parity: the seam where SOFABolt rides Netty's *native epoll*
transport (SURVEY.md §3.4 "Netty native transport") — the C++ event
loop owns every socket (listen/accept, pooled outbound connections,
framing, write queues) on its own I/O thread, and asyncio only ever
sees complete frames, delivered through an eventfd registered with
``loop.add_reader``.  Wire format is identical to tpuraft/rpc/tcp.py,
so :class:`NativeTcpRpcServer` serves pure-Python ``TcpTransport``
clients and vice versa.

Build: ``make -C native``; :func:`ensure_built` does it on demand.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import struct
import threading
from typing import Any, Callable, Optional

from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rpc.messages import decode_message, encode_message
from tpuraft_torch.rpc.transport import RpcError, RpcServer, TransportBase

LOG = logging.getLogger(__name__)

_LIB_NAME = "libtpuraft_transport.so"
_F_RESPONSE = 1
_F_ERROR = 2
_EV_FRAME = 1
_EV_CLOSED = 2


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


def lib_path() -> str:
    return os.environ.get(
        "TPURAFT_NATIVE_TRANSPORT_LIB",
        os.path.normpath(os.path.join(_native_dir(), _LIB_NAME)))


def ensure_built(timeout: float = 120.0) -> str:
    from tpuraft_torch.util.native_build import ensure_built as _eb
    return _eb(_native_dir(), lib_path(), timeout=timeout)


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(lib_path())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tnt_create.restype = ctypes.c_void_p
            lib.tnt_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.tnt_destroy.argtypes = [ctypes.c_void_p]
            lib.tnt_notify_fd.restype = ctypes.c_int
            lib.tnt_notify_fd.argtypes = [ctypes.c_void_p]
            lib.tnt_listen.restype = ctypes.c_int
            lib.tnt_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_int]
            lib.tnt_send_to.restype = ctypes.c_int64
            lib.tnt_send_to.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64, ctypes.c_uint8,
                                        ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_char_p, ctypes.c_int]
            lib.tnt_send_conn.restype = ctypes.c_int
            lib.tnt_send_conn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_uint64, ctypes.c_uint8,
                                          ctypes.c_char_p, ctypes.c_int64]
            lib.tnt_drop_endpoint.restype = ctypes.c_int
            lib.tnt_drop_endpoint.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p]
            lib.tnt_next_event.restype = ctypes.c_int
            lib.tnt_next_event.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(u8p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
                ctypes.c_int]
            lib.tnt_free.argtypes = [u8p]
            _lib = lib
        return _lib


class _NativeCtx:
    """One C++ event-loop context wired into the running asyncio loop.

    Owner registers callbacks; frames/closes arrive on the asyncio
    thread via the notify eventfd, so no locking is needed above.
    """

    def __init__(self,
                 on_frame: Callable[[int, str, int, int, bytes], None],
                 on_closed: Callable[[int, str], None]):
        ensure_built()
        self._lib = _load()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.tnt_create(err, len(err))
        if not self._h:
            raise OSError(f"tnt_create: {err.value.decode()}")
        self._on_frame = on_frame
        self._on_closed = on_closed
        self._fd = self._lib.tnt_notify_fd(self._h)
        self._loop = asyncio.get_running_loop()
        self._loop.add_reader(self._fd, self._drain)
        self._closed = False

    def listen(self, host: str, port: int) -> int:
        err = ctypes.create_string_buffer(256)
        bound = self._lib.tnt_listen(self._h, host.encode(), port, err,
                                     len(err))
        if bound < 0:
            raise OSError(f"listen {host}:{port}: {err.value.decode()}")
        return bound

    def send_to(self, endpoint: str, seq: int, flags: int,
                payload: bytes) -> int:
        err = ctypes.create_string_buffer(256)
        conn_id = self._lib.tnt_send_to(self._h, endpoint.encode(), seq,
                                        flags, payload, len(payload), err,
                                        len(err))
        if conn_id < 0:
            raise RpcError(Status.error(
                RaftError.EHOSTDOWN,
                f"send to {endpoint}: {err.value.decode()}"))
        return conn_id

    def send_conn(self, conn_id: int, seq: int, flags: int,
                  payload: bytes) -> bool:
        return self._lib.tnt_send_conn(self._h, conn_id, seq, flags,
                                       payload, len(payload)) == 0

    def drop_endpoint(self, endpoint: str) -> None:
        self._lib.tnt_drop_endpoint(self._h, endpoint.encode())

    def _drain(self) -> None:
        """Dequeue every pending event (called by add_reader)."""
        lib = self._lib
        ev_type = ctypes.c_int()
        conn_id = ctypes.c_int64()
        seq = ctypes.c_uint64()
        flags = ctypes.c_uint8()
        payload = ctypes.POINTER(ctypes.c_uint8)()
        plen = ctypes.c_int64()
        endpoint = ctypes.create_string_buffer(128)
        while not self._closed and lib.tnt_next_event(
                self._h, ctypes.byref(ev_type), ctypes.byref(conn_id),
                ctypes.byref(seq), ctypes.byref(flags),
                ctypes.byref(payload), ctypes.byref(plen), endpoint,
                len(endpoint)):
            data = ctypes.string_at(payload, plen.value) if plen.value \
                else b""
            lib.tnt_free(payload)
            ep = endpoint.value.decode()
            try:
                if ev_type.value == _EV_FRAME:
                    self._on_frame(conn_id.value, ep, seq.value,
                                   flags.value, data)
                elif ev_type.value == _EV_CLOSED:
                    self._on_closed(conn_id.value, ep)
            except Exception:  # noqa: BLE001 — callback bug must not
                LOG.exception("native transport event callback failed")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._loop.remove_reader(self._fd)
        self._lib.tnt_destroy(self._h)
        self._h = None


class NativeTcpRpcServer(RpcServer):
    """Server side: the C++ engine listens/accepts/frames; handlers run
    as asyncio tasks; responses go back over the originating connection.
    Drop-in replacement for TcpRpcServer (same handler registry)."""

    def __init__(self, endpoint: str, bind_host: Optional[str] = None):
        super().__init__(endpoint)
        self._bind_host = bind_host
        self._ctx: Optional[_NativeCtx] = None
        self._bound_port = 0
        self._tasks: set[asyncio.Task] = set()

    @property
    def bound_port(self) -> int:
        return self._bound_port

    async def start(self) -> None:
        host, port_s = self.endpoint.rsplit(":", 1)
        ctx = _NativeCtx(self._on_frame, lambda cid, ep: None)
        try:
            self._bound_port = ctx.listen(self._bind_host or host,
                                          int(port_s))
        except OSError:
            ctx.close()  # don't leak the io thread + fds on bind failure
            raise
        self._ctx = ctx
        self.running = True

    async def stop(self) -> None:
        self.running = False
        for t in list(self._tasks):
            t.cancel()
        for t in list(self._tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._tasks.clear()
        if self._ctx is not None:
            self._ctx.close()
            self._ctx = None

    def _on_frame(self, conn_id: int, endpoint: str, seq: int, flags: int,
                  payload: bytes) -> None:
        # concurrent dispatch, same rationale as TcpRpcServer: a slow
        # handler must not head-of-line-block heartbeats
        t = asyncio.ensure_future(self._serve_one(conn_id, seq, payload))
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _serve_one(self, conn_id: int, seq: int,
                         payload: bytes) -> None:
        flags, blob = await self.serve_framed_payload(
            seq, payload, _F_RESPONSE, _F_ERROR)
        if self._ctx is not None:
            self._ctx.send_conn(conn_id, seq, flags, blob)


class NativeTcpTransport(TransportBase):
    """Client side: pooled pipelined connections owned by the C++
    engine; request/response correlation by sequence number up here.
    Drop-in replacement for TcpTransport."""

    def __init__(self, endpoint: str = "client:0",
                 default_timeout_ms: float = 1000.0):
        self.endpoint = endpoint
        self._timeout_ms = default_timeout_ms
        self._ctx: Optional[_NativeCtx] = None
        self._seq = 0
        # (conn_id, seq) -> future; conn failure fails only its own calls
        self._pending: dict[tuple[int, int], asyncio.Future] = {}

    def _ensure_ctx(self) -> _NativeCtx:
        if self._ctx is None:
            self._ctx = _NativeCtx(self._on_frame, self._on_closed)
        return self._ctx

    def _on_frame(self, conn_id: int, endpoint: str, seq: int, flags: int,
                  payload: bytes) -> None:
        fut = self._pending.pop((conn_id, seq), None)
        if fut is None or fut.done():
            return
        try:
            msg = decode_message(payload)
        except Exception as e:  # noqa: BLE001 — protocol desync
            fut.set_exception(RpcError(Status.error(
                RaftError.EINTERNAL, f"undecodable response: {e!r}")))
            if self._ctx is not None:
                self._ctx.drop_endpoint(endpoint)
            return
        if flags & _F_ERROR:
            fut.set_exception(RpcError(Status(msg.code, msg.msg)))
        else:
            fut.set_result(msg)

    def _on_closed(self, conn_id: int, endpoint: str) -> None:
        status = Status.error(RaftError.EHOSTDOWN,
                              f"connection to {endpoint} lost")
        for key in [k for k in self._pending if k[0] == conn_id]:
            fut = self._pending.pop(key)
            if not fut.done():
                fut.set_exception(RpcError(status))

    async def call(self, dst: str, method: str, request: Any,
                   timeout_ms: Optional[float] = None) -> Any:
        timeout = (timeout_ms if timeout_ms is not None
                   else self._timeout_ms) / 1000.0
        ctx = self._ensure_ctx()
        m = method.encode()
        payload = struct.pack("<H", len(m)) + m + encode_message(request)
        self._seq += 1
        seq = self._seq
        conn_id = ctx.send_to(dst, seq, 0, payload)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # safe: _drain runs on this same loop thread, never mid-statement
        self._pending[(conn_id, seq)] = fut
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop((conn_id, seq), None)
            raise RpcError(Status.error(
                RaftError.ETIMEDOUT, f"{method} to {dst}"))

    async def close(self) -> None:
        if self._ctx is not None:
            self._ctx.close()
            self._ctx = None
        status = Status.error(RaftError.ESHUTDOWN, "transport closed")
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(RpcError(status))
        self._pending.clear()
