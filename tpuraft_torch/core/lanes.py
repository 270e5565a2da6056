"""Worker lanes: dedicated pipeline-stage threads over shared-nothing queues.

*Scaling Replicated State Machines with Compartmentalization* (PAPERS.md)
decouples the roles one replica multiplexes so each scales on its own
core.  Inside one store process the asyncio loop already offloads RPC
framing and log fsync to the executor; the remaining single-core stages
are FSM apply and client-batch encode.  A :class:`WorkerLane` is the
smallest compartment that moves one such stage off the loop: ONE
dedicated thread draining ONE submission queue in FIFO order.

Design contract (what makes this safe without fine-grained locking):

- **shared-nothing ownership** — state a lane stage mutates (the raw KV
  store under FSM apply) is owned by the lane thread; every other access
  (read serving, snapshot serialization, split-point probing) must be
  SUBMITTED to the lane rather than touching the state from the loop;
- **FIFO ordering** — jobs run in submission order, so the raft apply
  order is preserved and a read submitted after the fence's applies see
  them (queue order is the happens-before edge);
- **loop-side completion** — results and exceptions hop back via
  ``call_soon_threadsafe``; the lane thread never touches asyncio
  futures directly.
"""

from __future__ import annotations

import asyncio
import queue
import threading
from typing import Optional


class WorkerLane:
    """One dedicated stage thread + its submission queue.

    Cross-thread state is confined to the internally-locked
    ``queue.SimpleQueue``; ``jobs`` is bumped only by the lane thread
    and read (monotonic, int-atomic under the GIL) by metrics.
    """

    def __init__(self, name: str = "lane"):
        self.name = name
        self.jobs = 0          # written by the lane thread only
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=f"tpuraft-{name}", daemon=True)
        self._thread.start()

    # -- loop side -----------------------------------------------------------

    def submit(self, fn, *args) -> asyncio.Future:
        """Queue ``fn(*args)`` onto the lane thread; await the returned
        future for its result (exceptions propagate).  Must be called
        from a running event loop."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._q.put((fn, args, loop, fut))
        return fut

    def depth(self) -> int:
        """Submitted-but-unfinished job count (approximate, for gauges)."""
        return self._q.qsize()

    async def aclose(self, timeout: float = 5.0) -> None:
        """Drain pending jobs, stop the thread; join off-loop."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join, timeout)

    def close_blocking(self, timeout: float = 5.0) -> None:
        """Non-async teardown (tests / atexit paths)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout)

    # -- lane thread ---------------------------------------------------------

    @staticmethod
    def _resolve(fut: asyncio.Future, result, exc: Optional[BaseException]):
        if fut.done():        # loop torn down / caller gone mid-flight
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, loop, fut = item
            try:
                result, exc = fn(*args), None
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                result, exc = None, e
            self.jobs += 1
            try:
                loop.call_soon_threadsafe(self._resolve, fut, result, exc)
            except RuntimeError:
                return  # loop closed under us: shutting down
