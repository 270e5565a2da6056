"""RepeatedTimer: stoppable, restartable recurring timer with jitter.

Reference parity: ``core:util/RepeatedTimer`` (election/vote/stepdown/
snapshot timers — SURVEY.md §3.1 "Timers & queues").  asyncio-native: one
task per timer instead of a hashed wheel; the multi-raft engine replaces
per-group timers with tick-tensor deadlines (tpuraft.ops.tick), so this
class only backs the single-group host runtime and the snapshot cadence.

Time discipline (ISSUE 18): the delay is a DEADLINE on the injected
clock, slept toward in bounded real-time slices — so a store whose
ChaosClock runs 1.1x fast fires its election timers early, a frozen
clock never fires them, and a forward jump fires them immediately,
exactly like a real machine with that clock.  With the default
SystemClock one slice covers the whole delay and the loop degenerates
to the single ``asyncio.sleep`` it always was.
"""

from __future__ import annotations

import asyncio
import random
from typing import Awaitable, Callable, Optional

from tpuraft_torch.util import clock as _clockmod


class RepeatedTimer:
    #: real-seconds cap per sleep slice under an injected clock: the
    #: lag bound between a clock fault landing and the timer noticing
    _SLICE_S = 0.05

    def __init__(
        self,
        name: str,
        timeout_ms: int,
        on_trigger: Callable[[], Awaitable[None]],
        adjust: Optional[Callable[[int], int]] = None,
        clock: Optional[object] = None,
    ):
        """``adjust`` maps the base timeout to the actual per-round delay —
        e.g. randomized election timeouts (reference: NodeImpl's
        ``randomTimeout``)."""
        self._name = name
        self._timeout_ms = timeout_ms
        self._on_trigger = on_trigger
        self._adjust = adjust or (lambda t: t)
        self._clock = _clockmod.resolve(clock)
        self._task: Optional[asyncio.Task] = None
        self._stopped = True
        self._destroyed = False

    @staticmethod
    def random_adjust(timeout_ms: int) -> int:
        """Election-style jitter: [timeout, 2*timeout)."""
        return timeout_ms + random.randrange(timeout_ms)

    def start(self) -> None:
        if self._destroyed or not self._stopped:
            return
        self._stopped = False
        self._schedule()

    def _schedule(self) -> None:
        delay = self._adjust(self._timeout_ms) / 1000.0
        self._task = asyncio.ensure_future(self._run(delay))

    async def _sleep(self, delay: float) -> None:
        """Sleep until ``delay`` elapses ON THE TIMER'S CLOCK."""
        clock = self._clock
        if clock is _clockmod.SYSTEM:
            await asyncio.sleep(delay)
            return
        deadline = clock.monotonic() + delay
        while True:
            rem = deadline - clock.monotonic()
            if rem <= 0:
                return
            # bounded slices: a frozen clock parks here (rem never
            # shrinks) without spinning, and a rate change lands within
            # one slice instead of after the stale full delay
            await asyncio.sleep(min(rem, self._SLICE_S))

    async def _run(self, delay: float) -> None:
        try:
            await self._sleep(delay)
            if self._stopped or self._destroyed:
                return
            await self._on_trigger()
        except asyncio.CancelledError:
            return
        except Exception:
            import logging

            logging.getLogger(__name__).exception("timer %s handler failed", self._name)
        # only the active generation reschedules: a restart() from inside
        # the handler already created a fresh task
        if (not self._stopped and not self._destroyed
                and self._task is asyncio.current_task()):
            self._schedule()

    def stop(self) -> None:
        self._stopped = True
        task, self._task = self._task, None
        # A handler may stop its own timer (e.g. _elect_self stopping the
        # election timer that fired it).  Cancelling the current task
        # would kill the handler at its next await — mark stopped instead;
        # _run won't reschedule.
        if task is not None and task is not asyncio.current_task():
            task.cancel()

    def restart(self) -> None:
        self.stop()
        self._stopped = False
        self._schedule()

    def reset_timeout(self, timeout_ms: int) -> None:
        self._timeout_ms = timeout_ms

    async def destroy(self) -> None:
        self._destroyed = True
        self.stop()

    @property
    def running(self) -> bool:
        return not self._stopped
