"""Nemesis: a composable fault scheduler for chaos drives.

The reference validates its cluster behavior with ad-hoc kill/restart
loops in tests (SURVEY.md §5); tpuraft packages the pattern: a nemesis
repeatedly picks a fault from a weighted menu, applies it, dwells,
heals, and records a timeline.  Faults are plain async callables, so
the same schedule drives any fabric — the in-proc loopback network,
`FaultInjectingTransport`-wrapped real sockets, or process kills.

Usage::

    actions = [
        NemesisAction("drop+delay", apply=start_noise, heal=stop_noise,
                      dwell_s=0.8),
        NemesisAction("leader-kill", apply=kill_leader, heal=restart,
                      dwell_s=0.6, weight=2.0),
    ]
    timeline = await run_nemesis(actions, duration_s=60,
                                 rng=random.Random(7))
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

LOG = logging.getLogger(__name__)


@dataclass
class NemesisAction:
    name: str
    apply: Callable[[], Awaitable[None]]
    heal: Callable[[], Awaitable[None]]
    dwell_s: float = 0.5          # fault duration before healing
    weight: float = 1.0           # relative pick probability
    # faults that sometimes cannot fire (e.g. no current leader) may
    # raise SkipFault from apply; the nemesis just picks again
    applied: int = field(default=0, compare=False)
    # optional post-heal invariant probe (crash-recovery actions assert
    # their recovery invariants here); a failure ABORTS the drive —
    # unlike apply/heal errors, a violated invariant is the verdict,
    # not noise to ride through
    check: Optional[Callable[[], Awaitable[None]]] = None


class SkipFault(Exception):
    """Raised by an action's apply() when the fault is not currently
    applicable (e.g. no leader to kill); the nemesis moves on."""


class StageTrap:
    """Membership-churn coordination: land a seeded crash INSIDE a
    specific ``_ConfigurationCtx`` stage (catching_up / joint / stable).

    Install :meth:`listener` as ``Node.conf_stage_listener`` on every
    node; a nemesis action then ``arm()``s the trap for a target stage
    and awaits :meth:`wait` — the moment any node's conf-change machine
    enters that stage, the trap records the node and fires, and the
    action kills the recorded node's store while the change is mid-stage.
    One-shot per arm(); disarmed while no action is waiting so steady-
    state churn costs nothing.
    """

    def __init__(self) -> None:
        self._armed: Optional[str] = None
        self._event = asyncio.Event()
        self.node = None   # the Node whose ctx hit the armed stage

    def listener(self, node, stage: str) -> None:
        """Install as ``node.conf_stage_listener`` (sync, called under
        the node lock — record and signal only)."""
        if self._armed == stage and not self._event.is_set():
            self.node = node
            self._event.set()

    def arm(self, stage: str) -> None:
        self._armed = stage
        self.node = None
        self._event = asyncio.Event()

    def disarm(self) -> None:
        self._armed = None

    async def wait(self, timeout_s: float) -> bool:
        """True when the armed stage was entered within ``timeout_s``
        (``self.node`` holds the node that entered it)."""
        try:
            await asyncio.wait_for(self._event.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False


async def run_nemesis(actions: list[NemesisAction], duration_s: float,
                      rng, pause_s: float = 0.3,
                      on_tick: Optional[Callable[[str], None]] = None
                      ) -> list[tuple[float, str]]:
    """Drive the fault schedule for ``duration_s``; returns the
    timeline [(t_offset, action_name), ...].  Every applied fault is
    healed before the next one fires (single-fault-at-a-time keeps
    drives reproducible and diagnosable)."""
    if not actions:
        raise ValueError("no nemesis actions")
    weights = [a.weight for a in actions]
    timeline: list[tuple[float, str]] = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < duration_s:
        action = rng.choices(actions, weights=weights)[0]
        stamp = round(time.monotonic() - t0, 2)
        try:
            await action.apply()
        except SkipFault:
            await asyncio.sleep(pause_s)
            continue
        except Exception:
            LOG.exception("nemesis action %s failed to apply", action.name)
            try:
                # apply may have PARTIALLY taken effect before raising —
                # heal best-effort so a botched fault can't linger
                await action.heal()
            except Exception:
                LOG.exception("nemesis action %s failed to heal after "
                              "apply error", action.name)
            # the invariant probe runs on THIS path too: a recovery
            # failure the best-effort heal just swallowed must still
            # abort the drive, not hide in a log line
            if action.check is not None:
                await action.check()
            await asyncio.sleep(pause_s)
            continue
        action.applied += 1
        timeline.append((stamp, action.name))
        if on_tick:
            on_tick(action.name)
        try:
            await asyncio.sleep(action.dwell_s)
        finally:
            try:
                await action.heal()
            except Exception:
                LOG.exception("nemesis action %s failed to heal",
                              action.name)
        if action.check is not None:
            await action.check()   # invariant violation aborts the drive
        await asyncio.sleep(pause_s)
    return timeline
