"""Live-state dumps for running nodes.

Reference parity [1.3+]: ``Node#describe`` / ``Describer`` printer plus
``NodeDescribeSignalHandler`` / ``NodeMetricsSignalHandler`` (SIGUSR2
dumps — SURVEY.md §6 "Tracing / profiling").  Anything with a
``describe() -> str`` method can be registered; ``dump_all()`` renders
every live registrant, and ``install_signal_dump()`` wires that to a
signal for in-production inspection.
"""

from __future__ import annotations

import logging
import signal
import sys
import time
import weakref
from typing import Optional

LOG = logging.getLogger(__name__)


class DescriberRegistry:
    """Holds weak references so registration never delays GC of a node."""

    def __init__(self) -> None:
        self._objs: "weakref.WeakSet" = weakref.WeakSet()

    def register(self, obj) -> None:
        self._objs.add(obj)

    def unregister(self, obj) -> None:
        self._objs.discard(obj)

    def dump(self) -> str:
        parts = [f"--- describe @ {time.strftime('%Y-%m-%d %H:%M:%S')} "
                 f"({len(self._objs)} objects) ---"]
        for obj in sorted(self._objs, key=str):
            try:
                parts.append(obj.describe())
            except Exception as e:  # a dump must never take the process down
                parts.append(f"{obj}: describe failed: {e!r}")
        return "\n".join(parts)


_registry = DescriberRegistry()


def register(obj) -> None:
    _registry.register(obj)


def unregister(obj) -> None:
    _registry.unregister(obj)


def dump_all() -> str:
    return _registry.dump()


def install_signal_dump(signum: int = signal.SIGUSR2,
                        path: Optional[str] = None) -> None:
    """Dump all registered describers on ``signum`` (default SIGUSR2), to
    ``path`` (append) or stderr.  Safe to call more than once."""

    def _handler(_sig, _frame):
        text = dump_all()
        if path:
            with open(path, "a") as f:
                f.write(text + "\n")
        else:
            print(text, file=sys.stderr)

    signal.signal(signum, _handler)
