"""What the profiler's trace of a window says: the device's busy time,
device time by operation, and the device's idle gaps by what the host
was doing.

``device_busy`` is a frozen copy of ``tpuraft_torch.device_plane.
_device_busy`` (the program may change; the yardstick does not).  The
host's activity comes from the harness's own ``record_function`` ranges
(``HOST_LABELS``); a gap that starts outside all of them is
``host.other``.
"""

from __future__ import annotations

from collections import defaultdict

FUSED_TICK_KERNEL = "fused_tick_kernel"


def device_busy(prof) -> tuple[float, int, int]:
    """(device busy us, kernels, copies) of a profiler window: the sum
    of the device events' own times (one stream: they do not overlap)."""
    import torch

    busy = 0.0
    kernels = copies = 0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
        busy += e.self_device_time_total
    return busy, kernels, copies


class _Averages:
    """A profiler's ``key_averages()``, computed once."""

    def __init__(self, prof):
        self._ka = prof.key_averages()

    def key_averages(self):
        return self._ka


def device_ops(prof) -> dict[str, tuple[int, float]]:
    """Device operations by name: (count, device seconds)."""
    import torch

    out = {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        out[e.key] = (e.count, e.self_device_time_total / 1e6)
    return out


def idle_gaps(prof, labels: tuple[str, ...]) -> dict[str, float]:
    """Seconds the device sat idle between two of its operations, by
    what the host was doing meanwhile: the innermost of the harness's
    ``labels`` ranges open at each instant of a gap, ``host.other``
    where none was."""
    import torch

    dev, points = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.time_range.start, e.time_range.end))
        elif e.name in labels:
            points.append((e.time_range.start, 1, e.name))
            points.append((e.time_range.end, -1, e.name))
    dev.sort()
    end = None
    for s, e in dev:  # gaps between the device's merged busy spans
        if end is not None and s > end:
            points.append((end, 2, None))
            points.append((s, -2, None))
        end = e if end is None else max(end, e)
    points.sort(key=lambda p: (p[0], p[1]))
    by_label: dict[str, float] = defaultdict(float)
    open_labels: list[str] = []
    in_gap = False
    last = None
    for t, kind, name in points:
        if in_gap and last is not None and t > last:
            by_label[open_labels[-1] if open_labels else "host.other"] += \
                (t - last) / 1e6
        last = t
        if kind == 1:
            open_labels.append(name)
        elif kind == -1:
            for j in range(len(open_labels) - 1, -1, -1):
                if open_labels[j] == name:
                    del open_labels[j]
                    break
        else:
            in_gap = kind == 2
    return dict(by_label)


def summarize(prof, window_s: float, labels: tuple[str, ...]) -> dict:
    """The traced window's device record: ``busy_s``, ``window_s``, the
    device operations by name and the breakdown the result line
    carries (the ten longest of each, with all their digits)."""
    import time

    t = time.perf_counter()
    avg = _Averages(prof)
    busy_us, kernels, copies = device_busy(avg)
    ops = device_ops(avg)
    gaps = idle_gaps(prof, labels)
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "kernels": kernels,
        "copies": copies,
        "ops": ops,
        "reduce_s": time.perf_counter() - t,
        "breakdown": {
            "device_ops": [[k, v[1]] for k, v in top_ops],
            "idle_gaps": [[k, v] for k, v in top_gaps],
        },
    }


class WindowTracer:
    """The profiler of a window's traced part: it is entered at
    ``start()`` and left at ``stop()``, so the window's untraced part
    runs with no profiler at all.  A process's first profiler start
    takes seconds (the card's tracing library loads), so it is paid
    here, in set-up, with a throwaway profile of one operation."""

    def __init__(self, device_type: str):
        import torch
        from torch.profiler import ProfilerActivity

        self.acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            self.acts.append(ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=self.acts):
            x = torch.zeros(1, device=device_type) + 1
            if device_type == "cuda":
                torch.cuda.synchronize()
        del x
        self.prof = None
        self.t = None

    def start(self) -> None:
        import time

        import torch

        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.__enter__()
        self.t = time.perf_counter()

    def stop(self) -> float:
        """Stop; the traced seconds."""
        import time

        t = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
        return t - self.t if self.t is not None else 0.0


def paced_idle_share(ctx) -> float | None:
    """The device's idle share, in %, at the pace the window kept with
    no profiler: the traced part's device busy time a unit of work (a
    tick) times the untraced part's units a second.  The profiler's own
    host cost slows the traced part; its device time a tick is the
    card's."""
    tr = ctx.get("trace")
    pace = ctx.get("pace") or {}
    traced, untraced = pace.get("traced_per_s"), pace.get("untraced_per_s")
    if not tr or tr["busy_s"] <= 0 or not traced or not untraced:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"] * untraced / traced)
