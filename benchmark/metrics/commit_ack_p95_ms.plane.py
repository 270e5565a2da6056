"""commit_ack_p95_ms.plane: the 95th percentile over every tick of the
window of submit to its commit row on the host (the loop's own
latencies)."""

from benchmark.core.stats import percentile


def read(ctx):
    p = percentile(ctx.get("lat_s", ()), 95)
    return None if p is None else p * 1e3
