"""The replica-axis commit plane of the port, on one device.

:mod:`tpuraft_torch.parallel.collective` holds the quorum math over the
replicas' ``[R, G]`` rows (one launch of the replica-quorum kernel on
CUDA), :mod:`tpuraft_torch.parallel.replica_plane` the plane that feeds
it from each replica's durable log, and
:mod:`tpuraft_torch.parallel.replica_cluster` a bootable cluster on it.
Group-axis mesh sharding over several GPUs is not ported yet (ROADMAP
A7).
"""

from tpuraft_torch.parallel.collective import (
    replica_commit_point,
    replica_quorum,
    replica_vote_count,
    replicated_tick,
)

__all__ = [
    "replica_commit_point",
    "replica_quorum",
    "replica_vote_count",
    "replicated_tick",
]
