"""Parallelism of the port's multi-raft tick over several devices.

Two complementary planes, as in the JAX package:

- :mod:`tpuraft_torch.parallel.mesh` — split the ``[G]`` and ``[G, P]``
  group state into row blocks along the ``groups`` axis of a list of
  devices (one fused-tick launch and one deadline-fold launch a shard);
- :mod:`tpuraft_torch.parallel.collective` — quorum math over the
  replicas' ``[R, G]`` rows (one launch of the replica-quorum kernel on
  a device, or one a groups-shard of a (replica, groups) grid);
  :mod:`tpuraft_torch.parallel.replica_plane` is the plane that feeds it
  from each replica's durable log, and
  :mod:`tpuraft_torch.parallel.replica_cluster` a bootable cluster on it.

One process drives every device of a mesh or grid.
"""

from tpuraft_torch.parallel.mesh import make_mesh, shard_group_state, sharded_tick
from tpuraft_torch.parallel.collective import (
    replica_commit_point,
    replica_quorum,
    replica_vote_count,
    replicated_tick,
)

__all__ = [
    "make_mesh",
    "shard_group_state",
    "sharded_tick",
    "replica_commit_point",
    "replica_quorum",
    "replica_vote_count",
    "replicated_tick",
]
