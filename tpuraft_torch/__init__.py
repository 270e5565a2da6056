"""tpuraft_torch — the PyTorch/CUDA port of tpuraft, a multi-raft
consensus framework whose per-group quorum math runs as one batched
device tick over ``[groups, peers]`` state tensors.

The port stands beside the JAX package and imports nothing of it: the
host protocol (asyncio nodes, RPC, log and snapshot storage, the RheaKV
store) is carried over as its own copy, and the device plane
(``tpuraft_torch.ops``) is torch code around a hand-written CUDA kernel
for Hopper.  Entry points run on the
CUDA card unless the caller asks for the CPU
(``TickOptions(device="cpu")``).
"""

__version__ = "0.1.0"

from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.entity import PeerId, LogId, LogEntry, EntryType, Task
from tpuraft_torch.conf import Configuration

__all__ = [
    "RaftError",
    "Status",
    "PeerId",
    "LogId",
    "LogEntry",
    "EntryType",
    "Task",
    "Configuration",
]
