"""L3 storage: durable raft log, meta, and snapshots.

Reference parity (SURVEY.md §3.1): ``core:storage/`` — LogStorage
(RocksDBLogStorage), LogManager (in-memory window + batched async flush),
LocalRaftMetaStorage, snapshot subsystem.  The file log storage here is a
segmented append log (the C++ native engine in ``native/`` implements the
same on-disk format; selected via ``log_uri`` scheme ``native://``).

Crash-consistency fault injection for all of it lives in
``tpuraft.storage.fault`` (ChaosDir / FaultInjectingFile /
NativeJournalTracker — see docs/operations.md "Crash-consistency
testing"); imported lazily, never on the serving path.
"""

from tpuraft_torch.storage.log_storage import (
    LogStorage,
    MemoryLogStorage,
    FileLogStorage,
    create_log_storage,
)
from tpuraft_torch.storage.meta_storage import RaftMetaStorage
from tpuraft_torch.storage.log_manager import LogManager

__all__ = [
    "LogStorage",
    "MemoryLogStorage",
    "FileLogStorage",
    "create_log_storage",
    "RaftMetaStorage",
    "LogManager",
]
