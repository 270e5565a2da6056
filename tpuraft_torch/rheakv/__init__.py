"""RheaKV: an embedded distributed KV store on multi-raft.

Reference parity: ``jraft-rheakv`` (SURVEY.md §3.2) — regions (key
ranges) each backed by one raft group, a store engine per process
multiplexing many regions over one transport, a placement driver for
region scheduling/splitting.

TPU-first design note: regions map to rows of the MultiRaftEngine's
``[G, P]`` device plane — all regions on a store advance their consensus
math in one fused tick (SURVEY.md §3.5 "multi-group data parallelism").
The KV data path stays host-side (storage + RPC), as in the reference.
"""

from tpuraft_torch.rheakv.client import BatchingOptions, RheaKVStore
from tpuraft_torch.rheakv.kv_operation import KVOp, KVOperation
from tpuraft_torch.rheakv.metadata import Region, RegionEpoch, StoreMeta
from tpuraft_torch.rheakv.raw_store import MemoryRawKVStore, RawKVStore
from tpuraft_torch.rheakv.region_engine import RegionEngine
from tpuraft_torch.rheakv.store_engine import StoreEngine

__all__ = [
    "BatchingOptions",
    "KVOp",
    "KVOperation",
    "MemoryRawKVStore",
    "RawKVStore",
    "Region",
    "RegionEngine",
    "RegionEpoch",
    "RheaKVStore",
    "StoreEngine",
    "StoreMeta",
    "create_raw_kv_store",
]


def create_raw_kv_store(uri: str) -> RawKVStore:
    """SPI factory: ``memory://`` or ``native://<dir>`` (C++ engine).
    Imported lazily so the memory path never touches ctypes."""
    from tpuraft_torch.rheakv.native_store import create_raw_kv_store as _create

    return _create(uri)
