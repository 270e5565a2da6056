"""SnapshotExecutor: periodic/on-demand snapshot save, remote install.

Reference parity: ``core:storage/snapshot/SnapshotExecutorImpl``
(SURVEY.md §3.1): doSnapshot (FSM save -> atomic commit -> log prefix
truncation), installSnapshot (leader streams files to a lagging follower
via the file service; follower loads and resets its log).  This subsystem
doubles as checkpoint/resume AND log compaction (§6).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

from tpuraft_torch.conf import Configuration, ConfigurationEntry
from tpuraft_torch.entity import LogId, PeerId
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rpc.messages import (
    InstallSnapshotRequest,
    InstallSnapshotResponse,
    SnapshotMeta,
)
from tpuraft_torch.rpc.transport import RpcError
from tpuraft_torch.storage.log_manager import _is_enospc
from tpuraft_torch.storage.snapshot import (
    LocalSnapshotStorage,
    RemoteFileCopier,
    SnapshotReader,
    ThroughputSnapshotThrottle,
    _MANIFEST,
    _decode_manifest,
)

LOG = logging.getLogger(__name__)


class SnapshotExecutor:
    def __init__(self, node, snapshot_uri: str):
        assert snapshot_uri.startswith("file://"), snapshot_uri
        self._node = node
        self._storage = LocalSnapshotStorage(snapshot_uri[len("file://"):])
        self.last_snapshot_id = LogId(0, 0)
        self.installing = False
        self._saving = False
        # one throttle for the whole node so concurrent installs share the
        # byte budget; rebuilt if the configured rate changes
        self._throttle: Optional[ThroughputSnapshotThrottle] = None
        self._throttle_bps = 0

    def _get_throttle(self) -> Optional[ThroughputSnapshotThrottle]:
        bps = self._node.options.snapshot.throttle_bytes_per_sec
        if bps != self._throttle_bps:
            self._throttle = ThroughputSnapshotThrottle(bps) if bps > 0 else None
            self._throttle_bps = bps
        return self._throttle

    # -- lifecycle -----------------------------------------------------------

    async def init(self) -> LogId:
        """Load the newest local snapshot into the FSM (direct call — the
        FSMCaller loop isn't running yet at bootstrap). Returns the
        bootstrap id the FSM state corresponds to."""
        self._storage.init()
        reader = self._storage.open()
        if reader is None:
            return LogId(0, 0)
        meta = reader.load_meta()
        node = self._node
        ok = await node.options.fsm.on_snapshot_load(reader)
        if not ok:
            LOG.error("%s: on_snapshot_load failed at init", node)
            return LogId(0, 0)
        self.last_snapshot_id = LogId(meta.last_included_index,
                                      meta.last_included_term)
        conf = _conf_from_meta(meta)
        await node.log_manager.set_snapshot(
            self.last_snapshot_id, conf,
            keep_margin=node.options.snapshot.log_index_margin)
        node.conf_entry = conf
        return self.last_snapshot_id

    async def shutdown(self) -> None:
        pass

    # -- save ----------------------------------------------------------------

    async def do_snapshot(self) -> Status:
        node = self._node
        if self.installing:
            return Status.error(RaftError.EBUSY, "installing a snapshot")
        if self._saving:
            return Status.error(RaftError.EBUSY, "snapshot already running")
        if node.fsm_caller.last_applied_index <= self.last_snapshot_id.index:
            return Status.error(RaftError.ECANCELED, "nothing new to snapshot")
        self._saving = True
        try:
            writer = self._storage.create()
            done_fut: asyncio.Future = asyncio.get_running_loop().create_future()
            meta_box: dict = {}

            def done(st: Status) -> None:
                if not done_fut.done():
                    done_fut.set_result(st)

            # capture applied state consistently: build meta inside the
            # FSMCaller queue right before on_snapshot_save runs
            async def save_wrapper(w, d):
                meta_box["id"] = LogId(node.fsm_caller.last_applied_index,
                                       node.fsm_caller.last_applied_term)
                try:
                    await node.options.fsm.on_snapshot_save(w, d)
                except Exception as exc:
                    # a failed SAVE (ENOSPC on the temp dir, most
                    # likely) must not escape into the FSMCaller drain
                    # loop — that poisons the queue and ERRORs the
                    # whole node.  The old snapshot is untouched; fail
                    # just this attempt and let reclaim retry.
                    LOG.exception("%s snapshot save failed", node)
                    d(Status.error(RaftError.EIO,
                                   f"snapshot save failed: {exc}"))

            node.fsm_caller._enqueue(
                ("snapshot_save_custom", (writer, done, save_wrapper)))
            st = await done_fut
            if not st.is_ok():
                return st
            snap_id: LogId = meta_box["id"]
            conf_entry = node.log_manager.conf_manager.get(snap_id.index)
            if conf_entry.conf.is_empty():
                conf_entry = ConfigurationEntry(
                    LogId(0, 0), node.conf_entry.conf.copy(),
                    node.conf_entry.old_conf.copy())
            meta = SnapshotMeta(
                last_included_index=snap_id.index,
                last_included_term=snap_id.term,
                peers=[str(p) for p in conf_entry.conf.peers],
                old_peers=[str(p) for p in conf_entry.old_conf.peers],
                learners=[str(p) for p in conf_entry.conf.learners],
                old_learners=[str(p) for p in conf_entry.old_conf.learners],
                witnesses=[str(p) for p in conf_entry.conf.witnesses],
                old_witnesses=[str(p) for p in conf_entry.old_conf.witnesses],
            )
            loop = asyncio.get_running_loop()
            budget = getattr(node.options, "disk_budget", None)
            try:
                await loop.run_in_executor(
                    None, self._storage.commit, writer, meta)
            except Exception as exc:
                # commit failed (ENOSPC on manifest write / rename):
                # the previous snapshot_<N> is intact and the temp dir
                # is swept at next init/create — report, don't crash
                LOG.exception("%s snapshot commit failed", node)
                if budget is not None and _is_enospc(exc):
                    budget.note_enospc()
                return Status.error(RaftError.EIO,
                                    f"snapshot commit failed: {exc}")
            if budget is not None:
                budget.note_snapshot(self._storage.last_commit_bytes
                                     - self._storage.last_reclaimed_bytes)
            self.last_snapshot_id = snap_id
            await node.log_manager.set_snapshot(
                snap_id, conf_entry,
                keep_margin=node.options.snapshot.log_index_margin)
            node.metrics.counter("snapshots-saved")
            LOG.info("%s snapshot saved at %s", node, snap_id)
            return Status.OK()
        finally:
            self._saving = False

    # -- leader: install on a lagging follower -------------------------------

    async def send_install_snapshot(self, peer: PeerId, replicator) -> bool:
        node = self._node
        reader = self._storage.open()
        if reader is None:
            LOG.error("%s: follower %s needs snapshot but none exists",
                      node, peer)
            return False
        meta = reader.load_meta()
        if meta.last_included_index < replicator.next_index:
            return False  # snapshot too old to help
        reader_id = node.node_manager.register_file_reader(
            _ChunkAdapter(reader, self._get_throttle()))
        try:
            req = InstallSnapshotRequest(
                group_id=node.group_id,
                server_id=str(node.server_id),
                peer_id=str(peer),
                term=node.current_term,
                meta=meta,
                uri=f"remote://{node.server_id.endpoint}/{reader_id}",
            )
            # the RPC stays open for the whole file copy: under a byte
            # throttle that takes total_size/bps, so scale the timeout
            # (2x for contention with other installs sharing the budget)
            timeout_ms = node.options.election_timeout_ms * 10
            if self._throttle is not None:
                timeout_ms += int(
                    reader.total_size() / self._throttle_bps * 2000)
            try:
                resp: InstallSnapshotResponse = await node.transport.install_snapshot(
                    peer.endpoint, req, timeout_ms=timeout_ms)
            except RpcError as e:
                LOG.warning("%s install_snapshot to %s failed: %s", node, peer, e)
                return False
            if resp.term > node.current_term:
                await node.step_down_on_higher_term(
                    resp.term, f"install_snapshot response from {peer}")
                return False
            if not resp.success:
                return False
            replicator.next_index = meta.last_included_index + 1
            replicator._matched = False  # re-probe from the snapshot point
            node.metrics.counter("install-snapshot-sent")
            LOG.info("%s installed snapshot %d on %s", node,
                     meta.last_included_index, peer)
            return True
        finally:
            node.node_manager.unregister_file_reader(reader_id)

    # -- follower: receive an install ---------------------------------------

    async def handle_install_snapshot(self, req: InstallSnapshotRequest
                                      ) -> InstallSnapshotResponse:
        node = self._node
        async with node._lock:
            if req.term < node.current_term:
                return InstallSnapshotResponse(term=node.current_term,
                                               success=False)
            from tpuraft_torch.core.node import State

            if req.term > node.current_term or node.state != State.FOLLOWER:
                await node._step_down(req.term, Status.error(
                    RaftError.EHIGHERTERMREQUEST, "install_snapshot"),
                    new_leader=PeerId.parse(req.server_id))
            node._last_leader_timestamp = node._clock.monotonic()
            if self.installing or self._saving:
                # save and install share the storage temp dir — mutual
                # exclusion both ways (reference: savingSnapshot /
                # downloadingSnapshot guards); the leader's paced retry
                # comes back after the local save finishes
                return InstallSnapshotResponse(term=node.current_term,
                                               success=False)
            if req.meta.last_included_index <= self.last_snapshot_id.index:
                return InstallSnapshotResponse(term=node.current_term,
                                               success=True)
            self.installing = True
        try:
            ok = await self._do_install(req)
            return InstallSnapshotResponse(term=node.current_term, success=ok)
        finally:
            self.installing = False

    async def _load_committed_install(self, meta: SnapshotMeta,
                                      path: str) -> bool:
        """Shared tail of BOTH install paths (full file copy and the
        witness meta-only skip): load the committed snapshot dir into
        the FSM queue, then adopt id/conf/commit under the node lock —
        one copy of the state-mutation protocol, so a future change
        cannot drift between the two."""
        node = self._node
        reader = SnapshotReader(path)
        fut = await node.fsm_caller.on_snapshot_load(reader)
        if not await fut:
            LOG.error("%s on_snapshot_load failed during install", node)
            return False
        snap_id = LogId(meta.last_included_index, meta.last_included_term)
        self.last_snapshot_id = snap_id
        conf = _conf_from_meta(meta)
        async with node._lock:
            await node.log_manager.set_snapshot(snap_id, conf)
            node.conf_entry = conf
            node.ballot_box.update_conf(conf.conf, conf.old_conf)
            node.ballot_box.set_last_committed_index(snap_id.index)
        node.metrics.counter("install-snapshot-received")
        LOG.info("%s loaded installed snapshot at %s", node, snap_id)
        return True

    async def _do_install(self, req: InstallSnapshotRequest) -> bool:
        node = self._node
        loop = asyncio.get_running_loop()
        if node.options.witness:
            # WITNESS SKIP: a witness holds no FSM state, so there is
            # nothing to download — commit an EMPTY local snapshot at
            # the leader's meta (the compaction point + conf), load it
            # through the null FSM (advances the applied index), and
            # reset the metadata journal there.  A lagging geo witness
            # catches up in one meta-sized RPC instead of a full state
            # transfer over the WAN.
            writer = self._storage.create()
            path = await loop.run_in_executor(
                None, self._storage.commit, writer, req.meta)
            node.metrics.counter("install-snapshot-witness-skips")
            return await self._load_committed_install(req.meta, path)
        # parse uri: remote://<endpoint>/<reader_id>
        rest = req.uri[len("remote://"):]
        endpoint, _, rid = rest.partition("/")
        copier = RemoteFileCopier(node.transport, endpoint, int(rid),
                                  chunk_size=node.options.snapshot.max_chunk_size)
        writer = self._storage.create()
        try:
            manifest_blob = await copier.read_bytes(_MANIFEST)
            meta, files = _decode_manifest(manifest_blob)
            # filter-before-copy (reference: LocalSnapshotCopier#filter
            # BeforeCopy): files our latest local snapshot already holds
            # with identical name+size+crc are copied locally, not
            # re-downloaded — an InstallSnapshot where only part of the
            # state changed ships only the changed files
            local = self._storage.open()
            have = {}
            if local is not None:
                have = {(lf.name, lf.size, lf.crc):
                        os.path.join(local.path, lf.name)
                        for lf in local.files()}
            reused = 0
            loop = asyncio.get_running_loop()
            for f in files:
                dst = os.path.join(writer.path, f.name)
                if (f.name, f.size, f.crc) in have and local is not None:
                    # verify the LOCAL bytes before trusting them: the
                    # manifest crc was recorded at save time; rot since
                    # then must fall back to the network copy, not be
                    # laundered into a new self-consistent manifest
                    ok = await loop.run_in_executor(
                        None, _reuse_local_file, local, f.name, dst)
                    if ok:
                        reused += 1
                    else:
                        await copier.copy_to(f.name, dst)
                else:
                    await copier.copy_to(f.name, dst)
                writer.add_file(f.name)
            if reused:
                node.metrics.counter("install-snapshot-files-reused", reused)
                LOG.info("%s install: reused %d/%d files from local snapshot",
                         node, reused, len(files))
        except (RpcError, ValueError, IOError) as e:
            LOG.warning("%s snapshot copy failed: %s", node, e)
            return False
        path = await loop.run_in_executor(
            None, self._storage.commit, writer, meta)
        return await self._load_committed_install(meta, path)


class _ChunkAdapter:
    """Adapts SnapshotReader to the file-service read_file(name, off, count)
    protocol (reference: FileService + SnapshotFileReader).  ``throttle``
    (if set) is consulted by the file service before each chunk read."""

    def __init__(self, reader: SnapshotReader,
                 throttle: Optional[ThroughputSnapshotThrottle] = None):
        self._reader = reader
        self.throttle = throttle

    def read_file(self, name: str, offset: int, count: int):
        return self._reader.read_chunk(name, offset, count)


def _reuse_local_file(local, name: str, dst: str) -> bool:
    """Copy a file from the local snapshot into ``dst`` with the same
    durability as a network download: crc-verified read (read_file
    raises on rot), then write + fsync.  False => caller re-downloads.
    Runs in an executor thread."""
    try:
        data = local.read_file(name)
    except IOError:
        return False
    if data is None:
        return False
    with open(dst, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return True


def _conf_from_meta(meta: SnapshotMeta) -> ConfigurationEntry:
    return ConfigurationEntry(
        id=LogId(meta.last_included_index, meta.last_included_term),
        conf=Configuration(
            [PeerId.parse(p) for p in meta.peers],
            [PeerId.parse(p) for p in meta.learners],
            [PeerId.parse(p) for p in meta.witnesses]),
        old_conf=Configuration(
            [PeerId.parse(p) for p in meta.old_peers],
            [PeerId.parse(p) for p in meta.old_learners],
            [PeerId.parse(p) for p in meta.old_witnesses]),
    )
