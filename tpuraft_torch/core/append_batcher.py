"""AppendBatcher: store-wide append rounds — the write-plane mirror of
the read plane's ReadConfirmBatcher.

The send plane (``EndpointSender``) already packs many groups' append
frames into one ``multi_append`` RPC, but its append lane is strict
stop-and-wait per destination: ONE RPC in flight per endpoint pair, so
at region density every led group's window convoys behind whichever
chunk currently holds the lane (receiver-side fsync included).  The
read plane escaped exactly this shape in PR 10 by windowing store-wide
rounds; this batcher does the same for entries:

- Each drain pass collects EVERY pending (group, peer) window headed
  for one destination endpoint and ships them as ONE ``store_append``
  RPC (``StoreAppendRequest`` rows = plain AppendEntriesRequests — the
  per-group prev-log/term semantics are untouched, so safety is
  per-group unchanged).
- Rounds are WINDOWED per destination (``max_inflight_rounds``): up to
  that many store-wide RPCs ride one endpoint pair concurrently, so a
  slow chunk (one group's big fsync) no longer serializes every other
  group's tail latency behind it.  Per-group ordering still holds with
  concurrent rounds because a replicator submits at most ONE window at
  a time (``Replicator._pending``) — a group's frames can never ride
  two in-flight rounds, which is the whole in-order contract the
  receiver needs.
- One dead endpoint's round times out on its own lane; other
  destinations' lanes never queue behind it (the windowing bound
  tests/test_append_batch.py pins down).
- A receiver that predates ``store_append`` answers ENOMETHOD and this
  endpoint downgrades PERMANENTLY to classic per-group
  ``append_entries`` RPCs (``send_plane.sequential_appends`` — the PD
  delta-batch / kv_batch mixed-fleet pattern), counted in
  ``fallbacks``/``legacy_rows``.

Ack resolution rides the existing ``Replicator.on_batch_responses``
contract, so step-down/term pinning, fast backoff, rollback and the
commit tally (``on_match_advanced`` → ballot box, which for
engine-backed nodes now closes quorums eagerly on the ack — see
``TpuBallotBox.commit_at``) are one implementation shared with the
legacy path.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from tpuraft_torch.rpc.messages import ErrorResponse, StoreAppendRequest
from tpuraft_torch.rpc.transport import RpcError, is_no_method
from tpuraft_torch.util import clock as clockmod
from tpuraft_torch.util.metrics import MetricRegistry

LOG = logging.getLogger(__name__)


def _consume(t: "asyncio.Task") -> None:
    if not t.cancelled():
        t.exception()


# graftcheck: loop-confined — one batcher per store process, driven from
# the store's event loop (replicator submits + round tasks); the lane
# dicts and counters are lockless by that confinement
class AppendBatcher:
    """Windowed store-wide append rounds, one lane per destination.

    Replicators submit through the same ``submit_append(rep, reqs)``
    surface as ``EndpointSender``; the batcher groups everything
    pending per destination on the next loop pass (a burst of
    same-iteration applies coalesces into one round) and keeps up to
    ``max_inflight_rounds`` RPCs in flight per lane.
    """

    max_inflight_rounds = 4
    # cap per round RPC: bounds the receiver's fan-out burst (each row
    # may carry entries + a disk flush) — the EndpointSender chunk size
    max_rows_per_round = 128

    def __init__(self) -> None:
        # dst endpoint -> [(replicator, [AppendEntriesRequest], tmo_ms)]
        self._pending: dict[str, list] = {}
        self._inflight: dict[str, set] = {}
        self._kick_scheduled: set[str] = set()
        self._fast_ok: dict[str, bool] = {}  # dst serves store_append
        self._shut = False
        # gray-failure signal sink (HealthTracker): every round's RPC
        # doubles as a per-endpoint RTT probe
        self.health = None
        # store clock (ISSUE 18): the owning StoreEngine re-points this
        # so the RTT probes ride the store's time plane
        self.clock = clockmod.SYSTEM
        # counters (describe() + MetricRegistry + bench/soak stats)
        self.rounds = 0          # store_append RPCs sent
        self.rows = 0            # (group, peer) frames carried
        self.entries = 0         # log entries carried inside them
        self.fallbacks = 0       # ENOMETHOD downgrades (per endpoint)
        self.legacy_rows = 0     # frames shipped per-group post-downgrade
        self.deviating_rows = 0  # rows answered ErrorResponse (busy/absent)
        self.rejected_rows = 0   # in-protocol rejections (prev-log mismatch)
        self.round_errors = 0    # whole-RPC failures (timeout/unreachable)
        # gauges bound to the live counters (the ReadConfirmBatcher idiom)
        self.metrics = MetricRegistry()
        for name in ("rounds", "rows", "entries", "fallbacks",
                     "legacy_rows", "deviating_rows", "rejected_rows",
                     "round_errors"):
            self.metrics.gauge(f"append_batcher.{name}",
                               lambda n=name: getattr(self, n))
        self.metrics.gauge(
            "append_batcher.rows_per_round",
            lambda: self.rows / self.rounds if self.rounds else 0.0)

    # -- observability --------------------------------------------------------

    def counters(self) -> dict:
        return {
            "append_rounds": self.rounds,
            "append_rows": self.rows,
            "append_entries_batched": self.entries,
            "append_fallbacks": self.fallbacks,
            "append_legacy_rows": self.legacy_rows,
            "append_deviating_rows": self.deviating_rows,
            "append_rejected_rows": self.rejected_rows,
            "append_round_errors": self.round_errors,
        }

    def describe(self) -> str:
        amort = self.rows / self.rounds if self.rounds else 0.0
        return (f"AppendBatcher<rounds={self.rounds} rows={self.rows} "
                f"rows_per_round={amort:.2f} entries={self.entries} "
                f"fallbacks={self.fallbacks} legacy={self.legacy_rows} "
                f"deviating={self.deviating_rows} "
                f"rejected={self.rejected_rows} "
                f"errors={self.round_errors}>")

    # -- submit ---------------------------------------------------------------

    def submit_append(self, replicator, reqs: list) -> None:
        """Queue one group's window for its peer's endpoint lane.  Same
        contract as EndpointSender.submit_append: the whole window
        resolves through ``replicator.on_batch_responses`` /
        ``on_batch_error``, in send order."""
        node = replicator._node
        dst = replicator.peer.endpoint
        if self._shut:
            self._spawn(replicator.on_batch_error())
            return
        self._pending.setdefault(dst, []).append(
            (replicator, reqs, node.options.election_timeout_ms))
        if dst not in self._kick_scheduled:
            # next-loop-pass kick: every window submitted by tasks
            # runnable this iteration (a burst of concurrent applies)
            # joins the same round
            self._kick_scheduled.add(dst)
            asyncio.get_running_loop().call_soon(self._kick, dst)

    def _kick(self, dst: str) -> None:
        self._kick_scheduled.discard(dst)
        if self._shut:
            return
        pend = self._pending.get(dst)
        if not pend:
            return
        inflight = self._inflight.setdefault(dst, set())
        while pend and len(inflight) < self.max_inflight_rounds:
            # take whole windows until the row cap (a window never
            # straddles rounds: its acks resolve as one unit)
            batch: list = []
            nrows = 0
            while pend and (not batch
                            or nrows + len(pend[0][1])
                            <= self.max_rows_per_round):
                item = pend.pop(0)
                batch.append(item)
                nrows += len(item[1])
            t = asyncio.ensure_future(self._round(dst, batch))
            inflight.add(t)

            def _done(tt, dst=dst):
                self._inflight[dst].discard(tt)
                if not tt.cancelled() and tt.exception() is not None:
                    LOG.warning("append round to %s failed: %r", dst,
                                tt.exception())
                self._kick(dst)  # free slot: drain what queued meanwhile

            t.add_done_callback(_done)

    @staticmethod
    def _spawn(coro) -> None:
        t = asyncio.ensure_future(coro)
        t.add_done_callback(_consume)

    # -- rounds ---------------------------------------------------------------

    async def _round(self, dst: str, batch: list) -> None:
        if not self._fast_ok.get(dst, True):
            await self._legacy_round(dst, batch)
            return
        rows: list = []
        routes: list = []           # (replicator, frame count)
        timeout_ms = 0.0
        for rep, reqs, tmo in batch:
            rows.extend(reqs)
            routes.append((rep, len(reqs)))
            # groups with different election timeouts share the round:
            # budget for the slowest (the EndpointSender rule)
            timeout_ms = max(timeout_ms, tmo)
        transport = batch[0][0]._node.transport
        self.rounds += 1
        self.rows += len(rows)
        self.entries += sum(len(r.entries) for r in rows)
        t0 = self.clock.monotonic()
        try:
            resp = await transport.call(
                dst, "store_append", StoreAppendRequest(rows=rows),
                timeout_ms=timeout_ms)
        except asyncio.CancelledError:
            # shutdown mid-RPC: nothing was dispatched yet — fail the
            # whole batch so no replicator stays _pending forever
            self._fail_batch(batch)
            raise
        except RpcError as e:
            if is_no_method(e):
                # receiver predates the write-plane batcher: resend
                # these per group and stay legacy for this endpoint
                self._fast_ok[dst] = False
                self.fallbacks += 1
                await self._legacy_round(dst, batch)
                return
            self.round_errors += 1
            self._fail_batch(batch)
            return
        except Exception:  # noqa: BLE001 — a round bug must not silence
            LOG.exception("store_append round to %s crashed", dst)
            self.round_errors += 1
            self._fail_batch(batch)
            return
        if self.health is not None:
            self.health.note_peer_rtt(dst, self.clock.monotonic() - t0)
        acks = resp.acks
        if len(acks) != len(rows):
            # short/overlong reply reads as failure for the whole round
            # (zip would pair acks with the wrong groups' frames)
            LOG.warning("store_append %s: %d acks for %d rows", dst,
                        len(acks), len(rows))
            self.round_errors += 1
            self._fail_batch(batch)
            return
        i = 0
        for rep, count in routes:
            chunk = acks[i:i + count]
            i += count
            for a in chunk:
                if isinstance(a, ErrorResponse):
                    self.deviating_rows += 1
                elif not getattr(a, "success", True):
                    self.rejected_rows += 1
            # per-group resolution (term pinning, rollback, fast
            # backoff) — the one implementation both planes share.
            # Awaited INLINE in the round task, not spawned: one task
            # per group per round was a measurable slice of the
            # saturated loop at region density, resolutions are short
            # (ack bookkeeping + a wake), and a round that awaits its
            # own groups' resolutions is exactly the backpressure the
            # window wants.
            try:
                await rep.on_batch_responses(chunk)
            except Exception:  # noqa: BLE001 — one group's resolution
                LOG.exception("append-round resolution failed")

    async def _legacy_round(self, dst: str, batch: list) -> None:
        """Per-group classic append_entries for pre-batcher receivers.
        Groups run concurrently (their flushes still coalesce into the
        receiver's group-commit); the round slot stays occupied until
        all resolve, which keeps stop-and-wait-ish backpressure toward
        the old endpoint."""
        from tpuraft_torch.core.send_plane import sequential_appends

        self.legacy_rows += sum(len(reqs) for _rep, reqs, _t in batch)
        await asyncio.gather(
            *(sequential_appends(rep, dst, reqs)
              for rep, reqs, _tmo in batch),
            return_exceptions=True)

    def _fail_batch(self, batch: list) -> None:
        for rep, _reqs, _tmo in batch:
            self._spawn(rep.on_batch_error())

    # -- lifecycle ------------------------------------------------------------

    async def shutdown(self) -> None:
        self._shut = True
        for pend in self._pending.values():
            self._fail_batch(pend)
            pend.clear()
        for tasks in self._inflight.values():
            for t in list(tasks):
                t.cancel()
        self._pending.clear()
