"""Cluster configuration tracking.

Reference parity (SURVEY.md §3.1): ``core:conf/Configuration`` (peer set +
learners, parse/diff), ``core:conf/ConfigurationEntry`` (conf at a log id,
with the *old* conf during joint consensus), ``core:conf/ConfigurationManager``
(ordered history of committed/appended conf entries so the log manager can
answer "what was the conf at index i").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from tpuraft_torch.entity import LogId, PeerId


@dataclass
class Configuration:
    """A voter set plus optional learner (read-only replica) set.

    **Witnesses** are VOTERS flagged in ``witnesses`` (a subset of
    ``peers``): they vote and ack appends — so every quorum computation
    over ``peers`` covers them transparently — but they store only log
    METADATA (payload-stripped appends), never campaign, and never
    serve reads.  A geo topology gets majority-cost commits without a
    full extra data copy (2 data + 1 witness = quorum 2).  Safety rests
    on two invariants checked in :meth:`is_valid` and enumerated in
    tests/oracle.py: at least one non-witness voter exists (leaders are
    always data replicas), and witnesses stay a strict minority so
    every majority contains a data replica.
    """

    peers: list[PeerId] = field(default_factory=list)
    learners: list[PeerId] = field(default_factory=list)
    witnesses: list[PeerId] = field(default_factory=list)  # subset of peers

    @staticmethod
    def parse(conf_str: str) -> "Configuration":
        """Parse ``"ip:port,ip:port:idx,..."``; learners suffixed
        ``/learner``, witness voters suffixed ``/witness``."""
        conf = Configuration()
        for tok in conf_str.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.endswith("/learner"):
                conf.learners.append(PeerId.parse(tok[: -len("/learner")]))
            elif tok.endswith("/witness"):
                p = PeerId.parse(tok[: -len("/witness")])
                conf.peers.append(p)
                conf.witnesses.append(p)
            else:
                conf.peers.append(PeerId.parse(tok))
        return conf

    def copy(self) -> "Configuration":
        return Configuration(list(self.peers), list(self.learners),
                             list(self.witnesses))

    def is_empty(self) -> bool:
        return not self.peers

    def contains(self, peer: PeerId) -> bool:
        return peer in self.peers

    def is_witness(self, peer: PeerId) -> bool:
        return peer in self.witnesses

    def data_peers(self) -> list[PeerId]:
        """Voters that hold full log payloads (quorum durability)."""
        w = set(self.witnesses)
        return [p for p in self.peers if p not in w]

    def is_valid(self) -> bool:
        """Voter and learner sets must be disjoint; no duplicate peers.
        Witness invariants: witnesses ⊆ peers, at least one data voter
        exists, and witnesses are a strict MINORITY of the voter set
        (< quorum) so every majority contains a data replica — the rule
        is THE enumeration-verified ``util.quorum.witness_minority``
        (one predicate: the verified function IS the enforced one)."""
        from tpuraft_torch.util.quorum import witness_minority

        s = set(self.peers)
        if len(s) != len(self.peers) or (s & set(self.learners)):
            return False
        if len(set(self.witnesses)) != len(self.witnesses):
            return False
        return witness_minority(s, self.witnesses)

    def quorum(self) -> int:
        return len(self.peers) // 2 + 1

    def diff(self, other: "Configuration") -> tuple[set[PeerId], set[PeerId]]:
        """Returns (added, removed) voter peers going self -> other."""
        a, b = set(self.peers), set(other.peers)
        return b - a, a - b

    def list_all(self) -> list[PeerId]:
        return list(self.peers) + list(self.learners)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Configuration):
            return NotImplemented
        return (set(self.peers) == set(other.peers)
                and set(self.learners) == set(other.learners)
                and set(self.witnesses) == set(other.witnesses))

    def __str__(self) -> str:
        w = set(self.witnesses)
        toks = [f"{p}/witness" if p in w else str(p)
                for p in sorted(self.peers)]
        toks += [f"{p}/learner" for p in sorted(self.learners)]
        return ",".join(toks)


@dataclass
class ConfigurationEntry:
    """The configuration in force at a given log id.

    During joint consensus (arbitrary ``changePeers``), ``old_conf`` is
    non-empty and decisions need a quorum of *both* sets — the device
    kernel's double-order-statistic path (tpuraft.ops.ballot).
    """

    id: LogId = field(default_factory=LogId)
    conf: Configuration = field(default_factory=Configuration)
    old_conf: Configuration = field(default_factory=Configuration)

    def is_stable(self) -> bool:
        return self.old_conf.is_empty()

    def contains(self, peer: PeerId) -> bool:
        return self.conf.contains(peer) or self.old_conf.contains(peer)

    def list_peers(self) -> list[PeerId]:
        return list({*self.conf.peers, *self.old_conf.peers})

    def copy(self) -> "ConfigurationEntry":
        return ConfigurationEntry(self.id, self.conf.copy(), self.old_conf.copy())


class ConfigurationManager:
    """Ordered history of configuration entries present in the log.

    Reference: ``core:conf/ConfigurationManager`` — supports truncation from
    either end (snapshot compaction / conflict truncation) and lookup of the
    latest conf at-or-before an index.
    """

    def __init__(self) -> None:
        self._configurations: list[ConfigurationEntry] = []
        self._snapshot = ConfigurationEntry()

    def add(self, entry: ConfigurationEntry) -> bool:
        if self._configurations and self._configurations[-1].id.index >= entry.id.index:
            return False
        self._configurations.append(entry)
        return True

    def truncate_prefix(self, first_index_kept: int) -> None:
        self._configurations = [
            e for e in self._configurations if e.id.index >= first_index_kept
        ]

    def truncate_suffix(self, last_index_kept: int) -> None:
        self._configurations = [
            e for e in self._configurations if e.id.index <= last_index_kept
        ]

    def set_snapshot(self, entry: ConfigurationEntry) -> None:
        if entry.id.index >= self._snapshot.id.index:
            self._snapshot = entry

    def get_snapshot(self) -> ConfigurationEntry:
        return self._snapshot

    def get(self, last_included_index: int) -> ConfigurationEntry:
        """Latest configuration whose log index <= last_included_index."""
        best: Optional[ConfigurationEntry] = None
        for e in self._configurations:
            if e.id.index <= last_included_index:
                best = e
            else:
                break
        if best is None:
            return self._snapshot.copy()
        return best.copy()

    def last(self) -> ConfigurationEntry:
        if self._configurations:
            return self._configurations[-1].copy()
        return self._snapshot.copy()
