"""Ballot/quorum math over ``[G, P]`` tensors: the vectorized BallotBox.

PyTorch counterpart of the JAX package's ``ops/ballot.py`` and the
port's semantic oracle: the fused-quorum CUDA kernel
(``ops/quorum_cuda.py``) must equal these functions bit for bit.

The commit point of a group is an order statistic of its matchIndex
row: the q-th largest voter match, q = n_voters // 2 + 1.  Joint
consensus (old + new conf) takes the min of the two configs' values.
Every function is plain torch ops on whatever device its inputs lie
on; results are int32 (torch sums of bools are int64, so they are cast
back).
"""

from __future__ import annotations

import torch

# Sentinel for masked-out peer slots. Using iinfo.min would overflow under
# arithmetic; half-range is safely below any valid relative index (>= -1).
NEG_INF_I32 = -(2**30)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Per-row number of True slots, int32."""
    return mask.sum(dim=-1, dtype=torch.int32)


def _masked_desc_sort(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sort each row descending with masked slots pushed to the end."""
    v = torch.where(mask, values.to(torch.int32), NEG_INF_I32)
    return torch.sort(v, dim=-1, descending=True).values


def quorum_match_index(match: torch.Tensor,
                       voter_mask: torch.Tensor) -> torch.Tensor:
    """Per-group largest index replicated on a quorum of voters.

    match: int32 [..., P] relative matchIndex per peer slot.
    voter_mask: bool [..., P] — True for voters of the current config.

    Returns int32 [...]: the q-th largest voter matchIndex, where
    q = floor(n_voters/2) + 1; NEG_INF_I32 for groups with zero voters.
    """
    sorted_desc = _masked_desc_sort(match, voter_mask)
    n_voters = _count(voter_mask)
    q_idx = torch.clamp(n_voters // 2, 0, match.shape[-1] - 1)
    picked = torch.gather(sorted_desc, -1,
                          q_idx.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return torch.where(n_voters > 0, picked, NEG_INF_I32)


def joint_quorum_match_index(match: torch.Tensor, voter_mask: torch.Tensor,
                             old_voter_mask: torch.Tensor) -> torch.Tensor:
    """Joint-consensus commit point: needs a quorum of BOTH configs.

    Rows not in joint mode pass an all-False ``old_voter_mask`` row,
    which is ignored for them.
    """
    new_q = quorum_match_index(match, voter_mask)
    old_q = quorum_match_index(match, old_voter_mask)
    in_joint = old_voter_mask.any(dim=-1)
    return torch.where(in_joint, torch.minimum(new_q, old_q), new_q)


def vote_quorum(granted: torch.Tensor, voter_mask: torch.Tensor) -> torch.Tensor:
    """Per-group: does the granted-vote set reach a quorum of voters?"""
    n_voters = _count(voter_mask)
    votes = _count(granted & voter_mask)
    return (n_voters > 0) & (votes >= n_voters // 2 + 1)


def joint_vote_quorum(granted: torch.Tensor, voter_mask: torch.Tensor,
                      old_voter_mask: torch.Tensor) -> torch.Tensor:
    """Election quorum under joint consensus: both configs must grant."""
    new_ok = vote_quorum(granted, voter_mask)
    old_ok = vote_quorum(granted, old_voter_mask)
    in_joint = old_voter_mask.any(dim=-1)
    return torch.where(in_joint, new_ok & old_ok, new_ok)


def witness_commit_clamp(quorum_idx: torch.Tensor, match: torch.Tensor,
                         voter_mask: torch.Tensor,
                         old_voter_mask: torch.Tensor,
                         witness_mask: torch.Tensor) -> torch.Tensor:
    """Clamp the commit point to the best DATA-replica match for groups
    with witness voters.

    Witnesses vote and ack but hold no log payload, so an index acked
    only by witnesses must not commit.  Data peers are the voters of
    either config not marked witness; groups without witnesses pass
    through.  The max over an all-False data row is 0, like the host's
    ``max(..., default=0)``.
    """
    voters = voter_mask | old_voter_mask
    has_witness = (voters & witness_mask).any(dim=-1)
    data = voters & ~witness_mask
    data_best = torch.where(data, match.to(torch.int32), 0).amax(dim=-1)
    return torch.where(has_witness, torch.minimum(quorum_idx, data_best),
                       quorum_idx)


def quorum_ack_time(last_ack: torch.Tensor,
                    voter_mask: torch.Tensor) -> torch.Tensor:
    """q-th most recent voter ack timestamp — the leader-lease and
    step-down primitive.  Same math as :func:`quorum_match_index`."""
    return quorum_match_index(last_ack, voter_mask)


def joint_quorum_ack_time(last_ack: torch.Tensor, voter_mask: torch.Tensor,
                          old_voter_mask: torch.Tensor) -> torch.Tensor:
    """Lease ack point under joint consensus: the older (min) of the two
    configs' quorum ack times."""
    new_q = quorum_ack_time(last_ack, voter_mask)
    old_q = quorum_ack_time(last_ack, old_voter_mask)
    in_joint = old_voter_mask.any(dim=-1)
    return torch.where(in_joint, torch.minimum(new_q, old_q), new_q)
