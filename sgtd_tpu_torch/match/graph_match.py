"""Legacy coarse matcher: semantic-topology histograms + linear assignment
(port of sgtd_tpu.match.graph_match).

The reference's alternate ``graph_match`` path (Semantic_Graph.hpp:359-521),
superseded by the descriptor SearchLoop but kept for parity:

  * per-node feature: 9 classes x 12 range bins (5 m each) histogram of the
    other nodes (:385-407);
  * assignment on the histogram-distance cost with same-class gating and a
    density ratio gate (:414-426), solved as in the JAX package by a
    Bertsekas auction (parallel bidding, 64 sweeps; the reference's LSAP
    and LAPJV are sequential augmenting paths);
  * pairwise-distance consistency filter: a match survives when >= 20% of
    its co-matches preserve inter-node distances within 10% (:463-489);
  * final score = matched fraction (:492-494).

The auction's sweeps are tensor operations on the inputs' device with no
host synchronisation. Distances follow the reference's float32 order on
the CPU (FMA sums of squares, correctly rounded roots, the division by the
bin width as a multiplication by its reciprocal).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sgtd_tpu_torch.utils import segment_max, sq_norm_fma, sqrt_rn

_BIG = 1e9


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(sq_norm_fma(v))


def node_histograms(
    centers: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    num_classes: int = 9,
    num_bins: int = 12,
    bin_m: float = 5.0,
    label_base: int = 3,
) -> torch.Tensor:
    """(N, num_classes * num_bins) float32 semantic-topology histogram per node."""
    n = centers.shape[0]
    d = _norm3(centers[:, None, :] - centers[None, :, :])  # (N, N)
    bins = (d * float(np.float32(1.0) / np.float32(bin_m))).to(torch.int32).clamp(max=num_bins - 1)
    cls = (labels - label_base).clamp(0, num_classes - 1)
    feat_idx = (cls[None, :] * num_bins + bins).long()  # (N, N)
    weights = mask[None, :].to(torch.float32).expand(n, n)
    flat = torch.zeros((n, num_classes * num_bins), dtype=torch.float32, device=centers.device)
    flat.scatter_add_(1, feat_idx, weights)  # integer counts: exact in any order
    return torch.where(mask[:, None], flat, 0.0)


def _col_of_row(owner: torch.Tensor, n: int) -> torch.Tensor:
    """Row -> owned column (or -1) from column -> owner row (or -1)."""
    m = owner.shape[0]
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=owner.device)
    cols = torch.arange(m, dtype=torch.int32, device=owner.device)
    out[torch.where(owner >= 0, owner, n).long()] = torch.where(owner >= 0, cols, -1)
    return out[:n]


def auction_assignment(cost: torch.Tensor, valid: torch.Tensor, sweeps: int = 64) -> torch.Tensor:
    """Min-cost assignment by Bertsekas auction. cost: (N, M) float32 with
    1e9 for forbidden pairs; valid: (N,) rows to assign. Returns (N,) int32
    column index or -1."""
    n, m = cost.shape
    dev = cost.device
    benefit = -cost
    rows = torch.arange(n, device=dev)
    price = torch.zeros(m, dtype=torch.float32, device=dev)
    owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
    for _ in range(sweeps):
        # Rows that own a column sit out; the rest bid.
        unassigned = valid & (_col_of_row(owner, n) < 0)
        value = benefit - price[None, :]
        best = value.max(dim=1).values
        best_j = value.argmax(dim=1)  # the first maximum, as jnp.argmax
        value2 = value.clone()
        value2[rows, best_j] = -_BIG
        second = value2.max(dim=1).values
        bid = price[best_j] + (best - second) + 1e-3
        # Highest bid per column wins; among equal bids the highest row.
        bid_masked = torch.where(unassigned, bid, -_BIG)
        col_bid = segment_max(bid_masked, best_j, m)
        has_bid = col_bid > -_BIG / 2
        is_winner = unassigned & (bid_masked >= col_bid[best_j] - 1e-6)
        winner_row = segment_max(torch.where(is_winner, rows.to(torch.int32), -1), best_j, m)
        price = torch.where(has_bid, col_bid, price)
        owner = torch.where(has_bid, winner_row, owner)

    col_of_row = _col_of_row(owner, n)
    c = cost[rows, col_of_row.clamp(min=0).long()]
    return torch.where(valid & (col_of_row >= 0) & (c < _BIG / 2), col_of_row, -1)


class GraphMatchResult(NamedTuple):
    matches: torch.Tensor  # (N,) map-node index per query node, -1 unmatched
    score: torch.Tensor  # () matched fraction


def graph_match(q_centers, q_labels, q_density, q_mask, m_centers, m_labels, m_density, m_mask) -> GraphMatchResult:
    """Match a query graph against one map keyframe graph (legacy path).

    Nodes beyond 50 m of the sensor are ignored (ref :366,378).
    """
    q_mask = q_mask & (_norm3(q_centers) <= 50.0)
    m_mask = m_mask & (_norm3(m_centers) <= 50.0)

    fq = node_histograms(q_centers, q_labels, q_mask)
    fm = node_histograms(m_centers, m_labels, m_mask)

    # Histogram distance cost: the sum over classes of row-wise L2
    # (ref :421-424). Counts are integers, so each squared norm is exact.
    diff = fq.reshape(-1, 9, 12)[:, None] - fm.reshape(-1, 9, 12)[None, :]  # (N, M, 9, 12)
    norms = sqrt_rn((diff * diff).sum(-1))
    cost = torch.zeros_like(norms[..., 0])
    for c in range(norms.shape[-1]):
        cost = cost + norms[..., c]

    same_class = q_labels[:, None] == m_labels[None, :]
    density_ok = ((q_density[:, None] - m_density[None, :]).abs()
                  / torch.clamp(q_density[:, None], min=1e-6)) <= 3.0
    feasible = same_class & density_ok & q_mask[:, None] & m_mask[None, :]
    cost = torch.where(feasible, cost, _BIG)

    matches = auction_assignment(cost, q_mask)

    # Pairwise-distance consistency filter (ref :463-489).
    n = matches.shape[0]
    has = matches >= 0
    dq_pair = _norm3(q_centers[:, None] - q_centers[None, :])
    mc = m_centers[matches.clamp(min=0).long()]
    dm_pair = _norm3(mc[:, None] - mc[None, :])
    idx = torch.arange(n, device=matches.device)
    ok_pair = has[None, :] & (idx[:, None] != idx[None, :])
    consistent = (dq_pair - dm_pair).abs() < dq_pair * 0.1
    num = (consistent & ok_pair).to(torch.float32).sum(1)
    den = ok_pair.to(torch.float32).sum(1).clamp(min=1.0)
    keep = (num / den) >= 0.2
    matches = torch.where(has & keep, matches, -1)

    n_valid = q_mask.to(torch.float32).sum().clamp(min=1.0)
    score = (matches >= 0).to(torch.float32).sum() / n_valid
    return GraphMatchResult(matches=matches, score=score)
