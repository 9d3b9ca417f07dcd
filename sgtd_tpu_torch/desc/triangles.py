"""Semantic-guided triangle descriptors (port of sgtd_tpu.desc.triangles).

Batched over a leading frame axis. Per scan: dense pairwise distances, the
``near_num`` nearest nodes (self first), all (m, n) neighbour pairs as
candidate triangles, side-length gating, vertex ordering by opposite-side
length, first-occurrence dedup on mm-truncated side triples, compaction to
``max_descriptors`` slots in enumeration order.

Tie order follows the reference's ``top_k`` and stable sorts (lower index
first): the kNN is a stable ascending sort, and the dedup sort runs on one
int64 key that packs the reference's lexsort keys.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sgtd_tpu_torch.config import CapacityConfig, DescriptorConfig
from sgtd_tpu_torch.graph.types import SemanticGraph
from sgtd_tpu_torch.utils import batch_take, profiling, sqrt_rn

_BIG = 1e30

# Dedup sort key bit layout: invalid (1) | q0, q1, q2 (16 each) | flat (14).
_Q_BITS = 16
_IDX_BITS = 14


class Descriptors(NamedTuple):
    """Padded triangle descriptor sets, leading frame axis B.

    sides:    (B, D, 3) float32 — scaled side lengths, ascending.
    angles:   (B, D, 3) float32 — |cos| of the interior angles.
    vertices: (B, D, 3, 3) float32 — rows A, B, C.
    labels:   (B, D, 3) int32 — semantic labels of A, B, C.
    node_ids: (B, D, 3) int32 — graph node indices of A, B, C.
    center:   (B, D, 3) float32 — triangle centroid.
    mask:     (B, D) bool.
    """

    sides: torch.Tensor
    angles: torch.Tensor
    vertices: torch.Tensor
    labels: torch.Tensor
    node_ids: torch.Tensor
    center: torch.Tensor
    mask: torch.Tensor

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)


def _pair_indices(near_num: int):
    """Static (m, n) neighbour-slot pairs, 1 <= m < n < near_num."""
    ms, ns = [], []
    for m in range(1, near_num - 1):
        for n in range(m + 1, near_num):
            ms.append(m)
            ns.append(n)
    return ms, ns


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """|d| over the last axis, summed as ((d0^2 + d1^2) + d2^2)."""
    s = d * d
    return sqrt_rn((s[..., 0] + s[..., 1]) + s[..., 2])


def _norm3_fma(d: torch.Tensor) -> torch.Tensor:
    """|d| with the squares accumulated by fused multiply-adds, each rounded
    once to float32 (emulated in float64, where the products are exact).

    XLA:CPU compiles the reference's two sides at the anchor vertex this
    way and the third side as :func:`_norm3`; with both (and a correctly
    rounded root) the port's sides equal the reference's bit for bit on
    the 200-keyframe bench world. One ulp decides ``trunc(side * 1000)``
    for some triangles and so which duplicates the dedup merges: summed
    all alike, the sides of that world give other descriptor sets.
    """
    d64 = d.to(torch.float64)
    acc = (d64[..., 0] * d64[..., 0]).to(torch.float32)
    for k in (1, 2):
        acc = (d64[..., k] * d64[..., k] + acc.to(torch.float64)).to(torch.float32)
    return sqrt_rn(acc)


@profiling.traced("desc.triangles")
def build_descriptors(
    graph: SemanticGraph,
    cfg: DescriptorConfig = DescriptorConfig(),
    caps: CapacityConfig = CapacityConfig(),
) -> Descriptors:
    """Triangle descriptors of a batch of semantic graphs (leading axis B)."""
    pts = graph.centers.to(torch.float32)  # (B, N, 3)
    mask = graph.mask
    bsz, n_nodes, _ = pts.shape
    dev = pts.device
    near = min(cfg.near_num, n_nodes)
    m_slots, n_slots = _pair_indices(near)
    n_flat = n_nodes * len(m_slots)
    if n_flat > 1 << _IDX_BITS or cfg.max_len * 1000.0 >= 1 << _Q_BITS:
        raise ValueError(
            f"dedup sort key overflows int64: {n_flat} candidate triangles "
            f"(limit {1 << _IDX_BITS}) or max_len {cfg.max_len} m "
            f"(limit {(1 << _Q_BITS) / 1000} m)"
        )

    # --- kNN over the padded node set (self at slot 0). ---
    # Summed as ((x + y) + z), the reference's order. torch's CUDA
    # reduction over a 3-wide axis adds in another order, and near-ties
    # then reorder the neighbours (2 frames of the 5,000-keyframe world).
    diff = pts[:, :, None, :] - pts[:, None, :, :]
    sq = diff * diff
    dist2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    valid_pair = mask[:, :, None] & mask[:, None, :]
    dist2 = torch.where(valid_pair, dist2, _BIG)
    eye = torch.eye(n_nodes, dtype=torch.bool, device=dev)
    dist2 = torch.where(eye & mask[:, :, None], 0.0, dist2)
    d_sorted, order_nn = torch.sort(dist2, dim=-1, stable=True)
    knn_idx = order_nn[..., :near]
    knn_valid = d_sorted[..., :near] < _BIG * 0.5

    # --- candidate triangles (i, m, n). ---
    p2 = knn_idx[..., m_slots]  # (B, N, P)
    p3 = knn_idx[..., n_slots]
    v2ok = knn_valid[..., m_slots]
    v3ok = knn_valid[..., n_slots]
    x1 = pts[:, :, None, :]
    x2 = batch_take(pts, p2)  # (B, N, P, 3)
    x3 = batch_take(pts, p3)

    raw_sides = torch.stack(
        [_norm3_fma(x1 - x2), _norm3_fma(x1 - x3), _norm3(x3 - x2)], dim=-1
    )
    len_ok = ((raw_sides >= cfg.min_len) & (raw_sides <= cfg.max_len)).all(-1)
    tri_valid = mask[:, :, None] & v2ok & v3ok & len_ok  # (B, N, P)

    # --- ascending sides; A opposite the longest, B middle, C shortest. ---
    order = torch.argsort(raw_sides, dim=-1, stable=True)
    sides_sorted = torch.gather(raw_sides, -1, order)
    verts = torch.stack([x3, x2, x1.expand_as(x2)], dim=-2)  # (B, N, P, 3, 3)
    opp_order = order.flip(-1)
    abc = torch.gather(verts, -2, opp_order[..., None].expand(verts.shape))
    node_idx3 = torch.stack(
        [p3, p2, torch.arange(n_nodes, device=dev)[None, :, None].expand_as(p2)],
        dim=-1,
    )
    abc_nodes = torch.gather(node_idx3, -1, opp_order)  # (B, N, P, 3)
    abc_labels = batch_take(graph.labels, abc_nodes)

    sa, sb, sc = sides_sorted[..., 0], sides_sorted[..., 1], sides_sorted[..., 2]
    eps = 1e-12
    angles = torch.stack(
        [
            torch.abs((sb * sb + sc * sc - sa * sa) / (2 * sb * sc + eps)),
            torch.abs((sa * sa + sc * sc - sb * sb) / (2 * sa * sc + eps)),
            torch.abs((sa * sa + sb * sb - sc * sc) / (2 * sa * sb + eps)),
        ],
        dim=-1,
    )

    # --- first-occurrence dedup on truncated mm side triples. ---
    # One int64 sort reproduces the reference's lexsort over (invalid, q0,
    # q1, q2, flat position). Invalid triangles are never kept, so their q
    # is zeroed in the key (their sides may exceed the 16-bit field).
    flat = lambda x: x.reshape((bsz, n_flat) + x.shape[3:])
    q_f = flat(torch.trunc(sides_sorted * 1000.0).to(torch.int64))
    tri_valid_f = flat(tri_valid)
    q_f = torch.where(tri_valid_f[..., None], q_f, 0)
    flat_idx = torch.arange(n_flat, device=dev)
    key = (~tri_valid_f).to(torch.int64)
    for k in range(3):
        key = (key << _Q_BITS) | q_f[..., k]
    key = (key << _IDX_BITS) | flat_idx
    key_s, perm = torch.sort(key, dim=-1)
    group = key_s >> _IDX_BITS
    same_as_prev = torch.cat(
        [
            torch.zeros((bsz, 1), dtype=torch.bool, device=dev),
            group[:, 1:] == group[:, :-1],
        ],
        dim=-1,
    )
    keep_sorted = ~same_as_prev & ((key_s >> (_IDX_BITS + 3 * _Q_BITS)) == 0)
    keep = torch.zeros_like(keep_sorted).scatter_(1, perm, keep_sorted)

    # --- compact survivors into max_descriptors slots, in flat order. ---
    priority = torch.where(keep, flat_idx, n_flat)
    comp = torch.argsort(priority, dim=-1, stable=True)[:, : caps.max_descriptors]
    out_mask = torch.gather(priority, 1, comp) < n_flat

    take = lambda x: batch_take(flat(x), comp)
    abc_c = take(abc)
    return Descriptors(
        sides=take(sides_sorted) * float(np.float32(cfg.scale)),
        angles=take(angles),
        vertices=abc_c,
        labels=take(abc_labels).to(torch.int32),
        node_ids=take(abc_nodes).to(torch.int32),
        center=abc_c.mean(dim=-2),
        mask=out_mask,
    )
