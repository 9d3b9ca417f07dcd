"""Geometric verification (port of sgtd_tpu.match.verify).

Per candidate: up to H rigid hypotheses from sampled match pairs (QCP
Kabsch on the triangle vertices, skip_len sampling), inlier votes of every
hypothesis over the pair list (kernel B3), the best hypothesis' inlier
mask, and a weighted-Kabsch polish over all inlier vertices. Works on any
leading batch dimensions before (C, P).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sgtd_tpu_torch.config import SearchConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.match.search import CandidateSet
from sgtd_tpu_torch.ops import verify as verify_ops
from sgtd_tpu_torch.ops.linalg3 import kabsch
from sgtd_tpu_torch.utils import batch_take, sqrt_rn


class VerifyResult(NamedTuple):
    """Per-candidate verification output (vote order, like CandidateSet).

    scores:  (..., C) float32 — inlier count, or -1 when rejected.
    rot:     (..., C, 3, 3) float32 — query frame -> map keyframe.
    trans:   (..., C, 3) float32.
    inliers: (..., C, P) bool — inlier mask over the candidate's pairs.
    """

    scores: torch.Tensor
    rot: torch.Tensor
    trans: torch.Tensor
    inliers: torch.Tensor


def triangle_solver(src_verts: torch.Tensor, ref_verts: torch.Tensor):
    """Rigid transform mapping the src triangle onto the ref triangle.

    src_verts/ref_verts: (..., 3, 3) with rows A, B, C. Returns (rot
    (..., 3, 3), t (..., 3)) such that rot @ src + t ~= ref: the quaternion
    Kabsch of ``ops.linalg3`` (always a proper rotation), the same optimum
    as the reference's SVD with its reflection fix (STDesc.cpp:549-571).
    """
    return kabsch(src_verts, ref_verts)


def verify_candidates(
    db: DescriptorDB,
    query: Descriptors,
    cand: CandidateSet,
    search: SearchConfig = SearchConfig(),
) -> VerifyResult:
    """Gather the pairs' vertex triples and verify (leading query axis B)."""
    vq = batch_take(query.vertices, cand.pair_qidx)  # (B, C, P, 3, 3)
    vdb = db.vertices[cand.pair_row.long()]
    return verify_pairs(vq, vdb, cand.pair_valid, cand.valid, search)


def verify_pairs(
    vq: torch.Tensor,
    vdb: torch.Tensor,
    pair_valid: torch.Tensor,
    cand_valid: torch.Tensor,
    search: SearchConfig = SearchConfig(),
) -> VerifyResult:
    """Verification on gathered vertex triples.

    vq/vdb: (..., C, P, 3, 3); pair_valid (..., C, P), valid pairs forming
    a prefix of each row; cand_valid (..., C).
    """
    lead = pair_valid.shape[:-1]
    p = pair_valid.shape[-1]
    h = search.max_hypotheses
    dev = vq.device
    n_pairs = pair_valid.sum(-1, dtype=torch.int32)

    # Hypothesis sampling (ref skip_len subsampling, STDesc.cpp:467-482).
    skip = n_pairs // h + 1
    use_size = n_pairs // skip
    ar = torch.arange(h, dtype=torch.int32, device=dev)
    h_idx = (ar * skip[..., None]).clamp(max=p - 1)  # (..., C, H)
    h_valid = ar < use_size[..., None]
    take_h = lambda x: torch.gather(
        x, -3, h_idx[..., None, None].long().expand(lead + (h, 3, 3))
    )
    rot_h, t_h = kabsch(take_h(vq), take_h(vdb))  # (..., C, H, 3, 3)

    # Inlier votes of every hypothesis: d^2 < thr^2 on all three vertices.
    n = pair_valid[..., 0].numel()
    votes_h = verify_ops.hypothesis_votes(
        rot_h.reshape(n, h, 3, 3), t_h.reshape(n, h, 3),
        vq.reshape(n, p, 3, 3), vdb.reshape(n, p, 3, 3),
        pair_valid.reshape(n, p), search.verify_dis_threshold,
    ).reshape(lead + (h,))
    votes_h = torch.where(h_valid, votes_h, -1)

    # Best hypothesis, ties to the lowest index.
    max_vote = votes_h.max(-1).values
    best_h = torch.where(votes_h == max_vote[..., None], ar, h).min(-1).values
    rot_b = torch.gather(rot_h, -3, best_h[..., None, None, None].long().expand(lead + (1, 3, 3)))[..., 0, :, :]
    t_b = torch.gather(t_h, -2, best_h[..., None, None].long().expand(lead + (1, 3)))[..., 0, :]
    # Inlier mask of the best hypothesis only: norm < thr on all vertices.
    moved_b = torch.einsum("...ij,...pkj->...pki", rot_b, vq) + t_b[..., None, None, :]
    d = moved_b - vdb
    s = d * d
    d_b = sqrt_rn((s[..., 0] + s[..., 1]) + s[..., 2])  # (..., C, P, 3)
    inl_b = (d_b < search.verify_dis_threshold).all(-1) & pair_valid

    accepted = (max_vote >= search.min_hypothesis_votes) & cand_valid
    score = torch.where(accepted, inl_b.to(torch.float32).sum(-1), -1.0)

    # Pose polish: weighted Kabsch over all inlier vertex correspondences,
    # falling back to the sampled hypothesis below 2 inlier pairs.
    w3 = inl_b.to(torch.float32)[..., None].expand(lead + (p, 3)).reshape(lead + (3 * p,))
    rot_r, t_r = kabsch(vq.reshape(lead + (3 * p, 3)), vdb.reshape(lead + (3 * p, 3)), weights=w3)
    n_inl = inl_b.sum(-1, dtype=torch.int32)
    use_ref = (accepted & (n_inl >= 2))[..., None]
    rot_f = torch.where(use_ref[..., None], rot_r, rot_b)
    t_f = torch.where(use_ref, t_r, t_b)
    return VerifyResult(
        scores=score,
        rot=rot_f,
        trans=t_f,
        inliers=inl_b & accepted[..., None],
    )
