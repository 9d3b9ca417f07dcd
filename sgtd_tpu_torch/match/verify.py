"""Geometric verification (port of sgtd_tpu.match.verify).

Per candidate: up to H rigid hypotheses from sampled match pairs (QCP
Kabsch on the triangle vertices, skip_len sampling; kernel K1), inlier
votes of every hypothesis over the pair list (kernel B3), the best
hypothesis' inlier mask, and a weighted-Kabsch polish over all inlier
vertices (kernel K2). Works on any leading batch dimensions before (C, P).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sgtd_tpu_torch.config import SearchConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.match.search import CandidateSet
from sgtd_tpu_torch.ops import kabsch as kabsch_ops
from sgtd_tpu_torch.ops import verify as verify_ops
from sgtd_tpu_torch.ops.linalg3 import kabsch
from sgtd_tpu_torch.utils import batch_take, profiling


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


@profiling.traced("match.verify")
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

    # Hypothesis sampling (ref skip_len subsampling, STDesc.cpp:467-482) and
    # a Kabsch solve of each sampled pair (K1).
    with profiling.span("verify.hypotheses"):
        rot_h, t_h = kabsch_ops.triangle_hypotheses(vq, vdb, pair_valid, h)  # (..., C, H, 3, 3)

    with profiling.span("verify.votes"):
        # Inlier votes of every hypothesis: d^2 < thr^2 on all three vertices.
        n = pair_valid[..., 0].numel()
        votes_h = verify_ops.hypothesis_votes(
            rot_h.reshape(n, h, 3, 3), t_h.reshape(n, h, 3),
            vq.reshape(n, p, 3, 3), vdb.reshape(n, p, 3, 3),
            pair_valid.reshape(n, p), search.verify_dis_threshold,
        ).reshape(lead + (h,))

    # The best valid hypothesis' inlier mask, acceptance and score, and the
    # pose polish: weighted Kabsch over all inlier vertex correspondences,
    # falling back to the sampled hypothesis below 2 inlier pairs (K2).
    with profiling.span("verify.polish"):
        score, rot, trans, inliers, polished = kabsch_ops.verify_epilogue(
            votes_h, rot_h, t_h, vq, vdb, pair_valid, cand_valid,
            search.verify_dis_threshold, search.min_hypothesis_votes,
        )
        profiling.count_mask("verify.polished", polished, True)
    return VerifyResult(scores=score, rot=rot, trans=trans, inliers=inliers)
