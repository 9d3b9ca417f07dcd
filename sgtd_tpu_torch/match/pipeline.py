"""One-shot localization (port of sgtd_tpu.match.pipeline, descriptor-only).

The reference's ``SearchLoop``: build the query's triangle descriptors,
vote for candidate keyframes, verify every candidate, and return the
score-sorted candidate list with rigid transforms — here for a batch of
query graphs at once (leading axis B) in place of the reference's vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.triangles import Descriptors, build_descriptors
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.graph.types import SemanticGraph
from sgtd_tpu_torch.match.search import candidate_search
from sgtd_tpu_torch.match.verify import verify_candidates
from sgtd_tpu_torch.utils import disable_tf32


class LocalizationResult(NamedTuple):
    """Score-sorted candidate lists for a batch of B query scans.

    found:        (B,) bool — best score exceeded icp_threshold.
    best_frame:   (B,) int32 — top candidate keyframe id (-1 if none).
    best_score:   (B,) float32.
    frames:       (B, C) int32 — candidates sorted by verify score desc.
    scores:       (B, C) float32.
    votes:        (B, C) float32 — selector votes of the sorted candidates.
    rot:          (B, C, 3, 3) float32 — query sensor -> keyframe sensor.
    trans:        (B, C, 3) float32.
    poses:        (B, C, 4, 4) float32 — world poses of the query.
    num_descriptors: (B,) int32.
    truncated:    (B,) int32 bitmask (search.TRUNC_SCAN | TRUNC_PAIRS).
    """

    found: torch.Tensor
    best_frame: torch.Tensor
    best_score: torch.Tensor
    frames: torch.Tensor
    scores: torch.Tensor
    votes: torch.Tensor
    rot: torch.Tensor
    trans: torch.Tensor
    poses: torch.Tensor
    num_descriptors: torch.Tensor
    truncated: torch.Tensor


def localize(
    db: DescriptorDB,
    graphs: SemanticGraph,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    """Localize a batch of query graphs (leading axis B) against ``db``."""
    disable_tf32()
    query = build_descriptors(graphs, config.desc, config.caps)
    return localize_descriptors(db, query, config)


def localize_descriptors(
    db: DescriptorDB,
    query: Descriptors,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    """Localize a batch of query descriptor sets (leading axis B)."""
    disable_tf32()
    cand = candidate_search(db, query, config.desc, config.search, config.caps)
    ver = verify_candidates(db, query, cand, config.search)

    order = torch.argsort(ver.scores, dim=-1, descending=True, stable=True)
    take = lambda x: torch.gather(
        x, 1, order.reshape(order.shape + (1,) * (x.dim() - 2)).expand_as(x)
    )
    frames = take(cand.frames)
    scores = take(ver.scores)
    rot = take(ver.rot)
    trans = take(ver.trans)

    t_loop = se3.rt_to_mat(rot, trans)  # (B, C, 4, 4)
    poses = db.frame_poses[frames.long()] @ t_loop

    best_score = scores[:, 0]
    found = best_score > config.search.icp_threshold
    best_frame = torch.where(found, frames[:, 0], -1)
    return LocalizationResult(
        found=found,
        best_frame=best_frame,
        best_score=best_score,
        frames=frames,
        scores=scores,
        votes=take(cand.votes),
        rot=rot,
        trans=trans,
        poses=poses,
        num_descriptors=query.count,
        truncated=cand.truncated,
    )
