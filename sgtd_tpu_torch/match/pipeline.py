"""One-shot localization (port of sgtd_tpu.match.pipeline).

The reference's ``SearchLoop``: build the query's triangle descriptors,
vote for candidate keyframes, verify every candidate, and return the
score-sorted candidate list with rigid transforms (``localize``); then
GICP- or VGICP-align the query cloud against the top candidates' keyframe
clouds and pick one (``localize_refined``, the full headline configuration) —
here for a batch of query graphs at once (leading axis B) in place of
the reference's vmap. ``localize_exact`` is the uncapped fallback for
queries that ``localize`` flags TRUNC_SCAN.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sgtd_tpu_torch.config import GicpConfig, SGTDConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.triangles import Descriptors, build_descriptors
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.graph.types import SemanticGraph
from sgtd_tpu_torch.match.search import (
    CandidateSet,
    build_probe_table,
    candidate_search,
    extract_pairs_by_frame,
    probe_and_hits,
    scan_totals,
    select_candidates,
)
from sgtd_tpu_torch.match.verify import VerifyResult, verify_candidates
from sgtd_tpu_torch.refine.gicp import gicp_rerank
from sgtd_tpu_torch.refine.vgicp import GaussianVoxelMap, vgicp_rerank
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


# The reference's vmap of ``localize`` over a leading batch of query
# graphs: the port's ``localize`` takes that axis itself.
localize_batch = localize


def localize_descriptors(
    db: DescriptorDB,
    query: Descriptors,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    """Localize a batch of query descriptor sets (leading axis B)."""
    disable_tf32()
    cand = candidate_search(db, query, config.desc, config.search, config.caps)
    ver = verify_candidates(db, query, cand, config.search)
    return rank_candidates(db, query, cand, ver, config)


def localize_exact(
    db: DescriptorDB,
    graphs: SemanticGraph,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    """Uncapped fallback for queries flagged TRUNC_SCAN by :func:`localize`.

    Measures the batch's true ragged-scan totals, re-runs the search with
    caps.max_scan_slots raised to the power of two (from 8192) that covers
    the largest, and builds the pair lists candidate-major
    (``extract_pairs_by_frame``, bounded only by pairs_per_candidate)
    instead of through the per-descriptor hits_per_descriptor cap. The
    scan of each query is exact whenever its total fits the cap, so one
    cap for the batch gives every query the reference's result; no vote
    or pair is lost, and ``truncated`` is 0.
    """
    disable_tf32()
    query = build_descriptors(graphs, config.desc, config.caps)
    total = int(scan_totals(db, query, config.desc).max())
    slots = 8192
    while slots < total:
        slots *= 2
    cfg = config.replace(caps=dataclasses.replace(config.caps, max_scan_slots=slots))

    ph = probe_and_hits(db, query, cfg.desc, cfg.search, cfg.caps, with_sel=False)
    cand_votes, cand_frames, cand_valid = select_candidates(ph.votes, cfg.search)
    pkeys, pdesc = build_probe_table(query, cfg.desc)
    pair_qidx, pair_row, pair_valid = extract_pairs_by_frame(
        db, query, pkeys, pdesc, cand_frames, cand_valid, cfg.search, cfg.caps
    )
    cand = CandidateSet(
        frames=cand_frames,
        votes=cand_votes,
        valid=cand_valid,
        pair_qidx=pair_qidx,
        pair_row=pair_row,
        pair_valid=pair_valid,
        truncated=torch.zeros_like(ph.scan_overflow, dtype=torch.int32),
    )
    ver = verify_candidates(db, query, cand, cfg.search)
    return rank_candidates(db, query, cand, ver, cfg)


def rank_candidates(
    db: DescriptorDB,
    query: Descriptors,
    cand: CandidateSet,
    ver: VerifyResult,
    config: SGTDConfig = SGTDConfig(),
) -> LocalizationResult:
    """Sort verified candidates by score and compose their world poses."""
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


class RefinedResult(NamedTuple):
    """LocalizationResult plus the GICP-refined world pose, per query.

    pose:    (B, 4, 4) float32 — refined when accepted, else the top
             candidate's descriptor pose (ref semantic_graph_localization.cpp:747).
    refined: (B,) bool — a refinement was accepted.
    fitness: (B,) float32 — raw fitness of the picked candidate.
    result:  the batched LocalizationResult.
    """

    pose: torch.Tensor
    refined: torch.Tensor
    fitness: torch.Tensor
    result: LocalizationResult


def localize_refined(
    db: DescriptorDB,
    graphs: SemanticGraph,
    query_clouds: torch.Tensor,
    query_masks: torch.Tensor,
    map_clouds: torch.Tensor,
    map_masks: torch.Tensor,
    map_covs: torch.Tensor | None = None,
    config: SGTDConfig = SGTDConfig(),
    rerank_k: int = 4,
    map_vmaps: GaussianVoxelMap | None = None,
) -> RefinedResult:
    """Localization with the multi-candidate registration rerank (the
    reference's SG-STD-gicp-multi, candidate loop
    semantic_graph_localization.cpp:651-723).

    The top ``rerank_k`` candidates of each query align at once, by GICP
    or (``config.gicp.engine == "vgicp"``) VGICP, and :func:`rerank_pick`
    chooses among them. graphs: a batch of B query graphs; query_clouds
    (B, S, 3) / query_masks (B, S); map_clouds (F_pad, P, 3) / map_masks
    (F_pad, P) / map_covs (F_pad, P, 3, 3) | None: the keyframe clouds
    indexed by frame id, with one row per row of ``db.frame_poses``.
    ``map_vmaps``: prebuilt per-keyframe Gaussian voxel maps
    (``refine.vgicp.build_voxel_maps``, leading F_pad axis); with the VGICP
    engine the rerank then gathers them and builds none, else it builds
    the candidates' maps from their clouds and covariances.
    """
    disable_tf32()
    f_pad = db.frame_poses.shape[0]
    maps = (("map_clouds", map_clouds), ("map_masks", map_masks), ("map_covs", map_covs),
            ("map_vmaps", None if map_vmaps is None else map_vmaps.keys))
    for name, x in maps:
        if x is not None and x.shape[0] != f_pad:
            raise ValueError(
                f"{name} has {x.shape[0]} rows; the DB's frame_poses has {f_pad} "
                "(pad the map tensors to the DB's frame count)"
            )
    res = localize(db, graphs, config)
    frames_k = res.frames[:, :rerank_k].long()  # (B, K) score-sorted
    inits = se3.rt_to_mat(res.rot[:, :rerank_k], res.trans[:, :rerank_k])
    if config.gicp.engine == "vgicp" and map_vmaps is not None:
        vm_k = GaussianVoxelMap(*(x[frames_k] for x in map_vmaps))
        out = vgicp_rerank(query_clouds, query_masks, None, None, inits, config.gicp, voxel_maps=vm_k)
    else:
        rerank = vgicp_rerank if config.gicp.engine == "vgicp" else gicp_rerank
        out = rerank(
            query_clouds, query_masks, map_clouds[frames_k], map_masks[frames_k], inits,
            config.gicp, tgt_covs=None if map_covs is None else map_covs[frames_k],
        )
    pick, use, refined_poses = rerank_pick(
        out.fitness_gated, out.inlier_frac, db.frame_poses[frames_k] @ out.transform,
        res.poses[:, :rerank_k], res.found, config.gicp,
    )
    rows = torch.arange(pick.shape[0], device=pick.device)
    return RefinedResult(
        pose=torch.where(use[:, None, None], refined_poses[rows, pick], res.poses[:, 0]),
        refined=use,
        fitness=out.fitness[rows, pick],
        result=res,
    )


def rerank_pick(fitness_gated, inlier_frac, refined_poses, init_poses, found, gcfg: GicpConfig):
    """Candidate pick and divergence guard of the GICP rerank (reference
    ``sgtd_tpu.match.pipeline.rerank_pick``).

    A refined pose further than max_refine_shift_m / max_refine_rot_deg
    from its OWN candidate's descriptor pose is excluded (a wrong-basin
    ICP); among the rest the pick maximises ``inlier_frac - 0.1 *
    fitness_gated`` (first maximum on ties). As in the reference,
    candidates that failed verification are scored too.

    fitness_gated/inlier_frac (B, K); refined_poses/init_poses
    (B, K, 4, 4); found (B,). Returns (pick (B,) int64, use (B,) bool,
    refined_poses).
    """
    shift = torch.linalg.vector_norm(refined_poses[..., :3, 3] - init_poses[..., :3, 3], dim=-1)
    dR = refined_poses[..., :3, :3] @ init_poses[..., :3, :3].transpose(-1, -2)
    tr = torch.clamp((dR.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5, -1.0, 1.0)
    rot_deg = torch.rad2deg(torch.arccos(tr))
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))
    guard_ok = (shift <= f32(gcfg.max_refine_shift_m)) & (rot_deg <= f32(gcfg.max_refine_rot_deg))
    score = torch.where(
        guard_ok, inlier_frac - f32(0.1) * fitness_gated,
        torch.full_like(inlier_frac, -float("inf")),
    )
    pick = score.argmax(-1)
    use = found & guard_ok.any(-1)
    return pick, use, refined_poses
