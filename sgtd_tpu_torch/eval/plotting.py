"""Plotting (port of sgtd_tpu.eval.plotting), the off-ROS analog of the
reference's visual output. matplotlib is imported inside each function; a
machine without it gets None back and no file.

``plot_localization``: the final matplotlibcpp trajectory scatter
(semantic_graph_localization.cpp:986-997): map keyframes, query GT,
successful and failed estimates.

``plot_query_candidates``: the per-query rviz marker topics
(semantic_graph_localization.cpp:784-953) rendered to a PNG: for each top
candidate keyframe, the DB triangle vertices, the query triangle vertices
under the candidate's rigid transform, and segments for the inlier
correspondences.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_localization(
    out_path: str,
    map_poses: np.ndarray,
    query_gt: np.ndarray,
    est_poses: np.ndarray,
    success: np.ndarray,
    title: str = "sgtd_tpu_torch localization",
) -> Optional[str]:
    """Write a top-down scatter PNG (host arrays). Returns the path, or None
    when matplotlib is unavailable."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 8))
    mp = np.asarray(map_poses)[:, :2, 3]
    ax.scatter(mp[:, 0], mp[:, 1], s=10, c="red", label="map keyframes")
    qg = np.asarray(query_gt)[:, :2, 3]
    ax.scatter(qg[:, 0], qg[:, 1], s=10, c="blue", label="query GT")
    est = np.asarray(est_poses)[:, :2, 3]
    succ = np.asarray(success).astype(bool)
    if succ.any():
        ax.scatter(est[succ, 0], est[succ, 1], s=20, c="green", label="estimate (ok)")
    if (~succ).any():
        ax.scatter(est[~succ, 0], est[~succ, 1], s=20, c="orange", label="estimate (fail)")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_query_candidates(
    out_path: str,
    db,
    graph,
    config,
    k: int = 3,
    title: str = "query candidates",
) -> Optional[str]:
    """Per-query candidate/match visualization (ref marker topics,
    semantic_graph_localization.cpp:784-953) of one query graph (fields
    without a batch axis, NumPy or tensors) against the DB on its device.

    One panel per top-``k`` verified candidate, drawn in the candidate
    keyframe's sensor frame: query graph nodes under the candidate's rigid
    transform (crosses), DB-side triangle vertices of the match pairs
    (dots), and green segments joining the inlier vertex correspondences
    (gray for non-inlier pairs). Returns the path, or None when matplotlib
    is unavailable.
    """
    plt = _pyplot()
    if plt is None:
        return None
    from sgtd_tpu_torch.desc.triangles import build_descriptors
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.interop import to_numpy
    from sgtd_tpu_torch.match.search import candidate_search
    from sgtd_tpu_torch.match.verify import verify_candidates

    batch = stack_graphs([graph], db.frame_poses.device)
    query = build_descriptors(batch, config.desc, config.caps)
    cand = candidate_search(db, query, config.desc, config.search, config.caps)
    ver = verify_candidates(db, query, cand, config.search)
    cand, ver = (type(x)(*(v[0] for v in to_numpy(x))) for x in (cand, ver))

    order = np.argsort(-ver.scores, kind="stable")[:k]
    qverts = query.vertices[0].cpu().numpy()  # (D, 3, 3) query-local
    centers = batch.centers[0].cpu().numpy()
    cmask = batch.mask[0].cpu().numpy()
    db_verts = db.vertices.cpu().numpy()

    fig, axes = plt.subplots(1, k, figsize=(6 * k, 6))
    if k == 1:
        axes = [axes]
    for ax, ci in zip(axes, order):
        rot, t = ver.rot[ci], ver.trans[ci]
        pq, pr, pv, inl = cand.pair_qidx[ci], cand.pair_row[ci], cand.pair_valid[ci], ver.inliers[ci]
        moved_nodes = centers[cmask] @ rot.T + t
        ax.scatter(moved_nodes[:, 0], moved_nodes[:, 1], marker="x", s=25,
                   c="tab:blue", label="query nodes (transformed)")
        for j in np.nonzero(pv)[0][:120]:  # bounded on dense pair lists
            vq3 = qverts[pq[j]] @ rot.T + t  # (3, 3)
            vd3 = db_verts[pr[j]]
            color = "tab:green" if inl[j] else "0.8"
            for v in range(3):
                ax.plot([vq3[v, 0], vd3[v, 0]], [vq3[v, 1], vd3[v, 1]], color=color, lw=0.8,
                        zorder=2 if inl[j] else 1)
            ax.scatter(vd3[:, 0], vd3[:, 1], s=8, c="tab:red", zorder=3)
        ax.set_aspect("equal")
        ax.set_title(
            f"frame {int(cand.frames[ci])}  votes {float(cand.votes[ci]):.0f}  "
            f"score {ver.scores[ci]:.0f}  inliers {int(inl.sum())}"
        )
    axes[0].legend(loc="lower left", fontsize=8)
    fig.suptitle(title)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path
