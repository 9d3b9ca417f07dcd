"""Multi-session SLAM: loop-closure localization and pose-graph refinement
(port of sgtd_tpu.slam.multisession).

A drifting session trajectory is corrected by anchoring it to a prior map.
One batched ``localize`` proposes a loop closure (keyframe and relative
pose) for every session scan; accepted closures become factors in a pose
graph over [map keyframes (anchored) + session nodes] together with the
session's odometry chain, optimized with ``backend.pgo``. The loop pruning
is the reference's float64 NumPy on the host; the localization and the
pose graph run on the DB's device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from sgtd_tpu_torch.backend.pgo import PoseGraph, optimize_pose_graph, optimize_pose_graph_cg
from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.graph.types import SemanticGraph, stack_graphs
from sgtd_tpu_torch.match.pipeline import localize
from sgtd_tpu_torch.utils import host_array

# Dense solve up to this many pose-graph nodes; matrix-free PCG above (the
# dense (6N)^2 Hessian is O(N^2) memory).
DENSE_MAX_NODES = 1024


class SessionResult(NamedTuple):
    """Corrected session trajectory and loop-closure bookkeeping.

    poses:       (S, 4, 4) optimized session poses (world frame).
    num_loops:   () int — accepted loop closures.
    loop_frames: (S,) int32 — matched map keyframe per scan (-1 = none).
    loop_scores: (S,) float32.
    """

    poses: np.ndarray
    num_loops: int
    loop_frames: np.ndarray
    loop_scores: np.ndarray


def localize_and_optimize_session(
    db: DescriptorDB,
    session_graphs: Sequence[SemanticGraph],
    odom_poses: np.ndarray,
    config: SGTDConfig = SGTDConfig(),
    min_loop_score: float | None = None,
    loop_weight: float = 10.0,
    odom_weight: float = 1.0,
    pgo_iterations: int = 10,
    loop_outlier_m: float = 5.0,
) -> SessionResult:
    """Correct a drifting session against a prior map.

    odom_poses: (S, 4, 4) the session's odometry estimates (world frame,
    drifting). session_graphs[i] is scan i's semantic graph (its ``pose``
    field is ignored here: odometry provides the initial values). The
    graph's nodes are the DB's frame axis (padded frames included,
    anchored and without edges) followed by the session's scans.
    """
    device = db.frame_poses.device
    s_n = len(session_graphs)
    f_n = db.frame_poses.shape[0]
    if min_loop_score is None:
        min_loop_score = config.search.icp_threshold

    # Batched loop-closure proposals.
    res = localize(db, stack_graphs(session_graphs, device), config)
    found = host_array(res.found)
    best_frame = host_array(res.best_frame)
    best_score = host_array(res.best_score)
    rot = host_array(res.rot[:, 0])
    trans = host_array(res.trans[:, 0])

    accept = found & (best_score > min_loop_score)

    # Outlier rejection before optimization: each loop to the anchored map
    # implies an absolute session-node pose, and odometry is locally
    # accurate, so for any two accepted loops the implied relative motion
    # must agree with the odometry's (pairwise-consistency pruning). Keep
    # the loops consistent with the majority.
    frame_poses_np = host_array(db.frame_poses).astype(np.float64)
    odom_np = np.asarray(odom_poses, np.float64)
    idxs = np.nonzero(accept)[0]
    if len(idxs) >= 2:
        m = len(idxs)
        T_loop = np.tile(np.eye(4), (m, 1, 1))
        T_loop[:, :3, :3] = rot[idxs]
        T_loop[:, :3, 3] = trans[idxs]
        implied = frame_poses_np[best_frame[idxs]] @ T_loop  # (m, 4, 4)
        odom_s = odom_np[idxs]

        def rel_t(T):  # (m, 4, 4) -> (m, m, 3): R_a^T (t_b - t_a)
            R = T[:, :3, :3]
            t = T[:, :3, 3]
            return np.einsum("aji,abj->abi", R, t[None, :, :] - t[:, None, :])

        d = np.linalg.norm(rel_t(implied) - rel_t(odom_s), axis=-1)  # (m, m)
        agree = d < loop_outlier_m
        np.fill_diagonal(agree, False)
        consistent = agree.sum(axis=1).astype(np.int32)
        majority = consistent >= max(1, (m - 1) // 2)
        accept[idxs[~majority]] = False

    loop_frames = np.where(accept, best_frame, -1).astype(np.int32)
    n_loops = int(accept.sum())

    # Pose graph: nodes [0..F) = map keyframes (anchored), [F..F+S) session.
    init = np.concatenate([host_array(db.frame_poses), np.asarray(odom_poses, np.float32)])
    anchor = np.zeros(f_n + s_n, bool)
    anchor[:f_n] = True
    # With no accepted loops, anchor the first session node for gauge.
    if n_loops == 0:
        anchor[f_n] = True

    # Odometry chain factors.
    oi = np.arange(s_n - 1, dtype=np.int32) + f_n
    oj = oi + 1
    odom = np.asarray(odom_poses, np.float64)
    ot = np.stack([np.linalg.inv(odom[i]) @ odom[i + 1] for i in range(s_n - 1)]).astype(np.float32)
    ow = np.full(s_n - 1, odom_weight, np.float32)

    # Loop factors keyframe -> session node. Localization returns T_loop
    # with T_world<-session = T_world<-kf @ T_loop (match.pipeline), so the
    # measured relative pose T_kf^-1 T_session is T_loop itself.
    li, lj, lt, lw = [], [], [], []
    for i in range(s_n):
        if loop_frames[i] < 0:
            continue
        T_loop = np.eye(4, dtype=np.float64)
        T_loop[:3, :3] = rot[i]
        T_loop[:3, 3] = trans[i]
        li.append(loop_frames[i])
        lj.append(f_n + i)
        lt.append(T_loop.astype(np.float32))
        lw.append(loop_weight)
    if li:
        edge_i = np.concatenate([oi, np.asarray(li, np.int32)])
        edge_j = np.concatenate([oj, np.asarray(lj, np.int32)])
        t_meas = np.concatenate([ot, np.stack(lt)])
        weight = np.concatenate([ow, np.asarray(lw, np.float32)])
    else:
        edge_i, edge_j, t_meas, weight = oi, oj, ot, ow

    pg = PoseGraph(*(torch.from_numpy(a).to(device) for a in (init, edge_i, edge_j, t_meas, weight, anchor)))
    solver = optimize_pose_graph if f_n + s_n <= DENSE_MAX_NODES else optimize_pose_graph_cg
    out = host_array(solver(pg, iterations=pgo_iterations))

    return SessionResult(
        poses=out[f_n:],
        num_loops=n_loops,
        loop_frames=loop_frames,
        loop_scores=best_score.astype(np.float32),
    )
