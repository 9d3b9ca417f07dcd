"""Evaluation metrics (port of the part of sgtd_tpu.eval.metrics the slice
uses): the relative pose error and the success gate, T < 5 m and R < 10 deg
(reference semantic_graph_localization.cpp:750)."""

from __future__ import annotations

import numpy as np

from sgtd_tpu_torch.config import SGTDConfig


def rpe(gt: np.ndarray, est: np.ndarray):
    """Translation (m) / rotation (deg) error, ref compute_adj_rpe."""
    delta = np.linalg.inv(est) @ gt
    t_err = float(np.linalg.norm(delta[:3, 3]))
    tr = np.clip((np.trace(delta[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    r_err = float(abs(np.degrees(np.arccos(tr))))
    return t_err, r_err


def success_rate(gt_poses, est_poses, found, config: SGTDConfig) -> float:
    """Share of queries that were found and pass the success gate
    (gt_poses, est_poses: (Q, 4, 4); found: (Q,))."""
    n_succ = 0
    for gt, est, f in zip(gt_poses, est_poses, found):
        if f:
            t_err, r_err = rpe(np.asarray(gt), np.asarray(est))
            n_succ += t_err < config.success_trans_m and r_err < config.success_rot_deg
    return n_succ / max(len(gt_poses), 1)
