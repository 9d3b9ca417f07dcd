"""Evaluation metrics (port of sgtd_tpu.eval.metrics), NumPy on the host.

The reference's metric definitions, so numbers compare directly:
``compute_adj_rpe`` (src/sgtd/include/utility.hpp:110-123),
``calculateRMSE`` (utility.hpp:60-68), the 5 m / 10 deg success gate
(src/sgtd/src/semantic_graph_localization.cpp:750) and the Recall@K
accounting with a 10 m gate over the score-sorted candidate list
(semantic_graph_localization.cpp:622-646).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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


def rmse(errors: Sequence[float]) -> float:
    e = np.asarray(errors, dtype=np.float64)
    if e.size == 0:
        return float("nan")
    return float(np.sqrt(np.mean(e * e)))


@dataclasses.dataclass
class EvalAccumulator:
    """Running accumulation identical to the reference main loop."""

    config: SGTDConfig = SGTDConfig()
    total: int = 0
    succeeded: int = 0
    t_errors: list = dataclasses.field(default_factory=list)
    r_errors: list = dataclasses.field(default_factory=list)
    times_ms: list = dataclasses.field(default_factory=list)
    recall_at: np.ndarray = None  # filled lazily

    def __post_init__(self):
        if self.recall_at is None:
            self.recall_at = np.zeros(self.config.search.candidate_num, dtype=np.int64)

    def add(
        self,
        gt_pose: np.ndarray,
        est_pose: np.ndarray,
        cand_poses: np.ndarray | None = None,
        time_ms: float = 0.0,
    ):
        """Record one query.

        gt_pose: ground-truth 4x4 (sensor in world).
        est_pose: estimated 4x4 from the best candidate.
        cand_poses: (C, 4, 4) score-sorted candidate pose estimates for
                    Recall@K (gate: translation error < 10 m, ref :639-645).
        """
        self.total += 1
        # The time is recorded for every query, success or not (the
        # reference's per-frame printout, :771-777); error statistics
        # accumulate over successes only, as its RMSE accounting does.
        self.times_ms.append(time_ms)
        t_err, r_err = rpe(gt_pose, est_pose)
        if t_err < self.config.success_trans_m and r_err < self.config.success_rot_deg:
            self.succeeded += 1
            self.t_errors.append(t_err)
            self.r_errors.append(r_err)
        if cand_poses is not None:
            for k in range(min(len(cand_poses), len(self.recall_at))):
                te, _ = rpe(gt_pose, cand_poses[k])
                if te < self.config.recall_trans_m:
                    self.recall_at[k:] += 1
                    break

    def summary(self) -> dict:
        n = max(self.total, 1)
        mean = lambda v: float(np.mean(v)) if v else float("nan")
        at = lambda k: float(self.recall_at[min(k - 1, len(self.recall_at) - 1)]) / n
        return {
            "total": self.total,
            "success_rate": self.succeeded / n,
            "rmse_trans_m": rmse(self.t_errors),
            "rmse_rot_deg": rmse(self.r_errors),
            "mean_trans_m": mean(self.t_errors),
            "mean_rot_deg": mean(self.r_errors),
            "mean_time_ms": mean(self.times_ms),
            "recall_at_1": at(1),
            "recall_at_5": at(5),
            "recall_at_10": at(10),
        }
