"""Multi-frame local-map keyframes (port of sgtd_tpu.graph.local_map).

The reference's ``local_map`` tool (local_map.cpp:213-482): for each
keyframe, every scan whose pose lies within ``radius`` (15 m there, :266)
is transformed into the keyframe's sensor frame (T_i^-1 T_j, :300) and
merged before clustering: the map variant behind the "SG-STD-gicp-multi"
results. Queries remain single scans.

Host NumPy selects and merges the scans (the same operations as the
reference's, so the merged clouds are equal); the merged cloud goes to the
device once and through ``build_graph`` like any single scan.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from sgtd_tpu_torch.config import CapacityConfig, DcvcConfig
from sgtd_tpu_torch.graph.build import build_graph
from sgtd_tpu_torch.graph.types import SemanticGraph


def neighbor_indices(poses: np.ndarray, center: int, radius_m: float) -> np.ndarray:
    """Scans within radius of the centre keyframe (ref local_map.cpp:266-270)."""
    t = poses[:, :3, 3]
    d = np.linalg.norm(t - t[center, None], axis=-1)
    return np.nonzero(d < radius_m)[0]


def merge_scans(
    load_scan: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    poses: np.ndarray,
    center: int,
    neighbor_ids: Sequence[int],
    max_points: int,
    subsample_stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Merge neighbour scans into the centre frame.

    load_scan(j) -> (points (N, 3), sem (N,), inst (N,)) in scan j's frame.
    Returns padded (points, sem, inst, mask) of size max_points; past the
    cap the points are strided uniformly (never biased to one scan).
    """
    T_c_inv = np.linalg.inv(poses[center])
    pts_all, sem_all, inst_all = [], [], []
    for j in neighbor_ids:
        pts, sem, inst = load_scan(int(j))
        T = T_c_inv @ poses[j]
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        sem_all.append(sem)
        inst_all.append(inst)
    pts = np.concatenate(pts_all).astype(np.float32)
    sem = np.concatenate(sem_all).astype(np.int32)
    inst = np.concatenate(inst_all).astype(np.int32)
    if subsample_stride > 1:
        pts, sem, inst = pts[::subsample_stride], sem[::subsample_stride], inst[::subsample_stride]
    if len(pts) > max_points:
        stride = -(-len(pts) // max_points)
        pts, sem, inst = pts[::stride], sem[::stride], inst[::stride]
    n = len(pts)
    pad = max_points - n
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return np.pad(pts, ((0, pad), (0, 0))), np.pad(sem, (0, pad)), np.pad(inst, (0, pad)), mask


def build_local_map_graphs(
    load_scan: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    poses: np.ndarray,
    radius_m: float = 15.0,
    caps: CapacityConfig = CapacityConfig(),
    dcvc: DcvcConfig = DcvcConfig(),
    keyframe_ids: Sequence[int] | None = None,
    device: torch.device | str = "cuda",
) -> List[SemanticGraph]:
    """Densified keyframe graphs for the whole trajectory (or
    ``keyframe_ids``), built on ``device``."""
    ids = list(keyframe_ids) if keyframe_ids is not None else list(range(poses.shape[0]))
    out = []
    for i in ids:
        nb = neighbor_indices(poses, i, radius_m)
        arrays = merge_scans(load_scan, poses, i, nb, dcvc.max_points)
        pts, sem, inst, mask = (torch.from_numpy(a).to(device) for a in arrays)
        out.append(build_graph(pts, sem, inst, mask, poses[i].astype(np.float32), caps, dcvc))
    return out
