"""Host-side voxel-grid downsampling and query-cloud loading (port of the
NumPy half of sgtd_tpu.ops.voxel).

The reference voxel-downsamples the query cloud before GICP (leaf_size,
semantic_graph_localization.cpp:357-359, 654-662): points are binned by
floor(p / leaf) and replaced by per-voxel centroids, exactly (no hash
merging, unlike PCL's ApproximateVoxelGrid). Pure NumPy, the same
operations as the reference's, so both give the same arrays; the
reference module cannot be imported where the port runs (it imports JAX).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_B = np.int64(1) << 20  # coordinate offset; 21 bits per axis


def _keys_np(points: np.ndarray, leaf: float) -> np.ndarray:
    c = np.floor(points / leaf).astype(np.int64)
    return ((c[:, 0] + _B) << 42) | ((c[:, 1] + _B) << 21) | (c[:, 2] + _B)


def voxel_downsample_np(points: np.ndarray, leaf_size: float) -> np.ndarray:
    """Exact voxel-grid centroids: (N, 3) -> (V, 3) float32, in key order."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if pts.shape[0] == 0:
        return pts
    key = _keys_np(pts, leaf_size)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(sums, inv, pts)
    cnt = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    return (sums / cnt[:, None]).astype(np.float32)


def load_query_cloud(
    points: np.ndarray, leaf_size: float, max_points: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's query-cloud preprocessing for GICP
    (semantic_graph_localization.cpp:654-662): drop near-origin invalid
    points (|p|^2 < 1e-3), voxel-downsample at ``leaf_size``, thin with a
    fixed stride past ``max_points``, pad. Returns (cloud (max_points, 3)
    float32, mask (max_points,) bool)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    pts = pts[np.sum(pts * pts, axis=1) >= 1e-3]
    if leaf_size > 0:
        pts = voxel_downsample_np(pts, leaf_size)
    if len(pts) > max_points:
        stride = -(-len(pts) // max_points)
        pts = pts[::stride][:max_points]
    n = len(pts)
    out = np.zeros((max_points, 3), np.float32)
    mask = np.zeros(max_points, bool)
    out[:n] = pts
    mask[:n] = True
    return out, mask
