"""Voxel-grid downsampling and query-cloud loading (port of
sgtd_tpu.ops.voxel).

The reference voxel-downsamples the query cloud before GICP (leaf_size,
semantic_graph_localization.cpp:357-359, 654-662): points are binned by
floor(p / leaf) and replaced by per-voxel centroids, exactly (no hash
merging, unlike PCL's ApproximateVoxelGrid). The host half is pure
NumPy, the same operations as the reference's, so both give the same
arrays; ``voxel_downsample`` is the fixed-shape version on tensors, on the
points' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sgtd_tpu_torch.utils import segment_sum

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


def voxel_downsample(
    points: torch.Tensor, mask: torch.Tensor, leaf_size: float, max_out: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape voxel-grid centroids on the points' device: points
    (N, 3) and mask (N,) -> (centroids (max_out, 3), out_mask (max_out,)).
    Voxels past ``max_out`` (in key order) are dropped; int32 keys of 10
    bits an axis, so voxel coordinates within +-512 of the origin. Each
    centroid sums its points in their order (the reference's)."""
    dev = points.device
    stride, i32_max = 1024, 2**31 - 1
    leaf = torch.tensor(float(np.float32(leaf_size)), dtype=torch.float32, device=dev)
    c = (torch.floor(points / leaf).to(torch.int32) + stride // 2).clamp(0, stride - 1)
    key = torch.where(mask, (c[:, 0] * stride + c[:, 1]) * stride + c[:, 2], i32_max).to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    spts = points[order]
    head = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([head, skey[1:] != skey[:-1]]) & (skey != i32_max)
    seg = torch.cumsum(first.to(torch.int32), 0) - 1
    seg_c = torch.where((seg >= 0) & (seg < max_out) & (skey != i32_max), seg, max_out)
    ones = (seg_c < max_out).to(torch.float32)
    cnt = segment_sum(ones, seg_c, max_out + 1)[:max_out]
    s = segment_sum(spts * ones[:, None], seg_c, max_out + 1)[:max_out]
    out_mask = cnt > 0
    centroids = s / cnt.clamp(min=1.0)[:, None]
    return torch.where(out_mask[:, None], centroids, 0.0), out_mask


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
