"""Voxelized NDT registration (port of sgtd_tpu.refine.ndt).

The reference's ``Ndt3d`` (ndt_3d.h, ndt_3d.cc, used in earlier pipeline
versions): the target cloud becomes a grid of per-voxel Gaussians (mean,
regularized inverse covariance), and alignment is Gauss-Newton on se(3)
over point-to-Gaussian Mahalanobis residuals. As in the JAX package: voxel
statistics by sort/unique and segment sums (each voxel's points in point
order, no atomics on the card), voxel lookup by bisection over the sorted
keys, the NEARBY6 neighbourhood as 7 probes, and a fixed number of
Gauss-Newton steps with a convergence mask in place of an early exit, so
the loop runs on the card without a host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.ops.linalg3 import inv3x3, sym_eig3x3
from sgtd_tpu_torch.utils import fma_f32, segment_sum, sorted_unique_head, sq_norm_fma, sqrt_rn

I32_MAX = 2**31 - 1
# Voxel coordinate packing: 10 bits per axis, offset 512.
_STRIDE = 1024

_NEARBY7 = np.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], dtype=np.int32
)


class NdtMap(NamedTuple):
    """Sorted voxel-Gaussian map of a target cloud.

    keys:  (V,) int32 sorted packed voxel coords (padding I32_MAX).
    mean:  (V, 3) float32.
    info:  (V, 3, 3) float32 — regularized inverse covariance.
    valid: (V,) bool — voxels with >= min_pts points (ref min_pts_in_voxel=5,
           ndt_3d.h:117).
    voxel_size: () float32.
    """

    keys: torch.Tensor
    mean: torch.Tensor
    info: torch.Tensor
    valid: torch.Tensor
    voxel_size: torch.Tensor


class NdtResult(NamedTuple):
    transform: torch.Tensor
    score: torch.Tensor  # mean Mahalanobis cost over matched points


def _voxel_key(pts: torch.Tensor, voxel_size: torch.Tensor) -> torch.Tensor:
    c = (torch.floor(pts / voxel_size).to(torch.int32) + _STRIDE // 2).clamp(0, _STRIDE - 1)
    return (c[..., 0] * _STRIDE + c[..., 1]) * _STRIDE + c[..., 2]


def build_ndt_map(
    points: torch.Tensor,
    mask: torch.Tensor,
    voxel_size: float = 1.0,
    max_voxels: int = 8192,
    min_pts: int = 5,
) -> NdtMap:
    """The voxel Gaussians of ``points`` (N, 3) under ``mask`` (N,), on the
    points' device."""
    dev = points.device
    n = points.shape[0]
    max_voxels = min(max_voxels, n)
    vs = torch.tensor(float(np.float32(voxel_size)), dtype=torch.float32, device=dev)
    key = torch.where(mask, _voxel_key(points, vs), I32_MAX).to(torch.int32)
    ukey = sorted_unique_head(key, max_voxels, I32_MAX)
    slot = torch.searchsorted(ukey, key).to(torch.int32)
    pc = torch.where(mask & (slot < max_voxels), slot, max_voxels)

    ones = (pc < max_voxels).to(torch.float32)
    cnt = segment_sum(ones, pc, max_voxels + 1)[:max_voxels]
    s = segment_sum(points * ones[:, None], pc, max_voxels + 1)[:max_voxels]
    denom = cnt.clamp(min=1.0)[:, None]
    mu = s / denom
    outer = segment_sum(points[:, :, None] * points[:, None, :] * ones[:, None, None], pc, max_voxels + 1)
    cov = fma_f32(-mu[:, :, None], mu[:, None, :], outer[:max_voxels] / denom[..., None])

    # Regularize like the reference's covariance conditioning: floor the
    # eigenvalue spread.
    vals, vecs = sym_eig3x3(cov)
    floor = torch.clamp(vals[..., 2:3] * 1e-2, min=1e-4)
    vals_r = torch.maximum(vals, floor)
    cov_r = torch.einsum("vij,vj,vkj->vik", vecs, vals_r, vecs)
    info = inv3x3(cov_r)
    valid = (cnt >= float(min_pts)) & (ukey != I32_MAX)
    return NdtMap(keys=ukey, mean=mu, info=torch.where(valid[:, None, None], info, 0.0), valid=valid, voxel_size=vs)


def _lookup(ndt: NdtMap, pts: torch.Tensor) -> torch.Tensor:
    """Nearest valid voxel among the NEARBY7 probes of each point: (N,)
    slot or -1."""
    v_max = ndt.keys.shape[0]
    offs = torch.from_numpy(_NEARBY7).to(pts.device).to(torch.float32) * ndt.voxel_size
    best_slot = torch.full(pts.shape[:1], -1, dtype=torch.int32, device=pts.device)
    best_d = torch.full(pts.shape[:1], float("inf"), dtype=torch.float32, device=pts.device)
    for k in range(7):
        key = _voxel_key(pts + offs[k], ndt.voxel_size).to(torch.int32)
        slot_c = torch.searchsorted(ndt.keys, key).clamp(max=v_max - 1)
        ok = (ndt.keys[slot_c] == key) & ndt.valid[slot_c]
        d = sqrt_rn(sq_norm_fma(pts - ndt.mean[slot_c]))
        better = ok & (d < best_d)
        best_slot = torch.where(better, slot_c.to(torch.int32), best_slot)
        best_d = torch.where(better, d, best_d)
    return best_slot


def ndt_align(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    ndt: NdtMap,
    init_transform: torch.Tensor,
    max_iterations: int = 20,
) -> NdtResult:
    """Align ``src`` (N, 3) onto the NDT map from ``init_transform`` (4, 4):
    ``max_iterations`` Gauss-Newton steps, each kept unless its largest
    update component is below 1e-4 (no early exit, no host
    synchronisation)."""
    T = init_transform.to(src.dtype)
    eye3 = torch.eye(3, dtype=src.dtype, device=src.device)
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    for _ in range(max_iterations):
        moved = src @ T[:3, :3].T + T[:3, 3]
        slot = _lookup(ndt, moved)
        ok = (slot >= 0) & src_mask
        slot_c = slot.clamp(min=0).long()
        info = ndt.info[slot_c]
        r = moved - ndt.mean[slot_c]  # residual direction as ndt_3d.cc:131
        w = ok.to(src.dtype)
        sk = se3.hat(moved)
        J = torch.cat([eye3.expand(sk.shape), -sk], dim=-1)  # d(moved)/dxi for T <- exp(xi) T
        IJ = torch.einsum("nij,njk->nik", info, J)
        H = torch.einsum("nji,njk,n->ik", J, IJ, w)
        g = torch.einsum("nji,njk,nk,n->i", J, info, r, w)
        delta = torch.linalg.solve_ex(H + 1e-5 * eye6, -g).result
        T_new = se3.se3_exp(delta) @ T
        small = delta.abs().max() < 1e-4
        T = torch.where(small, T, T_new)

    moved = src @ T[:3, :3].T + T[:3, 3]
    slot = _lookup(ndt, moved)
    ok = (slot >= 0) & src_mask
    slot_c = slot.clamp(min=0).long()
    r = moved - ndt.mean[slot_c]
    cost = torch.einsum("ni,nij,nj->n", r, ndt.info[slot_c], r)
    n_ok = ok.to(torch.float32).sum().clamp(min=1.0)
    return NdtResult(transform=T, score=torch.where(ok, cost, 0.0).sum() / n_ok)
