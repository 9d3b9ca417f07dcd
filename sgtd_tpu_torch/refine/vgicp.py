"""Voxelized GICP (port of sgtd_tpu.refine.vgicp): a Gaussian voxel map of
the target and voxel-neighbourhood correspondences.

The reference's fast_vgicp math (fast_vgicp_voxel.hpp:79-165,
impl/fast_vgicp_impl.hpp:74-200), batched over leading axes in place of
the reference's ``vmap``:

  * Gaussian voxel map: voxel coord = floor(p / resolution - 0.5)
    (fast_vgicp_voxel.hpp:158-160), a true division by a resolution held
    in a tensor on the points' device (a Python scalar lets the card's
    division multiply by the reciprocal, and one ulp moves a point to the
    next voxel); ADDITIVE accumulation sums means and covariances and
    divides by the count (:104-123), MULTIPLICATIVE sums information
    matrices (:79-102). The unordered_map is a sorted table of packed keys
    (10 bits an axis, +-512 voxels; padding 2^31 - 1), and each voxel's
    sums run over its points in point order (a stable sort by voxel, then
    ``torch.segment_reduce``), the reference's order on the CPU, with no
    atomics on the card;
  * correspondences: each transformed source point probes its voxel plus a
    DIRECT1/DIRECT7/DIRECT27 neighbourhood (fast_vgicp_voxel.hpp:10-44,
    fast_vgicp_impl.hpp:74-101), a batched ``searchsorted`` (left side, as
    ``jnp.searchsorted``) per offset;
  * per-correspondence weight w = sqrt(num_points) and Mahalanobis
    M = (C_B + R C_A R^T)^-1 at each linearization
    (fast_vgicp_impl.hpp:103-119, 140-152); cost = w * e^T M e;
  * optimizer: Gauss-Newton or Levenberg-Marquardt (``refine.lsq``),
    selected by GicpConfig.optimizer.

No nearest-neighbour search runs per iteration: the only kernel on this
path is B5 ``knn`` (``ops.nn``), through ``point_covariances`` for the
source (and target) covariances. H and g are ``torch.matmul`` products, as
the reference computes them outside any Pallas kernel (TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sgtd_tpu_torch.config import GicpConfig
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.ops.linalg3 import inv3x3
from sgtd_tpu_torch.refine.gicp import _bsum_mm, _moved, point_covariances
from sgtd_tpu_torch.refine.lsq import gn_solve, lm_solve
from sgtd_tpu_torch.utils import batch_take, disable_tf32, sqrt_rn

I32_MAX = 2**31 - 1
# Voxel coordinate packing: 10 bits per axis, offset 512 (+-512 voxels).
_STRIDE = 1024

_OFFSETS = {
    # fast_vgicp_voxel.hpp:16-19
    "direct1": np.zeros((1, 3), np.int32),
    # fast_vgicp_voxel.hpp:20-29
    "direct7": np.array(
        [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.int32,
    ),
    # fast_vgicp_voxel.hpp:36-43
    "direct27": np.stack(
        np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(27, 3).astype(np.int32),
}


class GaussianVoxelMap(NamedTuple):
    """Sorted Gaussian-voxel tables, one per problem (leading axes ...).

    keys: (..., V) int32 sorted packed voxel coords (padding I32_MAX).
    mean: (..., V, 3) float32 finalized voxel mean.
    cov:  (..., V, 3, 3) float32 finalized voxel covariance.
    n:    (..., V) float32 points accumulated into the voxel.
    resolution: (...) float32.
    """

    keys: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor
    n: torch.Tensor
    resolution: torch.Tensor


def _voxel_coord(pts: torch.Tensor, resolution: torch.Tensor) -> torch.Tensor:
    """Reference voxel_coord: floor(x / r - 0.5) (fast_vgicp_voxel.hpp:158);
    ``resolution`` a tensor on the points' device, broadcast against them."""
    return torch.floor(pts / resolution - 0.5).to(torch.int32)


def _pack(coord: torch.Tensor) -> torch.Tensor:
    c = (coord + _STRIDE // 2).clamp(0, _STRIDE - 1)
    return (c[..., 0] * _STRIDE + c[..., 1]) * _STRIDE + c[..., 2]


def build_voxel_map(
    points: torch.Tensor,
    mask: torch.Tensor,
    covs: torch.Tensor,
    resolution: float = 1.0,
    max_voxels: int | None = None,
    mode: str = "additive",
) -> GaussianVoxelMap:
    """create_voxelmap (fast_vgicp_voxel.hpp:129-156) of each cloud:
    points (..., N, 3), mask (..., N), covs (..., N, 3, 3).

    ``max_voxels`` defaults to the point count (exact, no truncation).
    ``mode``: "additive" (the reference's default, fast_vgicp_impl.hpp:24)
    or "multiplicative".
    """
    if mode not in ("additive", "multiplicative"):
        raise ValueError(f"unknown voxel accumulation mode {mode!r}")
    batch, n = points.shape[:-2], points.shape[-2]
    dev = points.device
    pts = points.reshape(-1, n, 3)
    msk = mask.reshape(-1, n)
    cv = covs.reshape(-1, n, 3, 3)
    p = pts.shape[0]
    v_max = n if max_voxels is None else min(max_voxels, n)
    res = torch.full(batch, float(np.float32(resolution)), dtype=torch.float32, device=dev)

    key = torch.where(msk, _pack(_voxel_coord(pts, res.reshape(p, 1, 1))), I32_MAX).to(torch.int32)
    skey = torch.sort(key, dim=-1).values
    head = torch.ones((p, 1), dtype=torch.bool, device=dev)
    first = torch.cat([head, skey[:, 1:] != skey[:, :-1]], dim=-1) & (skey != I32_MAX)
    upos = torch.where(first, torch.arange(n, dtype=torch.int32, device=dev), n)
    sel = torch.sort(upos, dim=-1).values[:, :v_max]
    ukey = torch.where(sel < n, torch.gather(skey, 1, sel.clamp(max=n - 1).long()), I32_MAX).to(torch.int32)

    slot = torch.searchsorted(ukey, key.contiguous()).to(torch.int32)
    pc = torch.where(msk & (slot < v_max), slot, v_max)
    # Each voxel's points in point order: stable sort by (problem, slot),
    # then a sum over each run (slot v_max gathers the dropped points).
    seg = (torch.arange(p, dtype=torch.int64, device=dev)[:, None] * (v_max + 1) + pc).reshape(-1)
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg, minlength=p * (v_max + 1))

    def segment_sum(x: torch.Tensor) -> torch.Tensor:
        """(P, N, *rest) -> (P, v_max, *rest) sums over each voxel's points."""
        rest = x.shape[2:]
        flat = x.reshape((p * n, -1))[order]
        out = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0)
        return out.reshape((p, v_max + 1) + rest)[:, :v_max]

    ones = (pc < v_max).to(torch.float32)
    cnt = segment_sum(ones[..., None])[..., 0]
    denom = torch.clamp(cnt, min=1.0)
    if mode == "additive":
        s = segment_sum(pts * ones[..., None])
        c = segment_sum(cv * ones[..., None, None])
        mean = s / denom[..., None]
        cov = c / denom[..., None, None]
    else:
        # Information matrices and information-weighted means, finalized
        # with one inversion.
        info = inv3x3(cv)
        im = (info * pts[..., None, :]).sum(-1)  # info @ p
        c = segment_sum(info * ones[..., None, None])
        s = segment_sum(im * ones[..., None])
        eye = torch.eye(3, dtype=c.dtype, device=dev)
        cov = inv3x3(c + 1e-9 * eye)
        mean = (cov * s[..., None, :]).sum(-1)

    valid = (cnt > 0) & (ukey != I32_MAX)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    vm = GaussianVoxelMap(
        keys=ukey,
        mean=torch.where(valid[..., None], mean, zero),
        cov=torch.where(valid[..., None, None], cov, zero),
        n=torch.where(valid, cnt, zero),
        resolution=res.reshape(p),
    )
    return GaussianVoxelMap(*(x.reshape(batch + x.shape[1:]) for x in vm))


def build_voxel_maps(
    clouds: torch.Tensor, masks: torch.Tensor, covs: torch.Tensor, cfg: GicpConfig = GicpConfig()
) -> GaussianVoxelMap:
    """Per-keyframe Gaussian voxel maps, leading F axis: map keyframes are
    fixed, so their voxel maps are map-build artifacts gathered per
    candidate at query time (the reference builds its target map once per
    setInputTarget, fast_vgicp_impl.hpp:60-72)."""
    return build_voxel_map(clouds, masks, covs, cfg.voxel_resolution, mode=cfg.voxel_mode)


def _correspondences(vm: GaussianVoxelMap, moved: torch.Tensor, src_mask: torch.Tensor, offsets: np.ndarray):
    """update_correspondences probe (fast_vgicp_impl.hpp:74-101) of P
    problems: moved (P, N, 3) -> (slot (P, N, O), found (P, N, O))."""
    p, n = moved.shape[:2]
    v_max = vm.keys.shape[-1]
    coord = _voxel_coord(moved, vm.resolution.reshape(p, 1, 1))  # (P, N, 3)
    offs = torch.as_tensor(offsets, device=moved.device)
    key = _pack(coord[:, :, None, :] + offs).to(torch.int32)  # (P, N, O)
    slot = torch.searchsorted(vm.keys, key.reshape(p, -1)).reshape(key.shape).to(torch.int32)
    slot_c = slot.clamp(max=v_max - 1)
    found = (batch_take(vm.keys, slot_c) == key) & (batch_take(vm.n, slot_c) > 0) & src_mask[:, :, None]
    return slot_c, found


class VgicpResult(NamedTuple):
    """Per problem (leading batch axes); the fields of refine.gicp's
    GicpResult, so the rerank pick reads either engine, plus ``converged``.

    transform:     (..., 4, 4) refined src -> tgt.
    fitness:       (...) mean squared distance to the matched (DIRECT1)
                   voxel means.
    num_inliers:   (...) int32 matched points within fitness_radius.
    converged:     (...) bool.
    fitness_gated: (...) mean squared distance over those inliers.
    inlier_frac:   (...) inlier share of all valid source points (a point
                   with no voxel in reach counts against it).
    """

    transform: torch.Tensor
    fitness: torch.Tensor
    num_inliers: torch.Tensor
    converged: torch.Tensor
    fitness_gated: torch.Tensor
    inlier_frac: torch.Tensor


def vgicp_align(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor | None,
    tgt_mask: torch.Tensor | None,
    init_transform: torch.Tensor,
    cfg: GicpConfig = GicpConfig(),
    src_cov: torch.Tensor | None = None,
    tgt_cov: torch.Tensor | None = None,
    voxel_map: GaussianVoxelMap | None = None,
) -> VgicpResult:
    """Align each src onto its target's Gaussian voxel map from
    ``init_transform`` (..., 4, 4).

    src (..., S, 3) / src_mask (..., S) and the covariances (..., S|T, 3,
    3) carry the leading axes of ``init_transform``, one problem each.
    ``voxel_map``: prebuilt maps with those leading axes (then ``tgt`` and
    ``tgt_mask`` may be None); otherwise built here from tgt (..., T, 3)
    and its covariances.
    """
    disable_tf32()
    if src_cov is None:
        src_cov = point_covariances(src, src_mask, cfg)
    if voxel_map is None:
        if tgt_cov is None:
            tgt_cov = point_covariances(tgt, tgt_mask, cfg)
        voxel_map = build_voxel_map(tgt, tgt_mask, tgt_cov, cfg.voxel_resolution, mode=cfg.voxel_mode)
    batch = init_transform.shape[:-2]
    s_n = src.shape[-2]
    src = src.reshape(-1, s_n, 3)
    src_mask = src_mask.reshape(-1, s_n)
    src_cov = src_cov.reshape(-1, s_n, 3, 3)
    p = src.shape[0]
    vm = GaussianVoxelMap(*(x.reshape((p,) + x.shape[len(batch):]) for x in voxel_map))
    offsets = _OFFSETS[cfg.neighbor_search]
    eye = torch.eye(3, dtype=src.dtype, device=src.device)

    def linearize(T):
        R = T[:, :3, :3]
        moved = _moved(src, T)  # (P, N, 3)
        slot, found = _correspondences(vm, moved, src_mask, offsets)
        mu_b = batch_take(vm.mean, slot)  # (P, N, O, 3)
        cov_b = batch_take(vm.cov, slot)  # (P, N, O, 3, 3)
        w = torch.where(found, sqrt_rn(batch_take(vm.n, slot)), 0.0)  # :150
        # M = (C_B + R C_A R^T)^-1 (fast_vgicp_impl.hpp:109-118).
        rn = R[:, None]
        rca = _bsum_mm(_bsum_mm(rn, src_cov), rn.transpose(-1, -2))  # (P, N, 3, 3)
        M = inv3x3(cov_b + rca[:, :, None])
        e = mu_b - moved[:, :, None]  # (P, N, O, 3)
        # J = d e / d xi = [-I | skew(moved)], shared across offsets.
        sk = se3.hat(moved)
        J = torch.cat([-eye.expand(sk.shape), sk], dim=-1)  # (P, N, 3, 6)
        Jo = J[:, :, None].expand(M.shape[:3] + (3, 6))
        MJ = _bsum_mm(M, Jo)  # (P, N, O, 3, 6)
        Jw = (Jo * w[..., None, None]).reshape(p, -1, 6)
        H = Jw.transpose(-1, -2) @ MJ.reshape(p, -1, 6)
        Me = (M * e[..., None, :]).sum(-1)  # (P, N, O, 3)
        g = (Jw.transpose(-1, -2) @ Me.reshape(p, -1, 1))[..., 0]
        y0 = (w * (e * Me).sum(-1)).sum((-2, -1))
        return H, g, y0, (M, w, mu_b)

    def error(T, aux):
        """compute_error (fast_vgicp_impl.hpp:178-200) of trial transforms
        T (P, L, 4, 4): the same correspondences and Mahalanobis terms."""
        M, w, mu_b = aux
        e = mu_b[:, None] - _moved(src, T)[..., None, :]  # (P, L, N, O, 3)
        Me = (M[:, None] * e[..., None, :]).sum(-1)
        return (w[:, None] * (e * Me).sum(-1)).sum((-2, -1))

    T0 = init_transform.reshape(-1, 4, 4).to(src.dtype)
    if cfg.optimizer == "lm":
        res = lm_solve(
            linearize, error, T0,
            max_iterations=cfg.max_iterations,
            lm_inner=cfg.lm_max_inner,
            rot_eps=cfg.rot_eps,
            trans_eps=cfg.trans_eps,
            init_lambda_factor=cfg.lm_init_lambda_factor,
        )
    else:
        res = gn_solve(
            linearize, T0,
            max_iterations=cfg.max_iterations,
            rot_eps=cfg.rot_eps,
            trans_eps=cfg.trans_eps,
            damping=cfg.gn_damping,
        )

    T = res.transform
    moved = _moved(src, T)
    slot1, found1 = _correspondences(vm, moved, src_mask, _OFFSETS["direct1"])
    d = moved - batch_take(vm.mean, slot1[..., 0])
    sqd = (d * d).sum(-1)
    ok = found1[..., 0]
    zero = torch.zeros((), dtype=sqd.dtype, device=sqd.device)
    n_ok = torch.clamp(ok.to(torch.float32).sum(-1), min=1.0)
    fitness = torch.where(ok, sqd, zero).sum(-1) / n_ok
    # Gated measures against all valid source points: a point with no
    # DIRECT1 voxel is a non-overlap point, like a far NN in plain GICP.
    r2 = float(torch.tensor(cfg.fitness_radius, dtype=torch.float32) ** 2)
    inl = ok & (sqd < r2)
    n_inl = inl.to(torch.float32).sum(-1)
    n_valid = torch.clamp(src_mask.to(torch.float32).sum(-1), min=1.0)
    return VgicpResult(
        transform=T.reshape(batch + (4, 4)),
        fitness=fitness.reshape(batch),
        num_inliers=n_inl.to(torch.int32).reshape(batch),
        converged=res.converged.reshape(batch),
        fitness_gated=(torch.where(inl, sqd, zero).sum(-1) / torch.clamp(n_inl, min=1.0)).reshape(batch),
        inlier_frac=(n_inl / n_valid).reshape(batch),
    )


def vgicp_rerank(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgts: torch.Tensor | None,
    tgt_masks: torch.Tensor | None,
    init_transforms: torch.Tensor,
    cfg: GicpConfig = GicpConfig(),
    tgt_covs: torch.Tensor | None = None,
    voxel_maps: GaussianVoxelMap | None = None,
    src_cov: torch.Tensor | None = None,
) -> VgicpResult:
    """Multi-candidate VGICP rerank, the counterpart of ``gicp_rerank``
    (ref candidate loop, semantic_graph_localization.cpp:672-722): each
    query cloud against its K candidates, all B x K problems at once.

    src (B, S, 3) / src_mask (B, S); init_transforms (B, K, 4, 4);
    ``voxel_maps``: prebuilt voxel maps of the candidates with leading
    (B, K) axes (``build_voxel_maps`` gathered by candidate frame; then
    ``tgts`` / ``tgt_masks`` may be None). Without them the maps build here
    from tgts (B, K, T, 3) / tgt_masks (B, K, T) and ``tgt_covs`` (or
    covariances computed here). Source covariances are computed once a
    query and shared across K. Returns a VgicpResult with (B, K) fields.
    """
    if src_cov is None:
        src_cov = point_covariances(src, src_mask, cfg)
    if voxel_maps is None:
        if tgt_covs is None:
            tgt_covs = point_covariances(tgts, tgt_masks, cfg)
        voxel_maps = build_voxel_map(tgts, tgt_masks, tgt_covs, cfg.voxel_resolution, mode=cfg.voxel_mode)
    k = init_transforms.shape[1]
    expand = lambda x: x[:, None].expand((x.shape[0], k) + x.shape[1:])
    return vgicp_align(
        expand(src), expand(src_mask), None, None, init_transforms, cfg,
        src_cov=expand(src_cov), voxel_map=voxel_maps,
    )
