"""Batched GICP registration (port of sgtd_tpu.refine.gicp).

Generalized ICP with plane-regularized covariances, the reference's
fast_gicp math (fast_gicp_impl.hpp): per-point covariances from the k
nearest neighbours with eigenvalues replaced by (plane_eps, 1, 1)
(:244-290); correspondences as the nearest target point of each
transformed source point (:118-155); Mahalanobis weights
M = (C_B + R C_A R^T)^-1 (:148-153); LM or GN on SE(3) (refine.lsq);
fitness as the mean squared nearest-neighbour distance plus the gated
pair (fitness_gated, inlier_frac) the rerank pick reads.

Every function takes a leading batch in place of the reference's vmap:
a problem is one (source, target) pair. The neighbour searches are the
hand-written kernels B5 ``knn`` (covariances) and B4 ``nn1``
(correspondences, fitness) of ``ops.nn``; the 6x6 reductions and 3x3
products are plain torch (TF32 off at the entry points).

With ``_USE_FUSED_LINEARIZE`` set, each linearization is one launch of
kernel B7 (``ops.gicp.linearize_gicp``) in place of B4 and the chain of
small tensor operations behind it; the final fitness pass stays B4.

On a card an LM solve replays each trip as one CUDA graph (``_graphed``):
the same kernels in the same order on buffers of the problems' tensors, so
the same bits as the eager trip, without its few hundred launches a trip.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from sgtd_tpu_torch.config import GicpConfig
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.ops import gicp as gicp_ops
from sgtd_tpu_torch.ops import nn
from sgtd_tpu_torch.ops.linalg3 import inv3x3, sym_eig3x3
from sgtd_tpu_torch.refine.lsq import LmGraph, gn_solve, lm_solve
from sgtd_tpu_torch.utils import batch_take, disable_tf32, profiling

# Where masked points are displaced, so no kernel special-cases a mask.
FAR = 1e6


def _bsum_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., i, j) @ (..., j, k) as a broadcast-multiply-sum, the
    reference's expression (and so its summation order)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


class GicpResult(NamedTuple):
    """Per problem (leading batch axes):

    transform:     (..., 4, 4) refined src -> tgt.
    fitness:       (...) mean squared NN distance over all valid source
                   points (PCL getFitnessScore semantics).
    num_inliers:   (...) int32 correspondences within fitness_radius.
    fitness_gated: (...) mean squared NN distance over those inliers.
    inlier_frac:   (...) inlier share of the valid source points.
    """

    transform: torch.Tensor
    fitness: torch.Tensor
    num_inliers: torch.Tensor
    fitness_gated: torch.Tensor
    inlier_frac: torch.Tensor


def _fitness_stats(sqd: torch.Tensor, valid: torch.Tensor, cfg: GicpConfig):
    """Raw and gated fitness from the final NN squared distances (..., S)."""
    sqd = torch.clamp(sqd, min=0.0)  # f32 cancellation at exact matches
    zero = torch.zeros((), dtype=sqd.dtype, device=sqd.device)
    n_valid = torch.clamp(valid.to(torch.float32).sum(-1), min=1.0)
    fitness = torch.where(valid, sqd, zero).sum(-1) / n_valid
    r2 = float(torch.tensor(cfg.fitness_radius, dtype=torch.float32) ** 2)
    inl = valid & (sqd < r2)
    n_inl = inl.to(torch.float32).sum(-1)
    fitness_gated = torch.where(inl, sqd, zero).sum(-1) / torch.clamp(n_inl, min=1.0)
    return fitness, n_inl.to(torch.int32), fitness_gated, n_inl / n_valid


def _displaced(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], points, torch.full_like(points, FAR))


def knn_indices(points: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest neighbours (self included) within each masked cloud:
    (..., N, 3), (..., N) -> (..., N, k) int32. Masked points are
    displaced far away and cluster among themselves; ``mask`` gates them
    downstream."""
    pts = _displaced(points, mask)
    return nn.knn(pts, pts, k)


@profiling.traced("refine.covariances")
def point_covariances(points: torch.Tensor, mask: torch.Tensor, cfg: GicpConfig) -> torch.Tensor:
    """Plane-regularized per-point covariances (fast_gicp_impl.hpp:244-290):
    (..., N, 3), (..., N) -> (..., N, 3, 3); identity at masked points."""
    disable_tf32()
    batch, n = points.shape[:-2], points.shape[-2]
    k = cfg.num_neighbors
    flat = points.reshape((-1, n, 3))
    idx = knn_indices(flat, mask.reshape(-1, n), k)
    neigh = batch_take(flat, idx)  # (P, N, k, 3)
    mu = neigh.sum(-2, keepdim=True) / k
    d = neigh - mu
    cov = (d[..., :, None] * d[..., None, :]).sum(-3) / k
    # Eigenvalues replaced by (eps, 1, 1) ascending (PLANE regularization).
    _, vecs = sym_eig3x3(cov)
    vals_reg = torch.tensor([cfg.plane_eps, 1.0, 1.0], dtype=cov.dtype, device=cov.device)
    cov_reg = _bsum_mm(vecs * vals_reg, vecs.transpose(-1, -2))
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    out = torch.where(mask.reshape(-1, n)[..., None, None], cov_reg, eye)
    return out.reshape(batch + (n, 3, 3))


def _moved(src: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """src (P, S, 3) under T (P, ..., 4, 4) -> (P, ..., S, 3)."""
    extra = T.dim() - 3
    s = src.reshape(src.shape[:1] + (1,) * extra + src.shape[1:])
    return s @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


# Fused linearization (kernel B7, ops.gicp): the correspondence search,
# the gate, the Mahalanobis weights and the H, g, y0 sums of one LM trip in
# one launch. Off by default, as in the reference; read at call time.
_USE_FUSED_LINEARIZE = False


def _error_of(src: torch.Tensor):
    """error() of the refine.lsq contract for the sources (P, S, 3), on a
    linearization's aux (b_pts (P, S, 3), M (P, S, 3, 3), w (P, S))."""

    def error(T, aux):
        """Cost of trial transforms T (P, L, 4, 4) on the correspondences
        and Mahalanobis terms of the last linearization
        (fast_gicp_impl.hpp:178-200)."""
        b_pts, M, w = aux
        r = b_pts[:, None] - _moved(src, T)  # (P, L, S, 3)
        Mr = (M[:, None] * r[..., None, :]).sum(-1)
        return (w[:, None] * (r * Mr).sum(-1)).sum(-1)

    return error


def _unfused_inputs(src, src_mask, src_cov, tgt, tgt_eff, tgt_mask, tgt_cov):
    """What the unfused trip reads: the problems' tensors as they are."""
    return src, src_mask, src_cov, tgt, tgt_eff, tgt_mask, tgt_cov


def _unfused_callbacks(inputs, cfg: GicpConfig):
    """linearize and error (the refine.lsq contract) on B4 ``nn1`` and
    plain tensor operations, over P flat problems (``_unfused_inputs``)."""
    src, src_mask, src_cov, tgt, tgt_eff, tgt_mask, tgt_cov = inputs
    p, s_n = src.shape[:2]
    gate = math.isfinite(cfg.max_corr_dist_m)
    gate2 = float(torch.tensor(cfg.max_corr_dist_m, dtype=torch.float32) ** 2) if gate else 0.0
    eye = torch.eye(3, dtype=src.dtype, device=src.device)

    def linearize(T):
        """Correspondences at T and the normal equations H, g
        (fast_gicp_impl.hpp:118-176)."""
        R = T[:, :3, :3]
        moved = _moved(src, T)
        nn_idx, nn_sqd = nn.nn1(moved, tgt_eff)
        b_pts = batch_take(tgt, nn_idx)
        cb = batch_take(tgt_cov, nn_idx)
        rn = R[:, None]
        M = inv3x3(cb + _bsum_mm(_bsum_mm(rn, src_cov), rn.transpose(-1, -2)))
        r = b_pts - moved
        valid = src_mask & batch_take(tgt_mask, nn_idx)
        # Correspondence distance gate (fast_gicp_impl.hpp:139).
        if gate:
            valid = valid & (nn_sqd < gate2)
        w = valid.to(src.dtype)
        sk = se3.hat(moved)  # (P, S, 3, 3)
        J = torch.cat([-eye.expand(sk.shape), sk], dim=-1)  # (P, S, 3, 6)
        MJ = _bsum_mm(M, J)
        Jw = (J * w[..., None, None]).reshape(p, s_n * 3, 6)
        H = Jw.transpose(-1, -2) @ MJ.reshape(p, s_n * 3, 6)
        Mr = (M * r[..., None, :]).sum(-1)  # (P, S, 3) = M r
        g = (Jw.transpose(-1, -2) @ Mr.reshape(p, s_n * 3, 1))[..., 0]
        y0 = (w * (r * Mr).sum(-1)).sum(-1)
        # aux carries the gathered target points, so error() (8 ladder
        # steps per iteration) never gathers again.
        return H, g, y0, (b_pts, M, w)

    return linearize, _error_of(src)


def _fused_inputs(src, src_mask, src_cov, tgt, tgt_eff, tgt_mask, tgt_cov):
    """What B7's trip reads: the source covariances' six entries and the
    targets' payload, built once a solve (reference ``_gicp_align_fused``)."""
    return src, gicp_ops.cov6(src_cov), src_mask, tgt_eff, gicp_ops.build_gicp_payload(tgt, tgt_mask, tgt_cov)


def _fused_callbacks(inputs, cfg: GicpConfig):
    """linearize and error on kernel B7 over ``_fused_inputs``: one launch
    per linearization over all P problems and no tensor operation behind it
    (H, g, y0 and the per-point b, M, w are views of the kernel's outputs);
    error() is the unfused one, on B7's per-point aux."""
    src, scov6, src_mask, tgt_eff, payload = inputs
    gate = float(cfg.max_corr_dist_m)

    def linearize(T):
        H, g, y0, aux = gicp_ops.linearize_gicp(T, src, scov6, src_mask, tgt_eff, payload, gate)
        return H, g, y0, gicp_ops.unpack_aux(aux)

    return linearize, _error_of(src)


# The two linearizations: (the tensors a trip reads, built once a solve
# from the problems; linearize and error over them), by _USE_FUSED_LINEARIZE.
_LINEARIZATIONS = {False: (_unfused_inputs, _unfused_callbacks), True: (_fused_inputs, _fused_callbacks)}


class _Graphed(NamedTuple):
    """An LM trip's graph and what it reads: ``inputs``, buffers refilled
    before each solve, and linearize and error over them."""

    inputs: tuple
    linearize: Callable
    error: Callable
    graph: LmGraph


# LM trips on a card are CUDA graphs (refine.lsq.LmGraph), one for each key
# of _graphed, the least recently used dropped beyond GRAPHS_KEPT: a graph
# holds its inputs and every tensor of its trip. The rerank meets two keys,
# its batch's and the TRUNC_SCAN fallback's single query.
GRAPHS_KEPT = 4
_GRAPHS: OrderedDict = OrderedDict()


def _graphed(inputs: tuple, fused: bool, cfg: GicpConfig) -> _Graphed:
    """The graph of the LM trip over tensors shaped as ``inputs`` (made on
    first use, captured by its first solve), with ``inputs`` copied into
    its buffers. Its key is what the capture fixes: each input's shape,
    dtype and device, the linearization, and the configuration's numbers
    that the trip reads."""
    key = (fused, cfg.lm_max_inner, cfg.rot_eps, cfg.trans_eps, cfg.lm_init_lambda_factor, cfg.max_corr_dist_m,
           tuple((x.shape, x.dtype, x.device) for x in inputs))
    g = _GRAPHS.get(key)
    if g is None:
        buffers = tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in inputs)
        g = _GRAPHS[key] = _Graphed(buffers, *_LINEARIZATIONS[fused][1](buffers, cfg), LmGraph())
        while len(_GRAPHS) > GRAPHS_KEPT:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    for buf, x in zip(g.inputs, inputs):
        buf.copy_(x)
    return g


@profiling.traced("refine.lm")
def _solve(linearize, error, T0: torch.Tensor, cfg: GicpConfig, graph: LmGraph | None = None):
    """The configured solver (``cfg.optimizer``: LM, else GN) from T0 (P, 4,
    4); LM replays ``graph`` for each trip where one is given."""
    if cfg.optimizer == "lm":
        return lm_solve(
            linearize, error, T0,
            max_iterations=cfg.max_iterations,
            lm_inner=cfg.lm_max_inner,
            rot_eps=cfg.rot_eps,
            trans_eps=cfg.trans_eps,
            init_lambda_factor=cfg.lm_init_lambda_factor,
            graph=graph,
        )
    return gn_solve(
        linearize, T0,
        max_iterations=cfg.max_iterations,
        rot_eps=cfg.rot_eps,
        trans_eps=cfg.trans_eps,
        damping=cfg.gn_damping,
    )


def gicp_align(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    init_transform: torch.Tensor,
    cfg: GicpConfig = GicpConfig(),
    src_cov: torch.Tensor | None = None,
    tgt_cov: torch.Tensor | None = None,
) -> GicpResult:
    """Align each src onto its tgt starting from ``init_transform``.

    src (..., S, 3) / src_mask (..., S), tgt (..., T, 3) / tgt_mask
    (..., T), init_transform (..., 4, 4), covariances (..., S|T, 3, 3):
    all with the same leading axes, one problem each.
    """
    disable_tf32()
    if src_cov is None:
        src_cov = point_covariances(src, src_mask, cfg)
    if tgt_cov is None:
        tgt_cov = point_covariances(tgt, tgt_mask, cfg)
    batch = init_transform.shape[:-2]
    s_n, t_n = src.shape[-2], tgt.shape[-2]
    src = src.reshape(-1, s_n, 3)
    src_mask = src_mask.reshape(-1, s_n)
    src_cov = src_cov.reshape(-1, s_n, 3, 3)
    tgt = tgt.reshape(-1, t_n, 3)
    tgt_mask = tgt_mask.reshape(-1, t_n)
    tgt_cov = tgt_cov.reshape(-1, t_n, 3, 3)
    tgt_eff = _displaced(tgt, tgt_mask)
    fused = _USE_FUSED_LINEARIZE
    inputs_of, callbacks = _LINEARIZATIONS[fused]
    inputs = inputs_of(src, src_mask, src_cov, tgt, tgt_eff, tgt_mask, tgt_cov)

    T0 = init_transform.reshape(-1, 4, 4).to(src.dtype)
    if T0.is_cuda and cfg.optimizer == "lm":
        g = _graphed(inputs, fused, cfg)
        res = _solve(g.linearize, g.error, T0, cfg, graph=g.graph)
    else:
        res = _solve(*callbacks(inputs, cfg), T0, cfg)
    T_final = res.transform
    with profiling.span("refine.fitness"):
        nn_idx, sqd = nn.nn1(_moved(src, T_final), tgt_eff)
        valid = src_mask & batch_take(tgt_mask, nn_idx)
        fitness, n_inl, fitness_gated, inlier_frac = _fitness_stats(sqd, valid, cfg)
    return GicpResult(
        transform=T_final.reshape(batch + (4, 4)),
        fitness=fitness.reshape(batch),
        num_inliers=n_inl.reshape(batch),
        fitness_gated=fitness_gated.reshape(batch),
        inlier_frac=inlier_frac.reshape(batch),
    )


@profiling.traced("refine.rerank")
def gicp_rerank(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgts: torch.Tensor,
    tgt_masks: torch.Tensor,
    init_transforms: torch.Tensor,
    cfg: GicpConfig = GicpConfig(),
    tgt_covs: torch.Tensor | None = None,
) -> GicpResult:
    """Multi-candidate GICP rerank (ref candidate loop,
    semantic_graph_localization.cpp:672-722): each query cloud against its
    K candidate map clouds, all B x K problems at once.

    src (B, S, 3) / src_mask (B, S); tgts (B, K, T, 3) / tgt_masks
    (B, K, T); init_transforms (B, K, 4, 4); tgt_covs (B, K, T, 3, 3)
    precomputed map covariances, or None to compute them here. Source
    covariances are computed once per query and shared across K. Returns
    a GicpResult with fields (B, K, ...).
    """
    k = tgts.shape[1]
    src_cov = point_covariances(src, src_mask, cfg)
    if tgt_covs is None:
        tgt_covs = point_covariances(tgts, tgt_masks, cfg)
    expand = lambda x: x[:, None].expand((x.shape[0], k) + x.shape[1:])
    return gicp_align(
        expand(src), expand(src_mask), tgts, tgt_masks, init_transforms, cfg,
        src_cov=expand(src_cov), tgt_cov=tgt_covs,
    )
