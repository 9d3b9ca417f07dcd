"""GICP with plane-regularized covariances and its LM optimizer, plainly
(fast_gicp_impl.hpp:118-290, lsq_registration_impl.hpp:53-163), over a
batch of independent (source, target) problems.

Covariances: the k nearest points of each point (itself included), their
scatter, eigenvalues replaced by (plane_eps, 1, 1). Correspondence: the
nearest target point of each moved source point. Cost: sum of r^T M r,
M = (C_target + R C_source R^T)^-1. LM: lambda from init_factor x max|diag
H|, rejections multiply it along 2^(k(k+1)/2) up to ``lm_max_inner``
tries, the first accepted (rho >= 0) or converged try ends a trip;
convergence when the step moves less than (rot_eps, trans_eps). Masked
points stand 1e6 m away, as in the configuration.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.geometry import Arith, hat, se3_exp, transform
from portbench.reference.params import Params

FAR = 1e6


def _sqdist(ar: Arith, a, b):
    """(P, N, M) squared distances by |a|^2 + |b|^2 - 2 a.b."""
    return (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :] - 2.0 * ar.mm(a, b.transpose(-1, -2))


def _nearest(ar: Arith, q, ref, chunk: int = 8):
    """Index of the nearest ``ref`` point of each ``q`` point, per problem."""
    return torch.cat([_sqdist(ar, q[i : i + chunk], ref[i : i + chunk]).argmin(-1) for i in range(0, q.shape[0], chunk)])


def _take(x, idx):
    rows = torch.arange(x.shape[0], device=x.device).reshape(-1, *([1] * (idx.dim() - 1)))
    return x[rows, idx]


def covariances(ar: Arith, pts, mask, p: Params, chunk: int = 8):
    """(P, N, 3), (P, N) -> (P, N, 3, 3); identity at masked points."""
    out = []
    for i in range(0, pts.shape[0], chunk):
        x, m = pts[i : i + chunk], mask[i : i + chunk]
        eff = torch.where(m[..., None], x, torch.full_like(x, FAR))
        d2 = _sqdist(ar, eff, eff)
        idx = torch.sort(d2, dim=-1, stable=True).indices[..., : p.num_neighbors]
        neigh = _take(x, idx)
        d = neigh - neigh.mean(-2, keepdim=True)
        cov = ar.mm(d.transpose(-1, -2), d) / p.num_neighbors
        # On the host: cuSOLVER's batched eigensolver refuses batches this large.
        v = torch.linalg.eigh(cov.double().cpu()).eigenvectors[..., :, 0].to(cov.device, cov.dtype)
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        reg = eye - (1.0 - p.plane_eps) * v[..., :, None] * v[..., None, :]
        out.append(torch.where(m[..., None, None], reg, eye))
    return torch.cat(out)


def _converged(delta, p: Params):
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    r = (delta[..., :3, :3] - eye).abs().amax(dim=(-2, -1))
    t = delta[..., :3, 3].abs().amax(-1)
    return torch.maximum(r / p.rot_eps, t / p.trans_eps) < 1.0


def align(ar: Arith, src, smask, scov, tgt, tmask, tcov, T0, p: Params):
    """LM-GICP of P problems: src (P, S, 3), tgt (P, T, 3), masks,
    covariances, T0 (P, 4, 4). Returns (T, fitness_gated, inlier_frac)."""
    n_p, s_n = src.shape[:2]
    dev, dt = src.device, src.dtype
    teff = torch.where(tmask[..., None], tgt, torch.full_like(tgt, FAR))
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    ladder = torch.tensor([2.0 ** (k * (k + 1) / 2.0) for k in range(p.lm_max_inner)], dtype=dt, device=dev)
    T = T0.clone()
    lam = torch.full((n_p,), -1.0, dtype=dt, device=dev)
    done = torch.zeros(n_p, dtype=torch.bool, device=dev)
    rows = torch.arange(n_p, device=dev)
    for _ in range(p.max_iterations):
        if bool(done.all()):
            break
        R, t = T[:, :3, :3], T[:, :3, 3]
        moved = transform(ar, R, t, src)
        idx = _nearest(ar, moved, teff)
        b, cb = _take(tgt, idx), _take(tcov, idx)
        Rn = R[:, None]
        M = torch.linalg.inv(cb + ar.mm(ar.mm(Rn, scov), Rn.transpose(-1, -2)))
        r = b - moved
        valid = smask & _take(tmask, idx)
        if math.isfinite(p.max_corr_dist_m):
            valid = valid & (((moved - b) ** 2).sum(-1) < p.max_corr_dist_m ** 2)
        w = valid.to(dt)
        J = torch.cat([-eye3.expand(n_p, s_n, 3, 3), hat(moved)], -1)  # (P, S, 3, 6)
        Jw = (J * w[..., None, None]).reshape(n_p, 3 * s_n, 6).transpose(-1, -2)
        H = ar.mm(Jw, ar.mm(M, J).reshape(n_p, 3 * s_n, 6))
        Mr = ar.mm(M, r[..., None])[..., 0]
        g = ar.mm(Jw, Mr.reshape(n_p, 3 * s_n, 1))[..., 0]
        y0 = (w * (r * Mr).sum(-1)).sum(-1)

        lam = torch.where(lam < 0, p.lm_init_lambda_factor * H.diagonal(dim1=-2, dim2=-1).abs().amax(-1), lam)
        lam_k = lam[:, None] * ladder  # (P, L)
        g_k = g[:, None, :].expand(-1, ladder.numel(), -1)
        d_k = torch.linalg.solve(H[:, None] + lam_k[..., None, None] * eye6, -g_k)
        delta_k = se3_exp(ar, d_k)
        T_k = ar.mm(delta_k, T[:, None])
        r_k = b[:, None] - transform(ar, T_k[..., :3, :3], T_k[..., :3, 3], src[:, None])
        y_k = (w[:, None] * (r_k * ar.mm(M[:, None], r_k[..., None])[..., 0]).sum(-1)).sum(-1)
        rho = (y0[:, None] - y_k) / (d_k * (lam_k[..., None] * d_k - g_k)).sum(-1)
        accept = rho >= 0
        stepconv = _converged(delta_k, p)
        event = accept | stepconv
        first = event.to(torch.uint8).argmax(-1)
        has = event.any(-1)
        acc = has & accept[rows, first]
        stop = has & ~accept[rows, first]
        rho_f = rho[rows, first]
        lam_acc = lam_k[rows, first] * torch.clamp(1.0 - (2.0 * rho_f - 1.0) ** 3, min=1.0 / 3.0)
        conv = (acc & stepconv[rows, first]) | stop
        T = torch.where((acc & ~done)[:, None, None], T_k[rows, first], T)
        lam = torch.where(acc & ~done, lam_acc, lam)
        done = done | conv | ~has
    moved = transform(ar, T[:, :3, :3], T[:, :3, 3], src)
    idx = _nearest(ar, moved, teff)
    sqd = ((moved - _take(tgt, idx)) ** 2).sum(-1)
    valid = smask & _take(tmask, idx)
    n_valid = valid.sum(-1).clamp(min=1)
    inl = valid & (sqd < p.fitness_radius ** 2)
    n_inl = inl.sum(-1)
    fit_g = torch.where(inl, sqd, 0.0).sum(-1) / n_inl.clamp(min=1)
    return T, fit_g, n_inl / n_valid
