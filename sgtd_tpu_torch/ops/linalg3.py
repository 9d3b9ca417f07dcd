"""Closed-form batched 3x3/4x4/6x6 linear algebra (port of
sgtd_tpu.ops.linalg3).

``inv3x3`` is the adjugate inverse; ``sym_eig3x3`` the analytic
(trigonometric Cardano) eigen-decomposition of symmetric 3x3 matrices
with cross-product eigenvectors; ``chol_solve6`` the unrolled Cholesky
solve of the 6x6 normal equations of the registration engines.

``kabsch`` is the reference's QCP solve: Horn's quaternion method, the
largest eigenvalue of the 4x4 K matrix by 12 fixed Newton steps on its
characteristic quartic, the eigenvector from the adjugate of K - lambda I.
Branch-free, no SVD, always det(R) = +1. All functions broadcast over
leading batch dimensions, and the arithmetic follows the reference's
expression order so the two agree to float32 rounding.
"""

from __future__ import annotations

import math

import torch

from sgtd_tpu_torch.utils import sqrt_rn

_EPS = 1e-12


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate-based inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() > _EPS, det, _EPS)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def det3x3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _minor(m: torch.Tensor, i: int, j: int) -> torch.Tensor:
    rows = [k for k in range(4) if k != i]
    cols = [k for k in range(4) if k != j]
    return m[..., rows, :][..., :, cols]


def _det4x4(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 4, 4) by cofactor expansion on the first row."""
    out = 0.0
    for j in range(4):
        out = out + ((-1.0) ** j) * m[..., 0, j] * det3x3(_minor(m, 0, j))
    return out


def _adjugate4x4(m: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of (..., 4, 4)."""
    cof = [
        [((-1.0) ** (i + j)) * det3x3(_minor(m, i, j)) for j in range(4)]
        for i in range(4)
    ]
    return torch.stack(
        [torch.stack([cof[i][j] for i in range(4)], dim=-1) for j in range(4)],
        dim=-2,
    )


def kabsch(
    src: torch.Tensor, ref: torch.Tensor, weights: torch.Tensor | None = None
):
    """Optimal proper rotation + translation aligning src -> ref.

    src/ref: (..., N, 3) paired points; weights: (..., N) optional.
    Returns (rot (..., 3, 3), t (..., 3)) minimizing sum w ||R s + t - r||^2.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    wsum = torch.clamp(w.sum(dim=-2, keepdim=True), min=_EPS)
    wn = w / wsum
    mu_s = (src * wn).sum(dim=-2, keepdim=True)
    mu_r = (ref * wn).sum(dim=-2, keepdim=True)
    s = src - mu_s
    r = ref - mu_r
    # Scale so E0 == 1: the Newton iteration below then starts at lambda = 1.
    sigma2 = 0.5 * (
        (wn[..., 0] * (s * s).sum(-1)).sum(-1)
        + (wn[..., 0] * (r * r).sum(-1)).sum(-1)
    )
    inv_sigma = torch.rsqrt(sigma2 + _EPS)[..., None, None]
    s = s * inv_sigma
    r = r * inv_sigma
    H = torch.einsum("...ni,...nj->...ij", s * wn, r)

    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    K = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        dim=-2,
    )

    # Largest root of P(l) = l^4 + c2 l^2 + c1 l + c0 (trace K = 0) by
    # Newton from the E0 = 1 upper bound (Theobald's QCP).
    c2 = -2.0 * (H * H).sum(dim=(-2, -1))
    c1 = -8.0 * det3x3(H)
    c0 = _det4x4(K)
    lam = torch.ones_like(c2)
    for _ in range(12):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - p / torch.where(dp.abs() > _EPS, dp, _EPS)

    # Eigenvector: the largest column of adj(K - lambda I).
    A = K - lam[..., None, None] * torch.eye(4, dtype=K.dtype, device=K.device)
    adj = _adjugate4x4(A)
    norms = (adj * adj).sum(dim=-2)
    best = norms.argmax(dim=-1)
    q = torch.take_along_dim(adj, best[..., None, None], dim=-1)[..., 0]
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    q = torch.where(qn > 1e-12, q / (qn + _EPS), ident)

    w0, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = torch.stack(
        [
            torch.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w0 * z), 2 * (x * z + w0 * y)], -1
            ),
            torch.stack(
                [2 * (x * y + w0 * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w0 * x)], -1
            ),
            torch.stack(
                [2 * (x * z - w0 * y), 2 * (y * z + w0 * x), 1 - 2 * (x * x + y * y)], -1
            ),
        ],
        dim=-2,
    )
    t = mu_r[..., 0, :] - torch.einsum("...ij,...j->...i", rot, mu_s[..., 0, :])
    return rot, t


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (sqrt_rn((v * v).sum(-1, keepdim=True)) + _EPS)


def sym_eig3x3(m: torch.Tensor):
    """Eigen-decomposition of symmetric (..., 3, 3): (eigenvalues (..., 3)
    ascending, eigenvectors (..., 3, 3) as matching columns). Cardano for
    the values; for the smallest and largest, the largest cross product of
    two rows of M - e I; the middle vector completes the frame."""
    dtype = m.dtype
    m = m.to(torch.float32)
    q = m.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    a = m - q[..., None, None] * eye
    p2 = (a * a).sum(dim=(-2, -1)) / 6.0
    p = sqrt_rn(p2 + _EPS)
    # det(A / p) / 2, the cosine of three times the angle.
    r = torch.clamp(det3x3(a) / (2.0 * (p * p * p) + _EPS), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e3 = q + 2.0 * p * torch.cos(phi)
    e1 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    vals = torch.stack([e1, e2, e3], dim=-1)

    def eigvec(ev):
        pa = m - ev[..., None, None] * eye
        r0, r1, r2 = pa[..., 0, :], pa[..., 1, :], pa[..., 2, :]
        cand = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
        best = (cand * cand).sum(-1).argmax(-1)
        v = torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
        return _unit(v)

    v1 = eigvec(e1)
    v3 = eigvec(e3)
    v3 = _unit(v3 - (v3 * v1).sum(-1, keepdim=True) * v1)
    v2 = _cross(v3, v1)
    vecs = torch.stack([v1, v2, v3], dim=-1)
    return vals.to(dtype), vecs.to(dtype)


def chol_solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD 6x6 H by an unrolled Cholesky factorisation
    (the se(3) normal equations, ref lsq_registration_impl.hpp:110,137).

    H (..., 6, 6), g (..., 6) -> x (..., 6). The diagonal is clamped at
    1e-30 so a fully masked problem (H = 0) solves to finite values.
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = sqrt_rn(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
