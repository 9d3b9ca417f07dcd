"""Rigid-body arithmetic of the reference: Kabsch by SVD, SO(3)/SE(3)
exponentials, and the one product every other module goes through.

``Arith`` fixes the precision: float64 for the reference; float32 with
every matrix product's operands rounded to TF32 (10 mantissa bits, as the
card's tensor cores take float32 operands when TF32 is allowed) for the
control, the precision below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Arith:
    def __init__(self, control: bool = False):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def __call__(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            return to_tf32(a.float()) @ to_tf32(b.float())
        return a @ b


def kabsch(ar: Arith, src, ref, w=None):
    """Proper rotation and translation minimising sum w |R s + t - r|^2:
    src, ref (..., N, 3), w (..., N) -> (R (..., 3, 3), t (..., 3))."""
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wn = (w / w.sum(-1, keepdim=True).clamp(min=1e-12))[..., None]
    mu_s, mu_r = (src * wn).sum(-2), (ref * wn).sum(-2)
    cov = ar.mm(((src - mu_s[..., None, :]) * wn).transpose(-1, -2), ref - mu_r[..., None, :])
    u, _, vt = torch.linalg.svd(cov)
    v = vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(ar.mm(v, u.transpose(-1, -2))))
    fix = torch.ones(d.shape + (3,), dtype=d.dtype, device=d.device)
    fix[..., 2] = torch.where(d < 0, -1.0, 1.0)
    rot = ar.mm(v * fix[..., None, :], u.transpose(-1, -2))
    t = mu_r - ar.mm(rot, mu_s[..., None])[..., 0]
    return rot, t


def transform(ar: Arith, rot, t, pts):
    """R p + t of points (..., N, 3) under (..., 3, 3), (..., 3)."""
    return ar.mm(pts, rot.transpose(-1, -2)) + t[..., None, :]


def to_mat(rot, t):
    out = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def se3_exp(ar: Arith, xi):
    """(..., 6) [v, w] -> (..., 4, 4): Rodrigues' rotation and the left
    Jacobian applied to v."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (ths - torch.sin(ths)) / (ths * ths * ths))
    W = hat(w)
    W2 = ar.mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return to_mat(R, ar.mm(V, v[..., None])[..., 0])


def pose_gap(a, b, lever_m: float) -> torch.Tensor:
    """Largest displacement, within ``lever_m`` of the sensor, between two
    world poses (..., 4, 4): |dt| + lever * (rotation angle of a^-1 b)."""
    a, b = a.double(), b.double()
    dt = torch.linalg.vector_norm(a[..., :3, 3] - b[..., :3, 3], dim=-1)
    rel = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    skew = rel - rel.transpose(-1, -2)
    s = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], -1).norm(dim=-1) / 2
    ang = torch.atan2(s, ((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2))
    return dt + lever_m * ang
