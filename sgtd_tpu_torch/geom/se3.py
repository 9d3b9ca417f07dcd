"""SO(3)/SE(3) operations (port of sgtd_tpu.geom.se3).

hat/vee, exp/log with the reference's Taylor branches and its ``_EPS``,
inverse, point transforms and the relative pose error. Every function
works on the trailing dimensions and broadcasts over leading batch
dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).sum(-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, safe near 0: (..., 3) -> (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 > 1e-8
    a = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(small, (1.0 - torch.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    return _eye3(w, W.shape) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation-matrix log: (..., 3, 3) -> (..., 3). Safe for angles < pi."""
    cos_t = torch.clamp((_trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    scale = torch.where(
        sin_t.abs() > 1e-6, theta / (sin_t + _EPS), 1.0 + theta * theta / 6.0
    )
    return w * scale[..., None]


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Angle of a rotation matrix in degrees (ref utility.hpp:117-122)."""
    cos_t = torch.clamp((_trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos_t))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) [v, w] -> (..., 4, 4) homogeneous transform."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 > 1e-8
    b = torch.where(small, (1.0 - torch.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    c = torch.where(
        small,
        (theta - torch.sin(theta)) / (theta2 * theta + _EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    V = _eye3(xi, W.shape) + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, v)
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: (..., 4, 4) -> (..., 6) [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    # V^-1 = I - W/2 + (1/theta^2 - cot(theta/2)/(2 theta)) W^2
    half = theta / 2.0
    cot_term = torch.where(
        theta2 > 1e-8,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + _EPS)) / (theta2 + _EPS),
        1.0 / 12.0 + theta2 / 720.0,
    )
    Vinv = _eye3(T, W.shape) - 0.5 * W + cot_term[..., None, None] * W2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([v, w], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (..., 3, 3), t (..., 3)) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mat_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse of (..., 4, 4)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def relative_pose_error(gt: torch.Tensor, est: torch.Tensor):
    """Translation (m) and rotation (deg) error, ref compute_adj_rpe
    (utility.hpp:110-123): delta = est^-1 @ gt."""
    delta = mat_inverse(est) @ gt
    t_err = torch.linalg.vector_norm(delta[..., :3, 3], dim=-1)
    return t_err, rotation_angle_deg(delta[..., :3, :3])

