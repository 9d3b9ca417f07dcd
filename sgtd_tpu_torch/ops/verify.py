"""B3 ``hypothesis_votes``: inlier counts of every (candidate, hypothesis)
(port of sgtd_tpu.ops.pallas_verify.hypothesis_votes; kernel in
``csrc/verify.cu``).

A pair votes for hypothesis h when all three of its transformed query
vertices lie within ``thr`` of the DB vertices, tested as
``d^2 < thr^2`` (reference STDesc.cpp:487-502). A CUDA tensor launches the
hand-written kernel; a CPU tensor takes the plain PyTorch version. There
is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from sgtd_tpu_torch.ops import _build

# Most pairs a thread of the kernel holds (csrc/verify.cu kPairs): a warp
# walks a candidate's pairs in tiles of 32 * PAIRS_PER_THREAD.
PAIRS_PER_THREAD = 4

# A hypothesis takes 52 bytes of shared memory (R and t as 12 floats on a
# 16-byte boundary, and its counter): 26 KB at MAX_H, within the 48 KB a
# block gets without asking.
MAX_H = 512


def _thr2(thr: float) -> float:
    """thr^2 rounded once to float32, as a Python float."""
    return float(np.float32(float(thr) ** 2))


def hypothesis_votes_plain(
    rot_h: torch.Tensor,
    t_h: torch.Tensor,
    vq: torch.Tensor,
    vdb: torch.Tensor,
    pair_valid: torch.Tensor,
    thr: float,
) -> torch.Tensor:
    """Plain version: the dense (N, H, P, 3) computation, evaluated as
    ((r0*x + r1*y) + r2*z) + t - v and ((d0^2 + d1^2) + d2^2), the order
    the kernel rounds in."""
    R = rot_h[:, :, None, None]  # (N, H, 1, 1, 3, 3)
    T = t_h[:, :, None, None]  # (N, H, 1, 1, 3)
    q = vq[:, None, :, :, None, :]  # (N, 1, P, 3, 1, 3)
    moved = (R[..., 0] * q[..., 0] + R[..., 1] * q[..., 1]) + R[..., 2] * q[..., 2]
    d = moved + T - vdb[:, None]  # (N, H, P, 3 vertices, 3 coords)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    inlier = (d2 < _thr2(thr)).all(-1) & pair_valid[:, None, :]
    return inlier.sum(-1, dtype=torch.int32)


def hypothesis_votes(
    rot_h: torch.Tensor,
    t_h: torch.Tensor,
    vq: torch.Tensor,
    vdb: torch.Tensor,
    pair_valid: torch.Tensor,
    thr: float,
) -> torch.Tensor:
    """rot_h (N, H, 3, 3), t_h (N, H, 3), vq/vdb (N, P, 3, 3) float32 vertex
    rows A, B, C, pair_valid (N, P) bool -> (N, H) int32 votes."""
    if rot_h.device.type == "cpu":
        return hypothesis_votes_plain(rot_h, t_h, vq, vdb, pair_valid, thr)
    return _hypothesis_votes_cuda(rot_h, t_h, vq, vdb, pair_valid, thr)


def _hypothesis_votes_cuda(rot_h, t_h, vq, vdb, pair_valid, thr) -> torch.Tensor:
    n, h = rot_h.shape[:2]
    p = vq.shape[1]
    f32 = torch.float32
    dev = _build.check("hypothesis_votes", ("rot_h", rot_h, (n, h, 3, 3), f32), ("t_h", t_h, (n, h, 3), f32),
                       ("vq", vq, (n, p, 3, 3), f32), ("vdb", vdb, (n, p, 3, 3), f32),
                       ("pair_valid", pair_valid, (n, p), torch.bool))
    if h > MAX_H:
        raise ValueError(f"hypothesis_votes: {h} hypotheses exceed {MAX_H}")
    rot_h, t_h, vq, vdb, pair_valid = (a.contiguous() for a in (rot_h, t_h, vq, vdb, pair_valid))
    out = rot_h.new_empty((n, h), dtype=torch.int32)
    _build.launch("sgtd_hypothesis_votes", dev, rot_h.data_ptr(), t_h.data_ptr(), vq.data_ptr(),
                  vdb.data_ptr(), pair_valid.data_ptr(), out.data_ptr(), n, h, p, _thr2(thr))
    return out
