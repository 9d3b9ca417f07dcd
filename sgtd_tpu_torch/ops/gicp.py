"""B7 ``linearize_gicp``: one fused GICP linearization for a batch of
problems (port of sgtd_tpu.ops.pallas_gicp; kernel in ``csrc/gicp.cu``).

Per problem and source point, at the transform T: the nearest displaced
target, the distance gate, the Mahalanobis weight
``M = (C_B + R C_A R^T)^-1`` in closed form, and the point's share of
``H = J^T M J``, ``g = J^T M r`` and ``y0 = r^T M r`` with
``J = [-I | skew(moved)]``, summed over the points; plus the per-point
``aux = [b (3) | M row-major (9) | w | 0 x 3]`` that the LM trust region's
error() reuses. The packed outputs are laid out so that H, g, y0, b, M
and w are views of them: a linearization is one call and no further
tensor operation (the reference packs H as 21 entries and M as 6, and
unpacks them with more operations).

Every function takes a leading problem axis P in place of the reference's
vmap. The target payload is the port's own layout, 12 floats a target
(three 16-byte loads): ``[x y z mask | cxx cxy cxz cyy | cyz czz 0 0]``
(the reference's 13 columns served a one-hot matmul gather).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version. There is no fallback between the two.
"""

from __future__ import annotations

import math

import torch

from sgtd_tpu_torch.ops import _build, nn
from sgtd_tpu_torch.utils import batch_take

PARTIAL = 32  # floats per block of the kernel's scratch: 30 sums, 0, 0
ROW = 48  # floats per row of sums: H 36, g 6, y0, n_valid, sum_sqd, 0 x 3
AUX = 16  # floats per source point of aux: b 3, M 9, w, 0 x 3
N_VALID, SUM_SQD = 43, 44  # columns of sums

# (i, j) of the 21 upper-triangular entries of H, in the order they are
# summed, and for each of the 48 columns of a row of sums the summed
# column it copies (30: a zero).
_H_IDX = [(i, j) for i in range(6) for j in range(i, 6)]
_COLUMN = [_H_IDX.index((min(i, j), max(i, j))) for i in range(6) for j in range(6)]
_COLUMN += list(range(21, 30)) + [30, 30, 30]


def cov6(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) upper-triangular xx xy xz yy yz zz."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1,
    )


def build_gicp_payload(tgt: torch.Tensor, tgt_mask: torch.Tensor, tgt_cov: torch.Tensor) -> torch.Tensor:
    """(..., T, 12) target payload ``[xyz mask | cov6 | 0 0]`` from the RAW
    target points (..., T, 3), their mask (..., T) and covariances
    (..., T, 3, 3). Residuals use the raw coordinates; a masked target's
    share is killed by its mask lane, and the distance search runs on the
    separately displaced ``tgt_eff``."""
    zeros = torch.zeros(tgt.shape[:-1] + (2,), dtype=torch.float32, device=tgt.device)
    return torch.cat([tgt, tgt_mask.to(torch.float32)[..., None], cov6(tgt_cov), zeros], dim=-1)


def unpack_sums(sums: torch.Tensor):
    """sums (P, 48) -> views (H (P, 6, 6) symmetric, g (P, 6), y0 (P))."""
    return sums[..., :36].unflatten(-1, (6, 6)), sums[..., 36:42], sums[..., 42]


def unpack_aux(aux: torch.Tensor):
    """aux (P, S, 16) -> views (b (P, S, 3), M (P, S, 3, 3), w (P, S))."""
    return aux[..., :3], aux[..., 3:12].unflatten(-1, (3, 3)), aux[..., 12]


def _gate2(gate: float) -> float:
    """The squared gate as the float32 the kernel compares with; +inf for
    no gate."""
    if not math.isfinite(gate):
        return math.inf
    return float(torch.tensor(gate, dtype=torch.float32) ** 2)


def _moved_fma(T: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """R src + t in the kernel's rounding order:
    ``fma(R2, z, fma(R1, y, R0 * x)) + t`` per row."""
    x, y, z = src.unbind(-1)
    rows = []
    for i in range(3):
        r0, r1, r2, t = (T[:, i, k, None] for k in range(4))
        rows.append(nn._fma(r2, z, nn._fma(r1, y, r0 * x)) + t)
    return torch.stack(rows, dim=-1)


def linearize_sums_plain(T, src, src_cov6, src_mask, tgt_eff, payload, gate: float = math.inf):
    """Plain version of the kernel: (sums (P, 48), aux (P, S, 16)).
    Correspondences through ``nn1_plain`` (the reference's order on the
    CPU), the per-point closed form, a ``sum`` over the points."""
    moved = _moved_fma(T, src)
    idx, dmin = nn.nn1_plain(moved, tgt_eff)
    sel = batch_take(payload, idx)  # (P, S, 12)
    sqd = torch.clamp(dmin, min=0.0)
    valid = src_mask & (sel[..., 3] != 0) & (sqd < _gate2(gate))

    R = T[:, None, :3, :3]  # (P, 1, 3, 3)
    axx, axy, axz, ayy, ayz, azz = src_cov6.unbind(-1)
    # v[i] = C_A R_i^T for rotation row i, then R C_A R^T + C_B.
    v = [
        (axx * R[..., i, 0] + axy * R[..., i, 1] + axz * R[..., i, 2],
         axy * R[..., i, 0] + ayy * R[..., i, 1] + ayz * R[..., i, 2],
         axz * R[..., i, 0] + ayz * R[..., i, 1] + azz * R[..., i, 2])
        for i in range(3)
    ]
    dot = lambda i, u: R[..., i, 0] * u[0] + R[..., i, 1] * u[1] + R[..., i, 2] * u[2]
    sxx, sxy, sxz = dot(0, v[0]) + sel[..., 4], dot(0, v[1]) + sel[..., 5], dot(0, v[2]) + sel[..., 6]
    syy, syz, szz = dot(1, v[1]) + sel[..., 7], dot(1, v[2]) + sel[..., 8], dot(2, v[2]) + sel[..., 9]
    cxx = syy * szz - syz * syz
    cxy = sxz * syz - sxy * szz
    cxz = sxy * syz - sxz * syy
    cyy = sxx * szz - sxz * sxz
    cyz = sxy * sxz - sxx * syz
    czz = sxx * syy - sxy * sxy
    inv = 1.0 / (sxx * cxx + sxy * cxy + sxz * cxz)
    M = [[cxx * inv, cxy * inv, cxz * inv], [None, cyy * inv, cyz * inv], [None, None, czz * inv]]
    M[1][0], M[2][0], M[2][1] = M[0][1], M[0][2], M[1][2]

    mx, my, mz = moved.unbind(-1)
    r = [sel[..., 0] - mx, sel[..., 1] - my, sel[..., 2] - mz]
    Mv = lambda u: [M[i][0] * u[0] + M[i][1] * u[1] + M[i][2] * u[2] for i in range(3)]
    Mr = Mv(r)
    zero, one = torch.zeros_like(mx), torch.ones_like(mx)
    c6 = [[-one, zero, zero], [zero, -one, zero], [zero, zero, -one],
          [zero, mz, -my], [-mz, zero, mx], [my, -mx, zero]]
    mc = [Mv(c) for c in c6]
    dot3 = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    cols = [dot3(c6[a], mc[b]) for a, b in _H_IDX]
    cols += [dot3(c6[a], Mr) for a in range(6)]
    cols += [dot3(r, Mr), one, sqd, zero]
    # w = 0 adds a literal 0 (a select), as in the kernel.
    contrib = torch.where(valid[..., None], torch.stack(cols, dim=-1), zero[..., None])
    sums = contrib.sum(-2)[..., _COLUMN]

    aux = torch.stack(
        [sel[..., 0], sel[..., 1], sel[..., 2], *(M[i][j] for i in range(3) for j in range(3)),
         valid.to(torch.float32), zero, zero, zero], dim=-1,
    )
    return sums, aux


def linearize_sums(T, src, src_cov6, src_mask, tgt_eff, payload, gate: float = math.inf):
    """(sums (P, 48), aux (P, S, 16)): the kernel's packed outputs, with
    n_valid at sums[:, N_VALID] and the sum of the valid points' squared NN
    distances at sums[:, SUM_SQD]. See :func:`linearize_gicp`."""
    if T.device.type == "cpu":
        return linearize_sums_plain(T, src, src_cov6, src_mask, tgt_eff, payload, gate)
    return _linearize_cuda(T, src, src_cov6, src_mask, tgt_eff, payload, gate)


def linearize_gicp(T, src, src_cov6, src_mask, tgt_eff, payload, gate: float = math.inf):
    """Fused GICP linearization of P problems at their transforms ``T``.

    T (P, 4, 4); src (P, S, 3); src_cov6 (P, S, 6) upper-triangular source
    covariances; src_mask (P, S) bool; tgt_eff (P, Tn, 3) displaced-masked
    target coordinates; payload (P, Tn, 12) (:func:`build_gicp_payload`);
    ``gate`` the correspondence distance in metres (inf: none). Returns
    (H (P, 6, 6), g (P, 6), y0 (P), aux (P, S, 16)), the first three
    views of one tensor; :func:`unpack_aux` splits aux.
    """
    sums, aux = linearize_sums(T, src, src_cov6, src_mask, tgt_eff, payload, gate)
    return (*unpack_sums(sums), aux)


def linearize_gicp_plain(T, src, src_cov6, src_mask, tgt_eff, payload, gate: float = math.inf):
    """:func:`linearize_gicp` through the plain version on any device."""
    sums, aux = linearize_sums_plain(T, src, src_cov6, src_mask, tgt_eff, payload, gate)
    return (*unpack_sums(sums), aux)


def _linearize_cuda(T, src, src_cov6, src_mask, tgt_eff, payload, gate):
    f32 = torch.float32
    ps, pt = src.shape[:2], src.shape[:1] + tgt_eff.shape[1:2]
    dev = _build.check("linearize_gicp", ("src", src, ps + (3,), f32), ("T", T, ps[:1] + (4, 4), f32),
                       ("src_cov6", src_cov6, ps + (6,), f32), ("src_mask", src_mask, ps, torch.bool),
                       ("tgt_eff", tgt_eff, pt + (3,), f32), ("payload", payload, pt + (12,), f32))
    (p, s), t = ps, pt[1]
    if t < 1 or s < 1:
        raise ValueError(f"linearize_gicp: {s} source and {t} target points (at least 1 each)")
    nn.check_scan_grid("linearize_gicp", p, s)
    tensors = (T, src, src_cov6, src_mask, tgt_eff, payload)
    T, src, src_cov6, src_mask, tgt_eff, payload = (x.contiguous() for x in tensors)
    # One row for every block of a problem. The kernel lays the blocks out
    # itself (nn.scan_plan: 32 or 128 source points a block) and uses the
    # first rows; 32 points a block is the most it can need.
    partial = T.new_empty((p, -(-s // 32), PARTIAL))
    sums = T.new_empty((p, ROW))
    aux = T.new_empty((p, s, AUX))
    payload_ptr, aux_ptr = payload.data_ptr(), aux.data_ptr()
    if payload_ptr % 16 or aux_ptr % 16:
        raise ValueError("linearize_gicp: payload and aux must be 16-byte aligned")
    _build.launch(
        "sgtd_linearize_gicp", dev, T.data_ptr(), src.data_ptr(), src_cov6.data_ptr(),
        src_mask.data_ptr(), tgt_eff.data_ptr(), payload_ptr, partial.data_ptr(),
        sums.data_ptr(), aux_ptr, p, s, t, _gate2(gate),
    )
    return sums, aux
