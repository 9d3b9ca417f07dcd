"""Landmark-based bundle adjustment with Schur-complement reduction (port of
sgtd_tpu.backend.ba).

Keyframe poses and semantic-instance landmark positions; each observation
is the instance centroid measured in a keyframe's sensor frame:

    residual r = R_f^T (p_l - t_f) - z_{f,l}   in R^3

The landmark block of the normal equations is 3x3 block-diagonal, so
landmarks are eliminated in closed form (Schur complement). Two solvers for
the reduced pose system share the per-observation block kernel:

  * ``optimize_ba`` — dense S (6F x 6F) and a direct solve. The cross-frame
    Schur fill accumulates one observation column at a time (memory
    O(L*O*36), not the O(L*O^2*36) of every (o, p) pair at once).
  * ``optimize_ba_cg`` — matrix-free: S is never formed; each CG matvec
    gathers x at the observations' frames, applies the blocks and sums
    them back into the frames (O(L*O) work, O(F*36) preconditioner state).

Every ``.at[obs_frame].add`` of the reference is a segment sum in its
order (``utils.segment_sum``); the helpers take a ``segment_plan`` made
once per problem, or make one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sgtd_tpu_torch.backend.cg import cg_solve
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.ops.linalg3 import inv3x3
from sgtd_tpu_torch.utils import SegmentPlan, disable_tf32, segment_plan, segment_sum


class BAProblem(NamedTuple):
    """Padded BA problem.

    poses:     (F, 4, 4) float32 — initial keyframe poses.
    landmarks: (L, 3) float32 — initial landmark positions (world).
    obs_frame: (L, O) int32 — observing keyframe per observation slot.
    obs_local: (L, O, 3) float32 — measured local-frame positions z.
    obs_valid: (L, O) bool.
    anchor:    (F,) bool — poses held fixed (gauge).
    """

    poses: torch.Tensor
    landmarks: torch.Tensor
    obs_frame: torch.Tensor
    obs_local: torch.Tensor
    obs_valid: torch.Tensor
    anchor: torch.Tensor


class BAResult(NamedTuple):
    poses: torch.Tensor
    landmarks: torch.Tensor
    costs: torch.Tensor  # (iterations,) sum squared residual per iteration


class _Blocks(NamedTuple):
    """Per-observation normal-equation blocks (everything (L, O, ...))."""

    r: torch.Tensor        # (L, O, 3) residuals
    cost: torch.Tensor     # () weighted SSR
    Hll_inv: torch.Tensor  # (L, 3, 3)
    gl: torch.Tensor       # (L, 3)
    W: torch.Tensor        # (L, O, 6, 3) pose-landmark cross blocks
    HppD: torch.Tensor     # (L, O, 6, 6) per-observation pose blocks
    gp_o: torch.Tensor     # (L, O, 6)


def _ba_blocks(poses, lms, ba: BAProblem, damping: float) -> _Blocks:
    """Linearize every observation; batched, no data-dependent shapes."""
    P = poses[ba.obs_frame.long()]  # (L, O, 4, 4)
    R = P[..., :3, :3]
    t = P[..., :3, 3]
    Rt = R.transpose(-1, -2)
    y = torch.einsum("loij,loj->loi", Rt, lms[:, None, :] - t)  # local pos
    r = y - ba.obs_local  # (L, O, 3)
    w = ba.obs_valid.to(poses.dtype)[..., None]

    # Jacobians: wrt landmark Jl = R^T; wrt pose Jp = [-I | hat(y)].
    Jl = Rt  # (L, O, 3, 3)
    eye3 = torch.eye(3, dtype=poses.dtype, device=poses.device)
    Jp = torch.cat([-eye3.expand(Rt.shape), se3.hat(y)], dim=-1)  # (L, O, 3, 6)

    wm = w[..., None]  # (L, O, 3, 1)
    Hll = torch.einsum("loai,loaj->lij", Jl * wm, Jl)  # (L, 3, 3)
    gl = torch.einsum("loai,loa->li", Jl * wm, r)  # (L, 3)
    Hll_inv = inv3x3(Hll + damping * eye3)

    HppD = torch.einsum("loai,loaj->loij", Jp * wm, Jp)  # (L, O, 6, 6)
    gp_o = torch.einsum("loai,loa->loi", Jp * wm, r)  # (L, O, 6)
    W = torch.einsum("loai,loaj->loij", Jp * wm, Jl)  # (L, O, 6, 3)
    cost = ((r * w) ** 2).sum()
    return _Blocks(r=r, cost=cost, Hll_inv=Hll_inv, gl=gl, W=W, HppD=HppD, gp_o=gp_o)


def _obs_plan(obs_frame: torch.Tensor, f_n: int, copies: int = 1) -> SegmentPlan:
    """The ``segment_plan`` of ``copies`` scatters by ``obs_frame`` into
    (F, ...), one after the other."""
    return segment_plan(obs_frame.reshape(-1).long().repeat(copies), f_n)


def _reduced_gradient(b: _Blocks, obs_frame, f_n, plan: SegmentPlan | None = None) -> torch.Tensor:
    """g = gp - W Hll^-1 gl, scattered to (F, 6). ``plan``:
    ``_obs_plan(obs_frame, f_n)``, or made here."""
    g_fill = torch.einsum("loij,lj->loi", b.W, torch.einsum("lij,lj->li", b.Hll_inv, b.gl))
    if plan is None:
        plan = _obs_plan(obs_frame, f_n)
    return segment_sum((b.gp_o - g_fill).reshape(-1, 6), None, f_n, plan=plan)


def _schur_matvec(b: _Blocks, obs_frame, diag_w, x, plan: SegmentPlan | None = None):
    """S @ x without forming S.

    S = Hpp - W Hll^-1 W^T + diag(diag_w):
      xo  = gather x at each observation's frame            (L, O, 6)
      y  += scatter  HppD xo                                 Hpp part
      u_l = sum_o W_lo^T xo                                  (L, 3)
      y  -= scatter  W_lo (Hll^-1 u)_l                       fill part

    The two scatters are one segment sum over both parts in that order;
    ``plan``: ``_obs_plan(obs_frame, F, copies=2)``, or made here.
    """
    f_n = x.shape[0]
    if plan is None:
        plan = _obs_plan(obs_frame, f_n, copies=2)
    xo = x[obs_frame.long()]  # (L, O, 6)
    hpp = (b.HppD @ xo[..., None])[..., 0]
    u = torch.einsum("loij,loi->lj", b.W, xo)  # (L, 3)
    v = torch.einsum("lij,lj->li", b.Hll_inv, u)
    fill = -torch.einsum("loij,lj->loi", b.W, v)
    y = segment_sum(torch.cat([hpp.reshape(-1, 6), fill.reshape(-1, 6)]), None, f_n, plan=plan)
    return y + diag_w[:, None] * x


def _diag_blocks(b: _Blocks, obs_frame, diag_w, f_n, plan: SegmentPlan | None = None):
    """Block-Jacobi preconditioner blocks: exact o == p Schur diagonal.
    ``plan``: ``_obs_plan(obs_frame, f_n)``, or made here."""
    WHW = torch.einsum("loik,lkm,lojm->loij", b.W, b.Hll_inv, b.W)  # (L, O, 6, 6): the (o, o) fill terms
    if plan is None:
        plan = _obs_plan(obs_frame, f_n)
    D = segment_sum((b.HppD - WHW).reshape(-1, 6, 6), None, f_n, plan=plan)
    return D + diag_w[:, None, None] * torch.eye(6, dtype=b.gl.dtype, device=b.gl.device)


def _back_substitute(b: _Blocks, obs_frame, dp):
    """dl = -Hll^-1 (gl + W^T dp)."""
    Wt_dp = torch.einsum("loij,loi->lj", b.W, dp[obs_frame.long()])
    return -torch.einsum("lij,lj->li", b.Hll_inv, b.gl + Wt_dp)


def _anchor_weights(ba: BAProblem, damping, dtype):
    return torch.where(ba.anchor, 1e8, 0.0).to(dtype) + damping


def optimize_ba(ba: BAProblem, iterations: int = 10, damping: float = 1e-5) -> BAResult:
    """Dense reduced solve: small and medium problems (F up to a few hundred)."""
    disable_tf32()
    f_n = ba.poses.shape[0]
    l_n, o_n = ba.obs_frame.shape
    of = ba.obs_frame.long()
    g_plan = _obs_plan(of, f_n)
    # S.at[f, f].add(HppD), then S.at[f_o, f].add(-fill_o) for each column
    # o: segments of the flat (F * F) axis, planned once.
    hpp_plan = segment_plan(of * f_n + of, f_n * f_n)
    col_plans = [segment_plan(of[:, o : o + 1] * f_n + of, f_n * f_n) for o in range(o_n)]
    anchor_w = _anchor_weights(ba, damping, ba.poses.dtype)
    diag = anchor_w[:, None, None] * torch.eye(6, dtype=ba.poses.dtype, device=ba.poses.device)
    idx = torch.arange(f_n, device=ba.poses.device)

    poses, lms, costs = ba.poses, ba.landmarks, []
    for _ in range(iterations):
        b = _ba_blocks(poses, lms, ba, damping)
        S = segment_sum(b.HppD.reshape(-1, 6, 6), None, f_n * f_n, plan=hpp_plan)
        WHinv = torch.einsum("loij,ljk->loik", b.W, b.Hll_inv)  # (L, O, 6, 3)
        # Cross-frame Schur fill, one observation column at a time: peak
        # extra memory O(L*O*36) instead of the (L, O, O, 6, 6) blocks.
        for o in range(o_n):
            fill = torch.einsum("lik,lpjk->lpij", WHinv[:, o], b.W)  # (L, O, 6, 6)
            S = S + segment_sum(-fill.reshape(-1, 6, 6), None, f_n * f_n, plan=col_plans[o])
        S = S.reshape(f_n, f_n, 6, 6)
        g = _reduced_gradient(b, of, f_n, plan=g_plan)
        S[idx, idx] = S[idx, idx] + diag

        Sd = S.permute(0, 2, 1, 3).reshape(f_n * 6, f_n * 6)
        dp = torch.linalg.solve_ex(Sd, -g.reshape(f_n * 6))[0].reshape(f_n, 6)
        dl = _back_substitute(b, of, dp)
        poses, lms = poses @ se3.se3_exp(dp), lms + dl
        costs.append(b.cost)
    return BAResult(poses=poses, landmarks=lms, costs=torch.stack(costs))


def optimize_ba_cg(
    ba: BAProblem,
    iterations: int = 10,
    damping: float = 1e-5,
    cg_iterations: int = 100,
) -> BAResult:
    """Matrix-free Schur BA: PCG on the reduced system, block-Jacobi
    preconditioned. Never materializes S: scales to thousands of keyframes
    where the dense (6F)^2 system cannot fit."""
    disable_tf32()
    f_n = ba.poses.shape[0]
    of = ba.obs_frame.long()
    plan, plan2 = _obs_plan(of, f_n), _obs_plan(of, f_n, copies=2)
    anchor_w = _anchor_weights(ba, damping, ba.poses.dtype)

    poses, lms, costs = ba.poses, ba.landmarks, []
    for _ in range(iterations):
        b = _ba_blocks(poses, lms, ba, damping)
        g = _reduced_gradient(b, of, f_n, plan=plan)
        D_inv = torch.linalg.inv_ex(_diag_blocks(b, of, anchor_w, f_n, plan=plan))[0]  # (F, 6, 6)

        def matvec(x, b=b):
            return _schur_matvec(b, of, anchor_w, x, plan=plan2)

        def precond(x, D_inv=D_inv):
            return (D_inv @ x[..., None])[..., 0]

        dp = cg_solve(matvec, -g, tol=1e-8, maxiter=cg_iterations, M=precond)
        dl = _back_substitute(b, of, dp)
        poses, lms = poses @ se3.se3_exp(dp), lms + dl
        costs.append(b.cost)
    return BAResult(poses=poses, landmarks=lms, costs=torch.stack(costs))
