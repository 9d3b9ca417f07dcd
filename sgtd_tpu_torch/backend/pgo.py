"""Pose-graph optimization: batched Gauss-Newton on SE(3) (port of
sgtd_tpu.backend.pgo).

Two solvers share the per-edge block kernel:

  * ``optimize_pose_graph`` — dense (6N)^2 normal equations and a direct
    solve (up to ~1k keyframes).
  * ``optimize_pose_graph_cg`` — matrix-free: H is never formed; each PCG
    matvec gathers x at the edge ends, applies the edges' 6x6 blocks and
    sums them into the nodes (O(E) work, O(N*36) preconditioner state).

Formulation (right perturbation, g2o-style approximate Jacobians):
  factor k: measured T_ij between nodes i, j
  residual r_k = log( T_ij^-1 (T_i^-1 T_j) )  in R^6  [v, w]
  dr/dxi_j ~=  I
  dr/dxi_i ~= -Ad(T_j^-1 T_i)
Gauge freedom is fixed by a 1e8 prior on the anchored nodes.

Every float scatter of the reference (``.at[].add`` into H, g, the matvec's
y and the block-Jacobi D) is a segment sum in the reference's order
(``utils.segment_sum``), planned once per problem since the edges never
change: on the card two runs give the same bits. GN steps are a Python loop
over the reference's ``lax.scan``. The solves are ``torch.linalg.solve_ex``
and ``inv_ex``: like ``jnp.linalg``, they raise nothing on a singular
system, and they never wait on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sgtd_tpu_torch.backend.cg import cg_solve
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.utils import SegmentPlan, disable_tf32, segment_plan, segment_sum


class PoseGraph(NamedTuple):
    """Batched factor-graph problem.

    poses:   (N, 4, 4) float32 — initial node poses (world from node).
    edge_i:  (E,) int32 — source node of each factor.
    edge_j:  (E,) int32 — target node.
    t_meas:  (E, 4, 4) float32 — measured T_i^-1 T_j.
    weight:  (E,) float32 — scalar information (0 disables a factor).
    anchor:  (N,) bool — nodes held fixed (gauge).
    """

    poses: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    t_meas: torch.Tensor
    weight: torch.Tensor
    anchor: torch.Tensor


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for [v, w] tangent ordering: (..., 6, 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = se3.hat(t) @ R
    z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _residuals(poses: torch.Tensor, pg: PoseGraph) -> torch.Tensor:
    Ti = poses[pg.edge_i.long()]
    Tj = poses[pg.edge_j.long()]
    rel = se3.mat_inverse(Ti) @ Tj
    err = se3.mat_inverse(pg.t_meas) @ rel
    return se3.se3_log(err)  # (E, 6)


class _EdgeBlocks(NamedTuple):
    """Per-edge normal-equation blocks (everything (E, ...))."""

    JiT_Ji: torch.Tensor  # (E, 6, 6)
    JiT_Jj: torch.Tensor  # (E, 6, 6)
    JjT_Jj: torch.Tensor  # (E, 6, 6)
    gi: torch.Tensor      # (E, 6)
    gj: torch.Tensor      # (E, 6)
    cost: torch.Tensor    # ()


def _edge_blocks(poses: torch.Tensor, pg: PoseGraph) -> _EdgeBlocks:
    """Linearize every factor; batched, no data-dependent shapes."""
    r = _residuals(poses, pg)  # (E, 6)
    Ti = poses[pg.edge_i.long()]
    Tj = poses[pg.edge_j.long()]
    Jj = torch.eye(6, dtype=poses.dtype, device=poses.device).expand(r.shape[0], 6, 6)
    Ji = -adjoint(se3.mat_inverse(Tj) @ Ti)  # (E, 6, 6)
    w = pg.weight[:, None, None]
    JiT_Ji = Ji.transpose(-1, -2) @ (Ji * w)
    JiT_Jj = Ji.transpose(-1, -2) @ (Jj * w)
    JjT_Jj = Jj.transpose(-1, -2) @ (Jj * w)
    gi = torch.einsum("eab,ea->eb", Ji * w, r)
    gj = torch.einsum("eab,ea->eb", Jj * w, r)
    return _EdgeBlocks(
        JiT_Ji=JiT_Ji, JiT_Jj=JiT_Jj, JjT_Jj=JjT_Jj,
        gi=gi, gj=gj, cost=(r * r * pg.weight[:, None]).sum(),
    )


def optimize_pose_graph(pg: PoseGraph, iterations: int = 10, damping: float = 1e-6) -> torch.Tensor:
    """Gauss-Newton refinement; returns optimized poses (N, 4, 4)."""
    disable_tf32()
    n = pg.poses.shape[0]
    ei, ej = pg.edge_i.long(), pg.edge_j.long()
    # H.at[i, i], .at[i, j], .at[j, i], .at[j, j] and g.at[i], .at[j], in
    # the reference's order, as segments of the flat (n * n) and (n) axes.
    h_plan = segment_plan(torch.cat([ei * n + ei, ei * n + ej, ej * n + ei, ej * n + ej]), n * n)
    g_plan = segment_plan(torch.cat([ei, ej]), n)
    eye = torch.eye(6, dtype=pg.poses.dtype, device=pg.poses.device)
    anchor_w = torch.where(pg.anchor, 1e8, 0.0).to(pg.poses.dtype)
    diag = (anchor_w[:, None, None] + damping) * eye
    idx = torch.arange(n, device=pg.poses.device)

    poses = pg.poses
    for _ in range(iterations):
        b = _edge_blocks(poses, pg)
        upd = torch.cat([b.JiT_Ji, b.JiT_Jj, b.JiT_Jj.transpose(-1, -2), b.JjT_Jj])
        H = segment_sum(upd, None, n * n, plan=h_plan).reshape(n, n, 6, 6)
        H[idx, idx] = H[idx, idx] + diag
        g = segment_sum(torch.cat([b.gi, b.gj]), None, n, plan=g_plan)
        Hd = H.permute(0, 2, 1, 3).reshape(n * 6, n * 6)
        delta = torch.linalg.solve_ex(Hd, -g.reshape(n * 6))[0].reshape(n, 6)
        poses = poses @ se3.se3_exp(delta)
    return poses


def _hessian_matvec(b: _EdgeBlocks, ei, ej, diag_w, plan: SegmentPlan | None = None):
    """The operator x -> H @ x of one GN step, H never formed: gather x at
    both ends of every edge, apply each edge's [[JiT_Ji, JiT_Jj], [JjT_Ji,
    JjT_Jj]] in one batched (6 x 12) product, and sum yi and yj into the
    nodes in the reference's order (``y.at[ei].add(yi).at[ej].add(yj)``),
    plus ``diag_w * x``. ``plan``: ``segment_plan(cat([ei, ej]), N)``."""
    n = diag_w.shape[0]
    if plan is None:
        plan = segment_plan(torch.cat([ei, ej]), n)
    ends = torch.stack([ei, ej], dim=-1)  # (E, 2)
    K = torch.stack([
        torch.cat([b.JiT_Ji, b.JiT_Jj], dim=-1),
        torch.cat([b.JiT_Jj.transpose(-1, -2), b.JjT_Jj], dim=-1),
    ])  # (2, E, 6, 12): the rows of yi, then those of yj, as the plan's

    def matvec(x):
        y = (K @ x[ends].reshape(-1, 12, 1)).reshape(-1, 6)
        return segment_sum(y, None, n, plan=plan) + diag_w[:, None] * x

    return matvec


def optimize_pose_graph_cg(
    pg: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    cg_iterations: int = 200,
) -> torch.Tensor:
    """Matrix-free Gauss-Newton PGO: PCG on the normal equations,
    block-Jacobi preconditioned.

    Never materializes H: peak memory is O(E*36 + N*36) instead of the
    dense path's O(N^2*36). The CG (``backend.cg.cg_solve``) stops where
    ``jax.scipy.sparse.linalg.cg`` stops, without a host sync.
    """
    disable_tf32()
    n = pg.poses.shape[0]
    ei, ej = pg.edge_i.long(), pg.edge_j.long()
    plan = segment_plan(torch.cat([ei, ej]), n)  # y.at[ei].add(yi).at[ej].add(yj)
    anchor_w = torch.where(pg.anchor, 1e8, 0.0).to(pg.poses.dtype) + damping
    eye = torch.eye(6, dtype=pg.poses.dtype, device=pg.poses.device)

    poses = pg.poses
    for _ in range(iterations):
        b = _edge_blocks(poses, pg)
        g = segment_sum(torch.cat([b.gi, b.gj]), None, n, plan=plan)
        # Block-Jacobi preconditioner: the exact 6x6 diagonal of H.
        D = segment_sum(torch.cat([b.JiT_Ji, b.JjT_Jj]), None, n, plan=plan)
        D_inv = torch.linalg.inv_ex(D + anchor_w[:, None, None] * eye)[0]

        def precond(x, D_inv=D_inv):
            return (D_inv @ x[..., None])[..., 0]

        matvec = _hessian_matvec(b, ei, ej, anchor_w, plan)
        delta = cg_solve(matvec, -g, tol=1e-8, maxiter=cg_iterations, M=precond)
        poses = poses @ se3.se3_exp(delta)
    return poses


def chain_with_loops(
    odom: torch.Tensor,
    loop_i: torch.Tensor,
    loop_j: torch.Tensor,
    loop_t: torch.Tensor,
    loop_w: torch.Tensor,
    odom_weight: float = 1.0,
) -> PoseGraph:
    """Build a PoseGraph from an odometry chain and loop-closure factors.

    odom: (N, 4, 4) initial/odometry poses; odometry factors connect
    consecutive nodes with their measured relative pose. Every tensor on
    ``odom``'s device.
    """
    disable_tf32()
    n = odom.shape[0]
    oi = torch.arange(n - 1, dtype=torch.int32, device=odom.device)
    oj = oi + 1
    ot = se3.mat_inverse(odom[oi.long()]) @ odom[oj.long()]
    ow = torch.full((n - 1,), odom_weight, dtype=odom.dtype, device=odom.device)
    anchor = torch.zeros(n, dtype=torch.bool, device=odom.device)
    anchor[0] = True
    return PoseGraph(
        poses=odom,
        edge_i=torch.cat([oi, loop_i.to(torch.int32)]),
        edge_j=torch.cat([oj, loop_j.to(torch.int32)]),
        t_meas=torch.cat([ot, loop_t]),
        weight=torch.cat([ow, loop_w]),
        anchor=anchor,
    )
