"""Multi-device Schur-complement bundle adjustment (port of
sgtd_tpu.parallel.sharded_ba).

The observation table, and the landmarks it references, shards over a
mesh dim; the keyframe poses (the small, globally coupled state) are
replicated:

  per rank: linearize the local observations        (L/n, O, ...) blocks
  -> psum of the reduced gradient and of every PCG matvec   (F, 6)
  -> the same preconditioned-CG solve on every rank
  -> local landmark back-substitution                (L/n, 3), no traffic

Each CG iteration moves O(F * 6) numbers, whatever the landmark and
observation counts, the dims that grow with the map. The sums run in
another order than the single-device segment sums, so the result equals
``backend.ba.optimize_ba_cg``'s to float tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sgtd_tpu_torch.backend.ba import (
    BAProblem,
    BAResult,
    _anchor_weights,
    _ba_blocks,
    _back_substitute,
    _diag_blocks,
    _obs_plan,
    _reduced_gradient,
    _schur_matvec,
)
from sgtd_tpu_torch.backend.cg import cg_solve
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.parallel.mesh import all_gather, psum, rank_device, shard_rows
from sgtd_tpu_torch.utils import disable_tf32, host_array

# The BAProblem fields with one row a landmark, sharded over the mesh dim.
LANDMARK_FIELDS = ("landmarks", "obs_frame", "obs_local", "obs_valid")


def shard_ba_problem(ba, mesh, axis: str = "obs") -> BAProblem:
    """This rank's BAProblem on its device: the ``LANDMARK_FIELDS`` rows
    are its contiguous slice along ``axis``, ``poses`` and ``anchor``
    replicated. ``ba``: a BAProblem of tensors or arrays, or a dict of
    arrays (memory-mapped ones are read only where this rank's rows lie).
    Raises when the landmarks do not divide the axis (pad them with
    ``obs_valid`` False rows)."""
    fields = ba._asdict() if isinstance(ba, BAProblem) else {f: ba[f] for f in BAProblem._fields}
    local, _ = shard_rows(fields, LANDMARK_FIELDS, mesh, axis, "landmark")
    dev = rank_device(mesh)
    return BAProblem(*(torch.from_numpy(np.array(host_array(local[f]))).to(dev) for f in BAProblem._fields))


def optimize_ba_sharded(
    ba: BAProblem,
    mesh,
    axis: str = "obs",
    iterations: int = 10,
    damping: float = 1e-5,
    cg_iterations: int = 100,
) -> BAResult:
    """Sharded matrix-free Schur BA on the 1-D mesh dim ``axis``. ``ba``
    holds this rank's landmark rows (:func:`shard_ba_problem`). Returns the
    whole result on every rank: the replicated poses and costs, and every
    rank's landmarks in rank order. ``cg_solve`` runs all its iterations
    without reading a value back, so every rank issues the same
    collectives."""
    disable_tf32()
    f_n = ba.poses.shape[0]
    dtype, dev = ba.poses.dtype, ba.poses.device
    of = ba.obs_frame.long()
    plan, plan2 = _obs_plan(of, f_n), _obs_plan(of, f_n, copies=2)
    anchor_w = _anchor_weights(ba, damping, dtype)
    # The local blocks carry no anchor term: it is added once, after the
    # sum over ranks.
    zero_w = torch.zeros(f_n, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    poses, lms, costs = ba.poses, ba.landmarks, []
    for _ in range(iterations):
        b = _ba_blocks(poses, lms, ba, damping)
        cost = psum(b.cost, mesh, axis)
        g = psum(_reduced_gradient(b, of, f_n, plan=plan), mesh, axis)
        D = psum(_diag_blocks(b, of, zero_w, f_n, plan=plan), mesh, axis) + anchor_w[:, None, None] * eye6
        D_inv = torch.linalg.inv_ex(D)[0]

        def matvec(x, b=b):
            return psum(_schur_matvec(b, of, zero_w, x, plan=plan2), mesh, axis) + anchor_w[:, None] * x

        def precond(x, D_inv=D_inv):
            return (D_inv @ x[..., None])[..., 0]

        dp = cg_solve(matvec, -g, tol=1e-8, maxiter=cg_iterations, M=precond)
        dl = _back_substitute(b, of, dp)  # local, no traffic
        poses, lms = poses @ se3.se3_exp(dp), lms + dl
        costs.append(cost)
    return BAResult(poses=poses, landmarks=all_gather(lms, mesh, axis, dim=0), costs=torch.stack(costs))
