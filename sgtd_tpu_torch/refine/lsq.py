"""Levenberg-Marquardt / Gauss-Newton stepping on SE(3) (port of
sgtd_tpu.refine.lsq), batched over the leading axes of ``T0``.

The reference's ``LsqRegistration`` optimizer
(lsq_registration_impl.hpp:53-163): GN solves (H + damping I) d = -g per
iteration; LM keeps a lambda trust region (initialised to
``init_factor * max|diag H|``), tries the deterministic lambda ladder
``lambda * 2^(k(k+1)/2)`` of up to ``lm_inner`` rejections as one batch and
takes the first event (an accepted step, rho >= 0, or a converged
rejection). Convergence: ``max(|dR - I|/rot_eps, |dt|/trans_eps) < 1`` on
the step (:82-93). State convention: T <- se3_exp(d) @ T, d = [v, w].

The engine supplies two callbacks, over the batch B = T0.shape[:-2]:

  linearize(T (B, 4, 4)) -> (H (B, 6, 6), g (B, 6), y0 (B), aux)
  error(T (B, L, 4, 4), aux) -> y (B, L)
      cost of L trial transforms, reusing the correspondences and
      Mahalanobis weights of the last linearization (``aux``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.ops.linalg3 import chol_solve6
from sgtd_tpu_torch.utils import profiling


class LsqResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4)
    converged: torch.Tensor  # (B,) bool
    final_cost: torch.Tensor  # (B,) y at the last executed linearization


def _is_converged(delta_T: torch.Tensor, rot_eps: float, trans_eps: float) -> torch.Tensor:
    """lsq_registration_impl.hpp:82-93, over leading axes."""
    eye = torch.eye(3, dtype=delta_T.dtype, device=delta_T.device)
    r = (delta_T[..., :3, :3] - eye).abs().amax(dim=(-2, -1))
    t = delta_T[..., :3, 3].abs().amax(-1)
    return torch.maximum(r / rot_eps, t / trans_eps) < 1.0


# Both solvers stop when every problem of the batch is done or after
# max_iterations trips, like the reference's vmapped while_loop: a done
# problem keeps its state, so the extra trips of the others cannot change
# it. The check costs one host sync per trip (``done.all()``), which is
# cheap while the device idles behind the host (the path is host-bound),
# and it saves whole linearizations when a batch converges early. A
# rerank chunk of 64 problems mostly runs all trips: one unconverged
# problem keeps the loop going.
#
# With tracing on, each trip is a span ``refine.lm.trip``; a solve counts
# its trips (``lm.trips``) and problems (``lm.problems``), and each trip
# holds its entry ``done`` mask for ``lm.live`` (the problems still live
# on entry), folded at ``profiling.flush``.


def _count_solve(trips: int, batch: torch.Size) -> None:
    profiling.count("lm.trips", trips)
    profiling.count("lm.problems", batch.numel())


def gn_solve(
    linearize: Callable,
    T0: torch.Tensor,
    *,
    max_iterations: int,
    rot_eps: float = 2e-3,
    trans_eps: float = 5e-4,
    damping: float = 1e-6,
) -> LsqResult:
    """Gauss-Newton (step_gn, lsq_registration_impl.hpp:106-120)."""
    batch = T0.shape[:-2]
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    T = T0
    done = torch.zeros(batch, dtype=torch.bool, device=T0.device)
    y = torch.full(batch, float("inf"), dtype=T0.dtype, device=T0.device)
    trips = 0
    for _ in range(max_iterations):
        if bool(done.all()):
            break
        with profiling.span("refine.lm.trip"):
            trips += 1
            profiling.count_mask("lm.live", done, False)
            H, g, y0, _ = linearize(T)
            d = chol_solve6(H + damping * eye6, -g)
            delta_T = se3.se3_exp(d)
            conv = _is_converged(delta_T, rot_eps, trans_eps)
            T = torch.where(done[..., None, None], T, delta_T @ T)
            y = torch.where(done, y, y0)
            done = done | conv
    _count_solve(trips, batch)
    return LsqResult(transform=T, converged=done, final_cost=y)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (B, L, *rest)[b, i[b]] -> (B, *rest)."""
    idx = i.reshape(i.shape + (1,) * (x.dim() - i.dim()))
    return torch.gather(x, i.dim(), idx.expand(i.shape + (1,) + x.shape[i.dim() + 1:])).squeeze(i.dim())


def lm_solve(
    linearize: Callable,
    error: Callable,
    T0: torch.Tensor,
    *,
    max_iterations: int,
    lm_inner: int = 8,
    rot_eps: float = 2e-3,
    trans_eps: float = 5e-4,
    init_lambda_factor: float = 1e-9,
) -> LsqResult:
    """Levenberg-Marquardt (step_lm, lsq_registration_impl.hpp:123-163).

    All ``lm_inner`` ladder steps are solved and evaluated at once, and the
    reference's sequential first-accept recovered by the first True of the
    event mask. ``final_cost`` is the linearization cost on entry to the
    last executed iteration, one accepted step stale, as in the reference.
    """
    batch = T0.shape[:-2]
    dt, dev = T0.dtype, T0.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    ladder = torch.tensor([2.0 ** (k * (k + 1) / 2.0) for k in range(lm_inner)], dtype=dt, device=dev)
    third = torch.tensor(1.0 / 3.0, dtype=dt, device=dev)
    T = T0
    lam = torch.full(batch, -1.0, dtype=dt, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    y = torch.full(batch, float("inf"), dtype=dt, device=dev)
    trips = 0
    for _ in range(max_iterations):
        if bool(done.all()):
            break
        with profiling.span("refine.lm.trip"):
            trips += 1
            profiling.count_mask("lm.live", done, False)
            H, g, y0, aux = linearize(T)
            # Lazy lambda init (lsq_registration_impl.hpp:128-130).
            diag_max = H.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
            lam = torch.where(lam < 0.0, init_lambda_factor * diag_max, lam)

            lam_k = lam[..., None] * ladder  # (B, L)
            Hk = H[..., None, :, :] + lam_k[..., None, None] * eye6
            g_k = g[..., None, :].expand(Hk.shape[:-1])
            d_k = chol_solve6(Hk, -g_k)  # (B, L, 6)
            delta_k = se3.se3_exp(d_k)  # (B, L, 4, 4)
            T_k = delta_k @ T[..., None, :, :]
            y_k = error(T_k, aux)  # (B, L)
            rho_k = (y0[..., None] - y_k) / (d_k * (lam_k[..., None] * d_k - g_k)).sum(-1)  # :142
            accept_k = rho_k >= 0.0
            stepconv_k = _is_converged(delta_k, rot_eps, trans_eps)
            # Sequential events: at ladder step k, accept (rho >= 0, :156-161)
            # or stop on a converged rejection (:147-151); first event wins.
            event_k = accept_k | stepconv_k
            first = event_k.to(torch.uint8).argmax(-1)  # first True
            has_event = event_k.any(-1)
            acc_first = _take(accept_k, first)
            acc = has_event & acc_first
            conv_stop = has_event & ~acc_first
            rho_f = _take(rho_k, first)
            lam_acc = _take(lam_k, first) * torch.maximum(third, 1.0 - (2.0 * rho_f - 1.0) ** 3)  # :159
            conv = (acc & _take(stepconv_k, first)) | conv_stop
            T_new = torch.where(acc[..., None, None], _take(T_k, first), T)
            lam_new = torch.where(acc, lam_acc, lam)
            # Inner exhaustion without an event ends the problem unconverged
            # (computeTransformation :70-73).
            T = torch.where(done[..., None, None], T, T_new)
            lam = torch.where(done, lam, lam_new)
            y = torch.where(done, y, y0)
            done = done | conv | ~has_event | conv_stop
    _count_solve(trips, batch)
    return LsqResult(transform=T, converged=done, final_cost=y)
