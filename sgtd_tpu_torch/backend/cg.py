"""Preconditioned conjugate gradients, as ``jax.scipy.sparse.linalg.cg``.

The reference solves the back end's normal equations with
``jax.scipy.sparse.linalg.cg(A, b, tol=tol, maxiter=maxiter, M=M)``: a
``while_loop`` from x0 = 0, r0 = b, p0 = z0 = M(r0), whose condition,
tested before each iteration, is ``vdot(r, r) > tol^2 vdot(b, b)`` (with
``M`` given it tests r, not gamma; ``jax/_src/scipy/sparse/linalg.py``
``_cg_solve``). The iteration count decides the answer: a graph whose
residuals are all zero gives b = 0 and runs no iteration at all.

Here the loop always runs ``maxiter`` iterations and never reads a value
back to the host: once the test fails, a ``torch.where`` on a 0-d flag
freezes x, r, gamma and p. The iterates are the ``while_loop``'s, a frozen
iteration's division by zero never reaches x, and the device never waits
on the host.
"""

from __future__ import annotations

from typing import Callable

import torch

from sgtd_tpu_torch.utils import disable_tf32

Operator = Callable[[torch.Tensor], torch.Tensor]


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))


def cg_solve(matvec: Operator, b: torch.Tensor, *, tol: float, maxiter: int, M: Operator) -> torch.Tensor:
    """x with ``matvec(x) ~= b`` for a symmetric positive-definite
    operator, preconditioned by ``M``; the reference's iterates (see the
    module docstring). ``b`` is any shape; ``matvec`` and ``M`` map that
    shape to itself."""
    disable_tf32()
    atol2 = tol * tol * _vdot(b, b)
    x = torch.zeros_like(b)
    r = b
    p = z = M(r)
    gamma = _vdot(r, z)
    active = _vdot(r, r) > atol2
    for _ in range(maxiter):
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        gamma_new = _vdot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        active = active & (_vdot(r, r) > atol2)
    return x
