"""The port's Schur bundle adjustment against sgtd_tpu.

The five single-device cases of tests/test_ba.py: the same NumPy problems
go through ``sgtd_tpu.backend.ba`` and, through
``interop.ba_problem_from_numpy``, through ``sgtd_tpu_torch.backend.ba`` on
the CPU. Each test applies the reference test's own gates to the port and
holds the port's poses and landmarks to the reference's within the
reference's own tolerance between its two solvers, 2e-3.
"""

import numpy as np
import pytest
import torch

from sgtd_tpu.backend import ba as jax_ba
from sgtd_tpu_torch.backend import ba
from sgtd_tpu_torch.interop import ba_problem_from_numpy
from tests.test_ba import _make_problem, _make_problem_vec

torch.set_num_threads(1)

TOL = 2e-3


def _problem(make, *args, **kw):
    p, gt_poses, gt_lms = make(np.random.default_rng(42), *args, **kw)
    return jax_ba.BAProblem(*(np.asarray(x) for x in p)), gt_poses, gt_lms


def _both(fn, problem, **kw):
    """(reference, port) results of ``fn`` (the module attribute's name)
    on ``problem``, as NumPy."""
    want = getattr(jax_ba, fn)(problem, **kw)
    got = getattr(ba, fn)(ba_problem_from_numpy(problem, "cpu"), **kw)
    return (jax_ba.BAResult(*(np.asarray(x) for x in want)),
            jax_ba.BAResult(*(x.numpy() for x in got)))


def _assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=tol)
    np.testing.assert_allclose(got.landmarks, want.landmarks, rtol=0, atol=tol)


def test_ba_converges_to_ground_truth():
    problem, gt_poses, gt_lms = _problem(_make_problem)
    want, got = _both("optimize_ba", problem, iterations=10)
    _assert_close(got, want)
    assert got.costs[-1] < got.costs[0] * 1e-4, got.costs
    t_err = np.linalg.norm(got.poses[:, :3, 3] - gt_poses[:, :3, 3], axis=1)
    assert t_err.max() < 1e-2, t_err
    assert np.median(np.linalg.norm(got.landmarks - gt_lms, axis=1)) < 1e-2
    np.testing.assert_allclose(got.costs[0], want.costs[0], rtol=1e-5)


def test_ba_anchor_fixed():
    problem, gt_poses, _ = _problem(_make_problem)
    want, got = _both("optimize_ba", problem, iterations=5)
    _assert_close(got, want)
    np.testing.assert_allclose(got.poses[0], gt_poses[0], atol=1e-4)


def test_ba_invalid_obs_ignored():
    problem, gt_poses, _ = _problem(_make_problem, pose_noise=0.05)
    bad = problem.obs_local.copy()
    bad[:, 3:] += 100.0
    valid = problem.obs_valid.copy()
    valid[:, 3:] = False
    problem = problem._replace(obs_local=bad, obs_valid=valid)
    want, got = _both("optimize_ba", problem, iterations=10)
    _assert_close(got, want)
    assert np.linalg.norm(got.poses[:, :3, 3] - gt_poses[:, :3, 3], axis=1).max() < 0.05


def test_ba_cg_matches_dense():
    problem, _, _ = _problem(_make_problem)
    want, got = _both("optimize_ba_cg", problem, iterations=6, cg_iterations=200)
    _assert_close(got, want)
    dense = ba.optimize_ba(ba_problem_from_numpy(problem, "cpu"), iterations=6)
    np.testing.assert_allclose(got.poses, dense.poses.numpy(), atol=TOL)
    np.testing.assert_allclose(got.landmarks, dense.landmarks.numpy(), atol=TOL)


def test_schur_matvec_matches_dense_s():
    """The matrix-free S @ x (and the block-Jacobi diagonal) against S
    assembled densely in float64 from the same blocks, invalid
    observations included."""
    problem, _, _ = _problem(_make_problem)
    valid = problem.obs_valid.copy()
    valid[::3, 2:] = False
    tb = ba_problem_from_numpy(problem._replace(obs_valid=valid), "cpu")
    b = ba._ba_blocks(tb.poses, tb.landmarks, tb, 1e-5)
    f_n = tb.poses.shape[0]
    diag_w = ba._anchor_weights(tb, 1e-5, torch.float32)
    of = tb.obs_frame.numpy()
    W, Hinv, Hpp = (x.double().numpy() for x in (b.W, b.Hll_inv, b.HppD))
    S = np.zeros((f_n, 6, f_n, 6))
    for l in range(of.shape[0]):
        for o in range(of.shape[1]):
            S[of[l, o], :, of[l, o]] += Hpp[l, o]
            for p in range(of.shape[1]):
                S[of[l, o], :, of[l, p]] -= W[l, o] @ Hinv[l] @ W[l, p].T
    D = np.stack([S[f, :, f] for f in range(f_n)]) + diag_w.double().numpy()[:, None, None] * np.eye(6)
    S = S.reshape(6 * f_n, 6 * f_n) + np.diag(np.repeat(diag_w.double().numpy(), 6))
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(f_n, 6)).astype(np.float32))
    got = ba._schur_matvec(b, tb.obs_frame, diag_w, x).double().numpy().reshape(-1)
    want = S @ x.double().numpy().reshape(-1)
    # The anchor's 1e8 dwarfs the rest: compare the free frames' rows.
    free = np.repeat(~tb.anchor.numpy(), 6)
    np.testing.assert_allclose(got[free], want[free], rtol=0, atol=1e-5 * np.abs(want[free]).max())
    np.testing.assert_allclose(got[~free], want[~free], rtol=1e-6)
    got_d = ba._diag_blocks(b, tb.obs_frame, diag_w, f_n).double().numpy()
    np.testing.assert_allclose(got_d[1:], D[1:], rtol=0, atol=1e-5 * np.abs(D[1:]).max())
    np.testing.assert_allclose(got_d[0], D[0], rtol=1e-6, atol=1e-2)


@pytest.mark.slow
def test_ba_cg_large_scale():
    """tests/test_ba.py::test_ba_cg_large_scale (5,000 keyframes, 20,000
    landmarks, 4 observations each; 4 GN steps, 150 CG iterations) on both
    packages: the reference test's gates on the port, and the port's
    median translation within 2e-3 m of the reference's."""
    problem, gt_poses, _ = _problem(_make_problem_vec, 5000, 20000, 4)
    want, got = _both("optimize_ba_cg", problem, iterations=4, cg_iterations=150)
    assert got.costs[-1] < got.costs[0] * 1e-2, got.costs
    t_err = np.linalg.norm(got.poses[:, :3, 3] - gt_poses[:, :3, 3], axis=1)
    assert np.median(t_err) < 0.05, np.median(t_err)
    gap = np.linalg.norm(got.poses[:, :3, 3] - want.poses[:, :3, 3], axis=1)
    assert np.median(gap) < TOL, np.median(gap)
