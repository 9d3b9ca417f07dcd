"""The port's GICP building blocks against sgtd_tpu: se3, the closed-form
linear algebra, point covariances, gicp_align (LM and GN), gicp_rerank,
rerank_pick, and the cloud generators.

Inputs are made with NumPy from a seed and fed to both packages. The
generators are bit-identical. Elementwise formulas agree to float32
rounding (stated per test); the registrations agree within 5e-3 m and
1e-3 rad, fitness statistics within 1e-3 relative: torch and XLA sum in
other orders, which can flip one of the LM's discrete decisions.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.config import GicpConfig, SGTDConfig
from sgtd_tpu.data import synthetic as jax_synth
from sgtd_tpu.geom import se3 as jax_se3
from sgtd_tpu.match.pipeline import rerank_pick as jax_rerank_pick
from sgtd_tpu.ops import linalg3 as jax_linalg3
from sgtd_tpu.refine import gicp as jax_gicp
from sgtd_tpu_torch.data import synthetic
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.interop import to_numpy
from sgtd_tpu_torch.match.pipeline import rerank_pick
from sgtd_tpu_torch.ops import linalg3
from sgtd_tpu_torch.ops.voxel import load_query_cloud
from sgtd_tpu_torch.refine import gicp

torch.set_num_threads(1)

T = torch.from_numpy
POS_TOL_M, ROT_TOL_RAD, FIT_RTOL = 5e-3, 1e-3, 1e-3


def _rots(rng, n, scale=1.0):
    w = rng.normal(0, scale, (n, 3)).astype(np.float32)
    return np.asarray(jax_se3.so3_exp(jnp.asarray(w)))


def _poses(rng, n, rot=0.5, trans=5.0):
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    out[:, :3, :3] = _rots(rng, n, rot)
    out[:, :3, 3] = rng.normal(0, trans, (n, 3))
    return out


# --- se3 ------------------------------------------------------------------


def test_se3_matches_reference():
    rng = np.random.default_rng(1)
    # Rotation vectors of ordinary size and below the Taylor switch.
    w = np.concatenate([rng.normal(0, 0.8, (30, 3)), rng.normal(0, 1e-5, (10, 3))]).astype(np.float32)
    xi = np.concatenate([rng.normal(0, 3, (40, 3)).astype(np.float32), w], axis=1)
    Ts = _poses(rng, 40)
    pts = rng.normal(0, 20, (40, 16, 3)).astype(np.float32)
    cases = [
        ("hat", (w,)), ("so3_exp", (w,)), ("se3_exp", (xi,)),
        ("so3_log", (Ts[:, :3, :3],)), ("se3_log", (Ts,)), ("mat_inverse", (Ts,)),
        ("transform_points", (Ts, pts)), ("rotation_angle_deg", (Ts[:, :3, :3],)),
        ("rt_to_mat", (Ts[:, :3, :3], xi[:, :3])),
    ]
    for name, args in cases:
        want = np.asarray(getattr(jax_se3, name)(*map(jnp.asarray, args)))
        got = getattr(se3, name)(*map(T, args)).numpy()
        # rotation_angle_deg: arccos near 1 turns float32 ulps into 1e-2 deg.
        atol = 2e-2 if name == "rotation_angle_deg" else 1e-4
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(se3.vee(se3.hat(T(w))).numpy(), w)
    est = (_poses(rng, 40, 0.05, 0.5) @ Ts).astype(np.float32)
    t_err, r_err = se3.relative_pose_error(T(Ts), T(est))
    wt, wr = jax_se3.relative_pose_error(jnp.asarray(Ts), jnp.asarray(est))
    np.testing.assert_allclose(t_err.numpy(), np.asarray(wt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r_err.numpy(), np.asarray(wr), atol=2e-2)
    assert (t_err > 0).all() and (r_err > 0).all()


# --- closed-form linear algebra -------------------------------------------


def test_inv3x3_and_chol_solve6_match_reference():
    rng = np.random.default_rng(2)
    m = (rng.normal(size=(64, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    np.testing.assert_allclose(
        linalg3.inv3x3(T(m)).numpy(), np.asarray(jax_linalg3.inv3x3(jnp.asarray(m))), rtol=1e-5, atol=1e-6
    )
    a = rng.normal(size=(64, 6, 6))
    H = (a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(6)).astype(np.float32)
    g = rng.normal(size=(64, 6)).astype(np.float32)
    got = linalg3.chol_solve6(T(H), T(g)).numpy()
    want = np.asarray(jax_linalg3.chol_solve6(jnp.asarray(H), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.linalg.solve(H.astype(np.float64), g[..., None])[..., 0], rtol=1e-2, atol=1e-2)
    # A fully masked problem (H = 0) solves to finite values in both.
    assert np.isfinite(linalg3.chol_solve6(torch.zeros(6, 6), torch.ones(6)).numpy()).all()


def test_sym_eig3x3_matches_reference():
    rng = np.random.default_rng(3)
    vecs = _rots(rng, 200)
    vals = np.sort(rng.uniform(0.05, 4.0, (200, 3)), axis=1).astype(np.float32)
    cov = np.einsum("nij,nj,nkj->nik", vecs, vals, vecs).astype(np.float32)
    want_v, want_e = (np.asarray(a) for a in jax_linalg3.sym_eig3x3(jnp.asarray(cov)))
    got_v, got_e = (a.numpy() for a in linalg3.sym_eig3x3(T(cov)))
    # float32 Cardano: the values carry ~1e-6 relative rounding, which the
    # arccos near r = +-1 amplifies for nearly repeated eigenvalues.
    np.testing.assert_allclose(got_v, want_v, atol=2e-4, rtol=0)
    gap = np.diff(vals, axis=1).min(1) > 0.05  # well-separated spectra
    np.testing.assert_allclose(got_e[gap], want_e[gap], atol=2e-3, rtol=0)
    np.testing.assert_allclose(got_v, vals, atol=1e-3)
    # Columns are eigenvectors: cov v = lambda v.
    np.testing.assert_allclose(np.einsum("nij,njk->nik", cov, got_e), got_e * got_v[:, None, :], atol=2e-3)


# --- GICP -----------------------------------------------------------------

GCFG = GicpConfig(num_neighbors=8, max_iterations=6)


@pytest.fixture(scope="module")
def pairs():
    """Three (source, target) problems from one world: a query render
    downsampled to <= 256 points against a 1,024-point keyframe render, with
    the true relative pose perturbed as the initial guess."""
    cfg = SGTDConfig()
    _, _, world = synthetic.make_map_and_queries(cfg, seed=5, num_map_frames=12, num_queries=3)
    rng = np.random.default_rng(9)
    src, smask, tgt, tmask, init = [], [], [], [], []
    prng = np.random.default_rng(10)
    for i, qp in enumerate(world.query_poses):
        mp = world.map_poses[np.argmin(np.linalg.norm(world.map_poses[:, :3, 3] - qp[:3, 3], axis=1))]
        c, m = synthetic.render_planar_cloud(world, qp, rng, max_points=1024)
        s, sm = load_query_cloud(c[m], 3.0, 256)
        t, tm = synthetic.render_planar_cloud(world, mp, rng, max_points=1024)
        rel = (np.linalg.inv(mp) @ qp).astype(np.float32)
        src.append(s), smask.append(sm), tgt.append(t), tmask.append(tm)
        init.append(_poses(prng, 1, 0.02, 0.3)[0] @ rel)
    return tuple(np.stack(a) for a in (src, smask, tgt, tmask, init))


def _assert_gicp_close(got, want):
    g_T, w_T = got.transform.astype(np.float64), np.asarray(want.transform, np.float64)
    np.testing.assert_allclose(g_T[..., :3, 3], w_T[..., :3, 3], atol=POS_TOL_M, rtol=0)
    np.testing.assert_allclose(g_T[..., :3, :3], w_T[..., :3, :3], atol=ROT_TOL_RAD, rtol=0)
    for f in ("fitness", "fitness_gated", "inlier_frac"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)), rtol=FIT_RTOL, err_msg=f)
    np.testing.assert_allclose(got.num_inliers, np.asarray(want.num_inliers), atol=2)


def test_point_covariances_match_reference(pairs):
    _, _, tgt, tmask, _ = pairs
    want = np.asarray(jax.vmap(functools.partial(jax_gicp.point_covariances, cfg=GCFG))(
        jnp.asarray(tgt), jnp.asarray(tmask)))
    got = gicp.point_covariances(T(tgt), T(tmask), GCFG).numpy()
    err = np.abs(got - want).max(axis=(-2, -1))
    # See test_torch_refined: float32 Cardano near r = 1 on a few points.
    assert (err > 2e-4).mean() <= 1e-3 and err.max() <= 1e-2, np.sort(err)[-5:]
    np.testing.assert_array_equal(got[~tmask], np.broadcast_to(np.eye(3), got[~tmask].shape))


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_gicp_align_matches_reference(pairs, optimizer):
    cfg = GicpConfig(num_neighbors=8, max_iterations=6, optimizer=optimizer)
    src, smask, tgt, tmask, init = pairs
    want = jax.jit(jax.vmap(functools.partial(jax_gicp.gicp_align, cfg=cfg)))(
        *map(jnp.asarray, (src, smask, tgt, tmask, init)))
    got = to_numpy(gicp.gicp_align(*map(T, (src, smask, tgt, tmask, init)), cfg))
    _assert_gicp_close(got, want)
    # Real overlap: a third or more of each source finds surface.
    assert (got.inlier_frac > 0.3).all()


def test_gicp_align_correspondence_gate(pairs):
    cfg = GicpConfig(num_neighbors=8, max_iterations=6, max_corr_dist_m=2.0)
    src, smask, tgt, tmask, init = (a[:1] for a in pairs)
    want = jax.jit(functools.partial(jax_gicp.gicp_align, cfg=cfg))(
        *(jnp.asarray(a[0]) for a in (src, smask, tgt, tmask, init)))
    got = to_numpy(gicp.gicp_align(*(T(a[0]) for a in (src, smask, tgt, tmask, init)), cfg))
    assert got.transform.shape == (4, 4) and got.fitness.shape == ()
    _assert_gicp_close(got, want)


def test_gicp_rerank_matches_reference(pairs):
    """Two queries x three candidates (their own target and two others),
    target covariances computed inside as the reference does with None."""
    src, smask, tgt, tmask, init = pairs
    order = np.array([[0, 1, 2], [1, 2, 0]])
    tgts, tmasks = tgt[order], tmask[order]
    inits = np.stack([init[0][None].repeat(3, 0), init[1][None].repeat(3, 0)])
    want = jax.jit(jax.vmap(functools.partial(jax_gicp.gicp_rerank, cfg=GCFG)))(
        *map(jnp.asarray, (src[:2], smask[:2], tgts, tmasks, inits)))
    got = to_numpy(gicp.gicp_rerank(*map(T, (src[:2], smask[:2], tgts, tmasks, inits)), GCFG))
    assert got.transform.shape == (2, 3, 4, 4) and got.fitness.shape == (2, 3)
    _assert_gicp_close(got, want)


# --- rerank_pick ----------------------------------------------------------


def test_rerank_pick_matches_reference():
    rng = np.random.default_rng(4)
    b, k = 64, 4
    init = _poses(rng, b * k).reshape(b, k, 4, 4)
    # Refinements near their inits, some beyond the 3 m / 10 deg guard.
    step = _poses(rng, b * k, 0.1, 1.5).reshape(b, k, 4, 4)
    refined = (init @ step).astype(np.float32)
    fg = rng.uniform(0, 5, (b, k)).astype(np.float32)
    fi = rng.uniform(0, 1, (b, k)).astype(np.float32)
    fi[:8] = 0.5  # ties: the first maximum wins
    fg[:8] = 1.0
    found = rng.uniform(size=b) < 0.8
    gcfg = GicpConfig()
    want = [jax.tree_util.tree_map(np.asarray, jax_rerank_pick(
        jnp.asarray(fg[i]), jnp.asarray(fi[i]), jnp.asarray(refined[i]), jnp.asarray(init[i]),
        jnp.asarray(found[i]), gcfg)) for i in range(b)]
    pick, use, _ = rerank_pick(T(fg), T(fi), T(refined), T(init), T(found), gcfg)
    np.testing.assert_array_equal(pick.numpy(), [w[0] for w in want])
    np.testing.assert_array_equal(use.numpy(), [w[1] for w in want])
    assert 0 < use.sum() < found.sum()  # the guard rejected some queries outright


def test_rerank_pick_scores_unverified_candidates():
    """Reproduces the reference's fault (ROADMAP §3, pipeline.py:325-331):
    the pick never sees the verification scores, so a candidate that failed
    verification wins when its refinement scores best."""
    init = torch.eye(4).expand(1, 2, 4, 4)
    fitness_gated = torch.tensor([[1.0, 0.5]])
    inlier_frac = torch.tensor([[0.6, 0.9]])  # candidate 1: verify score -1
    pick, use, _ = rerank_pick(fitness_gated, inlier_frac, init, init, torch.tensor([True]), GicpConfig())
    want = jax_rerank_pick(*(jnp.asarray(a[0].numpy()) for a in (fitness_gated, inlier_frac, init, init)),
                           jnp.asarray(True), GicpConfig())
    assert int(pick[0]) == int(want[0]) == 1 and bool(use[0])


# --- generators -----------------------------------------------------------


def test_hard_world_and_blob_clouds_are_bit_identical():
    kw = dict(n_motifs=2, grid=(2, 3), num_map_frames=10, num_queries=4)
    got = synthetic.make_hard_world(np.random.default_rng(3), **kw)
    want = jax_synth.make_hard_world(np.random.default_rng(3), **kw)
    assert isinstance(got, synthetic.HardWorld)
    for f in ("instance_xyz", "instance_label", "map_poses", "query_poses", "instance_yaw", "instance_size"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for render in ("render_cloud", "render_planar_cloud"):
        for pose in got.query_poses[:2]:
            c1, m1 = getattr(synthetic, render)(got, pose, np.random.default_rng(8), max_points=512)
            c2, m2 = getattr(jax_synth, render)(want, pose, np.random.default_rng(8), max_points=512)
            np.testing.assert_array_equal(c1, c2, err_msg=render)
            np.testing.assert_array_equal(m1, m2, err_msg=render)
