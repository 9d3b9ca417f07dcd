"""The port's VGICP (refine/vgicp.py) against sgtd_tpu.refine.vgicp on the
same clouds (the scene of test_gicp.py).

Tolerances, each from what differs between the two programs:

* Voxel keys, counts and every point's voxel coordinate: equal (zero
  points in another voxel). Additive means and covariances: equal bits on
  the CPU (each voxel sums its points in point order, as XLA's
  segment_sum does). Multiplicative: XLA contracts the jitted inversion
  into FMAs and the finalisation is ill-conditioned (plane_eps 1e-3), so
  means within 1e-2 of the voxel mean's size (5e-2 m at 20 m, measured
  5e-2 m at most), covariances within 1e-2 of their largest entry; the
  port equals the reference's operations run one by one without jit.
* Poses: within 1e-3 m and 1e-3 rad (measured below 2e-5 m), the same
  convergence flag and inlier count.
* The port against itself: prebuilt maps against maps built per call,
  equal bits; (B, K) problems at once against one at a time, within 1e-4
  (the H products and the cost sums run over a batch in other blocks:
  1.3e-5 m measured), integer fields equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtd_tpu.config import GicpConfig as JaxGicpConfig
from sgtd_tpu.geom import se3 as jax_se3
from sgtd_tpu.refine import vgicp as jax_vgicp
from sgtd_tpu.refine.gicp import point_covariances as jax_point_covariances
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.config import GicpConfig
from sgtd_tpu_torch.refine import vgicp
from tests.test_gicp import _scene

torch.set_num_threads(1)

POS_TOL_M, ROT_TOL = 1e-3, 1e-3


def _cfg(**kw):
    jcfg = JaxGicpConfig(num_neighbors=10, max_iterations=10, max_points=1024, **kw)
    return jcfg, interop.config_from_reference(jcfg, GicpConfig)


@pytest.fixture(scope="module")
def scene():
    """Target cloud (a tenth masked), its reference covariances, and a
    source displaced by a known transform."""
    rng = np.random.default_rng(42)
    tgt = _scene(rng, 1024)
    mask = np.ones(len(tgt), bool)
    mask[::10] = False
    jcfg, _ = _cfg()
    covs = np.asarray(jax_point_covariances(jnp.asarray(tgt), jnp.asarray(mask), jcfg))
    xi = np.array([0.5, -0.3, 0.1, 0.02, -0.01, 0.05], np.float32)
    T_true = np.asarray(jax_se3.se3_exp(jnp.asarray(xi)))
    Tinv = np.linalg.inv(T_true)
    src = (tgt @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
    return tgt, mask, covs, src, T_true


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("mode,res", [("additive", 1.0), ("additive", 0.7), ("multiplicative", 2.0)])
def test_voxel_map_matches_reference(scene, mode, res):
    tgt, mask, covs, src, _ = scene
    want = jax_vgicp.build_voxel_map(jnp.asarray(tgt), jnp.asarray(mask), jnp.asarray(covs), res, mode=mode)
    got = vgicp.build_voxel_map(*_t(tgt, mask, covs), res, mode=mode)
    for f in ("keys", "n", "resolution"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.keys.dtype == torch.int32 and int((got.n > 0).sum()) > 100
    if mode == "additive":
        for f in ("mean", "cov"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    else:
        scale = np.maximum(1.0, np.linalg.norm(np.asarray(want.mean), axis=-1))
        assert (np.abs(got.mean.numpy() - np.asarray(want.mean)).max(-1) / scale).max() <= 1e-2
        cscale = np.maximum(1e-6, np.abs(np.asarray(want.cov)).max(axis=(-2, -1)))
        assert (np.abs(got.cov.numpy() - np.asarray(want.cov)).max(axis=(-2, -1)) / cscale).max() <= 1e-2
    # Every point, and every displaced source point, in the same voxel.
    for pts in (tgt, src, tgt * np.float32(1.37) - np.float32(0.49)):
        a = vgicp._voxel_coord(torch.from_numpy(pts), torch.tensor(res, dtype=torch.float32)).numpy()
        b = np.asarray(jax_vgicp._voxel_coord(jnp.asarray(pts), jnp.float32(res)))
        assert int((a != b).any(-1).sum()) == 0


def test_multiplicative_map_equals_the_reference_ops_without_jit(scene):
    """The reference's multiplicative finalisation run op by op (no XLA
    fusion): the port gives the same bits."""
    from sgtd_tpu.ops.linalg3 import inv3x3 as jax_inv3x3

    tgt, mask, covs, _, _ = scene
    got = vgicp.build_voxel_map(*_t(tgt, mask, covs), 2.0, mode="multiplicative")
    n = len(tgt)
    pc = np.full(n, n)
    keys = got.keys.numpy()
    coords = np.asarray(jax_vgicp._voxel_coord(jnp.asarray(tgt), jnp.float32(2.0)))
    pk = np.asarray(jax_vgicp._pack(jnp.asarray(coords)))
    pc[mask] = np.searchsorted(keys, pk[mask])
    info = jax_inv3x3(jnp.asarray(covs))
    im = jnp.sum(info * jnp.asarray(tgt)[:, None, :], axis=-1)
    c = jax.ops.segment_sum(info * jnp.asarray(pc < n, jnp.float32)[:, None, None], jnp.asarray(pc), n + 1)[:n]
    s = jax.ops.segment_sum(im * jnp.asarray(pc < n, jnp.float32)[:, None], jnp.asarray(pc), n + 1)[:n]
    cov = jax_inv3x3(c + 1e-9 * jnp.eye(3, dtype=c.dtype))
    mean = jnp.sum(cov * s[:, None, :], axis=-1)
    live = got.n.numpy() > 0
    np.testing.assert_array_equal(got.mean.numpy()[live], np.asarray(mean)[live])
    np.testing.assert_array_equal(got.cov.numpy()[live], np.asarray(cov)[live])


def test_batched_voxel_maps_equal_one_at_a_time(scene):
    tgt, mask, covs, src, _ = scene
    rng = np.random.default_rng(1)
    clouds = np.stack([tgt, src, tgt[::-1].copy()])
    masks = np.stack([mask, rng.uniform(size=len(tgt)) < 0.8, np.zeros(len(tgt), bool)])
    cv = np.stack([covs, covs, covs])
    _, cfg = _cfg()
    both = vgicp.build_voxel_maps(*_t(clouds, masks, cv), cfg)
    for i in range(3):
        one = vgicp.build_voxel_map(*_t(clouds[i], masks[i], cv[i]), cfg.voxel_resolution)
        for f in vgicp.GaussianVoxelMap._fields:
            assert torch.equal(getattr(both, f)[i], getattr(one, f)), (i, f)
    assert not both.n[2].any() and bool((both.keys[2] == vgicp.I32_MAX).all())


@pytest.mark.parametrize("ns", ["direct1", "direct7", "direct27"])
@pytest.mark.parametrize("opt", ["lm", "gn"])
def test_vgicp_align_matches_reference(scene, ns, opt):
    tgt, mask, _, src, T_true = scene
    jcfg, cfg = _cfg(neighbor_search=ns, optimizer=opt)
    want = jax_vgicp.vgicp_align(jnp.asarray(src), jnp.asarray(mask), jnp.asarray(tgt), jnp.asarray(mask),
                                 jnp.eye(4, dtype=jnp.float32), jcfg)
    got = vgicp.vgicp_align(*_t(src, mask, tgt, mask), torch.eye(4), cfg)
    T, W = got.transform.numpy(), np.asarray(want.transform)
    assert np.abs(T[:3, 3] - W[:3, 3]).max() <= POS_TOL_M
    assert np.abs(T[:3, :3] - W[:3, :3]).max() <= ROT_TOL
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.05
    assert bool(got.converged) == bool(want.converged)
    assert int(got.num_inliers) == int(want.num_inliers) > 800
    for f in ("fitness", "fitness_gated", "inlier_frac"):
        np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)), rtol=1e-4, err_msg=f)


@pytest.fixture(scope="module")
def rerank(scene):
    """Three candidates (the true target, two unrelated scenes) for two
    queries (the displaced source and the source under another offset)."""
    tgt, mask, _, src, _ = scene
    others = [_scene(np.random.default_rng(s), 1024) for s in (100, 200)]
    tgts = np.stack([tgt] + others)
    masks = np.stack([mask, np.ones(1024, bool), np.ones(1024, bool)])
    srcs = np.stack([src, src + np.float32(0.2)])
    inits = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    jcfg, cfg = _cfg()
    covs = np.asarray(jax.vmap(functools.partial(jax_point_covariances, cfg=jcfg))(jnp.asarray(tgts),
                                                                                    jnp.asarray(masks)))
    return jcfg, cfg, srcs, tgts, masks, covs, inits


def test_vgicp_rerank_matches_reference_and_prebuilt_maps(rerank):
    jcfg, cfg, srcs, tgts, masks, covs, inits = rerank
    q = np.ones(1024, bool)
    got = vgicp.vgicp_rerank(*_t(srcs, np.stack([q, q]), tgts[None].repeat(2, 0), masks[None].repeat(2, 0),
                                 inits), cfg, tgt_covs=torch.from_numpy(covs)[None].expand(2, 3, 1024, 3, 3))
    vmaps = vgicp.build_voxel_maps(*_t(tgts, masks, covs), cfg)
    vm_k = vgicp.GaussianVoxelMap(*(x[None].expand((2,) + x.shape) for x in vmaps))
    pre = vgicp.vgicp_rerank(*_t(srcs, np.stack([q, q])), None, None, torch.from_numpy(inits), cfg,
                             voxel_maps=vm_k)
    for f in vgicp.VgicpResult._fields:
        assert torch.equal(getattr(got, f), getattr(pre, f)), f
    for b in range(2):
        want = jax_vgicp.vgicp_rerank(jnp.asarray(srcs[b]), jnp.asarray(q), jnp.asarray(tgts), jnp.asarray(masks),
                                      jnp.asarray(inits[b]), jcfg, tgt_covs=jnp.asarray(covs))
        assert np.abs(got.transform[b].numpy() - np.asarray(want.transform)).max() <= POS_TOL_M
        np.testing.assert_array_equal(got.num_inliers[b].numpy(), np.asarray(want.num_inliers))
        np.testing.assert_allclose(got.fitness[b].numpy(), np.asarray(want.fitness), rtol=1e-4)
        assert int(np.argmin(got.fitness[b].numpy())) == 0  # the true target


def test_batched_rerank_equals_one_problem_at_a_time(rerank):
    """(B, K) problems at once give each problem's own result."""
    _, cfg, srcs, tgts, masks, covs, inits = rerank
    vmaps = vgicp.build_voxel_maps(*_t(tgts, masks, covs), cfg)
    q = torch.ones(1024, dtype=torch.bool)
    vm_k = vgicp.GaussianVoxelMap(*(x[None].expand((2,) + x.shape) for x in vmaps))
    both = vgicp.vgicp_rerank(torch.from_numpy(srcs), q.expand(2, 1024), None, None, torch.from_numpy(inits), cfg,
                              voxel_maps=vm_k)
    for b in range(2):
        for k in range(3):
            one = vgicp.vgicp_align(torch.from_numpy(srcs[b]), q, None, None, torch.from_numpy(inits[b, k]), cfg,
                                    voxel_map=vgicp.GaussianVoxelMap(*(x[k] for x in vmaps)))
            for f in ("num_inliers", "converged"):
                assert torch.equal(getattr(both, f)[b, k], getattr(one, f)), f
            for f in ("transform", "fitness", "fitness_gated", "inlier_frac"):
                np.testing.assert_allclose(getattr(both, f)[b, k].numpy(), getattr(one, f).numpy(), rtol=0,
                                           atol=1e-4, err_msg=f)


def test_unknown_voxel_mode_raises(scene):
    tgt, mask, covs, _, _ = scene
    with pytest.raises(ValueError, match="unknown voxel accumulation mode"):
        vgicp.build_voxel_map(*_t(tgt, mask, covs), 1.0, mode="median")
