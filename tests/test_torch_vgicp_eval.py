"""The VGICP engine through the port's entry points against sgtd_tpu on the
CPU: map artifacts with voxel maps (built, saved, loaded, across the two
packages), ``localize_refined`` on prebuilt voxel maps and on covariances
alone, ``evaluate`` and the fallback's ``_rerank_single``.

Tolerances: voxel keys, counts and means equal (the means depend on the
points alone; the covariances on the port's float32 Cardano, equal but on
~0.03% of points, the rule of tests/test_torch_eval.py); refined poses
within 5e-3 m and 5e-3 rad of the reference's, refined and found flags
equal; summaries with equal counts, rates and recalls and pose errors
within 5e-3 m / 5e-2 deg (tests/test_torch_eval.py's refined rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtd_tpu import config as jax_config
from sgtd_tpu.data.synthetic import make_map_and_queries, render_planar_cloud
from sgtd_tpu.db import artifacts as jax_artifacts
from sgtd_tpu.eval import runner as jax_runner
from sgtd_tpu.match.pipeline import localize_refined as jax_localize_refined
from sgtd_tpu.ops.voxel import load_query_cloud
from sgtd_tpu_torch import config, interop
from sgtd_tpu_torch.db import artifacts
from sgtd_tpu_torch.eval import runner
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.match.pipeline import localize, localize_refined
from sgtd_tpu_torch.refine.vgicp import GaussianVoxelMap

torch.set_num_threads(1)

OBS = dict(center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
GCFG = config.GicpConfig(enable=True, engine="vgicp", num_neighbors=8, max_iterations=4, max_points=128)
JGCFG = jax_config.GicpConfig(enable=True, engine="vgicp", num_neighbors=8, max_iterations=4, max_points=128)
EXACT_KEYS = ("total", "success_rate", "recall_at_1", "recall_at_5", "recall_at_10", "db_rows")
POS_TOL_M = ROT_TOL = 5e-3


@pytest.fixture(scope="module")
def world(small_config):
    """The small world of tests/test_torch_eval.py: 20 keyframes, 6
    queries, planar clouds of 512 points, sources of at most 128; the
    reference's map index (GICP config set) and VGICP artifacts."""
    cfg = small_config
    maps, queries, w = make_map_and_queries(cfg, seed=13, num_map_frames=20, num_queries=6, **OBS)

    def m_fn(fid):
        return render_planar_cloud(w, w.map_poses[fid], np.random.default_rng(8000 + fid), max_points=512)

    def q_fn(i):
        pts, m = render_planar_cloud(w, w.query_poses[i], np.random.default_rng(7000 + i), max_points=512)
        return load_query_cloud(pts[m], 3.0, 128)

    jindex = jax_runner.build_map_index(maps, cfg)
    jindex = dataclasses.replace(jindex, config=jindex.config.replace(gicp=JGCFG))
    f_pad = jindex.db.frame_poses.shape[0]
    jart = jax.tree_util.tree_map(np.asarray, jax_artifacts.build_map_artifacts(m_fn, 20, JGCFG, f_pad=f_pad))
    return queries, m_fn, q_fn, jindex, jart


def _assert_vmaps(got: GaussianVoxelMap, want, exact_cov: bool) -> None:
    for f in ("keys", "n", "resolution", "mean") + (("cov",) if exact_cov else ()):
        a, w = getattr(got, f), np.asarray(getattr(want, f))
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == w.dtype and a.shape == w.shape, f
        np.testing.assert_array_equal(a, w, err_msg=f)
    if not exact_cov:
        err = np.abs(got.cov.numpy() - np.asarray(want.cov)).max(axis=(-2, -1))
        assert (err > 2e-4).mean() <= 1e-3 and err.max() <= 1e-2, np.sort(err.ravel())[-5:]


def test_artifacts_with_voxel_maps_match_reference(world):
    _, m_fn, _, jindex, jart = world
    f_pad = jindex.db.frame_poses.shape[0]
    art = artifacts.build_map_artifacts(m_fn, 20, GCFG, f_pad=f_pad, batch=8, device="cpu")
    assert art.vmaps is not None and art.vmaps.keys.shape == (f_pad, 512)
    _assert_vmaps(art.vmaps, jart.vmaps, exact_cov=False)
    assert artifacts.build_map_artifacts(m_fn, 2, dataclasses.replace(GCFG, engine="gicp"), device="cpu").vmaps is None
    assert artifacts.build_map_artifacts(m_fn, 2, GCFG, with_vmaps=False, device="cpu").vmaps is None
    # Across packages in memory, and back.
    crossed = interop.map_artifacts_from_numpy(jart, "cpu")
    _assert_vmaps(crossed.vmaps, jart.vmaps, exact_cov=True)
    back = interop.map_artifacts_to_numpy(crossed)
    _assert_vmaps(jax_artifacts.GaussianVoxelMap(**back["vmaps"]), jart.vmaps, exact_cov=True)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_artifacts_with_voxel_maps_files_cross_packages(world, tmp_path, writer):
    *_, jart = world
    art = interop.map_artifacts_from_numpy(jart, "cpu")
    path = str(tmp_path / "art.npz")
    n = art.clouds.shape[0]
    if writer == "port":
        artifacts.save_map_artifacts(path, art, GCFG)
        got = jax.tree_util.tree_map(np.asarray, jax_artifacts.load_map_artifacts(path, n, JGCFG))
    else:
        jax_artifacts.save_map_artifacts(path, jax.tree_util.tree_map(jnp.asarray, jart), JGCFG)
        got = artifacts.load_map_artifacts(path, n, GCFG, device="cpu")
    _assert_vmaps(got.vmaps, jart.vmaps, exact_cov=True)
    for f in ("clouds", "masks", "covs"):
        a = getattr(got, f)
        np.testing.assert_array_equal(a.numpy() if isinstance(a, torch.Tensor) else a, getattr(jart, f), err_msg=f)


def _pose_gap(a, b):
    return np.abs(a[..., :3, 3] - b[..., :3, 3]).max(), np.abs(a[..., :3, :3] - b[..., :3, :3]).max()


@pytest.mark.parametrize("maps", ["voxel_maps", "covariances"])
def test_localize_refined_vgicp_matches_reference(world, maps):
    """On prebuilt voxel maps (gathered by candidate), and on covariances
    alone (the candidates' voxel maps built per call)."""
    queries, _, q_fn, jindex, jart = world
    index = interop.map_index_from_reference(jindex, "cpu")
    art = interop.map_artifacts_from_numpy(jart, "cpu")
    clouds = [q_fn(i) for i in range(4)]
    qc = np.stack([c for c, _ in clouds])
    qm = np.stack([m for _, m in clouds])
    vm = art.vmaps if maps == "voxel_maps" else None
    got = localize_refined(index.db, stack_graphs(queries[:4], "cpu"), torch.from_numpy(qc), torch.from_numpy(qm),
                           art.clouds, art.masks, None if vm is not None else art.covs, index.config, rerank_k=2,
                           map_vmaps=vm)
    jvm = None if vm is None else jax.tree_util.tree_map(jnp.asarray, jart.vmaps)
    jcov = None if vm is not None else jnp.asarray(jart.covs)
    fn = jax.jit(jax.vmap(lambda g, c, m: jax_localize_refined(
        jindex.db, g, c, m, jnp.asarray(jart.clouds), jnp.asarray(jart.masks), jcov, jindex.config, 2,
        map_vmaps=jvm)))
    want = fn(jax_runner.stack_graphs(queries[:4]), jnp.asarray(qc), jnp.asarray(qm))
    np.testing.assert_array_equal(got.refined.numpy(), np.asarray(want.refined))
    np.testing.assert_array_equal(got.result.found.numpy(), np.asarray(want.result.found))
    assert got.refined.any()
    dt, dr = _pose_gap(got.pose.numpy(), np.asarray(want.pose))
    assert dt <= POS_TOL_M and dr <= ROT_TOL, (dt, dr)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), rtol=1e-3, atol=1e-4)


def test_evaluate_and_rerank_single_vgicp_match_reference(world):
    queries, _, q_fn, jindex, jart = world
    index = interop.map_index_from_reference(jindex, "cpu")
    art = interop.map_artifacts_from_numpy(jart, "cpu")
    kw = dict(batch_size=3, query_cloud_fn=q_fn, rerank_k=2)
    want = jax_runner.evaluate(jindex, queries, map_artifacts=jax.tree_util.tree_map(jnp.asarray, jart), **kw)
    got = runner.evaluate(index, queries, map_artifacts=art, **kw)
    assert list(got) == list(want)
    for k in EXACT_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("rmse_trans_m", "mean_trans_m"):
        assert abs(got[k] - want[k]) <= 5e-3, (k, got[k], want[k])
    for k in ("rmse_rot_deg", "mean_rot_deg"):
        assert abs(got[k] - want[k]) <= 5e-2, (k, got[k], want[k])
    # The fallback's single-query rerank on the voxel maps, both packages,
    # with the guard opened wide so that the pick takes a refinement.
    c = index.config.replace(gicp=dataclasses.replace(GCFG, max_refine_shift_m=100.0, max_refine_rot_deg=180.0))
    jc = jindex.config.replace(gicp=dataclasses.replace(JGCFG, max_refine_shift_m=100.0, max_refine_rot_deg=180.0))
    res = localize(index.db, stack_graphs(queries[:1], "cpu"), index.config)
    one = type(res)(*(v[0] for v in interop.to_numpy(res)))
    qc, qm = q_fn(0)
    mine = runner._rerank_single(index, c, one, torch.from_numpy(qc), torch.from_numpy(qm), art, 2,
                                 one.poses[0].copy())
    theirs = jax_runner._rerank_single(dataclasses.replace(jindex, config=jc), jc, one, qc, qm,
                                       jax.tree_util.tree_map(jnp.asarray, jart), 2, one.poses[0].copy())
    dt, dr = _pose_gap(mine, np.asarray(theirs))
    assert dt <= POS_TOL_M and dr <= ROT_TOL, (dt, dr)
    assert np.abs(mine - one.poses[0]).max() > 1e-4  # a refinement, not the input
