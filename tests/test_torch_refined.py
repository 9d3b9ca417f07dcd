"""The port's refined localization slice (GICP rerank) against sgtd_tpu.

Same seed -> bit-identical worlds and clouds; the port builds its own
descriptors, DB and map covariances and localizes every query in one
batch with ``localize_refined``; the reference runs its jitted
``localize_refined`` once per query (one compile, no vmap).

Tolerances: integer outputs (found, frames, votes, refined) are equal.
Refined poses agree within 5e-3 m and 1e-3 rad: the LM loop's discrete
decisions (rho >= 0, convergence, the correspondence choice) see float32
sums that torch and XLA round in other orders, and one flipped LM step
moves a transform by about trans_eps (5e-4 m).
"""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.config import GicpConfig
from sgtd_tpu.data.synthetic import render_planar_cloud as jax_render_planar_cloud
from sgtd_tpu.db.database import tuned_config
from sgtd_tpu.db.device_build import build_database_calibrated as jax_build_calibrated
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.match.pipeline import localize_refined as jax_localize_refined
from sgtd_tpu.match.search import fit_scan_slots
from sgtd_tpu.ops.voxel import load_query_cloud as jax_load_query_cloud
from sgtd_tpu.refine.gicp import point_covariances as jax_point_covariances
from sgtd_tpu_torch.data.synthetic import make_map_and_queries, render_planar_cloud
from sgtd_tpu_torch.db.device_build import build_database_calibrated
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.eval.metrics import success_rate
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.interop import config_from_reference, map_clouds_to_device, to_numpy
from sgtd_tpu_torch.match.pipeline import localize_refined
from sgtd_tpu_torch.match.search import TRUNC_SCAN
from sgtd_tpu_torch.ops.voxel import load_query_cloud
from sgtd_tpu_torch.refine.gicp import point_covariances

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OBS = dict(center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
TABLE_SLOTS = 1 << 21
RERANK_K = 2
POS_TOL_M, ROT_TOL_RAD = 5e-3, 1e-3


def _clouds(world, cfg, render=render_planar_cloud, load=load_query_cloud):
    """The bench's clouds at test size: 1,024-point map renders, query
    sources downsampled at the leaf size and capped at 256 points."""
    rng = np.random.default_rng(77)
    mc, mm = zip(*(render(world, p, rng, max_points=1024) for p in world.map_poses))
    qc, qm = [], []
    for p in world.query_poses:
        c, m = render(world, p, rng, max_points=1024)
        a, b = load(c[m], cfg.gicp.leaf_size, 256)
        qc.append(a)
        qm.append(b)
    return np.stack(mc), np.stack(mm), np.stack(qc), np.stack(qm)


@pytest.fixture(scope="module")
def slice_results(small_config):
    cfg = small_config.replace(gicp=GicpConfig(num_neighbors=8, max_iterations=6))
    maps, queries, world = make_map_and_queries(cfg, seed=11, num_map_frames=20, num_queries=4, **OBS)
    mc, mm, qc, qm = _clouds(world, cfg)

    # Reference: JAX DB, covariances of the padded map clouds, one jitted
    # localize_refined per query.
    fn = jax.jit(jax.vmap(lambda g: jax_build_descriptors(g, cfg.desc, cfg.caps)))
    stack = lambda gs: jax.tree_util.tree_map(lambda *xs: np.stack(xs), *gs)
    jdb, jrep, jtot = jax_build_calibrated(
        fn(stack(maps)), np.stack([g.pose for g in maps]), fn(stack(queries)), cfg.desc,
        table_slots=TABLE_SLOTS,
    )
    jcfg = fit_scan_slots(int(np.asarray(jtot).max()), tuned_config(cfg, jrep))
    f_pad = jdb.frame_poses.shape[0]
    pad = f_pad - mc.shape[0]
    jmc = jnp.asarray(np.pad(mc, ((0, pad), (0, 0), (0, 0))))
    jmm = jnp.asarray(np.pad(mm, ((0, pad), (0, 0))))
    jcov = jax.jit(jax.vmap(functools.partial(jax_point_covariances, cfg=jcfg.gicp)))(jmc, jmm)
    want = [
        jax.tree_util.tree_map(
            np.asarray,
            jax_localize_refined(jdb, g, jnp.asarray(qc[i]), jnp.asarray(qm[i]), jmc, jmm, jcov,
                                 config=jcfg, rerank_k=RERANK_K),
        )
        for i, g in enumerate(queries)
    ]

    # Port: its own config type, DB and map covariances, all queries in one batch.
    pcfg = config_from_reference(cfg)
    mb, qb = stack_graphs(maps, "cpu"), stack_graphs(queries, "cpu")
    db, rep, tot = build_database_calibrated(
        build_descriptors(mb, pcfg.desc, pcfg.caps), mb.pose,
        build_descriptors(qb, pcfg.desc, pcfg.caps), pcfg.desc, table_slots=TABLE_SLOTS,
    )
    tcfg = fit_scan_slots(int(tot.max()), tuned_config(pcfg, rep))
    assert tcfg == config_from_reference(jcfg) and type(tcfg) is type(pcfg)
    clouds, masks, _ = map_clouds_to_device(mc, mm, None, "cpu", f_pad=db.frame_poses.shape[0])
    covs = point_covariances(clouds, masks, tcfg.gicp)
    got = localize_refined(
        db, qb, torch.from_numpy(qc), torch.from_numpy(qm), clouds, masks, covs,
        config=tcfg, rerank_k=RERANK_K,
    )
    return queries, tcfg, want, to_numpy(got), np.asarray(jcov), covs.numpy()


def test_refined_integer_outputs_match_reference(slice_results):
    queries, cfg, want, got, _, _ = slice_results
    for f in ("found", "best_frame", "frames", "votes", "truncated"):
        np.testing.assert_array_equal(
            getattr(got.result, f), np.stack([getattr(w.result, f) for w in want]), err_msg=f
        )
    np.testing.assert_array_equal(got.refined, np.stack([w.refined for w in want]))
    assert got.result.found.all() and got.refined.all()
    assert not (got.result.truncated & TRUNC_SCAN).any()
    assert success_rate([g.pose for g in queries], got.pose, got.result.found, cfg) == 1.0


def test_refined_poses_and_fitness_match_reference(slice_results):
    _, _, want, got, _, _ = slice_results
    w_pose = np.stack([w.pose for w in want]).astype(np.float64)
    g_pose = got.pose.astype(np.float64)
    np.testing.assert_allclose(g_pose[:, :3, 3], w_pose[:, :3, 3], atol=POS_TOL_M, rtol=0)
    rel = np.einsum("nji,njk->nik", w_pose[:, :3, :3], g_pose[:, :3, :3])
    skew = rel - np.swapaxes(rel, 1, 2)
    ang = np.arcsin(np.clip(np.linalg.norm(skew[:, [2, 0, 1], [1, 2, 0]], axis=1) / 2, 0, 1))
    assert ang.max() < ROT_TOL_RAD, ang.max()
    # The refinement moved the poses (the rerank is not a no-op) ...
    shift = np.linalg.norm(g_pose[:, :3, 3] - got.result.poses[:, 0, :3, 3], axis=1)
    assert shift.max() > 10 * POS_TOL_M, shift
    np.testing.assert_allclose(got.fitness, np.stack([w.fitness for w in want]), rtol=1e-3)


def test_map_covariances_match_reference(slice_results):
    *_, want_cov, got_cov = slice_results
    # Both take the same neighbours (B5 is exact). The regularized
    # covariance depends only on the smallest eigenvector, from float32
    # Cardano: where the largest eigenvalue dwarfs the others, r = det/2
    # sits near 1, where arccos amplifies the ulps by which torch's and
    # XLA's arccos/cos differ (one point of the 20 x 1,024 here: smallest
    # eigenvalue 0.22288 in XLA, 0.22278 in torch, 0.22277 in float64).
    err = np.abs(got_cov - want_cov).max(axis=(-2, -1))
    assert (err > 2e-4).mean() <= 1e-3, np.sort(err)[-10:]
    assert err.max() <= 1e-2, err.max()


def test_clouds_are_bit_identical(small_config):
    cfg = small_config
    _, _, world = make_map_and_queries(cfg, seed=11, num_map_frames=6, num_queries=3, **OBS)
    got = _clouds(world, cfg)
    want = _clouds(world, cfg, jax_render_planar_cloud, jax_load_query_cloud)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_map_tensors_must_carry_the_db_frame_count(slice_results, small_config):
    """Indexing by frame id needs f_pad rows; the reference would clamp."""
    queries, cfg, *_ = slice_results
    clouds = torch.zeros(3, 8, 3)
    masks = torch.ones(3, 8, dtype=torch.bool)
    maps, qs, _ = make_map_and_queries(cfg, seed=11, num_map_frames=20, num_queries=1, **OBS)
    mb, qb = stack_graphs(maps, "cpu"), stack_graphs(qs, "cpu")
    md = build_descriptors(mb, cfg.desc, cfg.caps)
    db, _, _ = build_database_calibrated(md, mb.pose, md, cfg.desc, table_slots=TABLE_SLOTS)
    with pytest.raises(ValueError, match="frame_poses"):
        localize_refined(db, qb, clouds[:1], masks[:1], clouds, masks, None, cfg)
    with pytest.raises(ValueError, match="frame_poses"):
        localize_refined(
            db, qb, clouds[:1], masks[:1], clouds, masks, None,
            cfg.replace(gicp=config_from_reference(GicpConfig(engine="vgicp"), type(cfg.gicp))),
        )


def test_map_clouds_pad_to_the_db_frame_count():
    """Padding rows are empty clouds with identity covariances, as the
    reference's point_covariances gives a fully masked cloud."""
    rng = np.random.default_rng(0)
    clouds = rng.normal(size=(3, 16, 3)).astype(np.float32)
    masks = rng.uniform(size=(3, 16)) < 0.7
    covs = rng.normal(size=(3, 16, 3, 3)).astype(np.float32)
    c, m, v = map_clouds_to_device(clouds, masks, covs, "cpu", f_pad=8)
    assert c.shape == (8, 16, 3) and m.shape == (8, 16) and v.shape == (8, 16, 3, 3)
    np.testing.assert_array_equal(c[:3].numpy(), clouds)
    np.testing.assert_array_equal(m[:3].numpy(), masks)
    np.testing.assert_array_equal(v[:3].numpy(), covs)
    assert not m[3:].any() and (c[3:] == 0).all()
    assert torch.equal(v[3:], torch.eye(3).expand(5, 16, 3, 3))
    want = np.asarray(jax_point_covariances(jnp.zeros((16, 3)), jnp.zeros(16, bool), GicpConfig()))
    np.testing.assert_array_equal(v[3].numpy(), want)
    assert map_clouds_to_device(clouds, masks, None, "cpu")[2] is None
    with pytest.raises(ValueError, match="exceed f_pad"):
        map_clouds_to_device(clouds, masks, None, "cpu", f_pad=2)


def test_refined_port_imports_no_jax():
    """Driving localize_refined (covariances, rerank) loads no jax module
    and no sgtd_tpu module at all."""
    code = """
import sys
import numpy as np
import torch
from sgtd_tpu_torch.config import CapacityConfig, GicpConfig, SGTDConfig
from sgtd_tpu_torch.data.synthetic import make_map_and_queries, render_planar_cloud
from sgtd_tpu_torch.db.database import tuned_config
from sgtd_tpu_torch.db.device_build import build_database_calibrated
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.interop import map_clouds_to_device
from sgtd_tpu_torch.match.pipeline import localize_refined
from sgtd_tpu_torch.match.search import fit_scan_slots
from sgtd_tpu_torch.ops.voxel import load_query_cloud
from sgtd_tpu_torch.refine.gicp import point_covariances
torch.set_num_threads(1)
cfg = SGTDConfig().replace(caps=CapacityConfig(max_nodes=32, max_descriptors=128),
                           gicp=GicpConfig(num_neighbors=4, max_iterations=2))
maps, queries, world = make_map_and_queries(cfg, seed=1, num_map_frames=6, num_queries=2)
mb, qb = stack_graphs(maps, "cpu"), stack_graphs(queries, "cpu")
md, qd = build_descriptors(mb, cfg.desc, cfg.caps), build_descriptors(qb, cfg.desc, cfg.caps)
db, rep, tot = build_database_calibrated(md, mb.pose, qd, cfg.desc, table_slots=1 << 20)
cfg = fit_scan_slots(int(tot.max()), tuned_config(cfg, rep))
rng = np.random.default_rng(0)
mc, mm = zip(*(render_planar_cloud(world, p, rng, max_points=128) for p in world.map_poses))
qc, qm = zip(*(load_query_cloud(render_planar_cloud(world, p, rng, max_points=128)[0], 3.0, 64)
               for p in world.query_poses))
clouds, masks, _ = map_clouds_to_device(mc, mm, None, "cpu", f_pad=db.frame_poses.shape[0])
res = localize_refined(db, qb, torch.from_numpy(np.stack(qc)), torch.from_numpy(np.stack(qm)),
                       clouds, masks, point_covariances(clouds, masks, cfg.gicp), cfg, rerank_k=2)
assert res.pose.shape == (2, 4, 4) and bool(torch.isfinite(res.pose).all())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgtd_tpu"))
print("BAD", bad)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
