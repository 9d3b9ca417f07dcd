"""The port's multi-session correction against sgtd_tpu.

tests/test_multisession.py's world (rng 21, 24 map keyframes, the reference
test's small config): the reference's DB crosses to the port through
``interop.db_from_numpy``, its config through ``config_from_reference``,
and the same session graphs and odometry go through both packages'
``localize_and_optimize_session``. The loop decisions are integers and
must be equal; the corrected poses lie within 1e-2 m of the reference's
(float32 localization poses of the two packages differ by ulps, and the
dense solves are different LU code).
"""

from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.data.synthetic import make_world, observe
from sgtd_tpu.db.database import build_database, tuned_config
from sgtd_tpu.desc.triangles import build_descriptors
from sgtd_tpu.geom import se3 as jax_se3
from sgtd_tpu.slam import localize_and_optimize_session as jax_session
from sgtd_tpu_torch.graph.types import SemanticGraph
from sgtd_tpu_torch.interop import config_from_reference, db_from_numpy
from sgtd_tpu_torch.slam import localize_and_optimize_session, multisession

torch.set_num_threads(1)

POSE_TOL_M = 1e-2


@pytest.fixture(scope="module")
def setup(small_config):
    cfg = small_config
    rng = np.random.default_rng(21)
    world = make_world(rng, num_map_frames=24, num_queries=1)
    map_graphs = [observe(world, p, cfg, rng) for p in world.map_poses]
    descs = [build_descriptors(g, cfg.desc, cfg.caps) for g in map_graphs]
    db, rep = build_database(descs, [np.asarray(g.pose) for g in map_graphs], cfg.desc, cfg.caps)
    return tuned_config(cfg, rep), world, db, rng


def _both(setup, graphs, odom):
    cfg, _, db, _ = setup
    want = jax_session(db, graphs, odom, cfg)
    got = localize_and_optimize_session(
        db_from_numpy(db, "cpu"), [SemanticGraph(*g) for g in graphs], odom, config_from_reference(cfg))
    return want, got


@pytest.fixture(scope="module")
def session(setup):
    """tests/test_multisession.py::test_session_correction's session."""
    cfg, world, _, rng = setup
    s_n = 10
    gt = world.map_poses[:s_n].astype(np.float64).copy()
    drift = np.asarray(jax_se3.se3_exp(jnp.asarray([0.25, 0.1, 0.0, 0.0, 0.0, 0.01], jnp.float32))).astype(np.float64)
    odom = [gt[0]]
    for i in range(1, s_n):
        odom.append(odom[-1] @ (np.linalg.inv(gt[i - 1]) @ gt[i]) @ drift)
    odom = np.stack(odom)
    graphs = [observe(world, p, cfg, rng, center_noise_m=0.05, dropout=0.1) for p in gt]
    return gt, odom, graphs


def test_session_correction_matches_reference(setup, session):
    gt, odom, graphs = session
    want, got = _both(setup, graphs, odom)
    assert got.num_loops == want.num_loops
    np.testing.assert_array_equal(got.loop_frames, want.loop_frames)
    assert got.loop_frames.dtype == np.int32 and got.poses.dtype == np.float32
    np.testing.assert_allclose(got.poses[:, :3, 3], want.poses[:, :3, 3], rtol=0, atol=POSE_TOL_M)
    # The reference test's gates, on the port.
    assert np.linalg.norm(odom[-1][:3, 3] - gt[-1][:3, 3]) > 1.0
    assert got.num_loops >= len(gt) // 2, got.loop_scores
    assert np.linalg.norm(got.poses[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 1.0


def test_session_correction_through_pcg(setup, session):
    """The same session with the PCG solver (which the port takes above
    1,024 nodes): the reference's dense poses within 1e-2 m."""
    gt, odom, graphs = session
    with mock.patch.object(multisession, "DENSE_MAX_NODES", 0), \
            mock.patch.object(multisession, "optimize_pose_graph", side_effect=AssertionError("dense solver used")):
        want, got = _both(setup, graphs, odom)
    np.testing.assert_array_equal(got.loop_frames, want.loop_frames)
    np.testing.assert_allclose(got.poses[:, :3, 3], want.poses[:, :3, 3], rtol=0, atol=POSE_TOL_M)


def _shift(x):
    T = np.eye(4)
    T[0, 3] = x
    return T


@pytest.mark.slow
def test_session_no_map_overlap_keeps_odometry(setup):
    """tests/test_multisession.py's session far outside the map: no loops,
    odometry passes through, on both packages."""
    cfg, world, _, rng = setup
    far = np.eye(4)
    far[:3, 3] = (4000.0, 4000.0, 0.0)
    poses = np.stack([far @ _shift(i * 5.0) for i in range(4)])
    graphs = [observe(world, p, cfg, rng) for p in poses]
    want, got = _both(setup, graphs, poses)
    assert got.num_loops == want.num_loops == 0
    np.testing.assert_array_equal(got.loop_frames, want.loop_frames)
    np.testing.assert_allclose(got.poses, poses.astype(np.float32), atol=1e-2)
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=POSE_TOL_M)


@pytest.mark.slow
def test_reference_session():
    """REFERENCE_SESSION, which chip_smoke.py holds the card's bench-world
    session to, is what sgtd_tpu gives on the CPU: phase 3's world and DB
    (seed 2026, 200 keyframes, default widths, calibrated on the first 16
    queries) and the session of ``chip_smoke.session_inputs``; a few
    minutes on a CPU."""
    import jax

    import chip_smoke as cs
    from sgtd_tpu.config import SGTDConfig
    from sgtd_tpu.data.synthetic import make_map_and_queries
    from sgtd_tpu.db.device_build import build_database_calibrated
    from sgtd_tpu.match.search import fit_scan_slots

    cfg = SGTDConfig()
    maps, queries, world = make_map_and_queries(
        cfg, seed=cs.SEED, num_map_frames=cs.NUM_MAP, num_queries=cs.NUM_QUERIES,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
    fn = jax.jit(jax.vmap(lambda g: build_descriptors(g, cfg.desc, cfg.caps)))
    stack = lambda gs: jax.tree_util.tree_map(lambda *xs: np.stack(xs), *gs)
    db, rep, tot = build_database_calibrated(
        fn(stack(maps)), np.stack([g.pose for g in maps]), fn(stack(queries[: cs.N_SAMPLE])), cfg.desc)
    cfg = fit_scan_slots(int(np.asarray(tot).max()), tuned_config(cfg, rep))
    graphs, gt, odom = cs.session_inputs(world, observe, cfg, cs.SESSION_SCANS)
    res = jax_session(db, graphs, odom, cfg)
    got = {"num_loops": res.num_loops, "loop_frames": tuple(int(f) for f in res.loop_frames)}
    assert got == cs.REFERENCE_SESSION
    assert np.linalg.norm(res.poses[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 1.0
