"""The port's fused GICP path (kernel B7's plain version, the fused
``gicp_align``, the fused ``localize_refined``) and kernel B8's plain
version against sgtd_tpu on the CPU.

The reference's Pallas kernels run in interpret mode. Inputs are made
with NumPy from a seed and fed to both packages. Tolerances are the
reference's own (tests/test_pallas_gicp.py): H and g within rtol 2e-4 +
atol 2e-2, y0 within rtol 1e-4, the gathered target points within 1e-5,
the weights equal; registrations within 2e-3 m and 2e-4 in the rotation
entries (float32 sums taken in other orders). The reference reads its
``_USE_FUSED_LINEARIZE`` flag while tracing, so a test that patches it
calls the un-jitted ``gicp_align`` or clears JAX's caches around the call.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.config import GicpConfig as JaxGicpConfig
from sgtd_tpu.ops import pallas_gicp as jax_pallas_gicp
from sgtd_tpu.ops.pallas_probe import gather_rows as jax_gather_rows
from sgtd_tpu.refine import gicp as jax_gicp
from sgtd_tpu_torch.interop import config_from_reference, to_numpy
from sgtd_tpu_torch.config import GicpConfig
from sgtd_tpu_torch.ops import gicp as gicp_ops
from sgtd_tpu_torch.ops import probe
from sgtd_tpu_torch.refine import gicp

torch.set_num_threads(1)

T = torch.from_numpy
TRANS_ATOL, ROT_ATOL = 2e-3, 2e-4


# --- kernel B7: the plain version against the Pallas kernel. ---


def _linearize_inputs():
    """The inputs of tests/test_pallas_gicp.py:64-95: random clouds, a
    tenth of each side masked, random SPD covariances."""
    rng = np.random.default_rng(5)
    s_n, t_n = 128, 256
    src = rng.normal(0, 10, (s_n, 3)).astype(np.float32)
    tgt = rng.normal(0, 10, (t_n, 3)).astype(np.float32)
    smask = rng.uniform(size=s_n) > 0.1
    tmask = rng.uniform(size=t_n) > 0.1
    tgt_eff = np.where(tmask[:, None], tgt, 1e6).astype(np.float32)

    def rand_cov(n):
        a = rng.normal(0, 1, (n, 3, 3)).astype(np.float32)
        return a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)

    Tm = np.eye(4, dtype=np.float32)
    Tm[:3, 3] = [0.5, -0.2, 0.3]
    return Tm, src, rand_cov(s_n), smask, tgt, tmask, tgt_eff, rand_cov(t_n)


@pytest.mark.parametrize("gate", [float("inf"), 4.0])
def test_linearize_plain_matches_pallas(gate):
    Tm, src, scov, smask, tgt, tmask, tgt_eff, tcov = _linearize_inputs()
    scov6 = np.stack([scov[:, 0, 0], scov[:, 0, 1], scov[:, 0, 2],
                      scov[:, 1, 1], scov[:, 1, 2], scov[:, 2, 2]], axis=1)
    payload = jax_pallas_gicp.build_gicp_payload(jnp.asarray(tgt), jnp.asarray(tmask), jnp.asarray(tcov))
    want = [np.asarray(x) for x in jax_pallas_gicp.linearize_gicp(
        jnp.asarray(Tm), jnp.asarray(src), jnp.asarray(scov6), jnp.asarray(smask),
        jnp.asarray(tgt_eff), payload, gate)]

    assert torch.equal(gicp_ops.cov6(T(scov)), T(scov6))
    args = (T(Tm)[None], T(src)[None], T(scov6)[None], T(smask)[None], T(tgt_eff)[None],
            gicp_ops.build_gicp_payload(T(tgt), T(tmask), T(tcov))[None], gate)
    got = [x[0].numpy() for x in gicp_ops.linearize_gicp_plain(*args)]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-2)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=2e-2)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    # aux: the port keeps M as 9 row-major entries, the reference 6.
    b, M, w = (x.numpy() for x in gicp_ops.unpack_aux(T(got[3])))
    np.testing.assert_allclose(b, want[3][:, :3], atol=1e-5)
    np.testing.assert_array_equal(w, want[3][:, 9])
    np.testing.assert_allclose(M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]], want[3][:, 3:9], rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(M, M.transpose(0, 2, 1))
    assert (got[3][:, 13:] == 0).all() and got[0].shape == (6, 6)
    np.testing.assert_array_equal(got[0], got[0].T)
    # The gate bites, and masks alone already drop points.
    n_valid = int(w.sum())
    assert 0 < n_valid < (100 if np.isfinite(gate) else smask.sum() + 1)
    # The dispatcher takes the plain version for CPU tensors, bit for bit,
    # and carries n_valid and the sum of squared distances.
    before = gicp_ops.LINEARIZE_LAUNCHES
    sums, aux = gicp_ops.linearize_sums(*args)
    assert gicp_ops.LINEARIZE_LAUNCHES == before == 0
    H, g, y0 = gicp_ops.unpack_sums(sums)
    np.testing.assert_array_equal(H[0].numpy(), got[0])
    np.testing.assert_array_equal(aux[0].numpy(), got[3])
    assert int(sums[0, gicp_ops.N_VALID]) == n_valid and (sums[0, gicp_ops.SUM_SQD + 1:] == 0).all()


def test_linearize_dispatch_and_checks():
    """Any device but the CPU launches the kernel or raises."""
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    args = [z(2, 4, 4), z(2, 8, 3), z(2, 8, 6), z(2, 8, dt=torch.bool), z(2, 16, 3), z(2, 16, 12)]
    with pytest.raises(ValueError, match="CUDA tensors on one card required"):
        gicp_ops.linearize_gicp(*args)
    assert gicp_ops.LINEARIZE_LAUNCHES == 0


def test_linearize_all_masked_target_is_zero_and_finite():
    """A problem whose targets are all masked (a padding keyframe of the
    artifacts): w = 0 everywhere, H = g = y0 = 0, nothing non-finite."""
    rng = np.random.default_rng(6)
    src = T(rng.normal(0, 10, (1, 64, 3)).astype(np.float32))
    tgt = torch.zeros(1, 32, 3)
    tmask = torch.zeros(1, 32, dtype=torch.bool)
    eye = torch.eye(3).expand(1, 32, 3, 3)
    H, g, y0, aux = gicp_ops.linearize_gicp_plain(
        torch.eye(4)[None], src, gicp_ops.cov6(torch.eye(3).expand(1, 64, 3, 3)),
        torch.ones(1, 64, dtype=torch.bool), torch.full_like(tgt, 1e6),
        gicp_ops.build_gicp_payload(tgt, tmask, eye))
    assert not H.any() and not g.any() and not y0.any() and not aux[..., 12].any()
    assert torch.isfinite(aux).all()
    with mock.patch.object(gicp, "_USE_FUSED_LINEARIZE", True):
        out = gicp.gicp_align(src, torch.ones(1, 64, dtype=torch.bool), tgt, tmask, torch.eye(4)[None],
                              GicpConfig(num_neighbors=4, max_iterations=3))
    assert all(torch.isfinite(v.float()).all() for v in out)
    assert int(out.num_inliers) == 0


def _problems(rng, p, s_n, t_n):
    """p small registration problems: (T, src, src_cov, src_mask, tgt,
    tgt_mask, tgt_eff, tgt_cov) as NumPy arrays with a leading p."""
    src = rng.normal(0, 10, (p, s_n, 3)).astype(np.float32)
    tgt = rng.normal(0, 10, (p, t_n, 3)).astype(np.float32)
    tgt[:, t_n // 2 :] = tgt[:, : t_n - t_n // 2]  # duplicated targets: distance ties
    smask = rng.uniform(size=(p, s_n)) > 0.1
    tmask = rng.uniform(size=(p, t_n)) > 0.1
    tmask[:, 0] = True
    tgt_eff = np.where(tmask[..., None], tgt, 1e6).astype(np.float32)

    def rand_cov(n):
        a = rng.normal(0, 1, (p, n, 3, 3)).astype(np.float32)
        return a @ a.transpose(0, 1, 3, 2) + 0.1 * np.eye(3, dtype=np.float32)

    Tm = np.tile(np.eye(4, dtype=np.float32), (p, 1, 1))
    Tm[:, :3, 3] = rng.normal(0, 0.3, (p, 3))
    return Tm, src, rand_cov(s_n), smask, tgt, tmask, tgt_eff, rand_cov(t_n)


@pytest.mark.parametrize("s_n,t_n", [(100, 203), (33, 1), (5, 7)])
def test_linearize_plain_matches_pallas_on_ragged_batches(s_n, t_n):
    """Three problems at once whose point counts divide neither a warp, a
    group of 16 targets nor a block of 32 or 128 source points (and a single
    target): every problem of the batched plain version against the Pallas
    kernel on that problem alone, correspondences equal."""
    rng = np.random.default_rng(s_n)
    Tm, src, scov, smask, tgt, tmask, tgt_eff, tcov = _problems(rng, 3, s_n, t_n)
    scov6 = gicp_ops.cov6(T(scov))
    H, g, y0, aux = gicp_ops.linearize_gicp(
        T(Tm), T(src), scov6, T(smask), T(tgt_eff), gicp_ops.build_gicp_payload(T(tgt), T(tmask), T(tcov)), 4.0)
    b, _, w = gicp_ops.unpack_aux(aux)
    for i in range(3):
        payload = jax_pallas_gicp.build_gicp_payload(*map(jnp.asarray, (tgt[i], tmask[i], tcov[i])))
        want = [np.asarray(x) for x in jax_pallas_gicp.linearize_gicp(
            jnp.asarray(Tm[i]), jnp.asarray(src[i]), jnp.asarray(scov6[i].numpy()), jnp.asarray(smask[i]),
            jnp.asarray(tgt_eff[i]), payload, 4.0)]
        np.testing.assert_allclose(H[i].numpy(), want[0], rtol=2e-4, atol=2e-2)
        np.testing.assert_allclose(g[i].numpy(), want[1], rtol=2e-4, atol=2e-2)
        np.testing.assert_allclose(y0[i].numpy(), want[2], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(b[i].numpy(), want[3][:, :3], atol=1e-5)
        np.testing.assert_array_equal(w[i].numpy(), want[3][:, 9])


def test_linearize_takes_more_problems_than_a_grid_axis_holds():
    """70,000 problems (more than 65,535) in one call: the plain version
    here equals the same problems taken alone, and the CUDA wrapper's own
    checks pass the count on (a meta tensor stops at the device check, not
    at a problem limit); its scratch holds a row for every block."""
    rng = np.random.default_rng(13)
    p = 70000
    Tm, src, scov, smask, tgt, tmask, tgt_eff, tcov = _problems(rng, p, 2, 5)
    args = (T(Tm), T(src), gicp_ops.cov6(T(scov)), T(smask), T(tgt_eff),
            gicp_ops.build_gicp_payload(T(tgt), T(tmask), T(tcov)))
    sums, aux = gicp_ops.linearize_sums(*args)
    assert sums.shape == (p, gicp_ops.ROW) and aux.shape == (p, 2, gicp_ops.AUX)
    assert torch.isfinite(sums).all() and sums[:, gicp_ops.N_VALID].sum() > p // 2
    for i in (0, 40000, p - 1):
        one_sums, one_aux = gicp_ops.linearize_sums(*(a[i : i + 1] for a in args))
        assert torch.equal(sums[i : i + 1], one_sums) and torch.equal(aux[i : i + 1], one_aux)
    with pytest.raises(ValueError, match="CUDA tensors on one card required"):
        gicp_ops._linearize_cuda(*(a.to("meta") for a in args), float("inf"))


# --- the fused gicp_align. ---


def _cloud(rng, n):
    pts = np.column_stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                           rng.normal(0, 0.05, n)]).astype(np.float32)
    k = n // 4
    pts[:k, 2] = rng.uniform(0, 5, k)
    pts[:k, 0] = np.round(pts[:k, 0] / 5) * 5 + rng.normal(0, 0.03, k)
    return pts


@pytest.mark.parametrize("gate", [float("inf"), 2.0])
def test_fused_align_matches_reference_and_unfused(gate):
    """tests/test_pallas_gicp.py:25-61's problem: the port's fused
    gicp_align against the reference's fused one and the port's unfused."""
    rng = np.random.default_rng(3)
    tgt = _cloud(rng, 512)
    t_true = np.array([0.4, -0.3, 0.1], np.float32)
    src = (tgt[::2] + rng.normal(0, 0.02, (256, 3)).astype(np.float32)) - t_true
    smask, tmask = np.ones(256, bool), np.ones(512, bool)
    smask[-20:] = False
    tmask[-40:] = False
    jcfg = JaxGicpConfig(num_neighbors=8, max_iterations=8, max_corr_dist_m=gate)
    cfg = config_from_reference(jcfg, GicpConfig)
    init = np.eye(4, dtype=np.float32)

    with mock.patch.object(jax_gicp, "_USE_FUSED_LINEARIZE", True):
        want = jax_gicp.gicp_align(*map(jnp.asarray, (src, smask, tgt, tmask, init)), jcfg)
    args = tuple(T(a)[None] for a in (src, smask, tgt, tmask, init))
    unfused = to_numpy(gicp.gicp_align(*args, cfg))
    before = gicp_ops.LINEARIZE_LAUNCHES
    with mock.patch.object(gicp, "_USE_FUSED_LINEARIZE", True), \
            mock.patch.object(gicp_ops, "linearize_gicp", wraps=gicp_ops.linearize_gicp) as lin:
        fused = to_numpy(gicp.gicp_align(*args, cfg))
    assert 1 <= lin.call_count <= cfg.max_iterations and gicp_ops.LINEARIZE_LAUNCHES == before
    for other in (np.asarray(want.transform), unfused.transform[0]):
        np.testing.assert_allclose(fused.transform[0, :3, 3], other[:3, 3], atol=TRANS_ATOL)
        np.testing.assert_allclose(fused.transform[0, :3, :3], other[:3, :3], atol=ROT_ATOL)
    np.testing.assert_allclose(fused.fitness[0], float(want.fitness), rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(fused.fitness[0], unfused.fitness[0], rtol=0.05, atol=1e-4)
    assert fused.num_inliers[0] == unfused.num_inliers[0]
    np.testing.assert_allclose(fused.transform[0, :3, 3], t_true, atol=0.05)


def test_fused_flag_defaults_off_and_is_read_at_call_time():
    assert gicp._USE_FUSED_LINEARIZE is False and jax_gicp._USE_FUSED_LINEARIZE is False
    rng = np.random.default_rng(8)
    tgt = _cloud(rng, 128)
    args = (T(tgt[::2].copy())[None], torch.ones(1, 64, dtype=torch.bool), T(tgt)[None],
            torch.ones(1, 128, dtype=torch.bool), torch.eye(4)[None],
            GicpConfig(num_neighbors=4, max_iterations=2, optimizer="gn"))
    with mock.patch.object(gicp_ops, "linearize_gicp", wraps=gicp_ops.linearize_gicp) as lin:
        gicp.gicp_align(*args)
        assert lin.call_count == 0
        with mock.patch.object(gicp, "_USE_FUSED_LINEARIZE", True):
            out = gicp.gicp_align(*args)  # Gauss-Newton takes B7 too
        assert 1 <= lin.call_count <= 2 and torch.isfinite(out.transform).all()


# --- the slice as a whole: localize_refined, fused, in both packages. ---


def test_fused_localize_refined_matches_reference(small_config):
    from sgtd_tpu.db.database import tuned_config
    from sgtd_tpu.db.device_build import build_database_calibrated as jax_build_calibrated
    from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
    from sgtd_tpu.match.pipeline import localize_refined as jax_localize_refined
    from sgtd_tpu.match.search import fit_scan_slots
    from sgtd_tpu_torch.data.synthetic import make_map_and_queries, render_planar_cloud
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.interop import db_from_numpy, map_clouds_to_device
    from sgtd_tpu_torch.match.pipeline import localize_refined
    from sgtd_tpu_torch.ops.voxel import load_query_cloud
    from sgtd_tpu_torch.refine.gicp import point_covariances

    jcfg = small_config.replace(gicp=JaxGicpConfig(num_neighbors=8, max_iterations=4, max_corr_dist_m=3.0))
    obs = dict(center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
    maps, queries, world = make_map_and_queries(config_from_reference(jcfg), seed=11, num_map_frames=20,
                                                num_queries=3, **obs)
    rng = np.random.default_rng(77)
    mc, mm = map(np.stack, zip(*(render_planar_cloud(world, p, rng, max_points=512) for p in world.map_poses)))
    qc, qm = map(np.stack, zip(*(
        load_query_cloud((lambda c, m: c[m])(*render_planar_cloud(world, p, rng, max_points=512)), 3.0, 128)
        for p in world.query_poses)))

    # One DB (the reference's) and one set of map covariances (the port's)
    # for both packages, so only the refinement differs.
    fn = jax.jit(jax.vmap(lambda g: jax_build_descriptors(g, jcfg.desc, jcfg.caps)))
    stack = lambda gs: jax.tree_util.tree_map(lambda *xs: np.stack(xs), *gs)
    jdb, jrep, jtot = jax_build_calibrated(
        fn(stack(maps)), np.stack([g.pose for g in maps]), fn(stack(queries)), jcfg.desc, table_slots=1 << 21)
    jcfg = fit_scan_slots(int(np.asarray(jtot).max()), tuned_config(jcfg, jrep))
    cfg = config_from_reference(jcfg)
    db = db_from_numpy(jax.tree_util.tree_map(np.asarray, jdb), "cpu")
    clouds, masks, _ = map_clouds_to_device(mc, mm, None, "cpu", f_pad=db.frame_poses.shape[0])
    covs = point_covariances(clouds, masks, cfg.gicp)

    jax.clear_caches()
    try:
        with mock.patch.object(jax_gicp, "_USE_FUSED_LINEARIZE", True):
            want = [jax.tree_util.tree_map(np.asarray, jax_localize_refined(
                jdb, g, jnp.asarray(qc[i]), jnp.asarray(qm[i]), jnp.asarray(clouds.numpy()),
                jnp.asarray(masks.numpy()), jnp.asarray(covs.numpy()), config=jcfg, rerank_k=2))
                for i, g in enumerate(queries)]
    finally:
        jax.clear_caches()
    with mock.patch.object(gicp, "_USE_FUSED_LINEARIZE", True), \
            mock.patch.object(gicp_ops, "linearize_gicp", wraps=gicp_ops.linearize_gicp) as lin:
        got = to_numpy(localize_refined(db, stack_graphs(queries, "cpu"), T(qc), T(qm), clouds, masks, covs,
                                        config=cfg, rerank_k=2))
    assert lin.call_count >= 1
    np.testing.assert_array_equal(got.result.found, [w.result.found for w in want])
    np.testing.assert_array_equal(got.result.frames, np.stack([w.result.frames for w in want]))
    np.testing.assert_array_equal(got.refined, [w.refined for w in want])
    assert got.result.found.all() and got.refined.any()
    w_pose = np.stack([w.pose for w in want])
    np.testing.assert_allclose(got.pose[:, :3, 3], w_pose[:, :3, 3], atol=TRANS_ATOL)
    np.testing.assert_allclose(got.pose[:, :3, :3], w_pose[:, :3, :3], atol=ROT_ATOL)
    # Same pick: the raw fitness of the picked candidate agrees.
    np.testing.assert_allclose(got.fitness, [w.fitness for w in want], rtol=1e-2)


# --- kernel B8: the plain version against the Pallas kernel. ---


@pytest.mark.parametrize("m,w,l", [(1000, 2, 512), (64, 5, 128)])
def test_gather_rows_plain_matches_pallas(m, w, l):
    rng = np.random.default_rng(m)
    table = rng.integers(0, 1 << 32, (m, w), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, m, l, dtype=np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    got = probe.gather_rows(T(table.view(np.int32)), T(idx))
    assert got.dtype == torch.int32 and got.shape == (l, w) and probe.GATHER_LAUNCHES == 0
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        probe.gather_rows(torch.zeros(4, 2, dtype=torch.int32, device="meta"),
                          torch.zeros(3, dtype=torch.int32, device="meta"))
