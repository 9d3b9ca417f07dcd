"""The port's evaluation layer against sgtd_tpu on the CPU: the config
copy, ``EvalAccumulator``, the map artifacts (build, save, load) and
``evaluate`` (descriptor-only, refined, the TRUNC_SCAN fallback).

Inputs come from NumPy seeds and go to both packages. Counts, rates and
recalls are equal. The descriptor-only pose errors agree within 1e-3 m /
1e-2 deg and the refined ones within 5e-3 m / 5e-2 deg: the RMSEs average
float32 poses whose LM steps torch and XLA sum in other orders
(tests/test_torch_refined.py states the per-pose tolerance, 5e-3 m).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu import config as jax_config
from sgtd_tpu.data.synthetic import make_map_and_queries, render_planar_cloud
from sgtd_tpu.db import artifacts as jax_artifacts
from sgtd_tpu.eval import metrics as jax_metrics
from sgtd_tpu.eval import runner as jax_runner
from sgtd_tpu.ops.voxel import load_query_cloud
from sgtd_tpu_torch import config, interop
from sgtd_tpu_torch.db import artifacts
from sgtd_tpu_torch.eval import metrics, runner
from sgtd_tpu_torch.match.search import TRUNC_SCAN

torch.set_num_threads(1)

OBS = dict(center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
TIMING_KEYS = ("mean_time_ms", "map_build_seconds", "compile_seconds", "artifact_build_seconds",
               "query_cloud_load_seconds")
EXACT_KEYS = ("total", "success_rate", "recall_at_1", "recall_at_5", "recall_at_10", "db_rows")


# --- (e) the config copy. ---

CONFIG_CLASSES = ("DescriptorConfig", "SearchConfig", "CapacityConfig", "GicpConfig", "DcvcConfig", "SGTDConfig")


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_equal_reference(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert ours is not theirs and ours.__module__ == "sgtd_tpu_torch.config"
    a, b = dataclasses.fields(ours), dataclasses.fields(theirs)
    assert [f.name for f in a] == [f.name for f in b]
    flat = lambda c: {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
                      for k, v in ((f.name, getattr(c, f.name)) for f in dataclasses.fields(c))}
    assert flat(ours()) == flat(theirs())
    assert interop.config_from_reference(theirs(), ours) == ours()


def test_config_from_reference_round_trips_every_field():
    """Every field of every part set to a non-default value crosses."""
    def bumped(cls):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(cls(), f.name)
            if isinstance(v, bool):
                kw[f.name] = not v
            elif isinstance(v, (int, float)):
                kw[f.name] = v * 2 + 1
            elif isinstance(v, str):
                kw[f.name] = v + "_x"
        return kw

    parts = {"desc": "DescriptorConfig", "search": "SearchConfig", "caps": "CapacityConfig",
             "gicp": "GicpConfig", "dcvc": "DcvcConfig"}
    top = bumped(jax_config.SGTDConfig)
    ref = jax_config.SGTDConfig(**{k: getattr(jax_config, n)(**bumped(getattr(jax_config, n)))
                                   for k, n in parts.items()}, **top)
    got = interop.config_from_reference(ref)
    assert type(got) is config.SGTDConfig and got != config.SGTDConfig()
    for k, n in parts.items():
        part = getattr(got, k)
        assert type(part) is getattr(config, n)
        assert dataclasses.asdict(part) == dataclasses.asdict(getattr(ref, k)), k
    assert {k: getattr(got, k) for k in top} == top
    assert got.gicp.fitness_radius == ref.gicp.fitness_radius and got.desc.scale == ref.desc.scale
    assert got.replace(success_trans_m=1.0).success_trans_m == 1.0
    assert config.DEFAULT_CONFIG == config.SGTDConfig()


# --- (c) EvalAccumulator. ---


def _poses(rng, n, rot, trans):
    from sgtd_tpu.geom import se3 as jax_se3

    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    out[:, :3, :3] = np.asarray(jax_se3.so3_exp(jnp.asarray(rng.normal(0, rot, (n, 3)).astype(np.float32))))
    out[:, :3, 3] = rng.normal(0, trans, (n, 3))
    return out


def test_eval_accumulator_matches_reference():
    rng = np.random.default_rng(21)
    n, c = 40, 12
    gt = _poses(rng, n, 0.5, 30.0)
    # Estimates around the truth: some beyond the 5 m / 10 deg gate; the
    # candidate lists put the first pose within 10 m at varying ranks.
    est = gt @ _poses(rng, n, 0.08, 3.0)
    cands = gt[:, None] @ _poses(rng, n * c, 0.1, 9.0).reshape(n, c, 4, 4)
    cfg = config.SGTDConfig().replace(search=config.SearchConfig(candidate_num=c))
    jcfg = jax_config.SGTDConfig().replace(search=jax_config.SearchConfig(candidate_num=c))
    ours, theirs = metrics.EvalAccumulator(cfg), jax_metrics.EvalAccumulator(jcfg)
    assert ours.summary() == pytest.approx(theirs.summary(), nan_ok=True)  # empty: NaNs alike
    for i in range(n):
        kw = dict(cand_poses=cands[i] if i % 5 else None, time_ms=float(i))
        ours.add(gt[i], est[i], **kw)
        theirs.add(gt[i], est[i], **kw)
    got, want = ours.summary(), theirs.summary()
    assert got == want and list(got) == list(want)
    assert 0 < got["success_rate"] < 1 and got["recall_at_1"] < got["recall_at_10"] <= 1
    assert metrics.rmse([3.0, 4.0]) == jax_metrics.rmse([3.0, 4.0]) and np.isnan(metrics.rmse([]))


# --- (c) the map artifacts. ---

GCFG = config.GicpConfig(enable=True, num_neighbors=8, max_iterations=4, max_points=128)
JGCFG = jax_config.GicpConfig(enable=True, num_neighbors=8, max_iterations=4, max_points=128)


@pytest.fixture(scope="module")
def small_world(small_config):
    """20 keyframes and 6 queries with 512-point planar clouds; the
    reference's map index and artifacts (frame axis padded to the DB's)."""
    cfg = small_config
    maps, queries, world = make_map_and_queries(cfg, seed=13, num_map_frames=20, num_queries=6, **OBS)

    def m_fn(fid):
        if fid >= len(world.map_poses):  # a padding row of the DB's frame axis
            return np.zeros((512, 3), np.float32), np.zeros(512, bool)
        return render_planar_cloud(world, world.map_poses[fid], np.random.default_rng(8000 + fid), max_points=512)

    def q_fn(i):
        pts, m = render_planar_cloud(world, world.query_poses[i], np.random.default_rng(7000 + i), max_points=512)
        return load_query_cloud(pts[m], 3.0, 128)

    jindex = jax_runner.build_map_index(maps, cfg)
    f_pad = jindex.db.frame_poses.shape[0]
    jart = jax_artifacts.build_map_artifacts(m_fn, 20, JGCFG, f_pad=f_pad + 4)
    return cfg, maps, queries, m_fn, q_fn, jindex, jart


def test_build_map_artifacts_matches_reference(small_world):
    *_, m_fn, _, jindex, jart = small_world
    f_pad = jindex.db.frame_poses.shape[0] + 4
    art = artifacts.build_map_artifacts(m_fn, 20, GCFG, f_pad=f_pad, batch=8, device="cpu")
    assert art.vmaps is None and art.clouds.shape == (f_pad, 512, 3) and art.covs.shape == (f_pad, 512, 3, 3)
    np.testing.assert_array_equal(art.clouds.numpy(), np.asarray(jart.clouds))
    np.testing.assert_array_equal(art.masks.numpy(), np.asarray(jart.masks))
    # The tolerance of tests/test_torch_gicp.py: float32 Cardano near r = 1
    # on a few points.
    err = np.abs(art.covs.numpy() - np.asarray(jart.covs)).max(axis=(-2, -1))
    assert (err > 2e-4).mean() <= 1e-3 and err.max() <= 1e-2, np.sort(err.ravel())[-5:]
    assert not art.masks[20:].any() and torch.equal(art.covs[20:], torch.eye(3).expand(f_pad - 20, 512, 3, 3))
    # The VGICP engine's artifacts carry voxel maps too (held to the
    # reference's in tests/test_torch_vgicp_eval.py).
    vart = artifacts.build_map_artifacts(m_fn, 2, dataclasses.replace(GCFG, engine="vgicp"), device="cpu")
    assert vart.vmaps is not None and vart.vmaps.keys.shape == (2, 512)
    assert artifacts.gicp_fingerprint(GCFG) == jax_artifacts.gicp_fingerprint(JGCFG)
    # Across packages in memory.
    crossed = interop.map_artifacts_from_numpy(jax.tree_util.tree_map(np.asarray, jart), "cpu")
    assert crossed.vmaps is None and crossed.masks.dtype == torch.bool
    back = interop.map_artifacts_to_numpy(crossed)
    np.testing.assert_array_equal(back["covs"], np.asarray(jart.covs))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_artifacts_files_cross_packages(small_world, tmp_path, writer):
    """A file written by either package loads in the other."""
    *_, jart = small_world
    art = interop.map_artifacts_from_numpy(jax.tree_util.tree_map(np.asarray, jart), "cpu")
    path = str(tmp_path / "art.npz")
    n = art.clouds.shape[0]
    if writer == "port":
        artifacts.save_map_artifacts(path, art, GCFG)
        got = jax_artifacts.load_map_artifacts(path, expect_frames=n, expect_gicp=JGCFG)
        got = jax.tree_util.tree_map(np.asarray, got)
    else:
        jax_artifacts.save_map_artifacts(path, jart, JGCFG)
        loaded = artifacts.load_map_artifacts(path, expect_frames=n, expect_gicp=GCFG, device="cpu")
        assert loaded.clouds.device.type == "cpu"
        got = interop.map_artifacts_to_numpy(loaded)
        got = jax_artifacts.MapArtifacts(**got)
    assert got.vmaps is None
    for f in ("clouds", "masks", "covs"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(jart, f)), err_msg=f)


def test_artifacts_file_with_voxel_maps_loads_without_them(small_world, tmp_path):
    """A file without vmap_* fields loads with vmaps None; one with them
    (the reference's VGICP artifacts) loads with its voxel maps."""
    *_, jart = small_world
    fields = dict(format_version=np.int32(2), clouds=np.asarray(jart.clouds), masks=np.asarray(jart.masks),
                  covs=np.asarray(jart.covs))
    path = str(tmp_path / "art.npz")
    np.savez_compressed(path, **fields)
    art = artifacts.load_map_artifacts(path, device="cpu")
    assert art.vmaps is None and art.covs.shape == jart.covs.shape
    f = jart.clouds.shape[0]
    vm = dict(keys=np.full((f, 4), 2**31 - 1, np.int32), mean=np.zeros((f, 4, 3), np.float32),
              cov=np.zeros((f, 4, 3, 3), np.float32), n=np.zeros((f, 4), np.float32),
              resolution=np.ones(f, np.float32))
    np.savez_compressed(path, **fields, **{f"vmap_{k}": v for k, v in vm.items()})
    art = artifacts.load_map_artifacts(path, device="cpu")
    assert art.covs.shape == jart.covs.shape
    for k, v in vm.items():
        np.testing.assert_array_equal(getattr(art.vmaps, k).numpy(), v)


@pytest.mark.parametrize("case", ["format", "frames", "fingerprint", "validate"])
def test_artifacts_errors(small_world, tmp_path, case):
    *_, jindex, jart = small_world
    art = interop.map_artifacts_from_numpy(jax.tree_util.tree_map(np.asarray, jart), "cpu")
    path = str(tmp_path / "a.npz")
    artifacts.save_map_artifacts(path, art, GCFG)
    n = art.clouds.shape[0]
    if case == "format":
        np.savez_compressed(path, format_version=np.int32(7), clouds=art.clouds.numpy(),
                            masks=art.masks.numpy(), covs=art.covs.numpy())
        with pytest.raises(ValueError, match="format v7 is incompatible"):
            artifacts.load_map_artifacts(path, device="cpu")
    elif case == "frames":
        with pytest.raises(ValueError, match=f"cover {n} .padded. keyframes but the DB has {n + 1}"):
            artifacts.load_map_artifacts(path, expect_frames=n + 1, device="cpu")
    elif case == "fingerprint":
        with pytest.raises(ValueError, match="built under GICP params"):
            artifacts.load_map_artifacts(path, expect_gicp=dataclasses.replace(GCFG, num_neighbors=9), device="cpu")
    else:
        index = interop.map_index_from_reference(jindex, "cpu")
        with pytest.raises(ValueError, match="the DB was rebuilt"):
            artifacts.validate_map_artifacts(art, index.db, GCFG)  # f_pad + 4 rows
        ok = art._replace(clouds=art.clouds[:-4], masks=art.masks[:-4], covs=art.covs[:-4])
        artifacts.validate_map_artifacts(ok, index.db, GCFG)
        with pytest.raises(ValueError, match="needs vmaps or covs"):
            artifacts.validate_map_artifacts(ok._replace(covs=None), index.db, dataclasses.replace(GCFG, engine="vgicp"))


# --- (c) evaluate. ---


def _assert_summaries_close(got, want, trans_atol, rot_atol):
    assert list(got) == list(want)
    for k in EXACT_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("rmse_trans_m", "mean_trans_m"):
        assert abs(got[k] - want[k]) <= trans_atol, (k, got[k], want[k])
    for k in ("rmse_rot_deg", "mean_rot_deg"):
        assert abs(got[k] - want[k]) <= rot_atol, (k, got[k], want[k])
    assert all(np.isfinite(got[k]) and got[k] >= 0 for k in TIMING_KEYS)


def test_build_map_index_matches_reference(small_world):
    cfg, maps, *_, jindex, _ = small_world
    index = runner.build_map_index(maps, interop.config_from_reference(cfg), device="cpu")
    assert type(index.config) is config.SGTDConfig
    assert index.config == interop.config_from_reference(jindex.config)
    assert dataclasses.asdict(index.report) == dataclasses.asdict(jindex.report)
    want = jax.tree_util.tree_map(np.asarray, jindex.db)
    got = interop.db_to_numpy(index.db)
    for f in want._fields:
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)
    crossed = interop.map_index_from_reference(jindex, "cpu")
    assert crossed.config == index.config and crossed.report == index.report
    assert torch.equal(crossed.db.packed2, index.db.packed2)


def test_evaluate_descriptor_only_matches_reference(small_world):
    cfg, _, queries, _, _, jindex, _ = small_world
    index = interop.map_index_from_reference(jindex, "cpu")
    want = jax_runner.evaluate(jindex, queries, batch_size=4)  # 6 queries: a padded chunk
    got = runner.evaluate(index, queries, batch_size=4)
    _assert_summaries_close(got, want, 1e-3, 1e-2)
    assert got["success_rate"] == 1.0 and got["total"] == 6 and got["artifact_build_seconds"] == 0.0
    # Ground truth given apart: a 20 m offset fails every query alike.
    off = [np.asarray(g.pose) @ np.array([[1, 0, 0, 20.0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
           for g in queries]
    assert runner.evaluate(index, queries[:2], batch_size=2, gt_poses=off)["success_rate"] == 0.0


def test_evaluate_refined_matches_reference(small_world):
    cfg, _, queries, m_fn, q_fn, jindex, jart = small_world
    jidx = dataclasses.replace(jindex, config=jindex.config.replace(gicp=JGCFG))
    index = interop.map_index_from_reference(jidx, "cpu")
    assert index.config.gicp == GCFG
    n = jindex.db.frame_poses.shape[0]
    jart = jax.tree_util.tree_map(lambda x: x[:n], jart)
    art = interop.map_artifacts_from_numpy(jax.tree_util.tree_map(np.asarray, jart), "cpu")
    kw = dict(batch_size=3, query_cloud_fn=q_fn, rerank_k=2)
    want = jax_runner.evaluate(jidx, queries, map_artifacts=jart, **kw)
    got = runner.evaluate(index, queries, map_artifacts=art, **kw)
    _assert_summaries_close(got, want, 5e-3, 5e-2)
    # The rerank moved the poses: not the descriptor-only summary.
    desc = runner.evaluate(dataclasses.replace(index, config=index.config.replace(
        gicp=dataclasses.replace(GCFG, enable=False))), queries, batch_size=3)
    assert abs(desc["rmse_trans_m"] - got["rmse_trans_m"]) > 1e-2
    # Artifacts built inside from map_cloud_fn: the same summary, timed.
    own = runner.evaluate(index, queries, map_cloud_fn=m_fn, **kw)
    assert own["artifact_build_seconds"] > 0
    _assert_summaries_close({**own, "artifact_build_seconds": 0.0}, {**got, "artifact_build_seconds": 0.0}, 5e-3, 5e-2)
    # Stale artifacts are refused.
    with pytest.raises(ValueError, match="the DB was rebuilt"):
        runner.evaluate(index, queries, map_artifacts=art._replace(clouds=art.clouds[:-1]), **kw)


@pytest.mark.parametrize("refined", [False, True])
def test_evaluate_fallback_on_truncated_queries(small_world, refined):
    """tests/test_truncation.py:217's case: a starved scan cap alone would
    lose votes; localize_exact (and, refined, _rerank_single) restores the
    accuracy."""
    from unittest import mock

    cfg, _, queries, m_fn, q_fn, jindex, jart = small_world
    index = interop.map_index_from_reference(jindex, "cpu")
    caps = dataclasses.replace(index.config.caps, max_scan_slots=32)
    index.config = index.config.replace(caps=caps, gicp=GCFG if refined else index.config.gicp)
    n = index.db.frame_poses.shape[0]
    art = interop.map_artifacts_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x[:n]), jart), "cpu")
    kw = dict(query_cloud_fn=q_fn, map_artifacts=art, rerank_k=2) if refined else {}
    with mock.patch.object(runner, "localize_exact", wraps=runner.localize_exact) as exact, \
            mock.patch.object(runner, "_rerank_single", wraps=runner._rerank_single) as rerank:
        out = runner.evaluate(index, queries[:3], batch_size=2, **kw)
    assert out["success_rate"] == 1.0, out
    assert exact.call_count == 3 and rerank.call_count == (3 if refined else 0)
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.match.pipeline import localize

    starved = localize(index.db, stack_graphs(queries[:3], "cpu"), index.config)
    assert ((starved.truncated & TRUNC_SCAN) != 0).all()


def test_evaluate_reproduces_the_reference_faults(small_world):
    """ROADMAP section 3: IndexError on an empty query list, and GICP in
    _rerank_single when the artifacts carry no voxel maps, whatever the
    engine."""
    cfg, _, queries, _, q_fn, jindex, jart = small_world
    index = interop.map_index_from_reference(jindex, "cpu")
    with pytest.raises(IndexError):
        runner.evaluate(index, [])
    with pytest.raises(IndexError):
        jax_runner.evaluate(jindex, [])
    from sgtd_tpu_torch.graph.types import stack_graphs
    from sgtd_tpu_torch.match.pipeline import localize

    n = index.db.frame_poses.shape[0]
    art = interop.map_artifacts_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x[:n]), jart), "cpu")
    res = localize(index.db, stack_graphs(queries[:1], "cpu"), index.config)
    one = type(res)(*(v[0] for v in interop.to_numpy(res)))
    qc, qm = (torch.from_numpy(a) for a in q_fn(0))
    poses = {}
    for engine in ("gicp", "vgicp"):
        # The guard opened wide, so that the pick always takes a refinement.
        c = index.config.replace(gicp=dataclasses.replace(
            GCFG, engine=engine, max_refine_shift_m=100.0, max_refine_rot_deg=180.0))
        poses[engine] = runner._rerank_single(index, c, one, qc, qm, art, 2, one.poses[0].copy())
    np.testing.assert_array_equal(poses["gicp"], poses["vgicp"])
    assert np.abs(poses["gicp"] - one.poses[0]).max() > 1e-4  # a refinement, not the input
    lost = one._replace(found=np.bool_(False))
    assert runner._rerank_single(index, index.config, lost, qc, qm, art, 2, None) is None


# --- (d) the pinned reference of chip_smoke.py's hard world. ---


@pytest.mark.slow
def test_reference_hard_world():
    """REFERENCE_HARD, the descriptor-only leg that chip_smoke.py holds the
    card's hard-world run to, is what sgtd_tpu gives on the CPU: the
    world of tools/hard_eval.py through build_map_index, evaluate and
    per-query ``localize``; some minutes on a CPU."""
    import chip_smoke as cs
    from sgtd_tpu.data.synthetic import make_hard_world, observe
    from sgtd_tpu.match.pipeline import localize as jax_localize

    rng = np.random.default_rng(cs.HARD_SEED)
    cfg = jax_config.SGTDConfig()
    world = make_hard_world(rng, num_map_frames=cs.NUM_MAP, num_queries=cs.NUM_QUERIES,
                            n_motifs=cs.HARD_MOTIFS, unique_per_block=cs.HARD_UNIQUE)
    maps = [observe(world, p, cfg, rng, center_noise_m=0.05) for p in world.map_poses]
    queries = [observe(world, p, cfg, rng, **cs.HARD_OBS) for p in world.query_poses]
    index = jax_runner.build_map_index(maps, cfg)
    out = jax_runner.evaluate(index, queries, batch_size=cs.CHUNK)
    res = [jax_localize(index.db, g, index.config) for g in queries]
    got = {
        "rows": index.report.num_rows,
        "success_rate": out["success_rate"],
        "sha256": cs.found_frames_sha256([bool(r.found) for r in res], [int(r.best_frame) for r in res]),
    }
    assert got == cs.REFERENCE_HARD
