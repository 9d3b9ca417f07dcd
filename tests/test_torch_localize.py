"""The port's descriptor-only localization slice against sgtd_tpu, end to end.

Same seed -> bit-identical synthetic graphs; the port then builds its own
descriptors and DB and localizes every query in one batch, and the result
is held against the reference's ``localize`` per query.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries as jax_make_map_and_queries
from sgtd_tpu.db.database import tuned_config
from sgtd_tpu.db.device_build import build_database_calibrated as jax_build_calibrated
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.match.pipeline import localize as jax_localize
from sgtd_tpu.match.search import fit_scan_slots
from sgtd_tpu_torch.data.synthetic import make_map_and_queries
from sgtd_tpu_torch.db.device_build import build_database_calibrated
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.eval.metrics import success_rate
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.interop import config_from_reference
from sgtd_tpu_torch.match.pipeline import localize
from sgtd_tpu_torch.match.search import TRUNC_SCAN

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OBS = dict(center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
TABLE_SLOTS = 1 << 21


def test_world_generator_is_bit_identical(small_config):
    want = jax_make_map_and_queries(small_config, seed=7, num_map_frames=24, num_queries=8, **OBS)
    got = make_map_and_queries(small_config, seed=7, num_map_frames=24, num_queries=8, **OBS)
    for gs, ws in zip(got[:2], want[:2]):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            for f in w._fields:
                a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("instance_xyz", "instance_label", "map_poses", "query_poses", "instance_yaw", "instance_size"):
        np.testing.assert_array_equal(getattr(got[2], f), getattr(want[2], f), err_msg=f)


@pytest.fixture(scope="module")
def results(small_config):
    cfg = small_config
    maps, queries, _ = make_map_and_queries(cfg, seed=7, num_map_frames=24, num_queries=8, **OBS)
    # Reference: JAX descriptors and DB, one localize per query.
    fn = jax.jit(jax.vmap(lambda g: jax_build_descriptors(g, cfg.desc, cfg.caps)))
    stack = lambda gs: jax.tree_util.tree_map(lambda *xs: np.stack(xs), *gs)
    poses = np.stack([g.pose for g in maps])
    jdb, jrep, jtot = jax_build_calibrated(
        fn(stack(maps)), poses, fn(stack(queries[:4])), cfg.desc, table_slots=TABLE_SLOTS
    )
    jcfg = fit_scan_slots(int(np.asarray(jtot).max()), tuned_config(cfg, jrep))
    want = [jax.tree_util.tree_map(np.asarray, jax_localize(jdb, g, jcfg)) for g in queries]
    # Port: its own config type, descriptors and DB, all queries in one batch.
    pcfg = config_from_reference(cfg)
    mb, qb = stack_graphs(maps, "cpu"), stack_graphs(queries, "cpu")
    db, rep, tot = build_database_calibrated(
        build_descriptors(mb, pcfg.desc, pcfg.caps), mb.pose,
        build_descriptors(stack_graphs(queries[:4], "cpu"), pcfg.desc, pcfg.caps),
        pcfg.desc, table_slots=TABLE_SLOTS,
    )
    tcfg = fit_scan_slots(int(tot.max()), tuned_config(pcfg, rep))
    assert tcfg == config_from_reference(jcfg) and type(tcfg) is type(pcfg)
    got = localize(db, qb, tcfg)
    return queries, tcfg, want, got


def test_localize_integer_outputs_match_reference(results):
    queries, cfg, want, got = results
    for f in ("found", "best_frame", "frames", "votes", "truncated", "num_descriptors"):
        w = np.stack([getattr(r, f) for r in want])
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)
    assert got.found.all() and not (got.truncated.numpy() & TRUNC_SCAN).any()
    sr = success_rate([g.pose for g in queries], got.poses[:, 0].numpy(), got.found.numpy(), cfg)
    assert sr == 1.0


def test_localize_scores_and_poses_match_reference(results):
    _, _, want, got = results
    w_scores = np.stack([r.scores for r in want])
    g_scores = got.scores.numpy()
    off = np.abs(g_scores - w_scores)
    assert off.max() <= 1 and (off > 0).mean() <= 0.02, (
        "scores may differ by one inlier on at most 2% of candidates: the f32 "
        "Kabsch hypotheses of XLA and torch differ by ulps, so a vertex on "
        f"the 3 m gate can flip (max {off.max()}, share {(off > 0).mean():.4f})"
    )
    # Poses of accepted candidates (rejected ones carry unused hypotheses).
    ok = (w_scores >= 0) & (g_scores >= 0)
    w_poses = np.stack([r.poses for r in want])[ok].astype(np.float64)
    g_poses = got.poses.numpy()[ok].astype(np.float64)
    np.testing.assert_allclose(g_poses[:, :3, 3], w_poses[:, :3, 3], atol=1e-3, rtol=0)
    # Angle of R_want^T R_got from its skew part (sin of the angle): the
    # arccos-of-trace form turns float32 rounding into 1e-4-rad noise.
    rel = np.einsum("nji,njk->nik", w_poses[:, :3, :3], g_poses[:, :3, :3])
    skew = rel - np.swapaxes(rel, 1, 2)
    ang = np.arcsin(np.clip(np.linalg.norm(skew[:, [2, 0, 1], [1, 2, 0]], axis=1) / 2, 0, 1))
    assert ang.max() < 1e-4, ang.max()


def test_port_imports_no_jax():
    """The port runs where JAX is absent: importing it, building a graph
    from a labeled cloud, localizing and the back end (PGO, BA, the
    session correction) must load no jax module and no sgtd_tpu module at
    all."""
    code = """
import sys
import torch
from sgtd_tpu_torch.config import CapacityConfig, SGTDConfig
from sgtd_tpu_torch.data.synthetic import make_map_and_queries
from sgtd_tpu_torch.db.database import tuned_config
from sgtd_tpu_torch.db.device_build import build_database_calibrated
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.match.pipeline import localize
from sgtd_tpu_torch.match.search import fit_scan_slots
torch.set_num_threads(1)
cfg = SGTDConfig().replace(caps=CapacityConfig(max_nodes=32, max_descriptors=128))
maps, queries, _ = make_map_and_queries(cfg, seed=1, num_map_frames=6, num_queries=2)
mb, qb = stack_graphs(maps, "cpu"), stack_graphs(queries, "cpu")
md, qd = build_descriptors(mb, cfg.desc, cfg.caps), build_descriptors(qb, cfg.desc, cfg.caps)
db, rep, tot = build_database_calibrated(md, mb.pose, qd, cfg.desc, table_slots=1 << 20)
res = localize(db, qb, fit_scan_slots(int(tot.max()), tuned_config(cfg, rep)))
assert res.frames.shape == (2, 8)
import numpy as np
from sgtd_tpu_torch.config import DcvcConfig
from sgtd_tpu_torch.graph.build import build_graph
from sgtd_tpu_torch.graph.local_map import merge_scans
from sgtd_tpu_torch.match.graph_match import graph_match
from sgtd_tpu_torch.match.lapjv import lapjv
pts = torch.from_numpy(np.random.default_rng(0).normal(5.0, 0.2, (256, 3)).astype(np.float32))
g = build_graph(pts, torch.full((256,), 17, dtype=torch.int32), torch.zeros(256, dtype=torch.int32),
                torch.ones(256, dtype=torch.bool), np.eye(4), cfg.caps,
                DcvcConfig(max_points=256, max_voxels=256, max_clusters=8))
assert int(g.mask.sum()) == 1
assert graph_match(*(x[0] for x in mb[:4]), *(x[0] for x in mb[:4])).matches.shape == (32,) and lapjv(np.eye(3))[2] == 0.0
from sgtd_tpu_torch.backend.ba import optimize_ba_cg
from sgtd_tpu_torch.backend.pgo import chain_with_loops, optimize_pose_graph_cg
from sgtd_tpu_torch.slam import localize_and_optimize_session
odom = mb.pose[:4]
pg = chain_with_loops(odom, torch.tensor([3]), torch.tensor([0]), (torch.linalg.inv(odom[3]) @ odom[0])[None], torch.ones(1))
assert bool(torch.isfinite(optimize_pose_graph_cg(pg, iterations=1, cg_iterations=3)).all())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgtd_tpu"))
print("BAD", bad)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
