"""Candidate search and verification: the port against sgtd_tpu.match.

Both packages search the same DB (the reference's, carried across with
``interop``) with the same query descriptors. Votes, candidates, pair
lists and truncation flags must be equal, including under starved caps.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import build_database, tuned_config
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.match.search import candidate_search as jax_candidate_search
from sgtd_tpu.match.verify import triangle_solver as jax_triangle_solver
from sgtd_tpu.match.verify import verify_pairs as jax_verify_pairs
from sgtd_tpu.ops.linalg3 import kabsch as jax_kabsch
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.match.search import TRUNC_PAIRS, TRUNC_SCAN, candidate_search
from sgtd_tpu_torch.match import localize, localize_batch, triangle_solver
from sgtd_tpu_torch.match.verify import verify_pairs
from sgtd_tpu_torch.ops.linalg3 import kabsch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(small_config):
    cfg = small_config
    maps, queries, _ = make_map_and_queries(
        cfg, seed=13, num_map_frames=24, num_queries=4,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    descs = [jax_build_descriptors(g, cfg.desc, cfg.caps) for g in maps]
    db, report = build_database(descs, [np.asarray(g.pose) for g in maps], cfg.desc, cfg.caps)
    cfg = tuned_config(cfg, report)
    qd = [jax_build_descriptors(g, cfg.desc, cfg.caps) for g in queries]
    q_np = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *qd)
    return cfg, db, qd, interop.db_from_numpy(db, "cpu"), interop.descriptors_from_numpy(q_np, "cpu")


_CASES = {
    "default": {},
    "scan_starved": {"max_scan_slots": 32},  # forces TRUNC_SCAN
    "pairs_saturated": {"hits_per_descriptor": 1},  # forces TRUNC_PAIRS
}


@pytest.mark.parametrize("case", list(_CASES))
def test_candidate_search_matches_reference(world, case):
    cfg, db, qd, tdb, tq = world
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, **_CASES[case]))
    pcfg = interop.config_from_reference(cfg)
    got = candidate_search(tdb, tq, pcfg.desc, pcfg.search, pcfg.caps)
    for i, q in enumerate(qd):
        want = jax_candidate_search(db, q, cfg.desc, cfg.search, cfg.caps)
        for f in want._fields:
            np.testing.assert_array_equal(
                getattr(got, f)[i].numpy(), np.asarray(getattr(want, f)), err_msg=f"query {i} {f}"
            )
    trunc = got.truncated.numpy()
    if case == "default":
        assert (trunc & TRUNC_SCAN == 0).all()
        assert got.valid[:, 0].all()
    elif case == "scan_starved":
        assert (trunc & TRUNC_SCAN).all()
    else:
        assert (trunc & TRUNC_PAIRS).any()


@pytest.mark.parametrize("n_points,weighted", [(3, False), (40, True)])
def test_kabsch_matches_reference(n_points, weighted):
    rng = np.random.default_rng(n_points)
    src = rng.uniform(-30, 30, (512, n_points, 3)).astype(np.float32)
    # Well-shaped point sets only. For a sliver triangle the two largest
    # eigenvalues of the QCP matrix nearly meet, and float32 rounding alone
    # moves the rotation of either implementation by up to 1e-3 (against a
    # float64 solve); parity is held where the problem is well-conditioned.
    sv = np.linalg.svd(src - src.mean(1, keepdims=True), compute_uv=False)
    src = src[sv[:, 1] > 0.3 * sv[:, 0]][:64]
    ang = rng.uniform(-np.pi, np.pi, 64)
    rot = np.zeros((64, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
    rot[:, 2, 2] = 1
    ref = (np.einsum("bij,bnj->bni", rot, src) + rng.normal(0, 20, (64, 1, 3))
           + rng.normal(0, 0.2, src.shape)).astype(np.float32)
    w = (rng.uniform(size=(64, n_points)) > 0.3).astype(np.float32) if weighted else None
    want_r, want_t = jax_kabsch(jnp.asarray(src), jnp.asarray(ref), None if w is None else jnp.asarray(w))
    got_r, got_t = kabsch(torch.from_numpy(src), torch.from_numpy(ref), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-4, rtol=0)


def test_verify_pairs_matches_reference(world):
    """Both sides verify the same vertex triples (gathered by JAX)."""
    cfg, db, qd, _, _ = world
    for q in qd:
        cand = jax_candidate_search(db, q, cfg.desc, cfg.search, cfg.caps)
        vq = np.asarray(q.vertices[cand.pair_qidx])
        vdb = np.asarray(db.vertices[cand.pair_row])
        pv, cv = np.asarray(cand.pair_valid), np.asarray(cand.valid)
        want = jax_verify_pairs(*(jnp.asarray(a) for a in (vq, vdb, pv, cv)), cfg.search)
        got = verify_pairs(*(torch.tensor(a) for a in (vq, vdb, pv, cv)), interop.config_from_reference(cfg).search)
        np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
        np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
        # Transforms of accepted candidates; a rejected one (score -1, often
        # without a single valid pair) carries a degenerate hypothesis that
        # no caller reads.
        ok = np.asarray(want.scores) >= 0
        assert ok.any()
        np.testing.assert_allclose(got.rot.numpy()[ok], np.asarray(want.rot)[ok], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.trans.numpy()[ok], np.asarray(want.trans)[ok], atol=1e-4, rtol=0)


@pytest.mark.parametrize("path", ["bisection", "candidate_major"])
def test_fallback_paths_match_reference(world, path):
    """The search paths of large maps equal the reference's on this world:
    the in-cell bisection of a DB without a bucket table, and
    candidate-major pair extraction above sel_max_scan_slots."""
    cfg, db, qd, tdb, tq = world
    if path == "bisection":  # DB beyond the bucket-table budget
        tdb = tdb._replace(bucket_table=tdb.bucket_table[:0], cell_remap=tdb.cell_remap[:0],
                           code_remap=tdb.code_remap[:0])
        db = db._replace(bucket_table=db.bucket_table[:0], cell_remap=db.cell_remap[:0],
                         code_remap=db.code_remap[:0])
    else:  # scan budget above sel_max_scan_slots
        cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, sel_max_scan_slots=cfg.caps.max_scan_slots - 1))
    pcfg = interop.config_from_reference(cfg)
    got = candidate_search(tdb, tq, pcfg.desc, pcfg.search, pcfg.caps)
    for i, q in enumerate(qd):
        want = jax_candidate_search(db, q, cfg.desc, cfg.search, cfg.caps)
        for f in want._fields:
            np.testing.assert_array_equal(
                getattr(got, f)[i].numpy(), np.asarray(getattr(want, f)), err_msg=f"query {i} {f}"
            )
    assert got.valid[:, 0].all() and got.pair_valid[:, 0].any(-1).all()


def test_triangle_solver_matches_reference():
    """The rigid transform of one triangle onto another (rot @ src + t ~=
    ref): rotations within 1e-5 and translations (tens of metres) within
    1e-4 of the reference's, on well-shaped triangles as in
    test_kabsch_matches_reference. The port's match package exports it and
    ``localize_batch`` (its ``localize``) as the reference's does."""
    rng = np.random.default_rng(8)
    src = rng.uniform(-20, 20, (256, 3, 3)).astype(np.float32)
    sv = np.linalg.svd(src - src.mean(1, keepdims=True), compute_uv=False)
    src = src[sv[:, 1] > 0.3 * sv[:, 0]][:64]
    ang = rng.uniform(-np.pi, np.pi, 64)
    R = np.zeros((64, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang), 1
    ref = (np.einsum("nij,nkj->nki", R, src) + rng.uniform(-50, 50, (64, 1, 3))
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    want_r, want_t = jax_triangle_solver(jnp.asarray(src), jnp.asarray(ref))
    got_r, got_t = triangle_solver(torch.from_numpy(src), torch.from_numpy(ref))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-4)
    assert localize_batch is localize
