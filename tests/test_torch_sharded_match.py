"""The port's DB-sharded localizer against sgtd_tpu's, on the CPU.

tests/test_sharded_match.py's world (seed 11, 24 map frames, 8 queries)
goes through the reference's ``make_sharded_localizer`` on a virtual
4-device mesh and through the port's in one 4-rank gloo world of
subprocesses (``run_world``), at meshes (2, 2), (1, 4) and (4, 1). The
world starts once for the module; each test asserts on its outputs.
"""

import numpy as np
import jax
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import build_database
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.eval.metrics import rpe
from sgtd_tpu.eval.runner import stack_graphs as jax_stack_graphs
from sgtd_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sgtd_tpu.parallel.mesh import shard_database as jax_shard_database
from sgtd_tpu.parallel.sharded_match import make_sharded_localizer as jax_make_sharded_localizer
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.match.pipeline import localize
from sgtd_tpu_torch.parallel.multihost_check import Leg, read_outputs, run_world, write_inputs

torch.set_num_threads(1)

MESHES = [(2, 2), (1, 4), (4, 1)]
LEGS = {m: f"sharded:{m[0]}x{m[1]}" for m in MESHES}


@pytest.fixture(scope="module")
def outputs(small_config, tmp_path_factory):
    cfg = small_config
    maps, queries, _ = make_map_and_queries(
        cfg, seed=11, num_map_frames=24, num_queries=8, center_noise_m=0.05, dropout=0.1,
    )
    descs = [jax_build_descriptors(g, cfg.desc, cfg.caps) for g in maps]
    db, _ = build_database(descs, [np.asarray(g.pose) for g in maps], cfg.desc, cfg.caps)
    batch = jax_stack_graphs(queries)
    want = {}
    for dp, dbx in MESHES:
        mesh = jax_make_mesh(dp=dp, db=dbx, devices=jax.devices()[:4])
        res = jax_make_sharded_localizer(mesh, cfg)(jax_shard_database(db, mesh), batch)
        want[dp, dbx] = {f: np.asarray(v) for f, v in res._asdict().items()}

    pcfg = interop.config_from_reference(cfg)
    tdb = interop.db_from_numpy(db, "cpu")
    tq = interop.graph_from_numpy(batch, "cpu")
    single = localize(tdb, tq, pcfg)
    d = tmp_path_factory.mktemp("sharded_world")
    write_inputs(d, db=tdb, graphs=tq, config=pcfg)
    summary = run_world(4, "gloo", "cpu", d, list(LEGS.values()), timeout=300)
    got = {m: read_outputs(d / "out", leg) for m, leg in LEGS.items()}
    return want, got, single, summary, [np.asarray(g.pose) for g in queries]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_candidates_equal_reference(outputs, mesh):
    want, got, *_ = outputs
    for f in ("votes", "frames", "found", "best_frame", "truncated", "scores"):
        np.testing.assert_array_equal(got[mesh][f], want[mesh][f], err_msg=f)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_transforms_close_to_reference(outputs, mesh):
    want, got, *_ = outputs
    ok = want[mesh]["scores"] >= 0  # accepted candidates; a rejected one's transform is read by no caller
    assert ok.any()
    np.testing.assert_allclose(got[mesh]["rot"][ok], want[mesh]["rot"][ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[mesh]["trans"][ok], want[mesh]["trans"][ok], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[mesh]["poses"][ok], want[mesh]["poses"][ok], rtol=0, atol=1e-3)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_votes_equal_single_device(outputs, mesh):
    """The psum over shards reproduces the whole DB's tally exactly, and
    both localize every query to the same place (test_sharded_match.py's
    gates)."""
    _, got, single, _, gts = outputs
    np.testing.assert_array_equal(np.sort(got[mesh]["votes"], -1), np.sort(single.votes.numpy(), -1))
    np.testing.assert_array_equal(got[mesh]["found"], single.found.numpy())
    for i, gt in enumerate(gts):
        for est in (single.poses[i, 0].numpy(), got[mesh]["poses"][i, 0]):
            t_err, r_err = rpe(gt, est)
            assert t_err < 2.0 and r_err < 5.0, (i, t_err, r_err)


def test_world_summary(outputs):
    """Rank 0's summary: every rank of every mesh ran its queries on the
    CPU (no kernel), and no rank loaded JAX or the JAX package."""
    *_, summary, _ = outputs
    assert summary["world"] == 4 and summary["backend"] == "gloo" and summary["foreign_modules"] == []
    for (dp, dbx), leg in LEGS.items():
        ranks = summary["legs"][Leg.parse(leg).name]
        assert [r["queries"] for r in ranks] == [8 // dp] * 4
        assert all(r["launches"] == [0] * 8 for r in ranks)
        # Collectives: the vote psum and TRUNC pmax, the three gathers
        # (none on a 1-rank db dim).
        assert all(r["collective_calls"] == (5 if dbx > 1 else 0) for r in ranks)


def _bench_queries(qall, n):
    return type(qall)(*(x[:n] for x in qall))


@pytest.mark.slow
def test_reference_sharded():
    """REFERENCE_SHARDED, which chip_smoke.py holds the card's 8-rank
    (2, 4) run to, is what sgtd_tpu's sharded localizer gives on the CPU's
    8 virtual devices: phase 3's bench world (200 keyframes, 64 queries,
    seed 2026, scan budget fitted to the first 16), its first 16 queries."""
    import chip_smoke as cs
    from sgtd_tpu.eval.benchworld import build_bench_world as jax_build_bench_world

    cfg, db, qall, report, _ = jax_build_bench_world(num_map=cs.NUM_MAP, num_q=cs.NUM_QUERIES, seed=cs.SEED,
                                                     calibrate_n=cs.N_SAMPLE)
    mesh = jax_make_mesh(dp=2, db=4)
    res = jax_make_sharded_localizer(mesh, cfg)(jax_shard_database(db, mesh), _bench_queries(qall, cs.SHARDED_QUERIES))
    assert not (np.asarray(res.truncated) & 1).any()
    got = {"rows": report.num_rows, "sha256": cs.found_frames_sha256(res.found, res.best_frame)}
    assert got == cs.REFERENCE_SHARDED


@pytest.mark.slow
def test_bench_world_votes_bit_identical(tmp_path):
    """The port's 8-rank (2, 4) gloo world on the bench world: each
    query's votes equal the single-device pipeline's bit for bit (buckets
    split across shard boundaries included), no vote is lost, and the
    found flags agree (test_sharded_benchscale.py's gates)."""
    import chip_smoke as cs
    from sgtd_tpu_torch.eval.benchworld import build_bench_world

    cfg, db, qall, report, _ = build_bench_world(num_map=cs.NUM_MAP, num_q=cs.NUM_QUERIES, seed=cs.SEED,
                                                 calibrate_n=cs.N_SAMPLE, device="cpu")
    q = _bench_queries(qall, cs.SHARDED_QUERIES)
    single = localize(db, q, cfg)
    write_inputs(tmp_path, db=db, graphs=q, config=cfg)
    run_world(8, "gloo", "cpu", tmp_path, ["sharded:2x4"], timeout=1800)
    got = read_outputs(tmp_path / "out", "sharded:2x4")
    assert report.num_rows == cs.REFERENCE_SHARDED["rows"]
    assert not (got["truncated"] & 1).any() and not (single.truncated.numpy() & 1).any()
    np.testing.assert_array_equal(np.sort(got["votes"], -1), np.sort(single.votes.numpy(), -1))
    np.testing.assert_array_equal(got["found"], single.found.numpy())
