"""The port's ring-sweep localizer against sgtd_tpu's, on the CPU.

tests/test_ring_sweep.py's world (seed 13, 24 map frames, 8 queries)
goes through the reference's ``make_ring_localizer`` on a virtual
4-device ("dp", "db") mesh of shape (4, 1), DB rows in four blocks along
"dp", and through the port's in one 4-rank gloo world of subprocesses
(``run_world``), started once for the module.
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import DescriptorDB, build_database
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.eval.metrics import rpe
from sgtd_tpu.eval.runner import stack_graphs as jax_stack_graphs
from sgtd_tpu.parallel.ring_sweep import make_ring_localizer as jax_make_ring_localizer
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.match.pipeline import localize
from sgtd_tpu_torch.parallel.mesh import ROW_FIELDS
from sgtd_tpu_torch.parallel.multihost_check import read_outputs, run_world, write_inputs

torch.set_num_threads(1)

N = 4


@pytest.fixture(scope="module")
def outputs(small_config, tmp_path_factory):
    cfg = small_config
    maps, queries, _ = make_map_and_queries(
        cfg, seed=13, num_map_frames=24, num_queries=8, center_noise_m=0.05, dropout=0.1,
    )
    descs = [jax_build_descriptors(g, cfg.desc, cfg.caps) for g in maps]
    db, _ = build_database(descs, [np.asarray(g.pose) for g in maps], cfg.desc, cfg.caps)
    batch = jax_stack_graphs(queries)
    mesh = Mesh(np.asarray(jax.devices()[:N]).reshape(N, 1), ("dp", "db"))
    spec = lambda f, x: P("dp", *(None,) * (x.ndim - 1)) if f in ROW_FIELDS else P(*(None,) * x.ndim)
    sdb = DescriptorDB(*(jax.device_put(x, NamedSharding(mesh, spec(f, x))) for f, x in db._asdict().items()))
    want = {f: np.asarray(v) for f, v in jax_make_ring_localizer(mesh, cfg)(sdb, batch)._asdict().items()}

    pcfg = interop.config_from_reference(cfg)
    tdb = interop.db_from_numpy(db, "cpu")
    tq = interop.graph_from_numpy(batch, "cpu")
    single = localize(tdb, tq, pcfg)
    d = tmp_path_factory.mktemp("ring_world")
    write_inputs(d, db=tdb, graphs=tq, config=pcfg)
    summary = run_world(N, "gloo", "cpu", d, ["ring", "ring:1"], timeout=300)
    got = read_outputs(d / "out", "ring")
    return want, got, read_outputs(d / "out", "ring:1"), single, summary, [np.asarray(g.pose) for g in queries]


def test_candidates_equal_reference(outputs):
    want, got, *_ = outputs
    for f in ("votes", "frames", "found", "best_frame", "truncated", "scores"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_transforms_close_to_reference(outputs):
    want, got, *_ = outputs
    ok = want["scores"] >= 0  # accepted candidates; a rejected one's transform is read by no caller
    assert ok.any()
    np.testing.assert_allclose(got["rot"][ok], want["rot"][ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["trans"][ok], want["trans"][ok], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["poses"][ok], want["poses"][ok], rtol=0, atol=1e-3)


def test_votes_equal_single_device(outputs):
    """The per-block tallies add up to the whole DB's, and both localize
    every query to the same place (test_ring_sweep.py's gates)."""
    _, got, _, single, _, gts = outputs
    np.testing.assert_array_equal(np.sort(got["votes"], -1), np.sort(single.votes.numpy(), -1))
    np.testing.assert_array_equal(got["found"], single.found.numpy())
    for i, gt in enumerate(gts):
        for est in (single.poses[i, 0].numpy(), got["poses"][i, 0]):
            t_err, r_err = rpe(gt, est)
            assert t_err < 2.0 and r_err < 5.0, (i, t_err, r_err)


def test_chunked_calls_equal_one_call(outputs):
    """One query a call gives what one call on the rank's two queries
    gives: each query's ring is its own."""
    _, got, one_at_a_time, *_ = outputs
    for f, v in got.items():
        np.testing.assert_array_equal(one_at_a_time[f], v, err_msg=f)


def test_ring_moves_every_block(outputs):
    """Each rank probed all four blocks: three hand-offs of the five row
    fields a call, one call a query with ``ring:1``."""
    *_, summary, _ = outputs
    assert [r["collective_calls"] for r in summary["legs"]["ring_0"]] == [N - 1] * N
    assert [r["collective_calls"] for r in summary["legs"]["ring_1"]] == [2 * (N - 1)] * N
    assert summary["foreign_modules"] == []
