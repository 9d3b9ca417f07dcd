"""The port's search stages on one shard of the DB's rows against sgtd_tpu's.

A shard holds a contiguous slice of the five row fields (``keys``,
``codes``, ``packed2``, ``vertices``, ``frame_ids``) and every other field
whole; ``row_offset`` is the global row of its first row. On both bucket
lookups (the direct table and the in-cell bisection) and at 2 and 4
shards, each shard's probe ranges, votes, kept hits and candidate-major
pair lists equal the reference's on the same slice, and the shards' votes
add up to the whole DB's.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries
from sgtd_tpu.db.database import build_database, tuned_config
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.match import search as jax_search
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.match import search
from sgtd_tpu_torch.parallel.mesh import ROW_FIELDS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(small_config):
    cfg = small_config
    maps, queries, _ = make_map_and_queries(
        cfg, seed=17, num_map_frames=24, num_queries=4,
        center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05,
    )
    descs = [jax_build_descriptors(g, cfg.desc, cfg.caps) for g in maps]
    db, report = build_database(descs, [np.asarray(g.pose) for g in maps], cfg.desc, cfg.caps)
    cfg = tuned_config(cfg, report)
    qd = [jax_build_descriptors(g, cfg.desc, cfg.caps) for g in queries]
    q_np = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *qd)
    return cfg, db, qd, interop.descriptors_from_numpy(q_np, "cpu")


def _shard(db, k, n):
    """Shard ``k`` of ``n`` of a DB's rows (NumPy or torch fields alike)."""
    m = db.keys.shape[0] // n
    return db._replace(**{f: getattr(db, f)[k * m : (k + 1) * m] for f in ROW_FIELDS}), k * m


@functools.cache
def _jax_fns(cfg):
    probe = jax.jit(lambda db, q, off: jax_search.probe_and_hits(db, q, cfg.desc, cfg.search, cfg.caps, row_offset=off))
    ranges = jax.jit(lambda db, q, off: jax_search.probe_ranges(db, q, cfg.desc, row_offset=off))
    pairs = jax.jit(lambda db, q, pk, pd, cf, cv, off: jax_search.extract_pairs_by_frame(
        db, q, pk, pd, cf, cv, cfg.search, cfg.caps, row_offset=off))
    return probe, ranges, pairs


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("table", [True, False], ids=["direct_table", "bisection"])
def test_shard_search_matches_reference(world, table, n_shards):
    cfg, db, qd, tq = world
    if not table:
        db = db._replace(bucket_table=db.bucket_table[:0], cell_remap=db.cell_remap[:0],
                         code_remap=db.code_remap[:0])
    tdb = interop.db_from_numpy(db, "cpu")
    assert tdb.has_direct_table == table
    pcfg = interop.config_from_reference(cfg)
    j_probe, j_ranges, j_pairs = _jax_fns(cfg)
    m_local = db.keys.shape[0] // n_shards
    assert m_local * n_shards == db.keys.shape[0]

    whole = search.probe_and_hits(tdb, tq, pcfg.desc, pcfg.search, pcfg.caps)
    _, cand_frames, cand_valid = search.select_candidates(whole.votes, pcfg.search)
    pkeys, pdesc = search.build_probe_table(tq, pcfg.desc)
    vote_sum = torch.zeros_like(whole.votes)
    for k in range(n_shards):
        jdb, off = _shard(db, k, n_shards)
        local, off_t = _shard(tdb, k, n_shards)
        assert off == off_t == k * m_local
        got_r = search.probe_ranges(local, tq, pcfg.desc, row_offset=off)
        got = search.probe_and_hits(local, tq, pcfg.desc, pcfg.search, pcfg.caps, row_offset=off)
        got_p = search.extract_pairs_by_frame(local, tq, pkeys, pdesc, cand_frames, cand_valid,
                                              pcfg.search, pcfg.caps, row_offset=off)
        vote_sum += got.votes
        for i, q in enumerate(qd):
            o = jnp.int32(off)
            want_r = j_ranges(jdb, q, o)
            for name, g, w in zip(("start", "end", "ok"), got_r, want_r):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(w), err_msg=f"shard {k} query {i} {name}")
            want = j_probe(jdb, q, o)
            for f in ("votes", "sel_row", "sel_frame", "scan_overflow", "pair_overflow"):
                np.testing.assert_array_equal(getattr(got, f)[i].numpy(), np.asarray(getattr(want, f)),
                                              err_msg=f"shard {k} query {i} {f}")
            pk, pd = jax_search.build_probe_table(q, cfg.desc)
            want_p = j_pairs(jdb, q, pk, pd, jnp.asarray(cand_frames[i].numpy()),
                             jnp.asarray(cand_valid[i].numpy()), o)
            for name, g, w in zip(("qidx", "row", "valid"), got_p, want_p):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(w), err_msg=f"shard {k} query {i} {name}")
    # A vote is one hit row, and every row lies in exactly one shard.
    torch.testing.assert_close(vote_sum, whole.votes, rtol=0, atol=0)
    assert bool((whole.votes > 0).any())


@pytest.fixture
def one_rank():
    """A one-rank gloo process group in this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_contracts(world, one_rank, monkeypatch):
    """make_mesh and shard_database raise where the reference's raise; on
    one rank every collective is the identity and the shard is the DB."""
    from sgtd_tpu_torch.parallel import mesh as pm

    _, db, _, _ = world
    tdb = interop.db_from_numpy(db, "cpu")
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        pm.make_mesh(2, 1, device_type="cpu")
    mesh = pm.make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("dp", "db") and tuple(mesh.shape) == (1, 1)
    local, offset = pm.shard_database(tdb, mesh)
    assert offset == 0 and all(torch.equal(a, b) for a, b in zip(local, tdb))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert pm.psum(x, mesh, "db") is x and pm.pmax(x, mesh, "dp") is x
    assert pm.all_gather(x, mesh, "db", dim=1) is x
    assert pm.ppermute_next([x], mesh, "dp")[0] is x
    # Rows that do not divide the axis (seven ranks on it) are refused.
    monkeypatch.setattr(pm, "axis_size", lambda mesh, axis: 7)
    m = tdb.keys.shape[0]
    assert m % 7
    with pytest.raises(ValueError, match=rf"DB rows \({m}\) must be divisible by the 'db' axis \(7\)"):
        pm.shard_database(tdb, mesh)
