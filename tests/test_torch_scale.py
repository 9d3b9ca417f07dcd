"""The port's large-map paths against sgtd_tpu on a small world (CPU).

Kernel B6's plain version against the Pallas kernel (interpret mode), and
``localize`` through each path a large map takes — the wide vote tally
(DB widened past 2,048 frames), candidate-major pair lists, the in-cell
bisection of a DB without a bucket table, ``localize_exact`` — plus
``probe_ranges``, ``calibrate_scan_slots`` and ``append_database``, each
against the reference on the same DB and queries. Integer outputs must be
equal; poses agree within the tolerance stated at POSE_TOL. The >65,536-
keyframe fallbacks are checked on the port alone (narrow DB against the
same rows padded to 524,296 frames): the reference's own test of that
width is marked slow.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgtd_tpu.data.synthetic import make_map_and_queries as jax_make_map_and_queries
from sgtd_tpu.db.database import DescriptorDB as JaxDescriptorDB
from sgtd_tpu.db.database import tuned_config
from sgtd_tpu.db.device_build import append_database as jax_append_database
from sgtd_tpu.db.device_build import build_database_calibrated as jax_build_calibrated
from sgtd_tpu.db.device_build import build_database_on_device as jax_build_on_device
from sgtd_tpu.desc.triangles import build_descriptors as jax_build_descriptors
from sgtd_tpu.match.pipeline import localize as jax_localize
from sgtd_tpu.match.pipeline import localize_exact as jax_localize_exact
from sgtd_tpu.match.search import calibrate_scan_slots as jax_calibrate_scan_slots
from sgtd_tpu.match.search import fit_scan_slots
from sgtd_tpu.match.search import probe_ranges as jax_probe_ranges
from sgtd_tpu.ops.pallas_probe import frame_votes_wide as jax_frame_votes_wide
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.db.device_build import append_database, build_database_on_device
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.eval.runner import build_descriptors_chunked
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.match import search
from sgtd_tpu_torch.match.pipeline import localize, localize_exact
from sgtd_tpu_torch.match.search import TRUNC_SCAN, calibrate_scan_slots, probe_ranges
from sgtd_tpu_torch.ops import launch_counts, probe

torch.set_num_threads(1)

OBS = dict(center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
TABLE_SLOTS = 1 << 21
# Accepted candidates' world poses: rotation entries and translations
# (metres, up to ~130 m from the origin, where a float32 ulp is 1.5e-5)
# within 1e-5 relative + 1e-5 absolute of the reference's.
POSE_TOL = dict(rtol=1e-5, atol=1e-5)
# The port takes its own config type: P(cfg) of a reference config.
P = interop.config_from_reference
INT_FIELDS = ("found", "best_frame", "frames", "votes", "truncated", "num_descriptors")


# --- (a) kernel B6: plain version against the Pallas kernel. ---


@pytest.mark.parametrize("f_pad", [208, 2056, 20016])
def test_frame_votes_wide_matches_pallas(f_pad):
    rng = np.random.default_rng(f_pad)
    l = 5000
    hit = rng.uniform(size=l) < 0.3
    # Out-of-range ids (-1, the sentinel f_pad, f_pad + 1) count nothing.
    frame = rng.integers(-1, f_pad + 2, size=l, dtype=np.int32)
    want = np.asarray(jax_frame_votes_wide(jnp.asarray(hit), jnp.asarray(frame), f_pad))
    got = probe.frame_votes_wide(torch.from_numpy(hit)[None], torch.from_numpy(frame)[None], f_pad)
    assert got.dtype == torch.float32 and got.shape == (1, f_pad)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_frame_votes_wide_dense_counts():
    """Every bin hit many times: integer counts stay exact."""
    rng = np.random.default_rng(300)
    f_pad, l = 300, 40000
    hit = np.ones(l, bool)
    frame = rng.integers(0, f_pad, size=l, dtype=np.int32)
    want = np.asarray(jax_frame_votes_wide(jnp.asarray(hit), jnp.asarray(frame), f_pad))
    got = probe.frame_votes_wide(torch.from_numpy(hit)[None], torch.from_numpy(frame)[None], f_pad)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(want, np.bincount(frame, minlength=f_pad).astype(np.float32))


def test_frame_votes_wide_dispatch():
    """CPU tensors take the plain version without a launch; any other
    device launches the kernel or raises."""
    before = launch_counts()[5]
    probe.frame_votes_wide(torch.ones(2, 16, dtype=torch.bool), torch.zeros(2, 16, dtype=torch.int32), 4096)
    assert launch_counts()[5] == before == 0
    with pytest.raises(ValueError, match="CUDA tensors required"):
        probe.frame_votes_wide(
            torch.ones(1, 16, dtype=torch.bool, device="meta"),
            torch.zeros(1, 16, dtype=torch.int32, device="meta"), 4096,
        )


# --- (b) the large-map paths against the reference. ---


def _jax_widen(db, f_wide):
    """The reference DB with its frame axis padded to ``f_wide`` (extra
    frames invalid, owning no rows)."""
    f_old = db.frame_poses.shape[0]
    fp = np.tile(np.eye(4, dtype=np.float32), (f_wide, 1, 1))
    fp[:f_old] = np.asarray(db.frame_poses)
    fv = np.zeros(f_wide, bool)
    fv[:f_old] = np.asarray(db.frame_valid)
    fs = np.full(f_wide + 1, np.asarray(db.frame_start)[-1], np.int32)
    fs[: f_old + 1] = np.asarray(db.frame_start)
    return db._replace(frame_poses=jnp.asarray(fp), frame_valid=jnp.asarray(fv), frame_start=jnp.asarray(fs))


def _jax_no_table(db):
    return db._replace(
        bucket_table=jnp.zeros((0, 2), jnp.uint32),
        cell_remap=jnp.zeros(0, jnp.int32),
        code_remap=jnp.zeros(0, jnp.int32),
    )


def _no_table(db):
    return db._replace(bucket_table=db.bucket_table[:0], cell_remap=db.cell_remap[:0], code_remap=db.code_remap[:0])


def _stack_np(items):
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *items)


@pytest.fixture(scope="module")
def world(small_config):
    cfg = small_config
    maps, queries, _ = jax_make_map_and_queries(cfg, seed=7, num_map_frames=24, num_queries=8, **OBS)
    build = jax.jit(jax.vmap(functools.partial(jax_build_descriptors, cfg=cfg.desc, caps=cfg.caps)))
    map_descs = jax.tree_util.tree_map(np.asarray, build(_stack_np(maps)))
    q_descs = jax.tree_util.tree_map(np.asarray, build(_stack_np(queries)))
    poses = np.stack([g.pose for g in maps])
    jdb, rep, tot = jax_build_calibrated(map_descs, poses, q_descs, cfg.desc, table_slots=TABLE_SLOTS)
    cfg = fit_scan_slots(int(np.asarray(tot).max()), tuned_config(cfg, rep))
    return dict(
        cfg=cfg, maps=maps, queries=queries, poses=poses, map_descs=map_descs, q_descs=q_descs,
        jdb=jdb, tdb=interop.db_from_numpy(jdb, "cpu"),
        tq_graphs=interop.graph_from_numpy(_stack_np(queries), "cpu"),
        tq=interop.descriptors_from_numpy(q_descs, "cpu"),
    )


def _assert_result_matches(got, want, fields=INT_FIELDS):
    for f in fields:
        w = np.stack([np.asarray(getattr(r, f)) for r in want])
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)
    w_scores = np.stack([np.asarray(r.scores) for r in want])
    np.testing.assert_array_equal(got.scores.numpy(), w_scores)
    ok = w_scores >= 0  # rejected candidates carry hypotheses no caller reads
    assert ok[:, 0].all()
    w_poses = np.stack([np.asarray(r.poses) for r in want])
    np.testing.assert_allclose(got.poses.numpy()[ok], w_poses[ok], **POSE_TOL)


_PATHS = ("wide_tally", "candidate_major", "bisection")


def _path_inputs(world, path):
    cfg, jdb, tdb = world["cfg"], world["jdb"], world["tdb"]
    if path == "wide_tally":  # f_pad 2056 > 2048: kernel B6's path
        jdb, tdb = _jax_widen(jdb, 2056), interop.pad_frames(tdb, 2056)
    elif path == "candidate_major":
        cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, sel_max_scan_slots=0))
    else:  # a DB past the bucket-table budget
        jdb, tdb = _jax_no_table(jdb), _no_table(tdb)
    return cfg, jdb, tdb


@pytest.mark.parametrize("path", _PATHS)
def test_localize_matches_reference(world, path):
    cfg, jdb, tdb = _path_inputs(world, path)
    want = [jax_localize(jdb, g, cfg) for g in world["queries"]]
    got = localize(tdb, world["tq_graphs"], P(cfg))
    _assert_result_matches(got, want)
    assert got.found.all() and not (got.truncated.numpy() & TRUNC_SCAN).any()


def test_probe_ranges_match_reference(world):
    for jdb, tdb in ((world["jdb"], world["tdb"]), (_jax_no_table(world["jdb"]), _no_table(world["tdb"]))):
        got = probe_ranges(tdb, world["tq"], P(world["cfg"]).desc)
        for i in range(len(world["queries"])):
            q = jax.tree_util.tree_map(lambda x: x[i], world["q_descs"])
            want = jax_probe_ranges(jdb, q, world["cfg"].desc)
            ok = np.asarray(want[2])
            np.testing.assert_array_equal(got[2][i].numpy(), ok)
            # Ranges of live probes; off probes carry unread bounds.
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(g[i].numpy()[ok], np.asarray(w)[ok])


@pytest.mark.parametrize("table", ["direct_table", "bisection"])
def test_calibrate_scan_slots_matches_reference(world, small_config, table):
    jdb, tdb = world["jdb"], world["tdb"]
    if table == "bisection":
        jdb, tdb = _jax_no_table(jdb), _no_table(tdb)
    want = jax_calibrate_scan_slots(jdb, world["q_descs"], small_config)
    got = calibrate_scan_slots(tdb, world["tq"], P(small_config))
    assert got == P(want)
    assert got.caps.max_scan_slots < small_config.caps.max_scan_slots


def test_localize_exact_matches_reference(world):
    """Queries forced over a starved cap: localize flags TRUNC_SCAN, and
    localize_exact equals the reference's and the uncapped candidate-major
    run."""
    cfg = world["cfg"]
    starved = cfg.replace(caps=dataclasses.replace(cfg.caps, max_scan_slots=64))
    capped = localize(world["tdb"], world["tq_graphs"], P(starved))
    assert (capped.truncated.numpy() & TRUNC_SCAN).all()
    got = localize_exact(world["tdb"], world["tq_graphs"], P(starved))
    want = [jax_localize_exact(world["jdb"], g, starved) for g in world["queries"]]
    _assert_result_matches(got, want)
    assert not got.truncated.any()
    cm = cfg.replace(caps=dataclasses.replace(cfg.caps, sel_max_scan_slots=0))
    uncapped = localize(world["tdb"], world["tq_graphs"], P(cm))
    for f in ("frames", "votes", "scores", "found", "best_frame"):
        assert torch.equal(getattr(got, f), getattr(uncapped, f)), f


@pytest.mark.parametrize("table", ["direct_table", "table_overflow"])
def test_append_database_matches_reference(world, table):
    """Every DB field and the report of the port's append equal the
    reference's; the appended DB localizes as the full build does. In
    ``table_overflow`` the first part's table is sized to fit it exactly,
    so the appended DB outgrows it and falls back to bisection."""
    cfg, md, poses, k = world["cfg"], world["map_descs"], world["poses"], 16
    part = jax.tree_util.tree_map(lambda x: x[:k], md)
    rest = jax.tree_util.tree_map(lambda x: x[k:], md)
    slots = TABLE_SLOTS
    if table == "table_overflow":
        jpart, rep = jax_build_on_device(part, poses[:k], cfg.desc, table_slots=slots)
        slots = rep.num_cells * int(np.asarray(jpart.table_stride)[0])
    jpart, _ = jax_build_on_device(part, poses[:k], cfg.desc, table_slots=slots)
    want_db, want_rep = jax_append_database(jpart, rest, poses[k:], cfg.desc)
    assert jpart.has_direct_table and want_db.has_direct_table == (table == "direct_table")

    tpart, _ = build_database_on_device(
        interop.descriptors_from_numpy(part, "cpu"), torch.from_numpy(poses[:k]), P(cfg).desc,
        table_slots=slots,
    )
    got_db, got_rep = append_database(
        tpart, interop.descriptors_from_numpy(rest, "cpu"), torch.from_numpy(poses[k:]), P(cfg).desc
    )
    assert dataclasses.asdict(got_rep) == dataclasses.asdict(want_rep)
    got_np = interop.db_to_numpy(got_db)
    for f in JaxDescriptorDB._fields:
        w = np.asarray(getattr(want_db, f))
        assert got_np[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got_np[f], w, err_msg=f)

    full, _ = build_database_on_device(
        interop.descriptors_from_numpy(md, "cpu"), torch.from_numpy(poses), P(cfg).desc,
        table_slots=TABLE_SLOTS,
    )
    a = localize(got_db, world["tq_graphs"], P(cfg))
    b = localize(full, world["tq_graphs"], P(cfg))
    for f in INT_FIELDS + ("scores",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# --- (c) the >65,536-keyframe fallbacks, port alone. ---


def test_wide_frame_db_equals_narrow(world):
    cfg, tdb = world["cfg"], world["tdb"]
    f_wide = 524296  # (f + 1) * D * U >= 2^31 also trips the argsort grouping
    assert (f_wide + 1) * cfg.caps.max_descriptors * cfg.caps.hits_per_descriptor >= 2**31
    wide = interop.pad_frames(tdb, f_wide)
    rows = torch.arange(tdb.keys.shape[0], dtype=torch.int32)
    assert torch.equal(search._frame_of_rows(tdb, rows), search._frame_of_rows(wide, rows))
    a = localize(tdb, world["tq_graphs"], P(cfg))
    b = localize(wide, world["tq_graphs"], P(cfg))
    assert torch.equal(a.found, b.found) and torch.equal(a.best_frame, b.best_frame)
    # C widens with f_pad (24 -> 50): compare the live, score-sorted prefix.
    live_a = a.votes >= cfg.search.min_votes
    n = live_a.sum(-1)
    assert (n >= 1).all() and torch.equal(n, (b.votes >= cfg.search.min_votes).sum(-1))
    for i, k in enumerate(n.tolist()):
        for f in ("frames", "scores", "votes", "poses"):
            assert torch.equal(getattr(a, f)[i, :k], getattr(b, f)[i, :k]), (i, f)


def test_vote_tally_follows_frame_axis(world, monkeypatch):
    """probe_and_hits takes B1 up to 2048 frames and B6 above, as the
    reference does."""
    calls = []
    for name in ("frame_votes", "frame_votes_wide"):
        fn = getattr(probe, name)
        monkeypatch.setattr(probe, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    cfg, tdb = P(world["cfg"]), world["tdb"]
    for f_pad in (2048, 2056):
        search.probe_and_hits(interop.pad_frames(tdb, f_pad), world["tq"], cfg.desc, cfg.search, cfg.caps)
    assert calls == ["frame_votes", "frame_votes_wide"]


# --- (d) the chunked descriptor build. ---


def test_build_descriptors_chunked_equals_unchunked(world):
    cfg = P(world["cfg"])
    batch = stack_graphs(world["maps"], "cpu")
    want = build_descriptors(batch, cfg.desc, cfg.caps)
    got = build_descriptors_chunked(batch, cfg, chunk=5)
    for f, g, w in zip(want._fields, got, want):
        assert torch.equal(g, w), f


# --- chip_smoke.py's 5,000-keyframe reference, from sgtd_tpu. ---


@functools.cache
def _reference_5k():
    """The 5,000-keyframe world and pipeline of tools/scale_bench.py from
    sgtd_tpu on the CPU (default config, the sel path): (config, DB, build
    report, the 32 query graphs)."""
    import chip_smoke as cs
    from sgtd_tpu.config import SGTDConfig
    from sgtd_tpu.data.synthetic import make_world, observe
    from sgtd_tpu.eval.runner import build_descriptors_chunked as jax_chunked
    from sgtd_tpu.eval.runner import stack_graphs as jax_stack

    num_map = 5000
    cfg = SGTDConfig()
    rng = np.random.default_rng(cs.SCALE_SEED)
    extent = max(400.0, 8.0 * np.sqrt(num_map) * 4.0)
    world = make_world(rng, extent_m=extent, num_map_frames=num_map, num_queries=cs.SCALE_QUERIES)
    maps = [observe(world, p, cfg, rng) for p in world.map_poses]
    queries = [observe(world, p, cfg, rng, center_noise_m=0.05, dropout=0.1) for p in world.query_poses]
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, max_scan_slots=cs.SCALE_SLOT_CEILING))
    mb = jax_stack(maps)
    sample = jax.tree_util.tree_map(lambda x: x[: cs.SCALE_SAMPLE], jax_stack(queries))
    db, rep, tot = jax_build_calibrated(jax_chunked(mb, cfg), mb.pose, jax_chunked(sample, cfg), cfg.desc)
    del maps, mb
    cfg = fit_scan_slots(int(np.asarray(tot).max()), tuned_config(cfg, rep))
    return cfg, db, rep, queries


@pytest.mark.slow
def test_reference_5k_digest():
    """REFERENCE_5K, the rows and candidate digest that chip_smoke.py holds
    the card's large-map run to, is what sgtd_tpu gives on the CPU: the
    world and pipeline of tools/scale_bench.py (default config, the sel
    path) with per-query ``localize``; about 80 s on a CPU."""
    import chip_smoke as cs
    from sgtd_tpu.match.search import TRUNC_SCAN as JAX_TRUNC_SCAN

    cfg, db, rep, queries = _reference_5k()
    res = [jax_localize(db, g, cfg) for g in queries]
    assert not any(int(r.truncated) & JAX_TRUNC_SCAN for r in res)
    frames = np.stack([np.asarray(r.frames) for r in res])
    votes = np.stack([np.asarray(r.votes) for r in res])
    got = {"rows": rep.num_rows, "sha256": cs.candidates_sha256(frames, votes)}
    assert got == cs.REFERENCE_5K


@pytest.mark.slow
@pytest.mark.parametrize("pair_lists", ["sel", "candidate_major"])
def test_pair_lists_and_scores_equal_reference_5k(pair_lists):
    """The float gates of the pair pass and of verification, on the
    5,000-keyframe world's 32 queries: the candidates, their pair lists
    (``extract_pairs`` by default, ``extract_pairs_by_frame`` with
    ``sel_max_scan_slots=0``: pair_qidx, pair_row, pair_valid) and the
    integer verification scores equal the reference's. A gate that rounded
    another way than XLA:CPU's fused multiply-adds would add or drop a
    pair, or move a score by a vote. About 80 s a case after the world's
    70 s, on a CPU.

    The reference's pair lists are taken from one program with the body of
    its ``localize`` (descriptors, candidate search, verification), whose
    candidates and scores must also be ``localize``'s own: XLA:CPU fuses
    a gate's sums by the program around it, and ``candidate_search``
    jitted without the verification behind it gives one of these queries
    (the sixth) other probes than ``localize`` does."""
    from sgtd_tpu.match.search import candidate_search as jax_candidate_search
    from sgtd_tpu.match.verify import verify_candidates as jax_verify_candidates

    cfg, jdb, _, queries = _reference_5k()
    if pair_lists == "candidate_major":
        cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, sel_max_scan_slots=0))

    @jax.jit
    def reference(db, graph):
        query = jax_build_descriptors(graph, cfg.desc, cfg.caps)
        cand = jax_candidate_search(db, query, cfg.desc, cfg.search, cfg.caps)
        return cand, jax_verify_candidates(db, query, cand, cfg.search).scores

    tdb = interop.db_from_numpy(jdb, "cpu")
    tcfg = P(cfg)
    chunk = 8
    n_pairs = 0
    for i in range(0, len(queries), chunk):
        graphs = interop.graph_from_numpy(_stack_np(queries[i : i + chunk]), "cpu")
        got = search.candidate_search(tdb, build_descriptors(graphs, tcfg.desc, tcfg.caps),
                                      tcfg.desc, tcfg.search, tcfg.caps)
        res = localize(tdb, graphs, tcfg)
        n_pairs += int(got.pair_valid.sum())
        for k, graph in enumerate(queries[i : i + chunk]):
            cand, scores = reference(jdb, graph)
            want = jax_localize(jdb, graph, cfg)
            order = np.argsort(-np.asarray(scores), kind="stable")
            for f, mine in (("frames", cand.frames), ("votes", cand.votes), ("scores", scores)):
                np.testing.assert_array_equal(np.asarray(mine)[order], np.asarray(getattr(want, f)),
                                              err_msg=f"the reference program's {f}, query {i + k}")
            for f in ("frames", "votes", "valid", "pair_valid", "pair_qidx", "pair_row", "truncated"):
                np.testing.assert_array_equal(getattr(got, f)[k].numpy(), np.asarray(getattr(cand, f)),
                                              err_msg=f"{f}, query {i + k}")
            for f in ("scores", "frames", "votes", "found", "best_frame"):
                np.testing.assert_array_equal(getattr(res, f)[k].numpy(), np.asarray(getattr(want, f)),
                                              err_msg=f"{f}, query {i + k}")
    assert n_pairs > 0
