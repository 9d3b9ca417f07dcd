"""The port's reference oracle (eval/oracle.py, NumPy) against sgtd_tpu's on
the randomized scenes of test_reference_oracle.py, and the port's pipeline
against its own oracle.

The two oracles run the same NumPy code on the port's and the reference's
config types: descriptor sets, vote tallies, candidate lists, match pairs,
verification scores, inliers, transforms and the search loop's pick must
be equal, in float32 with the fixed-point filter (the pipeline's mirror)
and in float64 (reference-true). The port's pipeline gives the oracle's
descriptor sets (dedup keys equal, sides within 2e-4 cell, vertices
within 1e-5 m: the tolerances of test_reference_oracle.py) and its
per-frame votes exactly.
"""

import numpy as np
import pytest
import torch

from sgtd_tpu.eval import oracle as jax_oracle
from sgtd_tpu_torch import interop
from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.db.database import build_database
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.eval import oracle
from sgtd_tpu_torch.graph.types import make_graph, stack_graphs
from sgtd_tpu_torch.match.search import probe_and_hits
from tests.test_reference_oracle import CFG as JAX_CFG
from tests.test_reference_oracle import _scene

torch.set_num_threads(1)

CFG = interop.config_from_reference(JAX_CFG, SGTDConfig)


def _std_fields(s):
    return (s.side_length, s.angle, s.A, s.B, s.C, s.center, s.vertex_attached, s.frame_id, s.node_id)


def _assert_stds_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(_std_fields(g), _std_fields(w)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _managers(scene, dtype, fixed_point):
    frames, (qpts, qlabels), _ = scene
    mine = oracle.OracleManager(CFG.desc, CFG.search, dtype=dtype, fixed_point_filter=fixed_point)
    theirs = jax_oracle.OracleManager(JAX_CFG.desc, JAX_CFG.search, dtype=dtype, fixed_point_filter=fixed_point)
    for pts, labels in frames:
        a, b = mine.build(pts, labels), theirs.build(pts, labels)
        _assert_stds_equal(a, b)
        mine.add_stds(a)
        theirs.add_stds(b)
    return mine, theirs, mine.build(qpts, qlabels), theirs.build(qpts, qlabels)


def test_binary_encoding_matches_reference():
    for a, b, c in np.random.default_rng(0).integers(0, 40, (200, 3)):
        assert oracle.combinatorial_binary_encoding(a, b, c) == jax_oracle.combinatorial_binary_encoding(a, b, c)


@pytest.mark.parametrize("seed,dtype,fixed_point", [(0, np.float32, True), (1, np.float64, False)])
def test_search_loop_matches_reference(seed, dtype, fixed_point):
    mine, theirs, q_mine, q_theirs = _managers(_scene(seed), dtype, fixed_point)
    _assert_stds_equal(q_mine, q_theirs)
    assert mine.db.keys() == theirs.db.keys() and mine.current_frame_id == theirs.current_frame_id
    votes_m, cands_m = mine.candidate_selector(q_mine)
    votes_t, cands_t = theirs.candidate_selector(q_theirs)
    assert votes_m == votes_t and len(cands_m) == len(cands_t) > 0
    for (fm, vm, lm), (ft, vt, lt) in zip(cands_m, cands_t):
        assert (fm, vm) == (ft, vt)
        assert [(qi, e.node_id, e.frame_id) for qi, e in lm] == [(qi, e.node_id, e.frame_id) for qi, e in lt]
    best_m, score_m, (rot_m, t_m), res_m = mine.search_loop(q_mine)
    best_t, score_t, (rot_t, t_t), res_t = theirs.search_loop(q_theirs)
    assert (best_m, score_m) == (best_t, score_t) and best_m == 0
    np.testing.assert_array_equal(rot_m, rot_t)
    np.testing.assert_array_equal(t_m, t_t)
    for rm, rt in zip(res_m, res_t):
        assert rm[:3] == rt[:3] and rm[5] == rt[5]
        np.testing.assert_array_equal(rm[3], rt[3])


def test_port_pipeline_matches_its_oracle():
    """The port's descriptors and votes against its own oracle (float32,
    fixed-point filter), as test_reference_oracle.py holds the reference."""
    frames, (qpts, qlabels), _ = _scene(0)
    mgr = oracle.OracleManager(CFG.desc, CFG.search, dtype=np.float32, fixed_point_filter=True)
    graphs = [make_graph(p, l, np.eye(4), CFG.caps.max_nodes) for p, l in frames]
    descs = build_descriptors(stack_graphs(graphs, "cpu"), CFG.desc, CFG.caps)
    for i, (pts, labels) in enumerate(frames):
        stds = mgr.build(pts, labels)
        mgr.add_stds(stds)
        m = descs.mask[i].numpy()
        assert int(m.sum()) == len(stds)
        sides = descs.sides[i].numpy()[m]
        o_sides = np.stack([s.side_length for s in stds])
        np.testing.assert_array_equal(np.trunc(sides * np.float32(1000)), np.trunc(o_sides * np.float32(1000)))
        np.testing.assert_allclose(sides, o_sides, rtol=0, atol=2e-4)
        np.testing.assert_allclose(descs.vertices[i].numpy()[m], np.stack([np.stack([s.A, s.B, s.C]) for s in stds]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(descs.labels[i].numpy()[m], np.array([s.vertex_attached for s in stds]))
    db, _ = build_database([type(descs)(*(x[i : i + 1] for x in descs)) for i in range(len(frames))],
                           [np.eye(4)] * len(frames), CFG.desc, CFG.caps, device="cpu")
    q = build_descriptors(stack_graphs([make_graph(qpts, qlabels, np.eye(4), CFG.caps.max_nodes)], "cpu"),
                          CFG.desc, CFG.caps)
    votes = probe_and_hits(db, q, CFG.desc, CFG.search, CFG.caps).votes[0].numpy()
    want, _ = mgr.candidate_selector(mgr.build(qpts, qlabels))
    for f in range(len(frames)):
        assert votes[f] == want.get(f, 0), (f, votes[f], want.get(f, 0))
    assert votes[len(frames):].sum() == 0
