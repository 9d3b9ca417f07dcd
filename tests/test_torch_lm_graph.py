"""The LM trip body shared by the eager loop and the CUDA graph
(``refine.lsq.lm_trip``, ``LmGraph``) and the graph cache of
``refine.gicp`` (``_graphed``), on the CPU.

- ``lm_trip`` run trip by trip, out of place and in place (as a graph
  holds it), gives ``lm_solve``'s result bit for bit, on GICP problems
  (both linearizations) and on a toy quadratic.
- ``lm_solve`` handed a graph runs one replay a trip: here a stand-in
  whose replay runs the in-place trip eagerly (a CPU has no CUDA graph),
  so the loop, the state buffers, the copies of the live mask and of the
  result, the launch counts added a replay and the counters are those of
  the card; the card's own capture is ``test_torch_lm_graph_card.py``.
- ``_graphed`` keys a graph by what its capture fixes, copies each
  solve's inputs into its buffers, and keeps at most ``GRAPHS_KEPT``.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from sgtd_tpu_torch.config import GicpConfig
from sgtd_tpu_torch.geom import se3
from sgtd_tpu_torch.ops import _build
from sgtd_tpu_torch.refine import gicp, lsq
from sgtd_tpu_torch.utils import profiling

CFG = GicpConfig()


def _clouds(seed: int, p: int, n_src: int = 96, n_tgt: int = 384, init: float = 0.2):
    """``p`` GICP problems from NumPy: a mostly planar target with a wall,
    the source a noisy moved subsample, a tenth of each side masked."""
    rng = np.random.default_rng(seed)
    tgt = np.stack([rng.uniform(-10, 10, (p, n_tgt)), rng.uniform(-10, 10, (p, n_tgt)),
                    rng.normal(0, 0.05, (p, n_tgt))], axis=-1)
    k = n_tgt // 4
    tgt[:, :k, 2] = rng.uniform(0, 3, (p, k))
    tgt[:, :k, 0] = np.round(tgt[:, :k, 0] / 5) * 5 + rng.normal(0, 0.03, (p, k))
    pick = np.stack([rng.permutation(n_tgt)[:n_src] for _ in range(p)])
    src = np.take_along_axis(tgt, pick[..., None], 1) + rng.normal(0, 0.05, (p, n_src, 3))
    src = src - rng.normal(0, 0.3, (p, 1, 3))
    xi = np.concatenate([rng.normal(0, init, (p, 3)), rng.normal(0, init / 10, (p, 3))], 1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    src_mask = torch.from_numpy(rng.uniform(size=(p, n_src)) >= 0.1)
    tgt_mask = torch.from_numpy(rng.uniform(size=(p, n_tgt)) >= 0.1)
    return f32(src), src_mask, f32(tgt), tgt_mask, se3.se3_exp(f32(xi))


def _gicp_inputs(seed: int, p: int, fused: bool, **kw):
    """(inputs, T0) of gicp_align's solve: the tensors a trip reads."""
    src, src_mask, tgt, tgt_mask, T0 = _clouds(seed, p, **kw)
    src_cov = gicp.point_covariances(src, src_mask, CFG)
    tgt_cov = gicp.point_covariances(tgt, tgt_mask, CFG)
    tgt_eff = gicp._displaced(tgt, tgt_mask)
    return gicp._LINEARIZATIONS[fused][0](src, src_mask, src_cov, tgt, tgt_eff, tgt_mask, tgt_cov), T0


def _gicp_problem(fused: bool, seed: int = 3):
    """(linearize, error, T0) of a GICP solve of 3 problems."""
    inputs, T0 = _gicp_inputs(seed, 3, fused)
    return (*gicp._LINEARIZATIONS[fused][1](inputs, CFG), T0)


def _toy_problem(n=5):
    """A quadratic in the translation (float64)."""
    target = torch.linspace(0.1, 0.5, n, dtype=torch.float64)[:, None].expand(n, 3)

    def linearize(T):
        r = T[:, :3, 3] - target
        H = torch.eye(6, dtype=T.dtype).expand(n, 6, 6).clone()
        return H, torch.cat([r, torch.zeros_like(r)], -1), (r * r).sum(-1), None

    def error(T, aux):
        r = T[..., :3, 3] - target[:, None]
        return (r * r).sum(-1)

    return linearize, error, torch.eye(4, dtype=torch.float64).expand(n, 4, 4).clone()


PROBLEMS = {"gicp": lambda: _gicp_problem(False), "gicp_fused": lambda: _gicp_problem(True), "toy": _toy_problem}
SOLVE = dict(max_iterations=CFG.max_iterations, lm_inner=CFG.lm_max_inner, rot_eps=CFG.rot_eps,
             trans_eps=CFG.trans_eps, init_lambda_factor=CFG.lm_init_lambda_factor)


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return x.contiguous().view({4: torch.int32, 8: torch.int64}[x.element_size()])
    return x


def _assert_same(got: lsq.LsqResult, want: lsq.LsqResult):
    for name in lsq.LsqResult._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize("in_place", [False, True], ids=["new_tensors", "in_place"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_the_trip_body_trip_by_trip_reproduces_lm_solve(problem, in_place):
    linearize, error, T0 = PROBLEMS[problem]()
    want = lsq.lm_solve(linearize, error, T0, **SOLVE)
    s = lsq.lm_start(T0.clone())
    consts = lsq.lm_constants(CFG.lm_max_inner, T0.dtype, T0.device)
    trips = 0
    for _ in range(CFG.max_iterations):
        if bool(s.done.all()):
            break
        trips += 1
        new = lsq.lm_trip(linearize, error, s, consts, rot_eps=CFG.rot_eps, trans_eps=CFG.trans_eps,
                          init_lambda_factor=CFG.lm_init_lambda_factor, out=s if in_place else None)
        assert all((a is b) == in_place for a, b in zip(new, s))
        s = new
    assert trips >= 2
    _assert_same(lsq.LsqResult(s.T, s.done, s.y), want)


class _EagerGraph(lsq.LmGraph):
    """An LmGraph whose "replay" runs the captured trip in place, eagerly,
    and counts one B4 launch a trip as a recorded capture of the unfused
    trip would."""

    @staticmethod
    def _record(trip, dev):
        return type("Replay", (), {"replay": staticmethod(lambda: trip(in_place=True))})(), {"sgtd_nn1": 1}


def _totals(tracer) -> dict:
    return {k: sum(v for _, v in tracer.counters.get(k, ()))
            for k in ("lm.trips", "lm.live", "lm.graph_captures", "lm.graph_replays")}


def _traced_solve(linearize, error, T0, graph=None):
    tracer = profiling.enable()
    try:
        nn1 = _build.COUNTS["sgtd_nn1"]
        res = lsq.lm_solve(linearize, error, T0, graph=graph, **SOLVE)
        profiling.flush()
        return res, _build.COUNTS["sgtd_nn1"] - nn1, _totals(tracer)
    finally:
        profiling.disable()


@pytest.mark.parametrize("problem", ["gicp", "toy"])
def test_a_solve_through_a_graph_replays_the_trip_and_keeps_each_answer(problem):
    linearize, error, T0 = PROBLEMS[problem]()
    graph = _EagerGraph()
    want, _, want_n = _traced_solve(linearize, error, T0)
    got, got_nn1, got_n = _traced_solve(linearize, error, T0, graph)
    _assert_same(got, want)
    assert got_n["lm.trips"] == want_n["lm.trips"] == got_n["lm.graph_replays"] == got_nn1
    assert got_n["lm.live"] == want_n["lm.live"] and got_n["lm.graph_captures"] == 1
    assert want_n["lm.graph_captures"] == want_n["lm.graph_replays"] == 0

    # A second solve from another start: its own answer, no capture, and
    # the first answer untouched by the buffers' reuse.
    kept = lsq.LsqResult(*(x.clone() for x in got))
    T1 = se3.se3_exp(torch.full(T0.shape[:-2] + (6,), 0.05, dtype=T0.dtype)) @ T0
    other, _, other_n = _traced_solve(linearize, error, T1, graph)
    _assert_same(other, _traced_solve(linearize, error, T1)[0])
    _assert_same(got, kept)
    assert other_n["lm.graph_captures"] == 0 and other_n["lm.graph_replays"] == other_n["lm.trips"]
    assert not any(x is b for x in other for b in graph.state)


def test_a_graph_refuses_other_settings_than_its_capture():
    linearize, error, T0 = _toy_problem()
    graph = _EagerGraph()
    lsq.lm_solve(linearize, error, T0, graph=graph, **SOLVE)
    with pytest.raises(ValueError, match="captured with"):
        lsq.lm_solve(linearize, error, T0, graph=graph, **dict(SOLVE, rot_eps=1e-3))


@pytest.fixture
def graphs(monkeypatch):
    """A fresh, empty graph cache."""
    cache = collections.OrderedDict()
    monkeypatch.setattr(gicp, "_GRAPHS", cache)
    return cache


def test_graphed_keys_by_shape_and_copies_each_solves_inputs(graphs):
    inputs, _ = _gicp_inputs(1, 4, False)
    g = gicp._graphed(inputs, False, CFG)
    assert len(graphs) == 1 and not g.graph.captured
    assert all(b is not x and torch.equal(b, x) and b.is_contiguous() for b, x in zip(g.inputs, inputs))
    other, _ = _gicp_inputs(2, 4, False)
    assert gicp._graphed(other, False, CFG) is g and len(graphs) == 1
    assert all(torch.equal(b, x) for b, x in zip(g.inputs, other))
    # Expanded inputs (a query against its K candidates) take the same key.
    wide = tuple(x[:1].expand(x.shape) for x in other)
    assert gicp._graphed(wide, False, CFG) is g
    assert all(torch.equal(b, x) for b, x in zip(g.inputs, wide))


@pytest.mark.parametrize("change", ["problems", "source_points", "target_points", "fused", "rot_eps",
                                    "trans_eps", "lm_init_lambda_factor", "max_corr_dist_m", "lm_max_inner"])
def test_graphed_takes_a_new_graph_for_what_the_capture_fixes(graphs, change):
    inputs, _ = _gicp_inputs(1, 4, False)
    g = gicp._graphed(inputs, False, CFG)
    fused, cfg = False, CFG
    if change == "problems":
        inputs, _ = _gicp_inputs(1, 5, False)
    elif change == "source_points":
        inputs, _ = _gicp_inputs(1, 4, False, n_src=64)
    elif change == "target_points":
        inputs, _ = _gicp_inputs(1, 4, False, n_tgt=256)
    elif change == "fused":
        inputs, fused = _gicp_inputs(1, 4, True)[0], True
    else:
        value = {"lm_max_inner": 6, "max_corr_dist_m": 2.0}.get(change, getattr(CFG, change) * 2)
        cfg = dataclasses.replace(CFG, **{change: value})
    assert gicp._graphed(inputs, fused, cfg) is not g and len(graphs) == 2
    assert gicp._graphed(_gicp_inputs(1, 4, False)[0], False, CFG) is g and len(graphs) == 2


def test_graphed_keeps_the_most_recently_used_graphs(graphs):
    made = [gicp._graphed(_gicp_inputs(0, p, False)[0], False, CFG) for p in range(1, gicp.GRAPHS_KEPT + 1)]
    assert len(graphs) == gicp.GRAPHS_KEPT
    assert gicp._graphed(_gicp_inputs(0, 1, False)[0], False, CFG) is made[0]
    gicp._graphed(_gicp_inputs(0, gicp.GRAPHS_KEPT + 1, False)[0], False, CFG)
    assert len(graphs) == gicp.GRAPHS_KEPT
    kept = [id(g) for g in graphs.values()]
    assert id(made[0]) in kept and id(made[1]) not in kept
