"""The port's tracer (``sgtd_tpu_torch.utils.profiling``) on a tiny world.

Tracing off records nothing and hands back the shared no-op span; on, the
entry points give the same bits and record the span tree of the
program's layers (parents, one request id a root call), the LM counters
(``lm.live`` folded only at ``flush``) and a bounded buffer; under a CPU
``device_trace`` the ``sgtd:`` ranges nest as the spans do and hold the
operations they issue.
"""

import json
import os
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from sgtd_tpu_torch.config import CapacityConfig, GicpConfig, SGTDConfig
from sgtd_tpu_torch.data.synthetic import make_map_and_queries, render_planar_cloud
from sgtd_tpu_torch.desc.triangles import build_descriptors
from sgtd_tpu_torch.eval.runner import build_descriptors_chunked, build_map_index
from sgtd_tpu_torch.graph.types import stack_graphs
from sgtd_tpu_torch.interop import map_clouds_to_device
from sgtd_tpu_torch.match.pipeline import localize, localize_exact, localize_refined
from sgtd_tpu_torch.match.search import calibrate_scan_slots
from sgtd_tpu_torch.ops import _build
from sgtd_tpu_torch.ops.voxel import load_query_cloud
from sgtd_tpu_torch.refine.gicp import point_covariances
from sgtd_tpu_torch.refine.lsq import lm_solve
from sgtd_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = SGTDConfig().replace(
    caps=CapacityConfig(max_nodes=64, max_descriptors=512, bucket_cap=32, hits_per_descriptor=8,
                        pairs_per_candidate=128),
    gicp=GicpConfig(num_neighbors=8, max_iterations=6),
)
RERANK_K = 2


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def world():
    """A 20-keyframe map index, 4 queries with clouds, map covariances."""
    profiling.disable()
    maps, queries, w = make_map_and_queries(CFG, seed=11, num_map_frames=20, num_queries=4,
                                            center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
    index = build_map_index(maps, CFG, "cpu")
    q = stack_graphs(queries, "cpu")
    cfg = calibrate_scan_slots(index.db, build_descriptors_chunked(q, index.config), index.config)
    rng = np.random.default_rng(77)
    mc, mm = zip(*(render_planar_cloud(w, p, rng, max_points=512) for p in w.map_poses))
    qc, qm = [], []
    for p in w.query_poses:
        c, m = render_planar_cloud(w, p, rng, max_points=512)
        a, b = load_query_cloud(c[m], cfg.gicp.leaf_size, 128)
        qc.append(a)
        qm.append(b)
    mct, mmt, _ = map_clouds_to_device(np.stack(mc), np.stack(mm), None, "cpu", f_pad=index.db.frame_poses.shape[0])
    return dict(maps=maps, queries=queries, index=index, cfg=cfg, q=q, qc=torch.from_numpy(np.stack(qc)),
                qm=torch.from_numpy(np.stack(qm)), mc=mct, mm=mmt, covs=point_covariances(mct, mmt, cfg.gicp))


def _call(world, entry):
    db, cfg, q = world["index"].db, world["cfg"], world["q"]
    if entry == "localize":
        return localize(db, q, cfg)
    if entry == "localize_exact":
        return localize_exact(db, stack_graphs(world["queries"][:1], "cpu"), cfg)
    return localize_refined(db, q, world["qc"], world["qm"], world["mc"], world["mm"], world["covs"], config=cfg,
                            rerank_k=RERANK_K)


def _flat(out):
    if hasattr(out, "result"):
        return [out.pose, out.refined, out.fitness] + _flat(out.result)
    return list(out)


def _by_id(tracer):
    return {s.id: s for s in tracer.spans}


def _children(tracer, span):
    return [s.name for s in sorted(tracer.spans, key=lambda s: s.t0_ns) if s.parent == span.id]


# -- off ------------------------------------------------------------------------


def test_tracing_off_records_nothing_and_spans_are_the_shared_no_op(world):
    assert profiling.active() is None
    assert profiling.span("localize") is profiling.NULL_SPAN
    assert profiling.span("refine.lm.trip") is profiling.span("x")
    old = profiling.enable()
    profiling.disable()
    _call(world, "localize_refined")
    profiling.count("lm.trips", 3)
    profiling.count_mask("lm.live", torch.zeros(4, dtype=torch.bool))
    profiling.flush()
    assert profiling.active() is None
    assert not old.spans and not old.counters and not old._pending and not old.timers.samples


@pytest.mark.parametrize("entry", ["localize", "localize_refined", "localize_exact"])
def test_answers_are_bit_equal_with_tracing_on_and_off(world, entry):
    off = _flat(_call(world, entry))
    tracer = profiling.enable()
    on = _flat(_call(world, entry))
    profiling.flush()
    profiling.disable()
    assert tracer.spans
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


# -- the span tree --------------------------------------------------------------


def test_localize_refined_span_tree(world):
    tracer = profiling.enable()
    _call(world, "localize_refined")
    spans = sorted(tracer.spans, key=lambda s: s.t0_ns)
    ids = _by_id(tracer)
    root = spans[0]
    assert root.name == "localize_refined" and root.parent is None
    assert {s.request for s in spans} == {root.request}
    assert _children(tracer, root) == ["localize", "refine.rerank", "refine.pick"]
    loc = next(s for s in spans if s.name == "localize")
    assert _children(tracer, loc) == ["desc.triangles", "match.search", "match.verify", "match.rank"]
    search = next(s for s in spans if s.name == "match.search")
    assert _children(tracer, search) == ["search.probe", "search.select", "search.pairs"]
    verify = next(s for s in spans if s.name == "match.verify")
    assert _children(tracer, verify) == ["verify.hypotheses", "verify.votes", "verify.polish"]
    rerank = next(s for s in spans if s.name == "refine.rerank")
    assert _children(tracer, rerank) == ["refine.covariances", "refine.lm", "refine.fitness"]
    lm = next(s for s in spans if s.name == "refine.lm")
    trips = _children(tracer, lm)
    assert trips and set(trips) == {"refine.lm.trip"} and len(trips) == _total(tracer, "lm.trips")
    for s in spans:
        if s.parent is not None:
            p = ids[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    # Each span's ms also went to the stage timers.
    assert tracer.timers.summary()["refine.lm.trip"]["count"] == len(trips)


def test_each_root_call_is_a_request_and_localize_exact_counts_its_queries(world):
    tracer = profiling.enable()
    _call(world, "localize")
    _call(world, "localize_exact")
    roots = [s for s in sorted(tracer.spans, key=lambda s: s.t0_ns) if s.parent is None]
    assert [s.name for s in roots] == ["localize", "localize_exact"]
    assert roots[0].request != roots[1].request
    assert Counter(s.request for s in tracer.spans)[roots[0].request] == 11
    assert _children(tracer, roots[1]) == ["desc.triangles", "match.search", "match.verify", "match.rank"]
    exact_search = next(s for s in tracer.spans if s.name == "match.search" and s.request == roots[1].request)
    assert _children(tracer, exact_search) == ["search.totals", "search.probe", "search.select", "search.pairs"]
    assert list(tracer.counters["search.fallback_queries"]) == [(roots[1].request, 1)]


def test_index_build_spans(world):
    tracer = profiling.enable()
    index = build_map_index(world["maps"], CFG, "cpu")
    calibrate_scan_slots(index.db, build_descriptors_chunked(world["q"], index.config), index.config)
    point_covariances(world["mc"], world["mm"], CFG.gicp)
    roots = [s for s in sorted(tracer.spans, key=lambda s: s.t0_ns) if s.parent is None]
    assert [s.name for s in roots] == ["index.build", "desc.triangles", "index.calibrate", "refine.covariances"]
    assert _children(tracer, roots[0]) == ["index.descriptors", "index.table"]
    desc = next(s for s in tracer.spans if s.name == "index.descriptors")
    assert set(_children(tracer, desc)) == {"desc.triangles"}


# -- counters -------------------------------------------------------------------


def _total(tracer, name):
    """Sum of counter ``name`` (0 where nothing was added)."""
    return sum(v for _, v in tracer.counters.get(name, ()))



def _toy_problem(n=5):
    """A quadratic in the translation: linearize and error of refine.lsq's
    contract, with a call counter on linearize."""
    target = torch.linspace(0.1, 0.5, n, dtype=torch.float64)[:, None].expand(n, 3)
    calls = []

    def linearize(T):
        calls.append(1)
        r = T[:, :3, 3] - target
        H = torch.eye(6, dtype=T.dtype).expand(n, 6, 6).clone()
        g = torch.cat([r, torch.zeros_like(r)], -1)
        return H, g, (r * r).sum(-1), None

    def error(T, aux):
        r = T[..., :3, 3] - target[:, None]
        return (r * r).sum(-1)

    T0 = torch.eye(4, dtype=torch.float64).expand(n, 4, 4).clone()
    return linearize, error, T0, calls


@pytest.mark.parametrize("max_iterations", [1, 10])
def test_lm_trips_count_the_solver_trips_and_live_folds_at_flush(max_iterations):
    linearize, error, T0, calls = _toy_problem()
    tracer = profiling.enable()
    lm_solve(linearize, error, T0, max_iterations=max_iterations)
    assert _total(tracer, "lm.trips") == len(calls) >= 1
    assert _total(tracer, "lm.problems") == 5
    assert "lm.live" not in tracer.counters and len(tracer._pending) == len(calls)
    profiling.flush()
    live = [v for _, v in tracer.counters["lm.live"]]
    assert len(live) == len(calls) and live[0] == 5 and all(0 < v <= 5 for v in live)
    assert not tracer._pending
    assert [s.name for s in tracer.spans].count("refine.lm.trip") == len(calls)


def test_the_buffer_drops_the_oldest_spans_at_capacity_and_counts_them():
    timers = profiling.StageTimers()
    timers.add("s0", 1.0)
    tracer = profiling.enable(timers, capacity=4)
    for i in range(7):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in tracer.spans] == ["s3", "s4", "s5", "s6"]
    assert tracer.dropped == 3
    assert sorted(timers.samples) == [f"s{i}" for i in range(7)]
    for _ in range(5):
        with profiling.span("s0"):
            pass
    assert len(timers.samples["s0"]) == 4 and timers.summary()["s0"]["count"] == 4
    assert 1.0 not in timers.samples["s0"] and tracer.dropped == 3 + 5 + 3
    for _ in range(6):
        profiling.count("c", 2)
    assert len(tracer.counters["c"]) == 4 and tracer.dropped == 13
    for _ in range(6):
        profiling.count_mask("m", torch.zeros(2, dtype=torch.bool))
    assert len(tracer._pending) == 4 and tracer.dropped == 15
    profiling.flush()
    assert [v for _, v in tracer.counters["m"]] == [2] * 4
    with pytest.raises(ValueError):
        profiling.enable(capacity=0)


def test_the_kernel_library_load_is_recorded_once_a_process(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "_LOADS", {})
    monkeypatch.setattr(_build, "_library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(_build, "build", lambda: tmp_path / "missing.so")
    with mock.patch("ctypes.CDLL", return_value=mock.MagicMock()):
        tracer = profiling.enable()
        with profiling.span("search.probe"):
            _build.library.__wrapped__()
        _build.library.__wrapped__()
    rec = profiling.loads()["ops.load"]
    assert rec["compiled"] is True and rec["seconds"] >= 0.0 and rec["build_s"] >= 0.0
    # A record of the process, not a span: a load inside a traced request adds no span to it.
    assert [s.name for s in tracer.spans] == ["search.probe"]


# -- the device trace -----------------------------------------------------------


def _trace_events(d):
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_under_a_device_trace_the_ranges_nest_as_the_spans_and_hold_their_ops(world, tmp_path):
    tracer = profiling.enable()
    g = world["q"]
    with profiling.device_trace(str(tmp_path / "a")):
        build_descriptors(g, world["cfg"].desc, world["cfg"].caps)
    ev = _trace_events(tmp_path / "a")
    (rng,) = [e for e in ev if e["name"] == "sgtd:desc.triangles"]
    a, b = rng["ts"], rng["ts"] + rng["dur"]
    ops = [e for e in ev if e.get("cat") == "cpu_op" and e["tid"] == rng["tid"]]
    assert ops and all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in ops)
    (span,) = tracer.spans
    assert rng["args"]["request"] == span.request and rng["args"]["span"] == span.id

    tracer = profiling.enable()
    with profiling.device_trace(str(tmp_path / "b")):
        _call(world, "localize_refined")
    ranges = sorted((e for e in _trace_events(tmp_path / "b") if e["name"].startswith("sgtd:")),
                    key=lambda e: e["ts"])
    spans = sorted(tracer.spans, key=lambda s: s.t0_ns)
    assert [e["name"] for e in ranges] == ["sgtd:" + s.name for s in spans]
    by_span = {e["args"]["span"]: e for e in ranges}
    for s in spans:
        e = by_span[s.id]
        assert e["args"]["request"] == s.request and e["args"]["parent"] == s.parent
        if s.parent is not None:
            p = by_span[s.parent]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def test_a_trace_whose_ranges_do_not_pair_with_the_spans_is_left_unlabelled_with_a_warning(world, tmp_path):
    tracer = profiling.enable(capacity=1)
    with pytest.warns(UserWarning, match="do not pair"):
        with profiling.device_trace(str(tmp_path)):
            with profiling.span("localize"):
                build_descriptors(world["q"], world["cfg"].desc, world["cfg"].caps)
    assert tracer.dropped == 1
    ranges = [e for e in _trace_events(tmp_path) if e["name"].startswith("sgtd:")]
    assert len(ranges) == 2 and not any("span" in e.get("args", {}) for e in ranges)
