"""CPU tests of the scan kind (``kinds/scan.py``): a tiny ``hdl64`` cell
(24 keyframes and 16 queries of 8,192-point scans) run whole through the
harness and ``readings.py``, the faults of the front end its check must
catch, the frozen renderer against the one it was copied from, the
reference front end's settings against the program's, and a program
without ``localize_scan`` refused before set-up.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.gen import scans, world  # noqa: E402
from portbench.kinds import scan as scan_kind  # noqa: E402
from portbench.reference import frontend  # noqa: E402

torch.set_num_threads(2)

CELL = "tiny.scan.b1"
METRICS = ("index_build_s", "frontend_ms", "frontend_kernel_ms", "dcvc_sweeps")


def _json(path):
    with open(path) as f:
        return json.load(f)


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A benchmark directory of one tiny cell of the scan kind, held to
    ``hdl64.scan.b1``'s limits."""
    d = str(tmp_path_factory.mktemp("tinyscan"))
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["workloads"] = [{"name": CELL, "config": "tinyscan", "traffic": "scan.b1x16", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["per_layer"] = [dict(m, workloads=[CELL]) for m in bench["per_layer"] if m["name"] in METRICS]
    _write(os.path.join(d, "BENCHMARK.json"), bench)
    config = _json(os.path.join(PB, "configs", "hdl64.json"))
    config.update(name="tinyscan", map_frames=24, world=dict(config["world"], max_nodes=64),
                  overrides={"caps": {"max_descriptors": 512}},
                  scans=dict(config["scans"], max_points=8192, target_points=8000, ground_points=1000,
                             min_blob_points=40))
    _write(os.path.join(d, "configs", "tinyscan.json"), config)
    _write(os.path.join(d, "traffic", "scan.b1x16.json"), dict(_json(os.path.join(PB, "traffic", "scan.b1.json")),
                                                                queries=16))
    _write(os.path.join(d, "cells", f"{CELL}.json"), _json(os.path.join(PB, "cells", "hdl64.scan.b1.json")))
    return d


def _run(d, traced=False, seed=7, seconds=0.5):
    return harness.run(d, CELL, seed, seconds, traced, device="cpu", base=d)


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cell_runs_correct(tiny, traced):
    out = _run(tiny, traced)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"node_off", "node_gap_med_m", "cand_off", "pose_gap_med_m", "pose_far_n"}
    # No device on the CPU: the kernel time of the front end has nothing to read.
    want = {"index_build_s", "frontend_ms", "dcvc_sweeps"} if traced else {"scans_per_s", "latency_p95_ms", "setup_s"}
    assert set(out["metrics"]) == want
    if traced:
        assert out["metrics"]["dcvc_sweeps"]["value"] >= 2


def test_the_readings_of_the_kind(tiny):
    """Sound readings pass the cell's limits; the control (the reference on
    points rounded to bfloat16) does not."""
    from portbench.check import verdict
    from portbench.readings import readings

    out = readings(CELL, 2**31 + 3, control=True, device="cpu", root=tiny, base=tiny)
    limits = harness.load_cell(tiny, CELL, base=tiny)["limits"]
    assert out["replay_off"] == 0 and out["sound"]["answers"] == 16
    assert verdict(out["sound"], limits)[0], out["sound"]
    assert not verdict(out["control"], limits)[0], out["control"]
    assert set(out["sound"]["node_off_at"]) == {str(s) for s in scan_kind.SHARE_LADDER}


def _six_connected():
    return mock.patch("sgtd_tpu_torch.cluster.dcvc._NEIGH", np.array(
        [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)], np.int32))


def _min_seg_ignored():
    from sgtd_tpu_torch.graph import build

    cluster = build.dcvc_cluster
    return mock.patch.object(build, "dcvc_cluster", lambda p, m, min_seg, *a, **k: cluster(p, m, 0, *a, **k))


def _query_graphs(change):
    """The timed path's graphs (``localize_scan``'s ``build_graph``) as
    ``change`` makes them from (args, graph)."""
    from sgtd_tpu_torch.match import pipeline

    build_graph = pipeline.build_graph
    return mock.patch.object(pipeline, "build_graph", lambda *a: change(a, build_graph))


def _sidewalk_dropped():
    return _query_graphs(lambda a, f: f(*a[:7], dataclasses.replace(a[7], whole_classes=())))


def _centroids_moved():
    def moved(a, f):
        g = f(*a)
        return g._replace(centers=g.centers + 0.05 * g.mask[:, None])

    return _query_graphs(moved)


def _previous_scan():
    from portbench import program_scan

    localize_scan, last = program_scan.localize_scan, {}

    def answer(db, *scan):
        prev = last.get("scan", scan)
        last["scan"] = scan
        return localize_scan(db, *prev)

    return mock.patch.object(program_scan, "localize_scan", answer)


@pytest.mark.parametrize("fault", [_six_connected, _min_seg_ignored, _sidewalk_dropped, _centroids_moved,
                                   _previous_scan])
def test_a_broken_front_end_is_not_correct(tiny, fault):
    with fault():
        out = _run(tiny, seconds=8.0)  # every query answered at least once
    assert out["attempted"] >= 16
    node_off = out["checks"]["node_off"]
    assert not out["correct"] and node_off["value"] > node_off["limit"], out["checks"]


def test_a_program_without_the_entry_fails_before_set_up(tiny):
    from sgtd_tpu_torch.match import pipeline

    with mock.patch.object(harness, "Run", side_effect=AssertionError("set-up began")):
        with mock.patch.dict(sys.modules, {"sgtd_tpu_torch.match.pipeline": object()}):
            with pytest.raises(ImportError):
                _run(tiny)
    assert pipeline.localize_scan


def test_the_frozen_renderer_equals_the_one_it_was_copied_from():
    import chip_smoke

    s = {"max_points": 131072, "target_points": chip_smoke.FRONT_TARGET_PTS,
         "ground_points": chip_smoke.FRONT_GROUND_PTS, "min_blob_points": chip_smoke.FRONT_MIN_BLOB,
         "blob_sigma_m": 0.15, "ground_noise_m": 0.03, "view_radius_m": chip_smoke.FRONT_VIEW_M}
    assert _json(os.path.join(PB, "configs", "hdl64.json"))["scans"] == s
    wd = world.make_world(np.random.default_rng(chip_smoke.FRONT_SEED), num_map_frames=8, num_queries=2)
    pts, sem = scans.render(wd, wd.map_poses[3], (chip_smoke.FRONT_SEED, 3), s)
    want_pts, want_sem, want_inst, _, _ = chip_smoke.render_labeled_scan(wd, wd.map_poses[3], (chip_smoke.FRONT_SEED, 3))
    assert np.array_equal(pts, want_pts) and np.array_equal(sem, want_sem.astype(np.int32)) and not want_inst.any()
    assert 100_000 < len(pts) <= 131_072


def test_reference_front_end_settings_are_the_programs():
    from sgtd_tpu_torch.cluster import dcvc
    from sgtd_tpu_torch.config import DcvcConfig
    from sgtd_tpu_torch.graph.build import MULRAN_ROUTING

    d, r = DcvcConfig(), frontend.Dcvc()
    for f in ("start_r", "delta_r", "delta_p", "delta_a", "min_range", "max_range", "max_clusters"):
        assert getattr(r, f) == getattr(d, f), f
    assert (r.polar_bins, r.pitch_bins) == (dcvc._POLAR_MAX, dcvc._PITCH_MAX)
    routing = MULRAN_ROUTING
    assert frontend.WHOLE_CLASSES == routing.whole_classes
    assert frontend.MIN_SEG == {c: dict(routing.min_seg).get(c, routing.default_min_seg)
                                for c in routing.instance_classes}
    assert frontend.NODE_MAP == dict(routing.node_map) and frontend.KEEP == (routing.keep_lo, routing.keep_hi)
    assert sorted(map(tuple, dcvc._NEIGH.tolist())) == sorted(frontend.NEIGHBOURS)


@pytest.mark.parametrize("metric,want", [("frontend_ms", 30.0), ("frontend_kernel_ms", 2.5), ("dcvc_sweeps", 4.5)])
def test_the_readers_on_a_canned_record(metric, want):
    record = {"scans": 16, "spans": {"frontend": [20.0, 40.0], "dcvc_sweeps": [4.0, 5.0]},
              "profile": {"stage_kernel_s": {"frontend": 0.04}}}
    assert harness.reader(metric)(record) == pytest.approx(want)
