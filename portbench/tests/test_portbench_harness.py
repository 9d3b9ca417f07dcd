"""CPU tests of the benchmark's harness (``portbench/``).

Tiny cells (24 keyframes, 8 queries, small clouds) run the whole of a run
on the CPU, the look for a card skipped: the program against the plain
reference, the reference's pair-list rules, the faults a check must catch,
the control, what the process has imported, and a configuration of
another kind brought as files alone. A test that needs the card
says so inside itself and skips here.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path.insert(0, ROOT)

from portbench import check, harness, trace, work  # noqa: E402
from portbench.gen import world  # noqa: E402
from portbench.reference import pipeline as ref_pipeline  # noqa: E402
from portbench.reference import search as ref_search  # noqa: E402
from portbench.reference.params import Params  # noqa: E402

torch.set_num_threads(2)

TINY = {
    "name": "tiny", "map_frames": 24,
    "world": {"extent_m": 400.0, "max_nodes": 64, "map_obs": {},
              "query_obs": {"center_noise_m": 0.05, "dropout": 0.1, "label_corrupt_rate": 0.05},
              "clouds": {"map_points": 512, "query_points": 128, "leaf_m": 3.0, "rng_stream": 77}},
    "overrides": {"caps": {"max_descriptors": 512}}, "calibrate_queries": 16,
}
# Few hits a descriptor and short pair lists: the strided subsample and the cap.
TINY_CAPS = {"caps": {"max_descriptors": 512, "hits_per_descriptor": 2, "pairs_per_candidate": 64}}
TRAFFIC = {"refined.b4": {"entry": "localize_refined", "batch": 4, "queries": 8, "rerank_k": 4},
           "desc.b4": {"entry": "localize", "batch": 4, "queries": 8, "rerank_k": 0},
           "desc.b1": {"entry": "localize", "batch": 1, "queries": 4, "rerank_k": 0},
           "refined.b4x64": {"entry": "localize_refined", "batch": 4, "queries": 64, "rerank_k": 4},
           "refined.b2x64": {"entry": "localize_refined", "batch": 2, "queries": 64, "rerank_k": 4},
           "desc.b4x32": {"entry": "localize", "batch": 4, "queries": 32, "rerank_k": 0}}
# Tiny cells, each held to the limits of the cell it stands for.
CELLS = {"tiny.refined.b4": ("tiny", "refined.b4", "site200.refined.b16"),
         "tinycaps.refined.b4": ("tinycaps", "refined.b4", "site200.refined.b16"),
         "tiny.desc.b4": ("tiny", "desc.b4", "fleet5k.desc.b8"),
         "tiny.desc.b1": ("tiny", "desc.b1", "site200.desc.b1"),
         # Enough queries that a fault on one slot of the batch stays under half of them.
         "tiny.refined.b4x64": ("tiny", "refined.b4x64", "site200.refined.b16"),
         "tiny.refined.b2x64": ("tiny", "refined.b2x64", "site200.refined.b16"),
         "tiny.desc.b4x32": ("tiny", "desc.b4x32", "fleet5k.desc.b8")}


def _json(path):
    with open(path) as f:
        return json.load(f)


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A benchmark directory of tiny cells beside the real one's metrics."""
    d = str(tmp_path_factory.mktemp("tiny"))
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "a CPU test"}
                          for n, (c, t, _) in CELLS.items()]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    _write(os.path.join(d, "BENCHMARK.json"), bench)
    _write(os.path.join(d, "configs", "tiny.json"), TINY)
    _write(os.path.join(d, "configs", "tinycaps.json"), dict(TINY, overrides=TINY_CAPS))
    for name, t in TRAFFIC.items():
        _write(os.path.join(d, "traffic", f"{name}.json"), t)
    for name, (_, _, real) in CELLS.items():
        _write(os.path.join(d, "cells", f"{name}.json"), _json(os.path.join(PB, "cells", f"{real}.json")))
    return d


def _run(d, cell, traced=False, seed=7, seconds=0.3):
    return harness.run(d, cell, seed, seconds, traced, device="cpu", base=d)


# -- files found by name --------------------------------------------------


def test_every_cell_and_metric_of_the_benchmark_loads_by_name():
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        spec = harness.load_cell(ROOT, w["name"])
        assert spec["traffic"]["batch"] >= 1 and spec["config"]["map_frames"] > 0
        assert set(spec["limits"]) >= {"cand_off", "pose_gap_med_m"}
        assert spec["per_layer"], w["name"]
        reports = {m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
        assert {m["name"] for m in spec["end_to_end"]} == reports and {"latency_p95_ms", "setup_s"} <= reports
        assert all(m["moves"] in reports for m in spec["per_layer"])
        assert "index_build_s" in {m["name"] for m in spec["per_layer"]}
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for c in bench["configs"]:
        cfg = _json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])


def test_a_new_cell_is_found_from_added_files_alone(tmp_path):
    """A cell, its configuration and its traffic added as files (and a row of
    BENCHMARK.json) load without a change to any file already there."""
    base = tmp_path / "pb"
    shutil.copytree(PB, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (base / p).read_bytes() for p in ("configs/site200.json", "traffic/desc.b1.json")}
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["workloads"].append({"name": "depot60.desc.b4", "config": "depot60", "traffic": "desc.b4",
                               "chips": 1, "why": "a new cell"})
    _write(str(tmp_path / "BENCHMARK.json"), bench)
    _write(str(base / "configs" / "depot60.json"), dict(_json(base / "configs" / "site200.json"), name="depot60",
                                                         map_frames=60))
    _write(str(base / "traffic" / "desc.b4.json"), TRAFFIC["desc.b4"])
    _write(str(base / "cells" / "depot60.desc.b4.json"), _json(base / "cells" / "site200.desc.b1.json"))
    spec = harness.load_cell(str(tmp_path), "depot60.desc.b4", base=str(base))
    assert spec["config"]["map_frames"] == 60 and spec["traffic"]["batch"] == 4
    assert {m["name"] for m in spec["per_layer"]} == set()  # every metric lists its cells
    assert all((base / p).read_bytes() == b for p, b in before.items())


# -- a configuration's kind ------------------------------------------------

TOY_KIND = '''"""A kind of configuration that only a test brings: the norm of each row
of a matrix made from the seed, on the device, against float64 NumPy."""

import time

import numpy as np
import torch


def check(config, traffic):
    if traffic["batch"] < 1:
        raise ValueError("a batch holds a row or more")


def make_inputs(seed, config, traffic):
    rng = np.random.default_rng([abs(seed), int(seed < 0)])
    return {"rows": rng.standard_normal((traffic["queries"], config["width"])).astype(np.float32)}


class Service:
    def __init__(self, inputs, config, traffic, device):
        self.dev, self.rows, b = torch.device(device), inputs["rows"], traffic["batch"]
        self.batches = [(list(range(s, min(s + b, len(self.rows)))), self.rows[s : s + b])
                        for s in range(0, len(self.rows), b)]
        self.table = None

    def build(self, frames=None):
        self.table = torch.from_numpy(self.rows[:frames]).to(self.dev)

    def free(self):
        self.table = None

    def serve(self, i):
        x = torch.from_numpy(self.batches[i][1]).to(self.dev)
        return {"norm": torch.linalg.vector_norm(x, dim=1).cpu().numpy()}

    def staged(self, i, spans, profiled=False):
        t0 = time.perf_counter()
        ans = self.serve(i)
        spans.setdefault("norm", []).append((time.perf_counter() - t0) * 1e3)
        return ans

    def warm(self):
        pass

    def describe(self):
        return f"{len(self.batches)} batches"

    def work(self, profiled_answers, spans):
        return {"norm": sum(4.0 * self.batches[b][1].size for b, _ in profiled_answers) / 3.35e12}


def reference(inputs, config, traffic, device, control=False):
    x = inputs["rows"].astype(np.float16 if control else np.float64)
    return {"norm": np.sqrt((x * x).sum(1, dtype=x.dtype))}


def numbers(answers, ref):
    ids = np.concatenate([q for q, _ in answers])
    got = np.concatenate([a["norm"] for _, a in answers])
    return {"norm_gap": float(np.max(np.abs(got - ref["norm"][ids]) / ref["norm"][ids])), "answers": int(ids.size),
            "extras": {}}


def control_answers(ref_ctl):
    return [(np.arange(len(ref_ctl["norm"])), {"norm": ref_ctl["norm"]})]


def readings(answers, ref):
    return numbers(answers, ref)
'''


@pytest.fixture
def toy(tmp_path):
    """A benchmark directory of one cell of the toy kind, its files all new."""
    d = str(tmp_path)
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["workloads"] = [{"name": "toy.rows.b4", "config": "toy", "traffic": "rows.b4", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["per_layer"] = [dict(next(m for m in bench["per_layer"] if m["name"] == "index_build_s"),
                               workloads=["toy.rows.b4"])]
    _write(os.path.join(d, "BENCHMARK.json"), bench)
    _write(os.path.join(d, "configs", "toy.json"), {"name": "toy", "kind": "toy", "width": 16})
    _write(os.path.join(d, "traffic", "rows.b4.json"), {"batch": 4, "queries": 32})
    _write(os.path.join(d, "cells", "toy.rows.b4.json"), {"limits": {"norm_gap": 1e-5}})
    os.makedirs(os.path.join(d, "kinds"))
    with open(os.path.join(d, "kinds", "toy.py"), "w") as f:
        f.write(TOY_KIND)
    return d


@pytest.mark.parametrize("traced", [False, True])
def test_a_kind_added_as_files_runs_correct(toy, traced):
    out = _run(toy, "toy.rows.b4", traced=traced)
    assert out["correct"], out["checks"]
    assert list(out["checks"]) == ["norm_gap"] and out["attempted"] >= 32
    assert set(out["metrics"]) == ({"index_build_s"} if traced else {"scans_per_s", "latency_p95_ms", "setup_s"})
    # The benchmark's own files know nothing of the toy kind.
    assert not os.path.exists(os.path.join(PB, "kinds", "toy.py"))
    for d, _, files in os.walk(PB):
        if os.path.basename(d) not in ("tests", "__pycache__"):
            for f in files:
                assert "toy" not in open(os.path.join(d, f), errors="replace").read(), f


def test_the_toy_kinds_control_is_not_correct(toy):
    spec = harness.load_cell(toy, "toy.rows.b4", base=toy)
    kind = spec["kind"]
    inputs = kind.make_inputs(2**31 + 5, spec["config"], spec["traffic"])
    ref = kind.reference(inputs, spec["config"], spec["traffic"], "cpu")
    ctl = kind.reference(inputs, spec["config"], spec["traffic"], "cpu", control=True)
    ok, table = check.verdict(kind.numbers(kind.control_answers(ctl), ref), spec["limits"])
    assert not ok, table


def test_the_readings_of_a_kind_added_as_files(toy):
    """``readings.py`` takes a new kind's sound and control readings, which
    its limits are set from, with no edit."""
    from portbench.readings import readings

    out = readings("toy.rows.b4", 2**31 + 7, control=True, device="cpu", root=toy, base=toy)
    assert out["replay_off"] == 0 and out["index"] == "8 batches"
    assert out["sound"]["norm_gap"] <= 1e-5 < out["control"]["norm_gap"]


def test_a_kind_refuses_traffic_it_cannot_serve_before_set_up(toy, tiny, tmp_path):
    _write(os.path.join(toy, "traffic", "rows.b4.json"), {"batch": 0, "queries": 32})
    d = str(tmp_path / "graph")
    shutil.copytree(tiny, d)
    traffic = _json(os.path.join(d, "traffic", "refined.b4.json"))
    _write(os.path.join(d, "traffic", "refined.b4.json"), dict(traffic, rerank_k=0))
    with mock.patch.object(harness, "Run", side_effect=AssertionError("set-up began")):
        with pytest.raises(ValueError, match="rows.b4: a batch holds"):
            _run(toy, "toy.rows.b4")
        with pytest.raises(ValueError, match="refined.b4: localize_refined, and only it"):
            _run(d, "tiny.refined.b4")


@pytest.mark.parametrize("cell", ["tiny.refined.b4", "tiny.desc.b1"])
def test_an_explicit_graph_kind_is_the_default(tiny, tmp_path, cell):
    """``"kind": "graph"`` in the configuration gives the answers and the
    check table that no key gives."""
    d = str(tmp_path)
    shutil.copytree(tiny, d, dirs_exist_ok=True)
    config, traffic, _ = CELLS[cell]
    named = dict(_json(os.path.join(tiny, "configs", f"{config}.json")), kind="graph")
    _write(os.path.join(d, "configs", f"{config}.json"), named)
    out = []
    for base in (tiny, d):
        spec = harness.load_cell(base, cell, base=base)
        assert spec["kind"].__name__ == "portbench_kinds_graph"
        r = harness.Run(spec, 17, "cpu")
        r.svc.build()
        answers = [(ids, r.svc.serve(i)) for i, (ids, _) in enumerate(r.svc.batches)]
        ref = spec["kind"].reference(r.inputs, spec["config"], spec["traffic"], "cpu")
        out.append((r.inputs, answers, check.verdict(spec["kind"].numbers(answers, ref), spec["limits"])))
    (inp_a, ans_a, table_a), (inp_b, ans_b, table_b) = out
    assert table_a == table_b and table_a[0], table_a
    assert _same(inp_a, inp_b) and _same(ans_a, ans_b)


def _same(a, b) -> bool:
    """Equal bit for bit, through dicts, lists, tuples and dataclasses."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        return _same(vars(a), vars(b))
    return np.array_equal(a, b)


def test_an_unknown_kind_fails_before_set_up(tiny, tmp_path):
    d = str(tmp_path)
    shutil.copytree(tiny, d, dirs_exist_ok=True)
    _write(os.path.join(d, "configs", "tiny.json"), dict(TINY, kind="lattice9"))
    with mock.patch.object(harness, "Run", side_effect=AssertionError("set-up began")):
        with pytest.raises(ValueError, match="lattice9"):
            _run(d, "tiny.desc.b1")


# -- readers and the trace -------------------------------------------------

RECORD = {
    "scans": 64, "index_build_s": 0.25, "window_scans": 1200, "window_s": 8.0,
    "spans": {"desc": [4.0, 6.0], "search": [3.0, 5.0], "verify": [20.0, 22.0], "refine": [60.0, 70.0]},
    "work": {"search": 2e-6, "refine": 4e-5},
    "profile": {"stage_kernel_s": {"search": 4e-4, "refine": 8e-4}, "window_s": 0.5, "busy_s": 0.05,
                "device_ops": 6400},
}


@pytest.mark.parametrize("metric,want", [
    ("desc_ms", 5.0), ("search_ms", 4.0), ("verify_ms", 21.0), ("refine_ms", 65.0),
    ("search_roofline", 0.5), ("refine_roofline", 5.0), ("device_idle_pct", 90.0),
    ("device_ops_per_scan", 100.0), ("index_build_s", 0.25), ("scans_per_s.staged", 150.0),
])
def test_readers_on_a_canned_record(metric, want):
    got = harness.reader(metric)(RECORD)
    assert got == pytest.approx(want) if want is not None else got is None


def test_readers_find_nothing_in_an_empty_record():
    for path in os.listdir(os.path.join(PB, "metrics")):
        assert harness.reader(path[:-3])({}) is None


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary_on_a_canned_trace():
    ev = [
        _ev("user_annotation", "pb:search", 0, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        _ev("kernel", "probe", 20, 30, corr=1, tid=7),
        _ev("user_annotation", "pb:request", 200, 100),
        _ev("cpu_op", "aten::mul", 205, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 5, corr=2),
        _ev("kernel", "verify", 230, 20, corr=2, tid=7),
        _ev("gpu_memcpy", "Memcpy DtoH", 260, 10, corr=3, tid=7),
        _ev("cuda_runtime", "cudaMemcpyAsync", 255, 5, corr=3),
    ]
    s = trace.summarize(ev)
    assert s["stage_kernel_s"] == {"search": pytest.approx(30e-6)}
    assert s["requests"] == 1 and s["device_ops"] == 2
    assert s["window_s"] == pytest.approx(100e-6) and s["busy_s"] == pytest.approx(30e-6)
    assert s["breakdown"]["device_ops"][0] == ["verify", pytest.approx(20e-6)]
    # Gaps 200-230, 250-260, 270-300, named by what holds their midpoints.
    assert dict(s["breakdown"]["idle_gaps"]) == {"cudaLaunchKernel": pytest.approx(30e-6),
                                                 "cudaMemcpyAsync": pytest.approx(10e-6),
                                                 "python, between operations": pytest.approx(30e-6)}


def test_work_counts():
    assert work.search_bytes([10, 20], 8) == 8 * 30 + 4 * 2 * 8
    assert work.refine_flops(11, 1, 64 * 300 * 4000, 16 * 300 * 300) == 8 * (11 * 64 * 300 * 4000 + 16 * 300 * 300)


def test_refine_work_counts_valid_points_only(tiny):
    """The rerank's point pairs come from the masks, padded points and
    padded keyframe rows left out."""
    spec = harness.load_cell(tiny, "tiny.refined.b4", base=tiny)
    r = harness.Run(spec, 3, "cpu")
    r.svc.build()
    qm, mm = r.inputs["query_masks"], r.inputs["map_masks"]
    frames = np.array([[0, 1], [2, -1]])
    if r.svc.db.frame_poses.shape[0] == mm.shape[0]:
        frames[1, 1] = 3
    pairs, self_pairs = r.svc.valid_points([0, 1], frames)
    nq, nm = qm[:2].sum(1), mm.sum(1)
    want = nq[0] * (nm[0] + nm[1]) + nq[1] * (nm[2] + (nm[3] if frames[1, 1] == 3 else 0))
    assert (pairs, self_pairs) == (want, int((nq * nq).sum()))
    assert work.bound_s(nbytes=3.35e12) == pytest.approx(1.0) and work.bound_s(flops=67e12) == pytest.approx(1.0)


# -- the frozen inputs and the reference's settings ---------------------------


def test_frozen_generator_equals_the_programs_bit_for_bit():
    from sgtd_tpu_torch.config import SGTDConfig
    from sgtd_tpu_torch.data import synthetic
    from sgtd_tpu_torch.ops.voxel import load_query_cloud

    cfg = SGTDConfig()
    obs = dict(center_noise_m=0.05, dropout=0.1, label_corrupt_rate=0.05)
    maps, queries, w = world.make_map_and_queries(5, 24, 6, 400.0, 128, {}, obs)
    m2, q2, w2 = synthetic.make_map_and_queries(cfg, seed=5, num_map_frames=24, num_queries=6, **obs)
    for a, b in zip(maps + queries, m2 + q2):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for pose in w.query_poses[:3]:
        pa, ma = world.render_planar_cloud(w, pose, rng_a, max_points=2048)
        pb, mb = synthetic.render_planar_cloud(w2, pose, rng_b, max_points=2048)
        assert np.array_equal(pa, pb) and np.array_equal(ma, mb)
        assert all(np.array_equal(x, y) for x, y in zip(world.query_cloud(pa[ma], 3.0, 256),
                                                        load_query_cloud(pb[mb], 3.0, 256)))


def test_reference_settings_are_the_programs_defaults():
    from sgtd_tpu_torch.config import SGTDConfig

    cfg, p = SGTDConfig(), Params()
    for group in (cfg.desc, cfg.search, cfg.caps, cfg.gicp):
        for f in group.__dataclass_fields__:
            if hasattr(p, f):
                assert getattr(p, f) == getattr(group, f), f
    assert p.fitness_radius == cfg.gicp.fitness_radius
    assert p.extent == 52


# -- the program against the reference, and what must fail ----------------


@pytest.mark.parametrize("cell", [c for c in CELLS if "x" not in c.rsplit(".", 1)[1]])
def test_a_cpu_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"scans_per_s", "latency_p95_ms", "setup_s"}


def test_a_traced_cpu_run_reads_its_stage_spans(tiny):
    out = _run(tiny, "tiny.refined.b4", traced=True)
    assert out["correct"], out["checks"]
    assert {"desc_ms", "search_ms", "verify_ms", "refine_ms", "index_build_s", "scans_per_s.staged"} <= set(out["metrics"])


def test_reference_pair_lists_past_the_scan_budget(tiny):
    """Every query past the budget: the reference's candidate-major pair
    lists against the program's ``localize_exact`` and single rerank."""
    spec = harness.load_cell(tiny, "tiny.refined.b4", base=tiny)
    r = harness.Run(spec, 12, "cpu")
    r.svc.build()
    read = r.svc._read

    def flagged(res, final=None):
        out = read(res, final)
        if len(out["trunc"]) > 1:
            out["trunc"][:] = True
        return out

    with mock.patch.object(r.svc, "_read", flagged):
        answers = [(ids, r.svc.serve(i)) for i, (ids, _) in enumerate(r.svc.batches)]
    with mock.patch.object(ref_search, "scan_budget", lambda totals, p: 0):
        ref = ref_pipeline.answers(r.inputs, spec["config"], spec["traffic"], "cpu")
    assert ref["trunc"].all()
    ok, table = check.verdict(check.numbers(answers, ref), spec["limits"])
    assert ok, table


def spec_queries(d, cell):
    return harness.load_cell(d, cell, base=d)["traffic"]["queries"]


def _half_batch(localize_descriptors):
    """localize on the first half of the batch, its answers repeated for
    the rest."""

    def fault(db, query, config):
        b = query.mask.shape[0]
        res = localize_descriptors(db, type(query)(*(x[: b // 2] for x in query)), config)
        return type(res)(*(torch.cat([x, x])[:b] for x in res))

    return fault


def _moved_answer(rank_candidates):
    """Each answer's poses moved 5 cm where they are produced."""

    def fault(*args, **kw):
        res = rank_candidates(*args, **kw)
        poses = res.poses.clone()
        poses[..., 0, 3] += 0.05
        return res._replace(poses=poses)

    return fault


def _one_slot_moved(rank_candidates):
    """The first slot of each batch: its poses moved 5 cm where they are
    produced; the other slots' answers untouched."""

    def fault(*args, **kw):
        res = rank_candidates(*args, **kw)
        poses = res.poses.clone()
        poses[0, :, 0, 3] += 0.05
        return res._replace(poses=poses)

    return fault


def _rerank_skipped(localize_refined):
    """Every third query of a batch keeps its descriptor pose, unrefined."""

    def fault(*args, **kw):
        out = localize_refined(*args, **kw)
        skip = torch.arange(out.refined.shape[0], device=out.refined.device) % 3 == 0
        pose = torch.where(skip[:, None, None], out.result.poses[:, 0], out.pose)
        return out._replace(pose=pose, refined=out.refined & ~skip)

    return fault


def _one_final_pose_moved(localize_refined):
    """The first slot of each batch: its final pose moved 5 cm."""

    def fault(*args, **kw):
        out = localize_refined(*args, **kw)
        pose = out.pose.clone()
        pose[0, 0, 3] += 0.05
        return out._replace(pose=pose)

    return fault


def _state_unchanged(lm_solve):
    """The LM solver returns its starting transform."""

    def fault(linearize, error, T0, **kw):
        res = lm_solve(linearize, error, T0, **kw)
        return res._replace(transform=T0)

    return fault


@pytest.mark.parametrize("cell,target,fault,counted", [
    ("tiny.refined.b4", "sgtd_tpu_torch.refine.gicp.lm_solve", _state_unchanged, None),
    ("tiny.refined.b4", "sgtd_tpu_torch.match.pipeline.localize_descriptors", _half_batch, None),
    ("tiny.desc.b4", "sgtd_tpu_torch.match.pipeline.localize_descriptors", _half_batch, None),
    ("tiny.refined.b4", "sgtd_tpu_torch.match.pipeline.rank_candidates", _moved_answer, None),
    ("tiny.desc.b1", "sgtd_tpu_torch.match.pipeline.rank_candidates", _moved_answer, None),
    # Faults on a few answers, which the medians pass: a count fails them.
    ("tiny.refined.b4x64", "sgtd_tpu_torch.match.pipeline.rank_candidates", _one_slot_moved, "pose_far_n"),
    ("tiny.desc.b4x32", "sgtd_tpu_torch.match.pipeline.rank_candidates", _one_slot_moved, "pose_far_n"),
    ("tiny.refined.b4x64", "portbench.program.localize_refined", _rerank_skipped, "refined_off"),
    # One slot of two: the tiny world's reference verifies every candidate
    # of only ~3/4 of its queries (site200's of all), so a slot of four
    # leaves too few for the count at site200's limit.
    ("tiny.refined.b2x64", "portbench.program.localize_refined", _one_final_pose_moved, "refined_far_n"),
])
def test_a_broken_timed_path_is_not_correct(tiny, cell, target, fault, counted):
    mod, name = target.rsplit(".", 1)
    module = __import__(mod, fromlist=[name])
    with mock.patch.object(module, name, fault(getattr(module, name))):
        # The window of a cell of 32 or 64 queries answers every batch at least once.
        out = _run(tiny, cell, seconds=30.0 if counted else 0.3)
    assert not out["correct"], out["checks"]
    if counted:
        assert out["attempted"] >= spec_queries(tiny, cell)
        failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
        assert counted in failed, out["checks"]
        if "b4x" in cell:  # a quarter of the answers or fewer: the medians pass
            assert not failed & {"pose_gap_med_m", "refined_gap_med_m"}, out["checks"]


@pytest.mark.parametrize("cell", ["tiny.refined.b4", "tiny.desc.b1"])
def test_the_control_is_not_correct(tiny, cell):
    """The reference in TF32 in the program's place fails the cell's limits."""
    spec = harness.load_cell(tiny, cell, base=tiny)
    control_answers = spec["kind"].control_answers
    inputs = world.make_inputs(21, spec["config"], spec["traffic"]["queries"], spec["traffic"]["rerank_k"] > 0)
    ref = ref_pipeline.answers(inputs, spec["config"], spec["traffic"], "cpu")
    ctl = ref_pipeline.answers(inputs, spec["config"], spec["traffic"], "cpu", control=True)
    ok, table = check.verdict(check.numbers(control_answers(ctl), ref), spec["limits"])
    assert not ok, table
    assert table["pose_gap_med_m"]["value"] > table["pose_gap_med_m"]["limit"]


def test_the_check_reads_each_kind_of_difference():
    eye = np.tile(np.eye(4), (2, 1, 1))
    ref = {"num_desc": np.array([5, 5]), "frames": np.array([[1, 2], [3, 4]]), "votes": np.array([[9, 7], [8, 6]]),
           "found": np.array([True, True]), "best_frame": np.array([1, 3]), "pose": eye.copy(),
           "cand_score": np.array([[40.0, 39.0], [50.0, 20.0]]), "cand_pose": np.stack([eye, eye], 1),
           "refined": np.array([True, True]), "final_pose": eye.copy(), "rerank_ok": np.array([True, True])}
    got = {k: copy.deepcopy(ref[k]) for k in ("num_desc", "found", "best_frame", "pose", "refined", "final_pose")}
    got["frames"] = ref["frames"][:, ::-1].copy()  # score order: the same list
    got["votes"] = ref["votes"][:, ::-1].astype(np.float32)
    nums = check.numbers([(np.arange(2), got)], ref)
    assert {k: nums[k] for k in ("cand_off", "pose_gap_med_m", "pose_far_n", "refined_off", "refined_far_n",
                                 "refined_gap_med_m", "answers")} == dict.fromkeys(
        ("cand_off", "pose_gap_med_m", "pose_far_n", "refined_off", "refined_far_n", "refined_gap_med_m"), 0) | {
        "answers": 2}
    # One query's pose 25 cm off, answered twice: it counts once among the far ones.
    got["pose"][0, 0, 3] += 0.25
    twice = [(np.arange(2), got), (np.arange(2), got)]
    nums = check.numbers(twice, ref)
    assert (nums["pose_far_n"], nums["answers"], nums["cand_off"]) == (1, 4, 0)
    assert nums["pose_gap_med_m"] == pytest.approx(0.125)
    got["best_frame"][0] = 2  # one inlier below the best: another keyframe, wrong
    assert check.numbers(twice, ref)["cand_off"] == 2
    got["refined"][1] = False
    got["final_pose"][0, 0, 3] += 0.5
    nums = check.numbers(twice, ref)
    assert (nums["refined_off"], nums["refined_far_n"]) == (2, 1)
    got["votes"][0, 0] += 1
    assert check.numbers([(np.arange(2), got)], ref)["cand_off"] == 1


# -- what the run imports --------------------------------------------------


def test_a_run_imports_no_jax_and_the_reference_nothing_of_the_program(tiny):
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads(2)
from portbench.reference import pipeline
from portbench.gen import world
from portbench import harness
spec = harness.load_cell({tiny!r}, "tiny.desc.b1", base={tiny!r})
inp = world.make_inputs(3, spec["config"], 4, False)
pipeline.answers(inp, spec["config"], spec["traffic"], "cpu")
print("REFERENCE", sorted(m for m in sys.modules if m.split(".")[0] == "sgtd_tpu_torch"))
harness.run({tiny!r}, "tiny.refined.b4", 5, 0.2, True, device="cpu", base={tiny!r})
print("RUN", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines() if line.startswith(("REFERENCE", "RUN")))
    assert lines == {"REFERENCE": "[]", "RUN": "[]"}


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted(os.listdir(os.path.join(PB, "reference"))):
        if path.endswith(".py"):
            tree = ast.parse(open(os.path.join(PB, "reference", path)).read())
            names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
            assert not [n for n in names if n.split(".")[0] in ("sgtd_tpu_torch", "sgtd_tpu", "jax", "jaxlib")], path


def test_forbidden_modules_compare_whole_top_level_names():
    with mock.patch.dict(sys.modules, {"sgtd_tpu_torchx": object(), "jaxfoo": object()}):
        assert harness.forbidden_modules() == sorted(m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN)
        assert "sgtd_tpu_torchx" not in harness.forbidden_modules()
    with mock.patch.dict(sys.modules, {"jax.numpy": object()}):
        assert "jax.numpy" in harness.forbidden_modules()


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(PB, "run.py"), "--workload", "site200.desc.b1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


# -- on the card -----------------------------------------------------------


def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's own runs measure on the H100")
    out = subprocess.run([sys.executable, os.path.join(PB, "run.py"), "--workload", "site200.desc.b1",
                          "--seed", "2147483649", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
