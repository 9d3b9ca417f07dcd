"""CPU tests of ``portbench/spans.py``: the readers of the program's spans
and counters on a canned record, the traced group's attribution on a
canned trace, and a traced run of a tiny cell on the CPU."""

from __future__ import annotations

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench import check, harness, spans, trace  # noqa: E402
from portbench.reference.pipeline import answers as reference  # noqa: E402
from test_portbench_harness import _ev, tiny  # noqa: E402,F401

RECORD = {
    "index_build_s": 0.2, "trace_builds": [0.1, 0.2, 0.3],
    "trace_window": {
        "requests": 4, "scans": 64, "seconds": 1.0, "request_ms": [100.0] * 4, "spans": 120, "dropped": 0,
        "span_ms": {"desc.triangles": 8.0, "match.search": 12.0, "match.verify": 60.0, "match.rank": 4.0,
                    "refine.rerank": 200.0, "refine.pick": 4.0, "refine.lm": 150.0},
        "counters": {"lm.trips": [10, 8], "lm.problems": [64, 64], "lm.live": [64] * 10 + [32] * 8},
    },
    "trace_group": {
        "requests": 4, "scans": 64, "device_ops": 136,
        "ops_by_chain": {"localize_refined/localize/match.verify": 32, "localize_refined/localize/match.rank": 32,
                         "localize_refined/refine.rerank/refine.lm/refine.lm.trip": 64, spans.OUTSIDE: 8},
        "syncs_by_root": {"localize_refined": 40, spans.OUTSIDE: 4},
    },
    "kernel_load": {"seconds": 0.5, "build_s": 7.5, "compiled": True},
}
WANT = {
    "desc_ms.span": 2.0, "search_ms.span": 3.0, "verify_ms.span": 16.0, "refine_ms.span": 51.0, "lm_trips": 9.0,
    "lm_useful_pct": 100.0 * (64 * 10 + 32 * 8) / (10 * 64 + 8 * 64), "verify_ops_per_scan": 1.0,
    "refine_ops_per_scan": 1.0, "host_syncs_per_request": 10.0, "index_build_s.span": 0.2, "kernel_load_s": 0.5,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader_on_a_canned_record_and_an_empty_one(metric):
    read = spans.READERS[metric]
    assert read(RECORD) == pytest.approx(WANT[metric])
    assert read({}) is None


def test_the_wired_kernel_load_reader_reads_the_programs_record(monkeypatch):
    from sgtd_tpu_torch.utils import profiling

    read = harness.reader("kernel_load_s")
    assert read({}) is None and read({"kernel_load": {"seconds": 1.5}}) == 1.5
    monkeypatch.setattr(profiling, "_LOADS", {})
    assert read({"index_build_s": 0.1}) is None
    profiling.record_load("ops.load", 0.25, build_s=8.0, compiled=True)
    profiling.record_load("ops.load", 9.0, build_s=0.0, compiled=False)
    assert read({"index_build_s": 0.1}) == 0.25


def test_readers_of_a_desc_cell_leave_the_rerank_out():
    rec = copy.deepcopy(RECORD)
    for k in ("refine.rerank", "refine.pick", "refine.lm"):
        rec["trace_window"]["span_ms"].pop(k)
    rec["trace_window"]["counters"] = {}
    rec["trace_group"]["ops_by_chain"].pop("localize_refined/refine.rerank/refine.lm/refine.lm.trip")
    for m in ("refine_ms.span", "lm_trips", "lm_useful_pct", "refine_ops_per_scan"):
        assert spans.READERS[m](rec) is None, m


def _canned():
    """A staged range, a pb:request group and a pb:traced group whose
    program spans nest: localize > match.verify."""
    staged = [_ev("user_annotation", "pb:search", -100, 50), _ev("cuda_runtime", "cudaLaunchKernel", -90, 5, corr=9),
              _ev("kernel", "probe", -80, 10, corr=9, tid=7)]
    request = [_ev("user_annotation", "pb:request", 0, 100), _ev("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
               _ev("kernel", "k1", 20, 20, corr=1, tid=7)]
    traced = [
        _ev("user_annotation", "pb:traced", 200, 100),
        _ev("user_annotation", "sgtd:localize", 200, 90),
        _ev("user_annotation", "sgtd:match.verify", 210, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 215, 5, corr=2), _ev("kernel", "kv", 230, 20, corr=2, tid=7),
        _ev("cpu_op", "aten::item", 251, 8), _ev("cuda_runtime", "cudaStreamSynchronize", 252, 6),
        _ev("cuda_runtime", "cudaLaunchKernel", 265, 5, corr=3), _ev("kernel", "kr", 275, 5, corr=3, tid=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 292, 3, corr=4), _ev("kernel", "ko", 296, 2, corr=4, tid=7),
        # The device's own copy of a program range: on the device's thread, not a span.
        _ev("gpu_user_annotation", "sgtd:match.verify", 230, 20, tid=7),
    ]
    return staged, request, traced


def test_the_traced_group_is_put_down_to_the_programs_spans():
    staged, request, traced = _canned()
    s = spans.summarize(staged + request + traced)
    assert s["requests"] == 1 and s["device_ops"] == 3
    assert s["ops_by_chain"] == {"localize/match.verify": 1, "localize": 1, spans.OUTSIDE: 1}
    assert s["syncs_by_root"] == {"localize": 1}
    assert s["syncs_by_site"] == {"match.verify aten::item cudaStreamSynchronize": 1}
    # Gaps 200-230 (in match.verify), 250-275 and 280-296 (in localize), 298-300 (outside).
    assert dict(s["idle_gaps_by_span"]) == {"match.verify": pytest.approx(30e-6), "localize": pytest.approx(41e-6),
                                            spans.OUTSIDE: pytest.approx(2e-6)}
    assert s["idle_s"] == pytest.approx(73e-6) and s["idle_in_spans_s"] == pytest.approx(71e-6)
    assert s["window_s"] == pytest.approx(100e-6) and s["busy_s"] == pytest.approx(27e-6)
    assert spans.summarize(staged + request) == {}


def test_the_request_slice_reads_as_it_did_without_the_traced_group():
    staged, request, traced = _canned()
    with_group, without = trace.summarize(staged + request + traced), trace.summarize(staged + request)
    for key in ("requests", "window_s", "busy_s", "device_ops", "breakdown"):
        assert with_group[key] == without[key], key
    assert with_group["stage_kernel_s"]["search"] == without["stage_kernel_s"]["search"]


def test_a_traced_cpu_run_reads_every_span_and_counter_metric(tiny):
    spec = harness.load_cell(tiny, "tiny.refined.b4", base=tiny)
    run = harness.Run(spec, 11, "cpu")
    run.setup(staged=False)
    record = {}
    answers = spans.extend(run, record, seconds=0.3)
    got = {k: f(record) for k, f in spans.READERS.items()}
    for m in ("desc_ms.span", "search_ms.span", "verify_ms.span", "refine_ms.span", "lm_trips", "lm_useful_pct",
              "index_build_s.span"):
        assert got[m] is not None and got[m] > 0, m
    assert 1 <= got["lm_trips"] <= run.svc.cfg.gicp.max_iterations and got["lm_useful_pct"] <= 100.0
    # The CPU runs no device operation: the trace's device metrics and the card's library read nothing.
    for m in ("verify_ops_per_scan", "refine_ops_per_scan", "host_syncs_per_request", "kernel_load_s"):
        assert got[m] is None, m
    assert len(record["trace_builds"]) == spans.TRACED_BUILDS
    assert record["trace_group"]["requests"] == max(4, 16 // run.batch)
    run.svc.free()
    ok, table = check.verdict(check.numbers(answers, reference(run.inputs, spec["config"], spec["traffic"], "cpu")),
                              spec["limits"])
    assert ok, table


def test_the_cost_of_a_span_is_measured_off_on_and_profiled():
    from sgtd_tpu_torch.utils import profiling

    cost = spans.span_cost_ns(2000)
    assert set(cost) == {"off", "on", "profiled"} and profiling.active() is None
    assert cost["off"] < cost["on"] < cost["profiled"]


def test_a_whole_measurement_of_a_tiny_cell_on_the_cpu(tiny):
    out = spans.measure(tiny, "tiny.desc.b1", 5, 0.2, device="cpu", base=tiny)
    assert out["correct"], out["checks"]
    assert out["device"] == "cpu" and out["spans_a_request"] >= 11
    assert out["metrics"]["desc_ms.span"] > 0 and out["metrics"]["refine_ms.span"] is None
    assert set(out["cost_pct_of_median_request"]) == {"off", "on", "profiled"}
    # No rerank, so no LM counter; verification counts its Kabsch problems.
    assert not [k for k in out["counters"] if k.startswith("lm.")] and out["counters"]["verify.kabsch_problems"] > 0


def test_without_a_card_the_measurement_stops():
    import subprocess

    out = subprocess.run([sys.executable, os.path.join(os.path.dirname(HERE), "spans.py"), "--workload",
                          "site200.desc.b1", "--seed", "1"], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == ""
