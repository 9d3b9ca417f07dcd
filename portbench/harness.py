"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is comes from files found by name: the cell's row in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic (``traffic/<traffic>.json``); ``cells/<cell>.json`` holds the
limits of its check; a per-layer metric is read by ``metrics/<name>.py``.
The configuration's ``kind`` (``graph`` where it names none) is the module
``kinds/<kind>.py`` that brings the cell's inputs, its service and its
reference:

- ``check(config, traffic)``: raises ValueError on traffic the kind cannot
  serve, before set-up;
- ``make_inputs(seed, config, traffic) -> dict``;
- ``Service(inputs, config, traffic, device)``, with ``batches`` (a list of
  (query ids, payload)), ``build(frames=None)``, ``free()``, ``serve(i)``,
  ``staged(i, spans, profiled=False)``, ``warm()``, ``describe()`` (the
  tail of the set-up's log line) and ``work(profiled_answers, spans)``
  (each stage's least seconds in the profiled staged requests);
- ``reference(inputs, config, traffic, device, control=False) -> dict``;
- ``numbers(answers, ref) -> dict``: the numbers the cell's limits hold;
- ``control_answers(ref_ctl)``: the control's answers as ``numbers`` reads
  the service's, and ``readings(answers, ref) -> dict``: the numbers with
  what else ``readings.py`` reports to set the limits from.

A kind is looked for under the directory the cell's files come from, then
among the benchmark's own.

Traffic is a closed loop of one client: requests of ``batch`` query scans
each, the cell's queries replayed in order, the next sent when the answer
is on the host. ``--trace 0`` times whole requests for the end-to-end
metrics; ``--trace 1`` answers them stage by stage for the per-layer spans,
then opens the process's one profiler session on a short slice of staged
and whole requests.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WARM_FRAMES = 16
WARM_BATCHES = 16
# A traced run builds the index this many times in a row; its seconds are
# their mean (one host-clock span of 0.25 s or more, never a single short
# one). A run for the end-to-end metrics builds it once.
BUILD_REPEATS = 10
FORBIDDEN = ("jax", "jaxlib", "flax", "sgtd_tpu")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _module(base: str, folder: str, name: str, what: str):
    """``<folder>/<name>.py`` under ``base``, else under the benchmark's
    own directory, loaded by path."""
    for d in dict.fromkeys((base, HERE)):
        path = os.path.join(d, folder, f"{name}.py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise ValueError(f"no {what} {name!r}: no {folder}/{name}.py")


def load_cell(root: str, name: str, base: str = HERE) -> dict:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its
    configuration, traffic and limits (files under ``base``), its kind's
    module and its per-layer metrics."""
    bench = _json(root, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    config = _json(base, "configs", f"{cell['config']}.json")
    traffic = _json(base, "traffic", f"{cell['traffic']}.json")
    kind = _module(base, "kinds", config.get("kind", "graph"), f"kind of configuration {cell['config']}")
    try:
        kind.check(config, traffic)
    except ValueError as e:
        raise ValueError(f"traffic {cell['traffic']}: {e}") from e
    limits = _json(base, "cells", f"{name}.json")["limits"]
    reports = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name]) and m["moves"] in reports]
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits, "kind": kind,
            "end_to_end": [m for m in bench["end_to_end"] if m["name"] in reports], "per_layer": per_layer}


def reader(metric: str):
    return _module(HERE, "metrics", metric, "reader of metric").read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Run:
    """A run's set-up, window and check; ``device`` is "cuda" on the card
    (the CPU serves the harness's own tests)."""

    def __init__(self, spec: dict, seed: int, device: str = "cuda"):
        self.spec, self.seed, self.device = spec, seed, device
        kind, t = spec["kind"], spec["traffic"]
        self.inputs = kind.make_inputs(seed, spec["config"], t)
        self.svc = kind.Service(self.inputs, spec["config"], t, device)
        self.batch = t["batch"]
        self.n_b = len(self.svc.batches)

    def sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def setup(self, staged: bool) -> float:
        """Warm the build on a slice of the map, build the index (traced,
        ``BUILD_REPEATS`` times: the mean build's seconds; a service that
        rebuilds a map finds its allocator warm), warm every request shape
        and what else the service answers with (``warm``: the graph kind's
        TRUNC_SCAN fallback)."""
        svc = self.svc
        svc.build(frames=WARM_FRAMES)
        repeats = BUILD_REPEATS if staged else 1
        t0 = time.perf_counter()
        for _ in range(repeats):
            svc.free()
            svc.build()
        seconds = (time.perf_counter() - t0) / repeats
        for i in range(min(self.n_b, WARM_BATCHES)):
            svc.serve(i)
            if staged:
                svc.staged(i, {})
        svc.warm()
        self.sync()
        gc.collect()
        return seconds

    def window(self, seconds: float, staged: bool):
        """Requests for ``seconds``: [(batch, t0, t1, answer)], spans."""
        out, spans = [], {}
        gc.disable()
        try:
            t_end = time.perf_counter() + seconds
            i = 0
            while time.perf_counter() < t_end:
                b = i % self.n_b
                t0 = time.perf_counter()
                ans = self.svc.staged(b, spans) if staged else self.svc.serve(b)
                out.append((b, t0, time.perf_counter(), ans))
                i += 1
        finally:
            gc.enable()
        return out, spans

    def profile(self, n: int):
        """The process's one profiler session: ``n`` staged requests, then
        ``n`` whole ones. Returns (answers, record parts)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace

        svc = self.svc
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
        answers, spans = [], {}
        self.sync()
        with profile(activities=acts) as prof:
            for i in range(n):
                answers.append((i % self.n_b, svc.staged(i % self.n_b, spans, profiled=True)))
            for i in range(n):
                with record_function("pb:request"):
                    answers.append((i % self.n_b, svc.serve(i % self.n_b)))
            self.sync()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            summary = trace.summarize(trace.load(path))
        return answers, {"profile": summary, "work": svc.work(answers[:n], spans), "scans": n * self.batch}


def run(root: str, name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float | None = None, base: str = HERE) -> dict:
    """One run; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(root, name, base)
    r = Run(spec, seed, device)
    build_s = r.setup(staged=traced)
    setup_s = time.perf_counter() - t_start
    log(f"{name} seed {seed}: set-up {setup_s:.3f} s, index build {build_s:.4f} s, {r.svc.describe()}")
    reqs, spans = r.window(seconds, staged=traced)
    answers = [(r.svc.batches[b][0], a) for b, _, _, a in reqs]
    scans = sum(len(r.svc.batches[b][0]) for b, *_ in reqs)
    lat = [(t1 - t0) * 1e3 for _, t0, t1, _ in reqs]
    win = reqs[-1][2] - reqs[0][1]
    record = {"spans": spans, "index_build_s": build_s, "window_scans": scans, "window_s": win}
    if traced:
        prof_answers, parts = r.profile(max(4, 16 // r.batch))
        answers += [(r.svc.batches[b][0], a) for b, a in prof_answers]
        record.update(parts)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    q = statistics.quantiles(lat, n=20) if len(lat) > 1 else lat * 19
    log(f"window: {len(reqs)} requests, {scans} scans in {win:.4f} s; request ms median "
        f"{statistics.median(lat):.4f}, p95 {_p95(lat):.4f} over {len(lat)} samples "
        f"(p5 {q[0]:.4f}, p25 {q[4]:.4f}, p75 {q[14]:.4f}, max {max(lat):.4f})")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"[portbench] the process holds modules of JAX or the JAX package: {bad[:10]}")

    # The check: the program's state freed, the reference on the same card.
    r.svc.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    from portbench import check

    t0 = time.perf_counter()
    ref = spec["kind"].reference(r.inputs, spec["config"], spec["traffic"], device)
    nums = spec["kind"].numbers(answers, ref)
    ok, table = check.verdict(nums, spec["limits"])
    log(f"check: {nums.get('answers')} answers against the reference in {time.perf_counter() - t0:.3f} s; "
        f"beside the compared numbers: {nums.get('extras')}")

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": scans, "failed": 0}
    if traced:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        p = record["profile"]
        if device == "cuda" and not p.get("busy_s"):
            raise SystemExit("[portbench] the profiler recorded no device activity in the traced slice")
        if p.get("busy_s"):
            dev.update(busy_s=p["busy_s"], window_s=p["window_s"])
        out.update(metrics=metrics, device=dev, breakdown=p.get("breakdown"))
    else:
        values = {"scans_per_s": scans / win, "latency_p95_ms": _p95(lat), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}
        out.update(metrics=metrics, device=dev)
    out["checks"] = table
    return out


def _p95(xs) -> float:
    return statistics.quantiles(xs, n=100)[94] if len(xs) > 1 else xs[0]
