"""The program's own spans and counters in a traced run of a cell.

``sgtd_tpu_torch.utils.profiling`` records spans and counters inside the
program's layers when a tracer is installed. This module runs a cell's
service with it installed, in three parts, and reads the per-layer
numbers from what it recorded:

- (a) ``builds``: index builds, tracing on; each build's seconds are the
  sum of the root spans it recorded (``index.*``, the calibration sample's
  ``desc.triangles``, the map clouds' ``refine.covariances``).
- (b) ``window``: whole requests (``Service.serve``) for some seconds,
  tracing on, no profiler; the held counts folded (``profiling.flush``)
  between requests, outside the timed request.
- (c) ``group``: one ``torch.profiler`` session over the same batches
  twice, as whole requests with tracing off (each a ``pb:request``
  range) and again with tracing on (each a ``pb:traced`` range), so the
  program's ``sgtd:`` ranges sit in the session's trace around the
  operations they issue. ``summarize`` attributes the traced group's
  device operations, host syncs and idle gaps to those ranges.

``READERS`` maps each metric's name to its reader over the record these
parts fill. Run alone on the card::

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

prints one JSON line: the metrics, ``idle_gaps_by_span``, the cost of a
span with tracing off, on, and under the profiler, the untraced and traced
windows' rates, and the check of every traced answer against the
reference. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from portbench import trace  # noqa: E402

TRACED = "pb:traced"
SPAN_PREFIX = "sgtd:"
OUTSIDE = "outside the program"
TRACED_BUILDS = 3
WINDOW_S = 10.0
# Runtime calls after which the host has waited for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol")
# Spans whose sums are a layer's time in a request.
STAGE_SPANS = {"desc": ("desc.triangles",), "search": ("match.search",), "verify": ("match.verify", "match.rank"),
               "refine": ("refine.rerank", "refine.pick")}


# -- (a), (b), (c) on a harness.Run --------------------------------------------


def builds(run, n: int = TRACED_BUILDS) -> list:
    """``n`` index builds, tracing on: the seconds of each (its root spans)."""
    from sgtd_tpu_torch.utils import profiling

    out = []
    for _ in range(n):
        run.svc.free()
        tracer = profiling.enable()
        try:
            run.svc.build()
        finally:
            profiling.disable()
        out.append(sum(s.t1_ns - s.t0_ns for s in tracer.spans if s.parent is None) * 1e-9)
    return out


def window(run, seconds: float, traced: bool = True):
    """Whole requests for ``seconds``; with ``traced`` the tracer on and its
    held counts folded between requests. Returns (answers, record part)."""
    from sgtd_tpu_torch.utils import profiling

    svc, answers, lat, scans = run.svc, [], [], 0
    tracer = profiling.enable() if traced else None
    try:
        t_end = time.perf_counter() + seconds
        i = 0
        t_first = time.perf_counter()
        while time.perf_counter() < t_end:
            b = i % run.n_b
            t0 = time.perf_counter()
            ans = svc.serve(b)
            lat.append((time.perf_counter() - t0) * 1e3)
            if tracer is not None:
                tracer.flush()
            answers.append((svc.batches[b][0], ans))
            scans += len(svc.batches[b][0])
            i += 1
        t_last = time.perf_counter()
    finally:
        profiling.disable()
    part = {"requests": len(lat), "scans": scans, "seconds": t_last - t_first, "request_ms": lat}
    if tracer is not None:
        span_ms = defaultdict(float)
        for s in tracer.spans:
            span_ms[s.name] += (s.t1_ns - s.t0_ns) * 1e-6
        part.update(span_ms=dict(span_ms), spans=len(tracer.spans), dropped=tracer.dropped,
                    counters={k: [v for _, v in q] for k, q in tracer.counters.items()})
    return answers, part


def group(run, n: int):
    """The profiler session of part (c): ``n`` whole requests in
    ``pb:request`` ranges with tracing off, then the same batches in
    ``pb:traced`` ranges with tracing on. Returns (answers, summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from sgtd_tpu_torch.utils import profiling

    svc = run.svc
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device == "cuda" else [])
    answers = []
    run.sync()
    with profile(activities=acts) as prof:
        for i in range(n):
            with record_function(trace.REQUEST):
                answers.append((svc.batches[i % run.n_b][0], svc.serve(i % run.n_b)))
        run.sync()
        tracer = profiling.enable()
        try:
            for i in range(n):
                with record_function(TRACED):
                    answers.append((svc.batches[i % run.n_b][0], svc.serve(i % run.n_b)))
                tracer.flush()
        finally:
            profiling.disable()
        run.sync()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = trace.load(path)
    out = summarize(events)
    out["request_ops"] = trace.summarize(events).get("device_ops", 0)
    out["scans"] = sum(len(svc.batches[i % run.n_b][0]) for i in range(n))
    return answers, out


def extend(run, record: dict, seconds: float = WINDOW_S, n: int | None = None) -> list:
    """Parts (a), (b) and (c) on a set-up ``harness.Run``; their readings go
    into ``record`` (``trace_builds``, ``trace_window``, ``trace_group``,
    ``kernel_load``). Returns the answers of (b) and (c) for the check."""
    from sgtd_tpu_torch.utils import profiling

    record["trace_builds"] = builds(run)
    answers, record["trace_window"] = window(run, seconds)
    more, record["trace_group"] = group(run, n or max(4, 16 // run.batch))
    load = profiling.loads().get("ops.load")
    if load is not None:
        record["kernel_load"] = load
    return answers + more


# -- the trace of part (c) -------------------------------------------------------


class _Nest:
    """Properly nested ranges of one thread: the innermost one that holds a
    time, and the chain of names around it."""

    def __init__(self, ranges):
        self.r = sorted(ranges, key=lambda x: (x[1], -x[2]))
        self.starts = [a for _, a, _ in self.r]
        self.parent, stack = [], []
        for i, (_, a, b) in enumerate(self.r):
            while stack and self.r[stack[-1]][2] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, t: float):
        """Index of the innermost range holding ``t``, else None."""
        j = bisect.bisect_right(self.starts, t) - 1
        if j < 0:
            return None
        while j is not None and self.r[j][2] < t:
            j = self.parent[j]
        return j

    def chain(self, t: float) -> tuple:
        out, j = [], self.at(t)
        while j is not None:
            out.append(self.r[j][0])
            j = self.parent[j]
        return tuple(reversed(out))


def summarize(events: list, top: int = 10) -> dict:
    """The ``pb:traced`` group of a session: its requests, the device
    operations launched in it by the chain of ``sgtd:`` spans open at the
    launch (outermost first, joined by ``/``), the host syncs by the root
    span they fall in and by site (innermost span, innermost torch
    operation, runtime call), and its idle gaps by the innermost span open
    at the gap's middle (else ``OUTSIDE``). Empty where the session has no
    such group."""
    marks = [e for e in events if e.get("name") == TRACED and e.get("cat") == "user_annotation"]
    if not marks:
        return {}
    groups = [trace._span(e) for e in marks]
    thread = (marks[0].get("pid"), marks[0].get("tid"))
    on_thread = lambda e: (e.get("pid"), e.get("tid")) == thread
    nest = _Nest([(str(e["name"])[len(SPAN_PREFIX):], *trace._span(e)) for e in events
                  if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX)
                  and on_thread(e)])
    inside = lambda t: any(a <= t <= b for a, b in groups)
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in trace.LAUNCH_CATS and "correlation" in e.get("args", {})}
    chains, busy = Counter(), []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        a, b = trace._span(e)
        t = launch_ts.get(e.get("args", {}).get("correlation"), a)
        if inside(t):
            chains["/".join(nest.chain(t)) or OUTSIDE] += 1
            busy.append((a, b))
    ops = _Nest([(str(e["name"]), *trace._span(e)) for e in events if e.get("cat") == "cpu_op" and on_thread(e)])
    syncs, sites = Counter(), Counter()
    for e in events:
        if e.get("cat") in trace.LAUNCH_CATS and e.get("name") in SYNC_CALLS and on_thread(e):
            t = trace._span(e)[0]
            if inside(t):
                chain = nest.chain(t)
                syncs[chain[0] if chain else OUTSIDE] += 1
                op = ops.at(t)
                sites[" ".join((chain[-1] if chain else OUTSIDE, ops.r[op][0] if op is not None else "-",
                                e["name"]))] += 1
    w0, w1 = min(a for a, _ in groups), max(b for _, b in groups)
    spans = trace._union([(max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1])
    edges = [w0] + [x for ab in spans for x in ab] + [w1]
    idle = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        for ga, gb in groups:  # the gap's part inside each request
            lo, hi = max(a, ga), min(b, gb)
            if hi > lo:
                j = nest.at(0.5 * (lo + hi))
                idle[nest.r[j][0] if j is not None else OUTSIDE] += (hi - lo) * 1e-6
    rank = sorted(idle.items(), key=lambda kv: -kv[1])
    return {
        "requests": len(groups), "device_ops": sum(chains.values()), "ops_by_chain": dict(chains),
        "syncs_by_root": dict(syncs), "syncs_by_site": dict(sites),
        "window_s": sum(b - a for a, b in groups) * 1e-6, "busy_s": sum(b - a for a, b in spans) * 1e-6,
        "idle_s": sum(idle.values()), "idle_in_spans_s": sum(v for k, v in idle.items() if k != OUTSIDE),
        "idle_gaps_by_span": [[k, v] for k, v in rank[:top]],
    }


# -- readers ------------------------------------------------------------------------


def _stage_ms(stage: str):
    def read(record):
        w = record.get("trace_window") or {}
        total = sum(w.get("span_ms", {}).get(n, 0.0) for n in STAGE_SPANS[stage])
        return total / w["requests"] if total and w.get("requests") else None

    return read


def lm_trips(record):
    """Mean LM trips a solve (a rerank) of window (b)."""
    xs = (record.get("trace_window") or {}).get("counters", {}).get("lm.trips")
    return statistics.fmean(xs) if xs else None


def lm_useful_pct(record):
    """Share (%) of the LM problem-trips that worked on a problem not yet
    done: sum of ``lm.live`` over sum, solve by solve, of trips times
    problems."""
    c = (record.get("trace_window") or {}).get("counters", {})
    slots = sum(t * p for t, p in zip(c.get("lm.trips", ()), c.get("lm.problems", ())))
    return 100.0 * sum(c.get("lm.live", ())) / slots if slots else None


def _ops_under(match):
    def read(record):
        g = record.get("trace_group") or {}
        ops = sum(n for chain, n in g.get("ops_by_chain", {}).items() if any(match(s) for s in chain.split("/")))
        return ops / g["scans"] if ops and g.get("scans") else None

    return read


def host_syncs_per_request(record):
    """Runtime calls that wait for the device, inside the program's root
    spans, a whole request of group (c)."""
    g = record.get("trace_group") or {}
    if not g.get("requests") or not g.get("device_ops"):
        return None
    return sum(n for root, n in g.get("syncs_by_root", {}).items() if root != OUTSIDE) / g["requests"]


def index_build_s_span(record):
    xs = record.get("trace_builds")
    return statistics.fmean(xs) if xs else None


def kernel_load_s(record):
    """Seconds to load and bind the kernel library, without its build
    (``build_s``: nvcc where the checkout had no library of the current
    sources, which depends on the runs before, not on the program). From
    ``record["kernel_load"]`` where a run of this module put it there;
    else, for a record of ``harness.run`` (it holds ``index_build_s``, and
    the harness gives a reader nothing but the record), from the program's
    own record of this process, ``profiling.loads()["ops.load"]``. None
    where neither holds one."""
    load = record.get("kernel_load")
    if load is None and "index_build_s" in record:
        try:
            from sgtd_tpu_torch.utils import profiling
        except ImportError:
            return None
        loads = getattr(profiling, "loads", None)
        load = loads().get("ops.load") if loads is not None else None
    return load["seconds"] if load else None


READERS = {
    "desc_ms.span": _stage_ms("desc"),
    "search_ms.span": _stage_ms("search"),
    "verify_ms.span": _stage_ms("verify"),
    "refine_ms.span": _stage_ms("refine"),
    "lm_trips": lm_trips,
    "lm_useful_pct": lm_useful_pct,
    "verify_ops_per_scan": _ops_under(lambda s: s in ("match.verify", "match.rank")),
    "refine_ops_per_scan": _ops_under(lambda s: s.startswith("refine.")),
    "host_syncs_per_request": host_syncs_per_request,
    "index_build_s.span": index_build_s_span,
    "kernel_load_s": kernel_load_s,
}


# -- the cost of a span ---------------------------------------------------------


def span_cost_ns(n: int = 100_000) -> dict:
    """Nanoseconds a ``with profiling.span(...)`` block costs the host with
    tracing off, on, and on under a profiler session (CPU activities), the
    least of 5 loops of ``n``."""
    from torch.profiler import ProfilerActivity, profile

    from sgtd_tpu_torch.utils import profiling

    def loop(k):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(k):
                with profiling.span("x"):
                    pass
            best = min(best, (time.perf_counter_ns() - t0) / k)
        return best

    out = {}
    profiling.disable()
    base = time.perf_counter_ns()
    for _ in range(n):
        pass
    empty = (time.perf_counter_ns() - base) / n
    out["off"] = loop(n) - empty
    profiling.enable(capacity=n)
    try:
        out["on"] = loop(n) - empty
        with profile(activities=[ProfilerActivity.CPU]):
            out["profiled"] = loop(n // 10) - empty
    finally:
        profiling.disable()
    return out


# -- one run on the card -------------------------------------------------------------


def measure(root: str, name: str, seed: int, seconds: float, device: str = "cuda", base: str | None = None) -> dict:
    """One run of cell ``name``: set-up, an untraced window, parts (a)-(c),
    a second untraced window, the cost of a span, and the check of the
    traced answers against the reference. Returns the printed object."""
    import torch

    from portbench import check, harness

    spec = harness.load_cell(root, name, base or harness.HERE)
    run = harness.Run(spec, seed, device)
    t0 = time.perf_counter()
    run.setup(staged=False)
    record = {"setup_s": time.perf_counter() - t0}
    _, plain_a = window(run, seconds, traced=False)
    answers = extend(run, record, seconds)
    _, plain_b = window(run, seconds, traced=False)
    record["cost_ns"] = span_cost_ns()
    run.svc.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    kind = spec["kind"]
    ref = kind.reference(run.inputs, spec["config"], spec["traffic"], device)
    ok, table = check.verdict(kind.numbers(answers, ref), spec["limits"])
    w, g = record["trace_window"], record["trace_group"]
    rate = lambda p: p["scans"] / p["seconds"]
    per_request = w["spans"] / w["requests"]
    median_ms = statistics.median(plain_a["request_ms"] + plain_b["request_ms"])
    return {
        "cell": name, "seed": seed, "correct": ok, "checks": table,
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "metrics": {k: f(record) for k, f in READERS.items()},
        "idle_gaps_by_span": g.get("idle_gaps_by_span"),
        "idle_in_spans_pct": 100.0 * g["idle_in_spans_s"] / g["idle_s"] if g.get("idle_s") else None,
        "ops_per_scan": {trace.REQUEST: g["request_ops"] / g["scans"], TRACED: g["device_ops"] / g["scans"]},
        "ops_by_chain": g.get("ops_by_chain"), "syncs_by_root": g.get("syncs_by_root"),
        "syncs_by_site": g.get("syncs_by_site"),
        "scans_per_s": {"untraced_before": rate(plain_a), "traced": rate(w), "untraced_after": rate(plain_b)},
        "request_ms_median": {"untraced": median_ms, "traced": statistics.median(w["request_ms"])},
        "spans_a_request": per_request, "dropped": w["dropped"], "cost_ns": record["cost_ns"],
        "cost_pct_of_median_request": {k: 100.0 * v * per_request * 1e-6 / median_ms
                                       for k, v in record["cost_ns"].items()},
        "trace_builds": record["trace_builds"], "kernel_load": record.get("kernel_load"),
        "setup_s": record["setup_s"], "span_ms_a_request": {k: v / w["requests"] for k, v in w["span_ms"].items()},
        "counters": {k: sum(v) for k, v in w["counters"].items()},
    }


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=WINDOW_S)
    args = ap.parse_args()
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("[portbench] spans.py measures on a CUDA card; this machine has none", file=sys.stderr)
        return 2
    print(json.dumps(measure(ROOT, args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
