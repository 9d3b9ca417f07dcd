"""Reading one ``torch.profiler`` session of a traced run.

The session holds two kinds of request, told apart by ranges the harness
opens (``torch.profiler.record_function``): staged requests, one range
``pb:<stage>`` a stage, and whole-entry requests, one range
``pb:request`` each. A device operation (kernel, copy, fill) belongs to the
range in which the host launched it (its runtime call, found by the
correlation id; else the range that holds the operation itself).

``summarize`` reduces the Chrome trace to what the per-layer readers read:
device seconds of kernels by stage, and for the whole-entry slice its wall
length, the seconds in which any device operation ran, the operations it
launched, the operations that took most time, and the idle gaps by what
the host was doing.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
PREFIX = "pb:"
REQUEST = "pb:request"


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _owner(t: float, ranges) -> str | None:
    """Innermost (shortest) pb: range holding time t."""
    best = None
    for name, a, b in ranges:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else None


def _host_at(events):
    """time -> name of the innermost host event on the requests' thread
    that holds it (the latest-starting one that has not ended)."""
    req = next(e for e in events if e.get("name") == REQUEST)
    host = sorted((_span(e) + (str(e["name"])[:120],) for e in events
                   if e.get("cat") in HOST_CATS and e.get("name") != REQUEST
                   and (e.get("pid"), e.get("tid")) == (req.get("pid"), req.get("tid"))))
    starts = [a for a, _, _ in host]

    def innermost(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 200, -1), -1):
            if host[j][1] >= t:
                return host[j][2]
        return "python, between operations"

    return innermost


def summarize(events: list, top: int = 10) -> dict:
    ranges = [(e["name"], *_span(e)) for e in events
              if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX)]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    stage_s = defaultdict(float)
    whole_ops, whole_busy = [], []
    op_s = defaultdict(float)
    for e in dev:
        a, b = _span(e)
        t = launch_ts.get(e.get("args", {}).get("correlation"), a)
        owner = _owner(t, ranges)
        if owner is None:
            continue
        if owner == REQUEST:
            whole_ops.append(e)
            whole_busy.append((a, b))
            op_s[str(e["name"])[:120]] += (b - a) * 1e-6
        elif e.get("cat") == "kernel":
            stage_s[owner[len(PREFIX):]] += (b - a) * 1e-6
    req = [(a, b) for n, a, b in ranges if n == REQUEST]
    out = {"stage_kernel_s": dict(stage_s), "requests": len(req)}
    if not req:
        return out
    w0, w1 = min(a for a, _ in req), max(b for _, b in req)
    busy = _union([(max(a, w0), min(b, w1)) for a, b in whole_busy if b > w0 and a < w1])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    by_host = defaultdict(float)
    innermost = _host_at(events)
    for a, b in gaps:
        if b > a:
            by_host[innermost(0.5 * (a + b))] += (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    out.update(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=len(whole_ops),
        breakdown={"device_ops": rank(op_s), "idle_gaps": rank(by_host)},
    )
    return out
