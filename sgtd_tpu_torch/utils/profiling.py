"""Stage timing and device profiling (port of sgtd_tpu.utils.profiling).

The reference's stage taxonomy, kept for comparability with its per-frame
breakdown (semantic_graph_localization.cpp:777, STDesc.cpp:455):

  SGC — semantic graph construction (clustering + node extraction)
  STD — triangle descriptor build
  CS1 — candidate search (probe + vote)
  PE  — pose estimation (verification + refinement)
  VM  — full per-query pipeline (the reference's VM_time)

``device_trace`` records a ``torch.profiler`` session (CPU and, where there
is a card, CUDA activities) and writes it to ``log_dir`` as a Chrome trace
that Perfetto opens: the counterpart of ``jax.profiler.start_trace``.

The tracer. The program's modules open spans (``span``, ``traced``) and add
counts (``count``, ``count_mask``) where the work happens. Tracing is off
by default: then ``span`` hands back one shared no-op after a single check
of the module's installed tracer, and a count returns at once. ``enable``
installs a :class:`Tracer`, ``disable`` takes it off. A span records its
name, start and end (``time.perf_counter_ns``), its parent and its request
id: a root span (an entry call) starts a new request, its children inherit
it. Spans never synchronize the device; while a ``torch.profiler`` session
is active each span also opens ``record_function("sgtd:<name>")``, so the
session's trace nests the spans around the operations they issue, on the
profiler's clock. A count never reads the device: a host-known count is an
int, a device-valued one (``count_mask``) holds a tensor the program
computed anyway and is folded by ``flush``, which the caller runs outside
the timed request.

Process-wide load records (``record_load``, ``loads``) hold one-off set-up
costs, such as the kernel library's build and load, whether or not a
tracer is installed.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
import warnings
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple

import numpy as np
import torch

STAGES = ("SGC", "STD", "CS1", "PE", "VM", "GICP", "PGO")


class StageTimers:
    """Accumulates wall-clock spans per stage; reference-style summary."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync: torch.device | str | None = None):
        """Time the block as stage ``name``, in ms. ``sync``: a CUDA device
        synchronized before the clock starts and before it is read, so the
        span holds the device work the block queued; None reads the host
        clock alone."""
        dev = None if sync is None else torch.device(sync)
        if dev is not None and dev.type != "cuda":
            dev = None
        if dev is not None:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if dev is not None:
                torch.cuda.synchronize(dev)
            self.samples[name].append((time.perf_counter() - t0) * 1000.0)

    def add(self, name: str, ms: float):
        self.samples[name].append(ms)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "total_ms": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        summary = self.summary()
        for name in list(STAGES) + sorted(set(self.samples) - set(STAGES)):
            if name not in summary:
                continue
            s = summary[name]
            lines.append(
                f"{name:>5}: n={s['count']:<5d} mean={s['mean_ms']:8.2f}ms "
                f"p50={s['p50_ms']:8.2f}ms p95={s['p95_ms']:8.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where a card is present) and write the trace to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format). With a tracer
    installed, its spans are the trace's ``sgtd:<name>`` ranges, each
    holding its request id and span id in ``args``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    tracer, t0 = _TRACER, time.perf_counter_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if tracer is not None:
        _label_ranges(path, [s for s in tracer.spans if s.t0_ns >= t0])


def _label_ranges(path: str, spans) -> None:
    """Write each span's request and span id into the ``args`` of its
    ``sgtd:`` range in the Chrome trace at ``path``. Ranges and spans pair
    up in order of start; where their names disagree (spans dropped from a
    full buffer), the file is left as the profiler wrote it."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ranges = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith(RANGE_PREFIX)), key=lambda e: float(e["ts"]))
    spans = sorted(spans, key=lambda s: s.t0_ns)
    if [e["name"] for e in ranges] != [RANGE_PREFIX + s.name for s in spans]:
        warnings.warn(f"{path}: its {len(ranges)} sgtd: ranges do not pair with the tracer's {len(spans)} "
                      "spans (spans dropped from a full buffer?); the ranges are left without ids")
        return
    for e, s in zip(ranges, spans):
        e.setdefault("args", {}).update(request=s.request, span=s.id, parent=s.parent)
    with open(path, "w") as f:
        json.dump(data, f)


# -- the tracer ---------------------------------------------------------------

RANGE_PREFIX = "sgtd:"
DEFAULT_CAPACITY = 1 << 16


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the enclosing span's id (None at a
    root); every span of one request carries its root's ``request``."""

    id: int
    parent: int | None
    request: int
    name: str
    t0_ns: int
    t1_ns: int


class Tracer:
    """Spans and counters of the installed tracer (``enable``).

    ``spans``: the newest ``capacity`` closed spans, oldest first.
    ``counters``: name -> (request id, value) entries, one an add, the
    newest ``capacity`` of each; at most ``capacity`` tensors held for
    ``flush``. Each span's ms also goes to ``timers.samples[name]``, the
    newest ``capacity`` of each name, for ``StageTimers.summary``/``report``.
    ``dropped`` counts the spans, counter entries and held tensors pushed
    out of these buffers. Spans are opened and closed from one thread.
    """

    def __init__(self, timers: StageTimers | None = None, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity {capacity}: the span buffer holds at least one span")
        self.timers = timers if timers is not None else StageTimers()
        self.capacity = capacity
        self.spans: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.counters: Dict[str, deque] = {}
        self._pending: deque = deque(maxlen=capacity)
        self._samples: Dict[str, deque] = {}
        self._stack: list = []  # (id, request) of each open span, innermost last
        self._ids = itertools.count()
        self._requests = itertools.count()

    def request(self) -> int | None:
        """The request id of the innermost open span."""
        return self._stack[-1][1] if self._stack else None

    def _close(self, rec: SpanRecord) -> None:
        if len(self.spans) == self.capacity:
            self.dropped += 1
        self.spans.append(rec)
        q = self._samples.get(rec.name)
        if q is None:  # the timers' samples of this name, bounded from now on
            samples = self.timers.samples
            q = self._samples[rec.name] = samples[rec.name] = deque(samples.get(rec.name, ()), maxlen=self.capacity)
        if len(q) == self.capacity:
            self.dropped += 1
        q.append((rec.t1_ns - rec.t0_ns) * 1e-6)

    def count(self, name: str, value: int) -> None:
        """Add ``value`` (a host int) to counter ``name``."""
        self._count_as(name, self.request(), value)

    def count_mask(self, name: str, mask: torch.Tensor, value: bool = False) -> None:
        """Add, at the next ``flush``, the entries of ``mask`` equal to
        ``value``; holds the tensor until then (the newest ``capacity``)
        and reads nothing now."""
        if len(self._pending) == self.capacity:
            self.dropped += 1
        self._pending.append((name, self.request(), mask, value))

    def flush(self) -> None:
        """Fold the held tensors of ``count_mask`` into their counters:
        one read of the device for each device that holds them."""
        pending, self._pending = self._pending, deque(maxlen=self.capacity)
        by_dev: Dict[torch.device, list] = defaultdict(list)
        for p in pending:
            by_dev[p[2].device].append(p)
        for group in by_dev.values():
            sums = torch.stack([(m == v).sum() for _, _, m, v in group]).tolist()
            for (name, rid, _, _), n in zip(group, sums):
                self._count_as(name, rid, n)

    def _count_as(self, name: str, rid: int | None, value: int) -> None:
        q = self.counters.get(name)
        if q is None:
            q = self.counters[name] = deque(maxlen=self.capacity)
        if len(q) == self.capacity:
            self.dropped += 1
        q.append((rid, int(value)))


class _Span:
    """A live span of the installed tracer (see ``span``)."""

    __slots__ = ("tracer", "name", "id", "parent", "request", "t0", "rf")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t = self.tracer
        stack = t._stack
        self.id = next(t._ids)
        if stack:
            self.parent, self.request = stack[-1]
        else:
            self.parent, self.request = None, next(t._requests)
        stack.append((self.id, self.request))
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = self.tracer
        t._stack.pop()
        t._close(SpanRecord(self.id, self.parent, self.request, self.name, self.t0, t1))
        return False


class _NullSpan:
    """The span of tracing off: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()
# The installed tracer; None while tracing is off.
_TRACER: Tracer | None = None


def enable(timers: StageTimers | None = None, capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install a new tracer (its spans' ms also go to ``timers``; each of
    its buffers keeps the newest ``capacity`` entries) and return it.
    Changes no configuration."""
    global _TRACER
    _TRACER = Tracer(timers, capacity)
    return _TRACER


def disable() -> Tracer | None:
    """Take the installed tracer off (tracing off) and return it, its
    records kept."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def active() -> Tracer | None:
    """The installed tracer, or None while tracing is off."""
    return _TRACER


def span(name: str):
    """A span named ``name`` around a ``with`` block: the shared no-op
    ``NULL_SPAN`` while tracing is off."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return _Span(t, name)


def traced(name: str):
    """Decorator: each call of the function is a span named ``name``; with
    tracing off the call goes straight through."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t = _TRACER
            if t is None:
                return fn(*args, **kwargs)
            with _Span(t, name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, value: int = 1) -> None:
    """Add ``value`` (a host int) to counter ``name`` of the installed
    tracer; nothing while tracing is off."""
    t = _TRACER
    if t is not None:
        t.count(name, value)


def count_mask(name: str, mask: torch.Tensor, value: bool = False) -> None:
    """Add the entries of ``mask`` equal to ``value`` to counter ``name`` at
    the next ``flush``; reads nothing now, and nothing while tracing is off."""
    t = _TRACER
    if t is not None:
        t.count_mask(name, mask, value)


def flush() -> None:
    """Fold the installed tracer's held tensors into its counters (a read
    of the device: call it outside a timed request)."""
    t = _TRACER
    if t is not None:
        t.flush()


# -- process-wide load records ---------------------------------------------------

_LOADS: Dict[str, dict] = {}


def record_load(name: str, seconds: float, **info) -> None:
    """Record a one-off set-up cost of the process (the first record of
    ``name`` stays)."""
    _LOADS.setdefault(name, dict(seconds=seconds, **info))


def loads() -> Dict[str, dict]:
    """The process's load records: name -> {"seconds": ..., and what the
    recorder added}."""
    return dict(_LOADS)
