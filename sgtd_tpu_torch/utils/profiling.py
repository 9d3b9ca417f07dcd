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
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

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
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
