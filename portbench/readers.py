"""Building blocks of the per-layer readers (``metrics/<name>.py``).

A reader is ``read(record) -> float | None``: None where the run has
nothing to read, and the harness then leaves the metric out. The record of
a traced run holds ``spans`` (each stage's ms,
one entry a staged request of the traced window), ``window_scans`` and
``window_s`` (the scans that window answered and its seconds), ``profile``
(``trace.summarize`` of the profiled slice), ``work`` (the least seconds of
each stage's profiled requests, ``work.py``) and ``scans`` (the scans the
profiled whole-entry requests answered), and ``index_build_s`` (the mean
seconds of the set-up's index builds).
"""

from __future__ import annotations

import statistics


def stage_ms(stage: str):
    """Mean ms a staged request spends in ``stage``."""

    def read(record):
        xs = record.get("spans", {}).get(stage)
        return statistics.fmean(xs) if xs else None

    return read


def staged_rate():
    """Scans a second of the traced window (staged requests, synchronized
    between stages)."""

    def read(record):
        s = record.get("window_s")
        return record["window_scans"] / s if s and record.get("window_scans") else None

    return read


def roofline(stage: str):
    """Share (%) of the stage's kernel time that its least work needs."""

    def read(record):
        need = record.get("work", {}).get(stage)
        spent = record.get("profile", {}).get("stage_kernel_s", {}).get(stage)
        return 100.0 * need / spent if need and spent else None

    return read


def device_idle():
    """Share (%) of the whole-entry slice in which no device operation ran."""

    def read(record):
        p = record.get("profile", {})
        if not p.get("busy_s") or not p.get("window_s"):
            return None
        return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

    return read


def ops_per_scan():
    """Device operations (kernels, copies, fills) a scan of the slice."""

    def read(record):
        p = record.get("profile", {})
        if not p.get("device_ops") or not record.get("scans"):
            return None
        return p["device_ops"] / record["scans"]

    return read
