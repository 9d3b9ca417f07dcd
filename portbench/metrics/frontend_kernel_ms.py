"""Kernel ms a scan inside the profiled front-end stages (pb:frontend); moves latency_p95_ms."""


def read(record):
    s = record.get("profile", {}).get("stage_kernel_s", {}).get("frontend")
    return 1e3 * s / record["scans"] if s and record.get("scans") else None
