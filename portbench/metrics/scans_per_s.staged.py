"""Scans a second of the traced window, its requests answered stage by stage; moves latency_p95_ms."""

from portbench.readers import staged_rate

read = staged_rate()
