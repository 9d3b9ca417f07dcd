"""Device operations a scan in the whole-entry slice; moves latency_p95_ms."""

from portbench.readers import ops_per_scan

read = ops_per_scan()
