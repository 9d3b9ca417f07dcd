"""Mean ms of the candidate search (match.search) a staged request; moves latency_p95_ms."""

from portbench.readers import stage_ms

read = stage_ms("search")
