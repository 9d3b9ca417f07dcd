"""Mean ms of verification and ranking (match.verify) a staged request; moves latency_p95_ms."""

from portbench.readers import stage_ms

read = stage_ms("verify")
