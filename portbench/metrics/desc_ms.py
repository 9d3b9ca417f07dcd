"""Mean ms of the descriptor stage (desc.triangles) a staged request; moves latency_p95_ms."""

from portbench.readers import stage_ms

read = stage_ms("desc")
