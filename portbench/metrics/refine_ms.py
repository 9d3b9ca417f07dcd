"""Mean ms of the GICP rerank (refine.gicp, refine.lsq) a staged request; moves latency_p95_ms."""

from portbench.readers import stage_ms

read = stage_ms("refine")
