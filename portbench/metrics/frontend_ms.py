"""Mean ms of the front end (graph.build: DCVC and the graph builder, the program's build_graph a scan) a staged request; moves latency_p95_ms."""

from portbench.readers import stage_ms

read = stage_ms("frontend")
