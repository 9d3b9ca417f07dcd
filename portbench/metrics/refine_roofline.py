"""Share (%) of the rerank stage's kernel time its nearest-neighbour distances need; moves latency_p95_ms."""

from portbench.readers import roofline

read = roofline("refine")
