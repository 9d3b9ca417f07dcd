"""Share (%) of the search stage's kernel time its bucket-slot reads and vote writes need; moves latency_p95_ms."""

from portbench.readers import roofline

read = roofline("search")
