"""Mean DCVC propagation sweeps a scan (the program's counter dcvc.sweeps, one host sync each) over the staged requests; moves latency_p95_ms."""

from portbench.readers import stage_ms

read = stage_ms("dcvc_sweeps")
