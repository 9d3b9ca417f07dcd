"""Share (%) of the whole-entry slice with no device operation running; moves latency_p95_ms."""

from portbench.readers import device_idle

read = device_idle()
