"""The median latency of the window's pushes (ms)."""
from portbench.harness.readers import latency_median_ms as read  # noqa: F401
