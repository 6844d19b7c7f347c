"""The card's idle share of the traced span (%)."""
from portbench.harness.readers import device_idle_pct as read  # noqa: F401
