"""A train step's share of the card's float32 peak (%)."""
from portbench.harness.readers import train_mfu_pct as read  # noqa: F401
