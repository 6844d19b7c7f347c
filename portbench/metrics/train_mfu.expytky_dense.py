"""A train step's share of the card's float32 peak (%), over the
learned-graph count of ``counts/megacrn.py``."""
from portbench.harness.readers import train_mfu_pct as read  # noqa: F401
