"""The block-COO SpMM's share of its roofline over a train step's
launches (%)."""
from portbench.harness.readers import \
    spmm_coo_roofline_pct as read  # noqa: F401
