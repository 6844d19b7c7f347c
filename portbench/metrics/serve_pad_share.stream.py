"""The share of the windows the card computed in the window's pushes that
are padding (%): a push forecasts one window in a whole chunk."""
from portbench.harness import spans


def read(cell, outcome):
    return spans.pad_share_pct(spans.window("serve.push",
                                            cell.traffic["warm_pushes"]))
