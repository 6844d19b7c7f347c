"""The host's own time in a push (ms): the median over the window's
``serve.push`` spans of each less its ``serve.copy_back``, where the host
waits for the card."""
from portbench.harness import spans


def read(cell, outcome):
    # Of the set-up's pushes only the last ``warm_pushes`` forecast and
    # record a ``serve.push``: the first ``seq_len - 1`` fill the window.
    return spans.host_ms(spans.window("serve.push",
                                      cell.traffic["warm_pushes"]),
                         "serve.push")
