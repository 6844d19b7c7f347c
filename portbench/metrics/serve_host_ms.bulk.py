"""The host's own time in a request (ms): the median over the window's
``serve.predict`` spans of each less its chunks' ``serve.copy_back``
spans, where the host waits for the card."""
from portbench.harness import spans


def read(cell, outcome):
    return spans.host_ms(spans.window("serve.predict",
                                      cell.traffic["warm_requests"]),
                         "serve.predict")
