"""The share of the window's serving forwards that replayed a CUDA graph
(%): Σ``graphed`` over the ``serve.forward`` spans, over their count.
Nothing to read where the program's forwards count no ``graphed``."""
from portbench.harness import spans


def read(cell, outcome):
    window = spans.window("serve.push", cell.traffic["warm_pushes"])
    forwards = [s for s in window or () if s.name == "serve.forward"]
    if not forwards or any("graphed" not in s.counts for s in forwards):
        return None
    return 100.0 * sum(s.counts["graphed"] for s in forwards) / len(forwards)
