"""A batch's upload on the host (ms): the window's ``train.upload`` spans
over its ``train.step`` count, one upload a step."""
from portbench.harness import spans


def read(cell, outcome):
    return spans.per_step_ms(spans.window("train.step",
                                          cell.traffic["check_steps"]),
                             "train.upload")
