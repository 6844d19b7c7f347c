"""The loader's host time a train step (ms): the window's ``data.*``
spans (the epoch's reshuffle, each batch's preparation) over its
``train.step`` count."""
from portbench.harness import spans


def read(cell, outcome):
    return spans.per_step_ms(spans.window("train.step",
                                          cell.traffic["check_steps"]),
                             "data.")
