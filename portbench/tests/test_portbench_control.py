"""The control on the card: the reference in TF32 (the next precision
below the configurations' float32 with TF32 off) put in the program's
place fails at least one compared number of each cell, while the program
passes them all, at the cell's own size.

    python3 -m pytest portbench/tests/test_portbench_control.py -q
"""
import time

import pytest

from conftest import WORKLOADS
from portbench.harness import cell as cells
from portbench.harness import env


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes(card, workload):
    cell = cells.load(workload)
    out, line = env.run_cell(cell, 4000000017, 2.0, False, card,
                             time.perf_counter(), control=True)
    assert line["correct"], line["compared"]
    assert any(out.control_readings[k] > cell.limits[k]
               for k in out.control_readings), out.control_readings
