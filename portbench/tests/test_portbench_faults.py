"""The rest of a run, driven on the CPU at a tiny size with the harness's
look for a card skipped: correct as the program stands, and not correct
with each fault that a cell can have planted under the timed path."""
import time

import pytest
import torch

from conftest import tiny_cell
from portbench.harness import env

FAULTS = [("expytky-road.train", "state_unchanged"),
          ("expytky-road.train", "half_batch"),
          ("expytky-road.train", "few_leaves"),
          ("expytky-road.train", "wrong_direction"),
          ("expytky-road.serve-bulk", "answer_altered"),
          ("expytky-road.serve-bulk", "half_batch"),
          ("expytky-road.serve-stream", "answer_altered"),
          ("expytky-road.serve-stream", "state_unchanged")]


def _run(workload, fault=None, seed=2 ** 31 + 7):
    return env.run_cell(tiny_cell(workload), seed, 0.3, False,
                        torch.device("cpu"), time.perf_counter(),
                        fault=fault)


@pytest.mark.parametrize("workload", sorted({w for w, _ in FAULTS}))
def test_sound_run_is_correct(workload):
    out, line = _run(workload)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "compared"
    for m in tiny_cell(workload).end_to_end:
        assert line["metrics"][m["name"]]["value"] > 0


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    out, line = _run(workload, fault)
    assert not line["correct"], (fault, line["compared"])
