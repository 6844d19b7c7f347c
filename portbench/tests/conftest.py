"""Shared fixtures of the benchmark's own tests. CPU tests run anywhere;
a test that needs the card takes the ``card`` fixture, which skips it
where there is none (decided when the test runs, never at import).

    python3 -m pytest portbench/tests -q
"""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = ("expytky-road.train", "expytky-road.serve-bulk",
             "expytky-road.serve-stream")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    return torch.device("cuda", 0)


def tiny_config(config: dict) -> dict:
    """A configuration shrunk to a CPU test's size: 40 sensors, narrow
    widths, small batches."""
    c = copy.deepcopy(config)
    c["model"].update(num_nodes=40, rnn_units=8, mem_num=4, mem_dim=8)
    c["train"]["batch_size"] = 8
    c["serve_batch"] = 8
    return c


def tiny_config_file(name: str) -> dict:
    """``portbench/configs/<name>.json`` at a CPU test's size."""
    return tiny_config(json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text()))


def tiny_cell(workload: str):
    """The cell as committed, shrunk to a CPU test's size: the tiny
    configuration, two days of data, small requests."""
    from portbench.harness import cell as cells

    c = copy.deepcopy(cells.load(workload))
    c.config = tiny_config(c.config)
    c.traffic["series_days"] = 2
    if "request_windows" in c.traffic:
        c.traffic["request_windows"] = 30
    return c
