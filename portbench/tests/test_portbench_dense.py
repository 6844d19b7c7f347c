"""The ``megacrn-expytky-dense`` configuration and its cell,
``expytky-dense.train``: the reference held to the program on the learned
dense graph, the cell's files found by name, a tiny CPU run correct and
each planted fault not, and ``counts/dense.py`` against a count of the
products the program's aggregation runs."""
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import test_portbench_reference as base
from conftest import tiny_cell
from portbench.counts import dense
from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from portbench.harness import cell as cells
from portbench.harness import env

CONFIG = "megacrn-expytky-dense"
WORKLOAD = "expytky-dense.train"
FAULTS = ("state_unchanged", "half_batch", "few_leaves", "wrong_direction")


def test_forward_matches_program():
    base.test_forward_matches_program(CONFIG)


def test_three_train_steps_match_program():
    base.test_three_train_steps_match_program(CONFIG)


def test_cell_finds_its_files():
    c = cells.load(WORKLOAD)
    assert c.chips == 1 and c.config["graph"] == {"kind": "learned"}
    assert c.config["model"]["graph_backend"] == "dense"
    assert [m["name"] for m in c.end_to_end] == [
        "train_step_ms.road", "setup_s"]
    assert {m["name"] for m in c.per_layer} == {
        "device_idle.expytky_dense", "train_mfu.expytky_dense"}
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))
    assert set(c.limits) == {"loss_gap", "grad_gap_med", "grad_gap_max",
                             "delta_gap_med", "delta_gap_max"}


def _run(fault=None, seed=2 ** 31 + 11):
    return env.run_cell(tiny_cell(WORKLOAD), seed, 0.3, False,
                        torch.device("cpu"), time.perf_counter(),
                        fault=fault)


def test_sound_run_is_correct():
    out, line = _run()
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["metrics"]["train_step_ms.road"]["value"] > 0
    # The meta-graph's leaves move, so the delta check reads them.
    assert not {"memory.We1", "memory.We2", "memory.Memory"} & set(
        out.layer["quiet_leaves"])


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    out, line = _run(fault)
    assert not line["correct"], (fault, line["compared"])


@pytest.mark.parametrize("order", (2, 3, 4))
def test_aggregate_operations_are_the_programs_products(order):
    """The operations against the products that the program's recursive
    aggregation runs, counted by torch's flop counter."""
    from megacrn_tpu_torch.ops.graph import cheb_aggregate

    n, b, c, s = 11, 3, 5, 2
    supports = torch.rand(s, n, n)
    x = torch.rand(b, n, c)
    with FlopCounterMode(display=False) as counter:
        cheb_aggregate(supports, x, order)
    counts = {"nodes": n, "width": b * c, "supports": s, "order": order}
    flops, _ = dense.aggregate_counts(counts)
    assert flops == counter.get_total_flops()


def test_aggregate_bytes_and_bound_by_hand():
    # N=4, width 6, S=2, K=3: 4 products, each reading its 16-element
    # support and a 24-element input and writing 24; the second level of
    # each support reads t_0 (24) again.
    counts = {"nodes": 4, "width": 6, "supports": 2, "order": 3}
    flops, nbytes = dense.aggregate_counts(counts)
    assert flops == 4 * 2 * 4 * 4 * 6
    assert nbytes == 4 * (4 * (16 + 24 + 24) + 2 * 24)
    seconds, by = dense.aggregate_bound(counts)
    assert (seconds, by) == (nbytes / HBM_BYTES_PER_S, "bytes")
    # At the cell's widest aggregation the products are compute-bound.
    big = {"nodes": 1843, "width": 64 * 66, "supports": 2, "order": 3}
    seconds, by = dense.aggregate_bound(big)
    assert by == "operations"
    assert seconds == dense.aggregate_counts(big)[0] / PEAK_FLOPS["float32"]
