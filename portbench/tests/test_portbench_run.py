"""The benchmark's command as a check runs it: without a card it exits
with another code than 0 and prints no result; the manifest's cells,
metrics and files are found by name."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT, WORKLOADS
from portbench.harness import cell as cells


def test_no_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        WORKLOADS[0], "--seed", "3000000000", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells_find_their_files(workload):
    c = cells.load(workload)
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(cells.reader(m["name"]))
    for base in names:
        assert base.split(".")[0] in {"setup_s", "train_step_ms",
                                      "serve_windows_per_s", "serve_p95_ms"}


def test_manifest_keys_and_paths():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert Path(c["file"]).parts[0] in bench["paths"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"]:
        assert m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                      "device_trace")
