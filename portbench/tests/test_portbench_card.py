"""On the card (``python -m pytest portbench/tests -m cuda``): one short
run of each cell through the command, correct, with the contract's
line. Skips where no CUDA card is present."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT

with open(f"{ROOT}/BENCHMARK.json") as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "4294967311", "--seconds", "3",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
