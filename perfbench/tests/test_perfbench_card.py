"""Every cell of ``BENCHMARK.json`` once on the card, as the check runs it:
a short window, its result line correct. Skips without a card.

    python -m pytest perfbench/tests -q -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 32 + 77), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
