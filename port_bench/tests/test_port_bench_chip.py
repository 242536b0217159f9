"""Each cell of ``BENCHMARK.json`` end to end on the card, with a short
window: the result line, ``correct`` and the device. Skips without a card.

    python -m pytest -m cuda port_bench/tests/test_port_bench_chip.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed", "2147483777",
                           "--seconds", "5", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
