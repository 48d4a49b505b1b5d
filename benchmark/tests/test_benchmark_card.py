"""Each cell run once, briefly, on the card: the result line, correct, and
the process leaving nothing behind. Marked `gpu`; skips without a card. On
the card:

    python -m pytest benchmark/tests/test_benchmark_card.py -q -m gpu
"""

import json
import subprocess
import sys

import pytest

from benchmark.spec import ROOT, load_benchmark

pytestmark = pytest.mark.gpu
BENCH = load_benchmark()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    cmd = BENCH["command"] + ["--workload", cell, "--seed", str(2**31 + 11),
                              "--seconds", "3", "--trace", "0"]
    proc = subprocess.run([sys.executable] + cmd[1:], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
