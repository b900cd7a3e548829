"""A short run of each cell through the command, on the card (skips
without one)."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["config4_orbit.batch64",
                                  "config4_orbit.fit4"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
