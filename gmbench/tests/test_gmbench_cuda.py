"""A short run of each cell on the card (``-m cuda``; skips without one):
``python -m pytest -p no:cacheprovider -q gmbench/tests -m cuda``."""

import json
import subprocess
import sys

import pytest
import torch

from gmbench import spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    p = subprocess.run([sys.executable, "-m", "gmbench.run", "--workload",
                        name, "--seed", "2147483749", "--seconds", "3"],
                       capture_output=True, text=True, cwd=spec.ROOT,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
