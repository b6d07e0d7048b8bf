"""On the card: each cell of ``BENCHMARK.json`` runs for two seconds,
untraced and traced, and prints a correct result line.  Skipped without
a CUDA device."""

import json
import os
import subprocess
import sys

import pytest

from ._small import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_correct(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for name in cells:
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench_port", "run.py"),
             "--workload", name, "--seed", str(2**31 + 3), "--seconds", "2",
             "--trace", str(trace)], capture_output=True, text=True,
            timeout=600, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["metrics"], (name, res)
