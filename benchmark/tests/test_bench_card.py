"""On the card: one short run of the 120 km dry cell through the benchmark's
command, and the control against its limits. Skips without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_a_correct_line(trace):
    need_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dry_120km",
         "--seed", str(2 ** 32 + 3), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
        assert "sim_days_per_hour.dry" in res["metrics"]


@pytest.mark.gpu
def test_control_fails():
    need_card()
    from benchmark import control, check, spec
    import torch
    cell = spec.load_cell("dry_120km")
    for numbers in control.control_numbers(cell, 7,
                                           torch.device("cuda")).values():
        assert not check.verdict(numbers, cell.limits)[0]
