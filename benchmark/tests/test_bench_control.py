"""The controls at a size a test run holds: the reference in bfloat16 put
in the program's place, computed or stored, fails each cell's limits, on
the CPU, on three seeds."""

import pytest
import torch

from benchmark import check, control, spec
from conftest import tiny


@pytest.mark.parametrize("cell_name", ["dry_120km", "moist_120km"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 1, 2 ** 40 + 3])
def test_control_is_not_correct(cell_name, seed, grid_dir):
    cell = tiny(spec.load_cell(cell_name), level=3, levels=8,
                check_steps=(8, 12))
    controls = control.control_numbers(cell, seed, torch.device("cpu"),
                                       grid_dir=grid_dir)
    assert sorted(controls) == ["bf16_compute", "bf16_store"]
    for name, numbers in controls.items():
        correct, failed, checks = check.verdict(numbers, cell.limits)
        assert not correct, (name, checks)
        assert failed >= 1
