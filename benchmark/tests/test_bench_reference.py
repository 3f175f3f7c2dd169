"""The frozen reference against the port's eager path on the CPU (where each
kernel's wrapper runs its plain version): the same grid file and seeded
inputs, float64, after two steps, dry and moist, on generate_mesh(2) and
generate_mesh(3)."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs, spec
from conftest import tiny

REL = 1e-10      # float64: the same arithmetic, up to the order of sums


@pytest.mark.parametrize("cell_name,level,levels", [
    ("dry_120km", 2, 4), ("dry_120km", 3, 5), ("moist_120km", 2, 6)])
def test_reference_matches_the_port(cell_name, level, levels, grid_dir):
    cell = tiny(spec.load_cell(cell_name), level=level, levels=levels)
    cell.config = dict(cell.config,
                       namelist=dict(cell.config["namelist"], dtype="float64"))
    draws = inputs.draw(2 ** 33 + 17, cell.traffic)
    grid = inputs.grid_file(level, grid_dir)
    device = torch.device("cpu")
    model = harness.build_program(cell, draws, grid, device)
    assert model.dtype == torch.float64
    start = check.to_host(check.fields(model.state))
    model.step(2)
    port = check.to_host(check.fields(model.state))
    ref0, ref = check.reference_run(cell, draws, grid, 2, device)
    assert sorted(port) == sorted(ref)
    if cell_name.startswith("moist"):
        assert "scalars" in ref and "rainnc" in ref
        assert ref["scalars"][1:].max() > 0          # the seeded condensate
        assert ref["rainnc"].max() > 0
    for k in ref:
        np.testing.assert_allclose(start[k], ref0[k], rtol=0, atol=0)
        scale = np.abs(ref[k]).max()
        assert np.abs(port[k] - ref[k]).max() <= REL * scale, k
    gaps = check.gaps(port, ref, ref0)
    assert max(gaps.values()) <= 1e-8


@pytest.mark.parametrize("option,value", [
    ("config_cell_form_ops", True), ("config_orient_edges", True),
    ("config_apvm_upwinding", 0.5), ("config_microphysics", "kessler"),
    ("config_apply_lbcs", True)])
def test_reference_refuses_what_it_does_not_carry(option, value, grid_dir):
    """An option the reference does not carry is refused, not run as
    something else."""
    from benchmark.reference.config import Namelist as RefNamelist
    from benchmark.reference.dynamics.model import build_model
    from benchmark.reference.mesh.loader import load_mesh
    nl = RefNamelist(**{option: value})
    with pytest.raises(ValueError, match=option):
        build_model(nl, load_mesh(str(inputs.grid_file(2, grid_dir))),
                    "cpu", torch.float64)


@pytest.mark.parametrize("cell_name", ["dry_120km", "moist_120km"])
def test_frozen_cells_run_the_frozen_reference(cell_name, grid_dir):
    """The benchmark's own cells name no module of their own, and the
    comparison's reference run is the frozen reference called directly."""
    from benchmark.reference.config import Namelist as RefNamelist
    from benchmark.reference.dynamics.model import build_model
    from benchmark.reference.mesh.loader import load_mesh
    cell = tiny(spec.load_cell(cell_name))
    assert cell.program is None and cell.reference is None
    assert not {"program", "reference"} & set(cell.config)
    draws = inputs.draw(2 ** 35 + 1, cell.traffic)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    device = torch.device("cpu")
    ref0, ref = check.reference_run(cell, draws, grid, 3, device)

    model = build_model(
        RefNamelist(**cell.namelist,
                    config_jw_u_perturbation=draws.jw_u_perturbation),
        load_mesh(str(grid)), device, torch.float64)
    s = model.state
    n_scalars = 0 if s.scalars is None else s.scalars.shape[0]
    model.state = check.with_inputs(s, check.condensate_for(
        cell, draws, n_scalars, *s.theta_m.shape))
    direct0 = check.to_host(check.fields(model.state))
    model.step(3)
    direct = check.to_host(check.fields(model.state))
    assert sorted(ref) == sorted(direct)
    for k in ref:
        np.testing.assert_array_equal(ref0[k], direct0[k])
        np.testing.assert_array_equal(ref[k], direct[k])
