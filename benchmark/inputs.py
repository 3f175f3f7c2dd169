"""What the benchmark makes and hands to both the program and the reference:
the grid file, and the inputs drawn from the seed.

The grid is the icosahedral CVT mesh x1.(10*4^level+2), made by the frozen
generator of `reference/mesh/` and written once as an MPAS grid file into
`grids/` inside the checkout; later runs read that file, as a user's run
reads its grid. The seed draws the JW perturbation amplitude, the checked
step of the window and, where the microphysics carries condensate, a
condensate field. Every seed gives the same sizes and the same work.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .reference.core.vertical import make_vertical_grid
from .reference.mesh.generator import generate_mesh
from .reference.mesh.writer import save_grid

GRID_DIR = Path(__file__).resolve().parent / "grids"

# the condensate species in the order of scalars[1:], each with its mixing
# ratio [kg/kg] and the phase it takes: liquid below 4.5 km, ice between
# 3.5 and 11 km of the vertical coordinate (so both in between)
CONDENSATE = ((4e-4, "liquid"), (2e-4, "liquid"), (1.5e-4, "ice"),
              (3e-4, "ice"), (2e-4, "ice"))
PHASE_HEIGHTS = {"liquid": (0.0, 4500.0), "ice": (3500.0, 11000.0)}


def grid_file(level: int, grid_dir: Path = GRID_DIR) -> Path:
    """The grid file of generate_mesh(level), made on first use. It is
    written under a temporary name and renamed, so a reader never sees a
    partial file."""
    path = Path(grid_dir) / f"x1.{10 * 4 ** level + 2}.grid.nc"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".nc", dir=path.parent)
    os.close(fd)
    try:
        save_grid(generate_mesh(levels=level), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@dataclass
class Draws:
    jw_u_perturbation: float
    check_step: int          # the window's step whose state is compared
    condensate_seed: int


def draw(seed: int, traffic: dict) -> Draws:
    rng = np.random.default_rng(seed)
    lo, hi = traffic["jw_u_perturbation"]
    amp = lo + (hi - lo) * float(rng.random())
    first, last = traffic["check_steps"]
    step = int(rng.integers(first, last + 1))
    return Draws(amp, step, int(rng.integers(2 ** 62)))


def condensate(draws: Draws, n_species: int, K: int, C: int, ztop: float,
               stretch: float, share: float) -> np.ndarray:
    """[n_species, K, C] float64 mixing ratios of scalars[1:]: each
    species' ratio where its phase lives (by the height of the level in
    the vertical coordinate, not by the state) times a factor in [0.5,
    1.5) at a random `share` of the points, zero elsewhere. WSM6 then runs
    its warm and its ice paths and sedimentation from the first step."""
    rng = np.random.default_rng(draws.condensate_seed)
    shape = (n_species, K, C)
    factor = (0.5 + rng.random(shape)) * (rng.random(shape) < share)
    z = make_vertical_grid(K, ztop, stretch).zu
    for i, (q, phase) in enumerate(CONDENSATE[:n_species]):
        lo, hi = PHASE_HEIGHTS[phase]
        factor[i] *= q * ((z >= lo) & (z < hi))[:, None]
    return factor
