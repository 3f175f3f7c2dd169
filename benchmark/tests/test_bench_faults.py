"""A whole run of each cell's harness on the CPU at a tiny size, past the
look for a card: sound, it comes out correct; with the timed path broken
underneath, `correct` comes out false, once for each fault the cells can
have: a step that returns its state unchanged, and an answer altered where
the step produces it."""

import time

import pytest
import torch

from benchmark import harness, spec
from conftest import tiny
from mpas_tpu_torch.dynamics import srk3


def run(cell_name, grid_dir, seed=2 ** 31 + 5):
    cell = tiny(spec.load_cell(cell_name))
    return harness.run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                            time.perf_counter(), 0.0, grid_dir=grid_dir,
                            log=lambda msg: None)


CELLS = ["dry_120km", "moist_120km"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name, grid_dir):
    res = run(cell_name, grid_dir)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    names = set(res["checks"])
    assert {"u", "w", "theta_m", "rho_zz", "nonfinite"} <= names
    if cell_name.startswith("moist"):
        assert {"scalars", "rainnc_rms"} <= names
    e2e = {"peak_mem_gib", "setup_s"}
    if cell_name.startswith("moist"):
        e2e |= {"sim_days_per_hour", "step_ms_p95"}
    assert set(res["metrics"]) == e2e


def unchanged(state, *args, **kw):
    return state


def altered(field):
    real = srk3.atm_srk3

    def step(state, *args, **kw):
        new = real(state, *args, **kw)
        t = getattr(new, field).clone()
        t.view(-1)[t.numel() // 2] += 0.1 * float(t.abs().max())
        return new.replace(**{field: t})
    return step


FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "theta_m", "u")]
FAULTS += [("moist_120km", "scalars"), ("moist_120km", "rainnc")]


@pytest.mark.parametrize("cell_name,fault", FAULTS)
def test_broken_step_is_not_correct(cell_name, fault, grid_dir, monkeypatch):
    monkeypatch.setattr(srk3, "atm_srk3",
                        unchanged if fault == "unchanged" else altered(fault))
    res = run(cell_name, grid_dir)
    assert not res["correct"]
    assert res["failed"] >= 1
