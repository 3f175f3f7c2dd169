"""The whole slice: mpas_tpu_torch's model against mpas_tpu's, float64 on the
CPU, on generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels.

  - build_model: the port's own host setup gives the reference's initial
    state;
  - atm_srk3: 2 steps from a state carried across with `from_jax_numpy`
    agree field by field at 1e-10 of each field's largest magnitude. The
    per-op tests hold 1e-12; two steps of ~40 stencil reductions each, whose
    sums run in another order, grow the round-off to ~1e-13 (w, the smallest
    field, measured 2e-13), so 1e-10 leaves room without hiding a fault;
  - every namelist option of the single-device step builds and steps; what
    is still unported (the regional boundary conditions, the halo) raises."""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh.generator import generate_mesh as j_generate

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics import srk3
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.weights import from_jax_numpy

STEP_RTOL = 1e-10
INIT_RTOL = 1e-12
FIELDS = ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p")
KW = dict(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
          config_jw_u_perturbation=1.0)


def as_dict(x):
    return {f.name: (None if getattr(x, f.name) is None
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


def rel_err(a, b):
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def jax_model():
    return j_build(namelist=JNamelist(**KW),
                   mesh=j_generate(levels=3, lloyd_iterations=2))


@pytest.fixture(scope="module")
def two_steps(jax_model):
    m = jax_model
    tm, tv, tst, ts = from_jax_numpy(
        as_dict(m.mesh_arrays), as_dict(m.vert), as_dict(m.static),
        as_dict(m.state), device="cpu", dtype=torch.float64)
    nl = Namelist(**KW)
    for _ in range(2):
        ts = srk3.atm_srk3(ts, tst, tm, tv, nl, nl.config_dt)
    jstate = m.step_fn(m.step_fn(m.state))
    return jstate, ts


@pytest.mark.parametrize("field", FIELDS)
def test_two_steps_match(two_steps, field):
    jstate, ts = two_steps
    a = np.asarray(getattr(jstate, field))
    b = getattr(ts, field).numpy()
    assert np.isfinite(b).all()
    assert rel_err(a, b) < STEP_RTOL, field


def test_build_model_matches_reference_initial_state(jax_model):
    model = build_model(Namelist(**KW),
                        generate_mesh(levels=3, lloyd_iterations=2),
                        device="cpu")
    assert model.device.type == "cpu" and model.dtype == torch.float64
    for f in dataclasses.fields(model.state):
        t = getattr(model.state, f.name)
        if t is None:
            continue
        assert t.is_contiguous(), f.name
        assert rel_err(np.asarray(getattr(jax_model.state, f.name)),
                       t.numpy()) < INIT_RTOL, f.name
    for f in dataclasses.fields(model.static):
        assert rel_err(np.asarray(getattr(jax_model.static, f.name)),
                       getattr(model.static, f.name).numpy()) < INIT_RTOL


def test_model_step_and_summarize():
    model = build_model(Namelist(**KW),
                        generate_mesh(levels=3, lloyd_iterations=2),
                        device="cpu")
    model.step(1)
    s = model.summarize()
    assert model.step_count == 1 and s["nan_detected"] == 0.0
    assert abs(s["u_max"]) < 100 and abs(s["w_max"]) < 5


def test_rk_substep_counts():
    assert srk3.rk_substep_counts(2) == [1, 1, 2]
    assert srk3.rk_substep_counts(6) == [3, 3, 6]


def test_build_model_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        build_model(Namelist(**KW), generate_mesh(levels=2, lloyd_iterations=0))


@pytest.mark.parametrize("change", [
    dict(config_init_case=21), dict(config_cell_form_ops=True),
    dict(config_hollingsworth=True), dict(config_moisture=True),
    dict(config_microphysics="kessler"), dict(config_apvm_upwinding=0.5),
    dict(config_microphysics="wsm6lite"),
    dict(config_moisture=True, config_microphysics="wsm6"),
    dict(config_pbl="ysu_lite"), dict(config_scalar_advection=True),
    dict(config_moisture=True, config_scalar_advection=True),
    dict(config_init_case=22, config_moisture=True)],
    ids=lambda c: "-".join(f"{k[7:]}={v}" for k, v in c.items()))
def test_ported_options_build_and_step(change):
    """Each of these options builds on the CPU, takes a
    step and stays finite; microphysics brings its species, rainnc, scalar
    transport and a substep count."""
    model = build_model(Namelist(**KW, **change),
                        generate_mesh(levels=2, lloyd_iterations=0),
                        device="cpu")
    nl = model.namelist
    n_species = {"kessler": 3, "wsm6lite": 5, "wsm6": 6}.get(
        nl.config_microphysics, 1 if nl.config_moisture else 0)
    if n_species:
        assert model.state.scalars.shape[0] == n_species
        assert bool((model.state.scalars[0] > 0).any()) == nl.config_moisture
    else:
        assert model.state.scalars is None
    if nl.config_microphysics != "off":
        assert nl.config_scalar_advection and nl.config_kessler_nfall >= 1
        assert model.state.rainnc.shape == (model.mesh.nCells,)
    else:
        assert model.state.rainnc is None
    model.step(1)
    for f in dataclasses.fields(model.state):
        t = getattr(model.state, f.name)
        assert t is None or bool(torch.isfinite(t).all()), f.name
    assert model.summarize()["nan_detected"] == 0.0


@pytest.mark.parametrize("what", ["config_apply_lbcs", "halo"])
def test_unported_options_raise(what):
    """The two options that raised until they were ported now run: the
    regional lateral boundary conditions (builds and steps; on a mesh with
    no boundary zone the step is the global one, bit for bit) and a halo
    (a 2-shard stacked step gives the single-device step on owned
    entries)."""
    from mpas_tpu_torch.parallel.sharded import shard_model
    mesh = generate_mesh(levels=2, lloyd_iterations=0)
    m = build_model(Namelist(**KW), mesh, device="cpu")
    ref = srk3.atm_srk3(m.state, m.static, m.mesh_arrays, m.vert,
                        m.namelist, 720.0)
    if what == "config_apply_lbcs":
        lbc = build_model(Namelist(**KW, config_apply_lbcs=True), mesh,
                          device="cpu")
        out = srk3.atm_srk3(lbc.state, lbc.static, lbc.mesh_arrays, lbc.vert,
                            lbc.namelist, 720.0)
        for n in ("u", "w", "theta_m", "rho_zz"):
            assert torch.equal(getattr(out, n), getattr(ref, n)), n
        return
    sm = shard_model(m, 2)
    sm.step(1)
    g = sm.gather_state(m.mesh)
    for n in ("u", "w", "theta_m", "rho_zz"):
        assert torch.allclose(torch.from_numpy(g[n]), getattr(ref, n),
                              rtol=0.0, atol=1e-12), n
