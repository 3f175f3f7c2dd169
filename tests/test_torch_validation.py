"""mpas_tpu_torch.validation's runners against the same loops written here
over the live mpas_tpu API, float64 on the CPU.

Each runner (jw, moist with Kessler and with WSM6 + PBL, the mountain
wave, the supercell, the radiation-coupled run) is run for STEPS steps
with a record every EVERY on a generated mesh of refinement level 2 (162
cells) at NZ levels; the loop here builds mpas_tpu's model on the same
mesh object, steps it the same way, records what the tool records
(tools/*.py) and lays its final fields out as the tool saves them. The
recorded series and every array of the artifact agree at 1e-10 of their
largest magnitude. `surface_pressure` gives the tools' own function's
values on a JAX model's state carried into the port.
"""

import types

import numpy as np
import pytest

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.physics.driver import physics_init as j_physics_init
from tools.jw_production_run import surface_pressure as tool_surface_pressure

from mpas_tpu_torch.core.vertical import make_vertical_grid
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.validation import (jw, moist, mountain_wave,
                                       radiation_coupled, supercell)
from mpas_tpu_torch.validation.common import surface_pressure

from test_torch_cellform import carry
from test_torch_copies import as_mpas_tpu

RTOL = 1e-10
LEVEL = 2
NZ = 6
STEPS, EVERY = 4, 2
SMALL = dict(config_nvertlevels=NZ, dtype="float64")


def assert_series(port, ref, keys):
    """Each record's `keys` at RTOL of the series' largest magnitude."""
    assert len(port) == len(ref)
    for k in keys:
        a = np.array([r[k] for r in ref], np.float64)
        b = np.array([r[k] for r in port], np.float64)
        scale = max(np.abs(a).max(), 1e-300)
        assert np.abs(a - b).max() <= RTOL * scale, (k, a, b)


def assert_files(port, ref):
    """The same keys, shapes and values (numbers at RTOL of each array's
    largest magnitude, strings equal)."""
    assert sorted(port) == sorted(ref)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype.kind in "US":
            assert (a == b).all(), k
            continue
        scale = max(np.abs(a).max(), 1e-300) if a.size else 0.0
        assert np.abs(a.astype(np.float64) - b).max() <= RTOL * scale, k


def j_loop(nl, mesh, record, steps=STEPS, every=EVERY, hook=None,
           hook_every=1, first=False):
    """The tools' loop over mpas_tpu: build, (record,) then `steps` steps
    `every` at a time with a record after each, `hook` before every
    `hook_every` steps."""
    m = j_build(namelist=nl, mesh=mesh)
    recs = [record(m)] if first else []
    for done in range(0, steps, every):
        if hook is not None and done % hook_every == 0:
            hook(m, done)
        m.step(every)
        recs.append(record(m))
    return m, recs


def summary_keys():
    return ("w_min", "w_max", "u_min", "u_max", "theta_min", "theta_max")


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(levels=LEVEL)


@pytest.fixture(scope="module")
def jw_runs(mesh):
    """The jw runner and the tools' loop over mpas_tpu: (port run, JAX
    model, JAX records)."""
    run = jw.run("jw480", mesh=mesh, steps=STEPS, record_every=EVERY,
                 device="cpu", log=None, **SMALL)
    nl = JNamelist(**as_mpas_tpu(
        jw.make_namelist(720.0, **SMALL).to_dict()))

    def record(m):
        sp = tool_surface_pressure(m)
        return dict(ps_min=float(sp.min()), ps_max=float(sp.max()),
                    **m.summarize())

    return (run,) + j_loop(nl, mesh, record, first=True)


def test_surface_pressure_matches_the_tools(jw_runs):
    _, jm, _ = jw_runs
    _, _, static, state = carry(jm)
    port = types.SimpleNamespace(
        state=state, static=static,
        vgrid=make_vertical_grid(NZ, 30000.0,
                                 jm.namelist.config_vertical_stretch))
    ref = tool_surface_pressure(jm)
    sp = surface_pressure(port)
    assert sp.dtype == ref.dtype and sp.shape == (jm.mesh.nCells,)
    np.testing.assert_array_equal(sp, ref)


def test_jw_runner_matches_the_tools_loop(mesh, jw_runs):
    run, jm, recs = jw_runs
    assert not run.full and run.steps == STEPS
    assert_series(run.records, recs, ("ps_min", "ps_max") + summary_keys())
    st = jm.state
    ref = {"jw_psmin_162.npz": dict(
        day=np.array([0, 2, 4]) / 120.0,
        ps_min=np.array([r["ps_min"] for r in recs]),
        ps_max=np.array([r["ps_max"] for r in recs]),
        n_levels=NZ, dt=720.0, mesh="x1.162"),
        "jw_step4_162.npz": dict(
        u=np.asarray(st.u).T, w=np.asarray(st.w).T,
        theta_m=np.asarray(st.theta_m).T, rho_zz=np.asarray(st.rho_zz).T,
        surface_pressure=tool_surface_pressure(jm),
        latCell=mesh.latCell, lonCell=mesh.lonCell,
        steps=jm.step_count, dt=720.0, levels=NZ)}
    files = jw.artifacts(run)
    assert sorted(files) == sorted(ref)
    for name in ref:
        assert_files(files[name], ref[name])


@pytest.mark.parametrize("preset", ["moist_kessler", "moist_wsm6"])
def test_moist_runner_matches_the_tools_loop(mesh, preset):
    run = moist.run(preset, mesh=mesh, steps=STEPS, record_every=EVERY,
                    device="cpu", log=None, **SMALL)
    mp = moist.PRESETS[preset]
    nl = JNamelist(**as_mpas_tpu(
        moist.make_namelist(mp, **SMALL).to_dict()))
    assert nl.config_pbl == ("ysu_lite" if mp == "wsm6" else "off")

    def record(m):
        return dict(rain_mean=float(np.asarray(m.state.rainnc).mean()),
                    **m.summarize())

    jm, recs = j_loop(nl, mesh, record)
    assert_series(run.records, recs, ("rain_mean",) + summary_keys())
    st = jm.state
    ref = dict(
        u=np.asarray(st.u).T, w=np.asarray(st.w).T,
        theta_m=np.asarray(st.theta_m).T,
        qv=np.asarray(st.scalars[0]).T, qc=np.asarray(st.scalars[1]).T,
        qr=np.asarray(st.scalars[2]).T, scalars=np.asarray(st.scalars),
        rainnc=np.asarray(st.rainnc),
        rain_series=np.array([r["rain_mean"] for r in recs]),
        latCell=mesh.latCell, lonCell=mesh.lonCell,
        days=STEPS * 450.0 / 86400, dt=450.0, ncells=mesh.nCells)
    files = moist.artifacts(run)
    assert list(files) == [moist.FILES[mp]]
    assert_files(files[moist.FILES[mp]], ref)


def test_mountain_wave_runner_matches_the_tools_loop():
    nl = mountain_wave.make_namelist(LEVEL)[0].replace(**SMALL)
    mesh = generate_mesh(levels=LEVEL, sphere_radius=nl.config_sphere_radius)
    run = mountain_wave.run(mesh=mesh, mesh_level=LEVEL, steps=STEPS,
                            record_every=EVERY, device="cpu", log=None,
                            **SMALL)
    jm, recs = j_loop(JNamelist(**as_mpas_tpu(nl.to_dict())), mesh,
                      lambda m: m.summarize())
    assert_series(run.records, recs, summary_keys())
    ref = dict(
        w=np.asarray(jm.state.w), u=np.asarray(jm.state.u),
        theta_m=np.asarray(jm.state.theta_m),
        zgrid=np.asarray(jm.static.zgrid),
        latCell=mesh.latCell, lonCell=mesh.lonCell,
        sphere_radius=mesh.sphere_radius, dc_mean=mesh.dcEdge.mean(),
        namelist_kw=np.array([nl.config_mtn_t0, nl.config_mtn_u0,
                              nl.config_mtn_h0, nl.config_mtn_halfwidth,
                              nl.config_mtn_wavelength]),
        t_final=jm.step_count * nl.config_dt)
    assert_files(mountain_wave.artifacts(run)[mountain_wave.FILE], ref)


def test_supercell_runner_matches_the_tools_loop():
    nl = supercell.make_namelist(**SMALL)
    mesh = generate_mesh(levels=LEVEL, sphere_radius=nl.config_sphere_radius)
    run = supercell.run(mesh=mesh, steps=STEPS, record_every=EVERY,
                        device="cpu", log=None, **SMALL)

    def record(m):
        s = m.summarize()
        return dict(wmax=max(abs(s["w_min"]), abs(s["w_max"])),
                    rain_max=float(np.asarray(m.state.rainnc).max()), **s)

    jm, recs = j_loop(JNamelist(**as_mpas_tpu(nl.to_dict())), mesh, record)
    assert_series(run.records, recs, ("wmax", "rain_max") + summary_keys())
    st = jm.state
    ref = dict(
        w=np.asarray(st.w), theta_m=np.asarray(st.theta_m),
        scalars=np.asarray(st.scalars), rainnc=np.asarray(st.rainnc),
        zgrid=np.asarray(jm.static.zgrid),
        latCell=mesh.latCell, lonCell=mesh.lonCell,
        sphere_radius=mesh.sphere_radius,
        wmax_series=np.array([r["wmax"] for r in recs]),
        rain_series=np.array([r["rain_max"] for r in recs]),
        dt=15.0, t_final=jm.step_count * 15.0)
    assert_files(supercell.artifacts(run)[supercell.FILE], ref)


def test_radiation_runner_matches_the_tools_loop(mesh):
    # dt = 1800 s makes an hour 2 steps, so radiation runs before each record
    small = dict(SMALL, config_dt=1800.0)
    run = radiation_coupled.run(mesh=mesh, steps=STEPS, record_every=EVERY,
                                device="cpu", log=None, **small)
    nl = JNamelist(**as_mpas_tpu(
        radiation_coupled.make_namelist(**small).to_dict()))
    phys = j_physics_init()
    julians = []

    def hook(m, step):
        julians.append(80.25 + step // 2 / 24.0)
        m.apply_physics(phys, julian=julians[-1])

    def record(m):
        rt = np.asarray(m.state.rt_diabatic_tend)
        return dict(rt_amp=float(np.abs(rt).max()), **m.summarize())

    jm, recs = j_loop(nl, mesh, record, hook=hook, hook_every=2)
    assert julians == [80.25, 80.25 + 1 / 24.0]
    assert run.timing["hook_s"] > 0.0
    assert_series(run.records, recs, ("rt_amp",) + summary_keys())
    st = jm.state
    ref = dict(
        theta_m=np.asarray(st.theta_m), u=np.asarray(st.u),
        w=np.asarray(st.w),
        rt_diabatic_tend=np.asarray(st.rt_diabatic_tend),
        qv=np.asarray(st.scalars[0]),
        latCell=mesh.latCell, lonCell=mesh.lonCell,
        rt_amp_series=np.array([r["rt_amp"] for r in recs]),
        days=STEPS * 1800.0 / 86400, dt=1800.0, ncells=mesh.nCells)
    assert_files(radiation_coupled.artifacts(run)["jw_radiation_162.npz"],
                 ref)
