"""mpas_tpu_torch's column physics (Kessler, WSM6 lite and full, the
surface layer + PBL) against mpas_tpu's on the same inputs, float64 on the
CPU, at 1e-12 of each output's largest magnitude.

The microphysics runs on synthetic columns made from a seed with numpy, as
tests/test_wsm6.py builds them, but with every species present and the
freezing level inside the column, so the cold and the warm branches both
run. The PBL functions run on synthetic columns and, for apply_pbl, on a
moist JW state carried across with `from_jax_numpy`. Then 2 steps of the
whole model with JW + Kessler, per field at 1e-10, and the port's own
properties: the substep count sized from the largest fall-speed cap, a
closed column's water budget, sedimentation writing into no input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu import constants
from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.physics import kessler as JK
from mpas_tpu.physics import pbl as JP
from mpas_tpu.physics import wsm6 as JW

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics import srk3
from mpas_tpu_torch.physics import kessler as TK
from mpas_tpu_torch.physics import pbl as TP
from mpas_tpu_torch.physics import sediment as TS
from mpas_tpu_torch.physics import wsm6 as TW

from test_torch_cellform import KW, carry
from test_torch_ops import assert_close

K, C = 20, 16
DT = 120.0
NFALL = 4
STEP_RTOL = 1e-10
SPECIES = ("theta", "qv", "qc", "qr", "qi", "qs", "qg")


def columns(t_sfc, seed=0):
    """Synthetic hydrostatic-ish columns, surface temperature t_sfc, every
    species active: dict of numpy [K, C] arrays."""
    rng = np.random.default_rng(seed)
    z = np.linspace(250.0, 15000.0, K)[:, None] * np.ones((K, C))
    t = t_sfc - 6.5e-3 * z + rng.normal(0.0, 0.5, (K, C))
    p = 1.0e5 * np.exp(-z / 8000.0)
    exner = (p / 1.0e5) ** (constants.rgas / constants.cp)
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qvs = 0.622 * es / (p - es)
    noisy = lambda a: a * (0.5 + rng.random((K, C)))
    return dict(
        theta=t / exner, qv=qvs * (0.6 + 0.6 * rng.random((K, C))),
        qc=noisy(np.where(z < 7000.0, 4e-4, 1e-5)),
        qr=noisy(np.where(z < 5000.0, 3e-4, 2e-5)),
        qi=noisy(np.where(z > 3000.0, 1.5e-4, 1e-6)),
        qs=noisy(np.where(z > 2000.0, 8e-4, 1e-4)),
        qg=noisy(np.where(z > 1500.0, 5e-4, 5e-5)),
        rho=p / (constants.rgas * t), exner=exner, p=p,
        dz=np.full((K, C), 15000.0 / K))


def both(cols, names):
    return ([jnp.asarray(cols[n]) for n in names],
            [torch.from_numpy(cols[n].copy()) for n in names])


@pytest.mark.parametrize("t_sfc", [300.0, 285.0, 262.0])
def test_columns_straddle_freezing(t_sfc):
    """What the microphysics tests rest on: at 285 K and 300 K the freezing
    level is inside the column; 262 K is cold throughout."""
    c = columns(t_sfc)
    t = c["theta"] * c["exner"]
    assert (t < 273.15).any()
    assert (t > 273.15).any() == (t_sfc > 280.0)
    assert min(c[n].min() for n in SPECIES[1:]) > 0.0


@pytest.mark.parametrize("species,law", [
    ("qr", "_fall_velocity"), ("qs", "_snow_fall_velocity"),
    ("qg", "_graupel_fall_velocity")])
def test_fall_velocity_matches(species, law):
    c = columns(285.0)
    (jq, jrho), (tq, trho) = both(c, (species, "rho"))
    J, T = (JK, TK) if species == "qr" else (JW, TW)
    assert_close(getattr(J, law)(jq, jrho), getattr(T, law)(tq, trho))


@pytest.mark.parametrize("species,fn", [
    ("qr", "_sediment"), ("qs", "_sediment_snow"), ("qg", "_sediment_graupel")])
@pytest.mark.parametrize("nfall", [1, 7, 53])
def test_sediment_matches(species, fn, nfall):
    """mpas_tpu's per-species loop against the port's plain sedimentation
    with the species' law, up to the 53 substeps of the benchmark's moist
    step."""
    c = columns(285.0)
    names = (species, "rho", "dz")
    j_in, t_in = both(c, names)
    J = JK if species == "qr" else JW
    j_out = getattr(J, fn)(*j_in, DT, nfall)
    law = {"qr": "rain", "qs": "snow", "qg": "graupel"}[species]
    (q,), (acc,) = TS.sediment_species_plain([t_in[0]], (law,), *t_in[1:],
                                            DT, nfall)
    t_out = (q, acc)
    assert float(t_out[1].min()) > 0.0        # precipitation reached the ground
    assert_close(j_out, t_out)
    # the substeps wrote into no input
    for n, t in zip(names, t_in):
        assert np.array_equal(t.numpy(), c[n]), n


@pytest.mark.parametrize("t_sfc", [300.0, 285.0, 262.0])
def test_kessler_matches(t_sfc):
    names = ("theta", "qv", "qc", "qr", "rho", "exner", "p", "dz")
    j_in, t_in = both(columns(t_sfc), names)
    assert_close(JK.kessler(*j_in, DT, NFALL), TK.kessler(*t_in, DT, NFALL))


@pytest.mark.parametrize("t_sfc", [300.0, 285.0, 262.0])
def test_wsm6lite_matches(t_sfc):
    names = ("theta", "qv", "qc", "qr", "qi", "qs", "rho", "exner", "p", "dz")
    j_in, t_in = both(columns(t_sfc), names)
    assert_close(JW.wsm6lite(*j_in, DT, NFALL), TW.wsm6lite(*t_in, DT, NFALL))


@pytest.mark.parametrize("t_sfc", [300.0, 285.0, 262.0])
@pytest.mark.parametrize("dt", [DT, 600.0])
def test_wsm6full_matches(t_sfc, dt):
    names = ("theta", "qv", "qc", "qr", "qi", "qs", "qg", "rho", "exner", "p",
             "dz")
    c = columns(t_sfc, seed=int(dt))
    j_in, t_in = both(c, names)
    j_out = JW.wsm6full(*j_in, dt, NFALL)
    t_out = TW.wsm6full(*t_in, dt, NFALL)
    assert_close(j_out, t_out)
    # every process ran somewhere: each species changed
    for n, new in zip(SPECIES, t_out):
        assert not np.array_equal(new.numpy(), c[n]), n


def test_wsm6full_three_calls_in_a_row_match():
    """Thresholds (freezing, melting, homogeneous freezing) are met from
    evolved values too, not only from the synthetic start."""
    names = ("theta", "qv", "qc", "qr", "qi", "qs", "qg")
    c = columns(285.0, seed=5)
    j_in, t_in = both(c, names)
    j_fix, t_fix = both(c, ("rho", "exner", "p", "dz"))
    for _ in range(3):
        j_in = JW.wsm6full(*j_in, *j_fix, DT, NFALL)[:7]
        t_in = TW.wsm6full(*t_in, *t_fix, DT, NFALL)[:7]
    assert_close(j_in, t_in)


def test_saturation_matches():
    c = columns(285.0)
    t = c["theta"] * c["exner"]
    j_es = JW.saturation_pressures(jnp.asarray(t))
    t_es = TW.saturation_pressures(torch.from_numpy(t))
    assert_close(j_es, t_es)
    assert_close(JW._qsat(j_es[1], jnp.asarray(c["p"])),
                 TW._qsat(t_es[1], torch.from_numpy(c["p"])))


def test_wsm6_closed_column_water_budget():
    """The port alone: vapor + condensate + what reached the ground is what
    the column held before, and no species goes negative."""
    names = ("theta", "qv", "qc", "qr", "qi", "qs", "qg", "rho", "exner", "p",
             "dz")
    c = columns(285.0)
    _, t_in = both(c, names)
    out = TW.wsm6full(*t_in, DT, NFALL)
    mass = lambda qs: sum((t_in[7] * t_in[10] * q).sum(0) for q in qs)
    before = mass(t_in[1:7])
    after = mass(out[1:7]) + out[7] + out[8] + out[9]
    assert float(((after - before).abs() / before).max()) < 1e-12
    assert min(float(q.min()) for q in out[1:7]) >= 0.0


@pytest.mark.parametrize("dt,dz_min", [(300.0, 320.0), (16.0, 1250.0),
                                       (720.0, 90.0), (1800.0, 30.0)])
def test_fall_substeps_sized_from_the_largest_cap(dt, dz_min):
    """One substep count serves rain, snow and graupel, so it is sized from
    the largest of their fall-speed caps. Today that is rain's 15 m/s
    (graupel's equals it), so the count is mpas_tpu's."""
    assert TW.max_fall_speed(full=True) == max(
        TK.MAX_VT, TW.MAX_VT_SNOW, TW.MAX_VT_GRAUPEL) == 15.0
    assert TW.max_fall_speed(full=False) == max(TK.MAX_VT, TW.MAX_VT_SNOW)
    want = JK.fall_substeps(dt, dz_min)
    assert TK.fall_substeps(dt, dz_min) == want
    assert TK.fall_substeps(dt, dz_min, TW.max_fall_speed(True)) == want
    # a larger cap gives more substeps, up to the limit of 60
    assert TK.fall_substeps(dt, dz_min, 30.0) == min(
        60, JK.fall_substeps(2 * dt, dz_min))


def test_microphysics_constants_equal():
    for J, T in ((JK, TK), (JW, TW)):
        names = [n for n in dir(J) if n.isupper()
                 and isinstance(getattr(J, n), (int, float))]
        assert len(names) >= 10
        for n in names:
            assert getattr(T, n) == getattr(J, n), n


# ---------------------------------------------------------------------------
# surface layer + PBL
# ---------------------------------------------------------------------------

def pbl_columns(seed=3):
    """Columns over gently varying terrain with a mixed layer under a stable
    troposphere, calm and windy, warm and cold against the skin."""
    rng = np.random.default_rng(seed)
    zsfc = 200.0 * rng.random(C)
    zw = np.concatenate([[0.0], np.cumsum(np.linspace(60.0, 1500.0, K))])
    zgrid = zsfc[None, :] + zw[:, None] * (1.0 - zsfc[None, :] / 40000.0)
    zmid = 0.5 * (zgrid[:-1] + zgrid[1:])
    theta = (288.0 + rng.normal(0.0, 3.0, C)[None, :]
             + 4.0e-3 * np.maximum(zmid - 900.0, 0.0)
             + rng.normal(0.0, 0.05, (K, C)))
    speed = rng.random(C) * 12.0 * (zmid / 1000.0) ** 0.3
    rho = 1.2 * np.exp(-zmid / 8500.0)
    return dict(theta=theta, u2=speed ** 2, zgrid=zgrid, rho=rho,
                x=rng.normal(size=(K, C)), flux=rng.normal(size=C) * 0.05,
                drag=rng.random(C) * 0.02)


@pytest.mark.parametrize("sst", [0.0, 291.0])
def test_surface_and_kprofile(sst):
    names = ("theta", "u2", "zgrid", "rho")
    j_in, t_in = both(pbl_columns(), names)
    kw = dict(config_sst=sst, config_roughness=0.02)
    j_out = JP.surface_and_kprofile(*j_in, JNamelist(**kw))
    t_out = TP.surface_and_kprofile(*t_in, Namelist(**kw))
    assert float(t_out[0].max()) > 1.0         # the PBL mixes somewhere
    assert_close(j_out, t_out)


def test_louis_functions():
    rib = np.linspace(-3.0, 3.0, 41)
    z1 = np.full(41, 35.0)
    assert_close(JP._louis_fm_fh(jnp.asarray(rib), jnp.asarray(z1), 0.01),
                 TP._louis_fm_fh(torch.from_numpy(rib), torch.from_numpy(z1),
                                 0.01))


@pytest.mark.parametrize("flux,drag", [(True, False), (False, True),
                                       (False, False), (True, True)],
                         ids=["flux", "drag", "neither", "both"])
def test_implicit_diffusion(flux, drag):
    c = pbl_columns()
    (jth, ju2, jzg, jrho, jx, jflux, jdrag), (tth, tu2, tzg, trho, tx, tflux,
                                              tdrag) = both(
        c, ("theta", "u2", "zgrid", "rho", "x", "flux", "drag"))
    jk = JP.surface_and_kprofile(jth, ju2, jzg, jrho, JNamelist())[0]
    tk = TP.surface_and_kprofile(tth, tu2, tzg, trho, Namelist())[0]
    jrho_i = jnp.concatenate([jrho[:1], 0.5 * (jrho[1:] + jrho[:-1]),
                              jrho[-1:]])
    trho_i = torch.from_numpy(np.array(jrho_i))
    j_out = JP.implicit_diffusion(
        jx, jk, jrho, jrho_i, jzg, 300.0,
        sfc_flux=jflux if flux else None, sfc_drag=jdrag if drag else None)
    t_out = TP.implicit_diffusion(
        tx, tk, trho, trho_i, tzg, 300.0,
        sfc_flux=tflux if flux else None, sfc_drag=tdrag if drag else None)
    assert_close(j_out, t_out)
    assert np.array_equal(tx.numpy(), c["x"])      # the input is not written


def test_implicit_diffusion_solves_its_system():
    """The port alone: the result satisfies the backward-Euler system
    (I - dt L) x_new = x + surface flux, row by row."""
    c = pbl_columns()
    _, (th, u2, zg, rho, x, flux) = both(
        c, ("theta", "u2", "zgrid", "rho", "x", "flux"))
    k_i = TP.surface_and_kprofile(th, u2, zg, rho, Namelist())[0]
    rho_i = torch.cat([rho[:1], 0.5 * (rho[1:] + rho[:-1]), rho[-1:]])
    dt = 300.0
    new = TP.implicit_diffusion(x, k_i, rho, rho_i, zg, dt, sfc_flux=flux)
    zmid = 0.5 * (zg[:-1] + zg[1:])
    f = torch.zeros_like(zg)
    f[1:-1] = rho_i[1:-1] * k_i[1:-1] * (new[1:] - new[:-1]) / (zmid[1:] - zmid[:-1])
    f[0] = -rho[0] * flux
    back = new - dt * (f[1:] - f[:-1]) / (rho * (zg[1:] - zg[:-1]))
    assert float((back - x).abs().max()) < 1e-11


@pytest.fixture(scope="module")
def moist():
    """{namelist changes (as a sorted tuple): (JAX model, port containers)}
    on the level-3 mesh, built when first asked for."""
    done = {}

    def get(**changes):
        key = tuple(sorted(changes.items()))
        if key not in done:
            m = j_build(namelist=JNamelist(**KW, **changes),
                        mesh=j_generate(levels=3, lloyd_iterations=2))
            done[key] = (m, carry(m), Namelist(**m.namelist.to_dict()))
        return done[key]

    return get


@pytest.mark.parametrize("changes", [
    dict(config_moisture=True, config_microphysics="kessler", config_sst=302.0),
    dict(config_moisture=True, config_microphysics="wsm6"),
    dict(),
    dict(config_moisture=True, config_microphysics="wsm6",
         config_orient_edges=True)],
    ids=["moist_sst", "moist_skin", "dry", "moist_aligned"])
def test_apply_pbl(moist, changes):
    m, (tm, tv, tst, ts), nl = moist(config_pbl="ysu_lite", **changes)
    # jitted, as the step runs it: the dry start holds numpy fields
    j_out = jax.jit(lambda s: JP.apply_pbl(
        s, m.static, m.vert, m.mesh_arrays, m.namelist, 600.0))(m.state)
    t_out = TP.apply_pbl(ts, tst, tv, tm, nl, 600.0)
    for name in ("theta_m", "rtheta_p", "exner", "pressure_p", "u", "ru",
                 "scalars"):
        if getattr(j_out, name) is None:
            assert getattr(t_out, name) is None
            continue
        assert_close(getattr(j_out, name), getattr(t_out, name))
    assert not np.array_equal(t_out.u.numpy(), ts.u.numpy())
    if ts.scalars is not None:
        # a fresh stack: the state the step saved is not written
        assert t_out.scalars.data_ptr() != ts.scalars.data_ptr()
        assert np.array_equal(ts.scalars.numpy(), np.asarray(m.state.scalars))


@pytest.mark.parametrize("scheme", ["kessler", "wsm6lite", "wsm6"])
def test_apply_microphysics(moist, scheme):
    """apply_kessler / apply_wsm6 on a JW state whose condensate is made
    non-trivial first (the JW start has vapor only)."""
    m, (tm, tv, tst, ts), nl = moist(config_moisture=True,
                                     config_microphysics=scheme)
    nS, K_, C_ = ts.scalars.shape
    rng = np.random.default_rng(11)
    extra = np.zeros((nS, K_, C_))
    extra[1:] = 3e-4 * rng.random((nS - 1, K_, C_))
    js = m.state.replace(scalars=m.state.scalars + jnp.asarray(extra))
    tss = ts.replace(scalars=ts.scalars + torch.from_numpy(extra))
    if scheme == "kessler":
        j_out = JK.apply_kessler(js, m.static, m.vert, m.namelist, 600.0)
        t_out = TK.apply_kessler(tss, tst, tv, nl, 600.0)
    else:
        full = scheme == "wsm6"
        j_out = JW.apply_wsm6(js, m.static, m.vert, m.namelist, 600.0, full)
        t_out = TW.apply_wsm6(tss, tst, tv, nl, 600.0, full)
    assert float(t_out.rainnc.max()) > 0.0
    for name in ("theta_m", "rtheta_p", "exner", "pressure_p", "scalars",
                 "rainnc"):
        assert_close(getattr(j_out, name), getattr(t_out, name))


@pytest.fixture(scope="module")
def kessler_two_steps(moist):
    m, (tm, tv, tst, ts), nl = moist(config_moisture=True,
                                     config_microphysics="kessler")
    for _ in range(2):
        ts = srk3.atm_srk3(ts, tst, tm, tv, nl, nl.config_dt)
    return m.step_fn(m.step_fn(m.state)), ts


@pytest.mark.parametrize("field", ["u", "w", "theta_m", "rho_zz", "rho_p",
                                   "rtheta_p", "scalars", "rainnc", "qtot",
                                   "cqu", "cqw"])
def test_two_steps_jw_kessler_match(kessler_two_steps, field):
    jstate, ts = kessler_two_steps
    b = getattr(ts, field).numpy()
    assert np.isfinite(b).all()
    assert_close(np.asarray(getattr(jstate, field)), b, rtol=STEP_RTOL)
