"""mpas_tpu_torch's radiation against mpas_tpu's, float64 on the CPU.

  - the numpy copies (the saturation tables, the radiation support
    routines, the standard atmospheres, physics_init's climatologies and
    time_params' values) are array-equal to the originals;
  - every torch function of physics/tables.py, radiation_support.py,
    radiation.py and driver.py agrees with the JAX function at 1e-12 of
    each output's largest magnitude, on random columns made from a numpy
    seed: temperatures 180-310 K, moist layers near and over saturation,
    condensate in part of them, day and night columns, qc present and
    absent, qv absent;
  - the physical checks of tests/test_physics.py and
    tests/test_radiation_coefficients.py hold on the port: clear-sky LW
    OLR and DLR within 4% of the line-by-line benchmarks on the three
    McClatchey atmospheres, OLR = sigma T^4 over an isothermal column, the
    LH74 water-vapour fit, SW energy closure and the signs of cloud effects;
  - legacy_relaxation_tend is bit-equal to its numpy oracle (skipped only
    where the native library cannot be built)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu import constants
from mpas_tpu.physics import driver as JD
from mpas_tpu.physics import radiation as JR
from mpas_tpu.physics import radiation_support as JRS
from mpas_tpu.physics import standard_atmospheres as JSA
from mpas_tpu.physics import tables as JT

from mpas_tpu_torch.physics import driver as TD
from mpas_tpu_torch.physics import legacy
from mpas_tpu_torch.physics import radiation as TR
from mpas_tpu_torch.physics import radiation_support as TRS
from mpas_tpu_torch.physics import standard_atmospheres as TSA
from mpas_tpu_torch.physics import tables as TT

from test_torch_copies import assert_same
from test_torch_ops import assert_close

C, K = 24, 10
JULIANS = (0.0, 1.0, 15.5, 80.25, 100.0, 200.7, 364.9, 400.3)


def columns(seed=0):
    """Random [C, K] columns (k = 0 lowest): temperatures 180-310 K, vapour
    at 30-105% of saturation, condensate in about half the layers, surface
    pressure, latitude and longitude; numpy float64."""
    rng = np.random.default_rng(seed)
    z = np.linspace(100.0, 18000.0, K)[None, :]
    t = np.clip(rng.uniform(260.0, 310.0, C)[:, None] - 6.5e-3 * z
                + rng.normal(0.0, 1.0, (C, K)), 180.0, 310.0)
    p = (1.0e5 + rng.normal(0.0, 800.0, C))[:, None] * np.exp(-z / 8000.0)
    exner = (p / 1.0e5) ** (constants.rgas / constants.cp)
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qv = 0.622 * es / (p - es) * rng.uniform(0.3, 1.05, (C, K))
    qc = np.where(rng.random((C, K)) > 0.5, 2e-4 * rng.random((C, K)), 0.0)
    return dict(t=t, p=p, exner=exner, qv=qv, qc=qc,
                theta_m=t / exner * (1.0 + constants.rvord * qv),
                sp=p[:, 0] * 1.01, lat=rng.uniform(-1.5, 1.5, C),
                lon=rng.uniform(0.0, 2.0 * np.pi, C),
                mu0=rng.uniform(-0.4, 1.0, C))


def J(a):
    return None if a is None else jnp.asarray(a)


def T(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def cols():
    return columns()


@pytest.fixture(scope="module")
def physics():
    """(JAX PhysicsState, port PhysicsState), their device tables and the
    time factors of one interval."""
    jp, tp = JD.physics_init(), TD.physics_init()
    return dict(j=jp, t=tp, jtab=JD._device_tables(jp, jnp.float64),
                ttab=TD._device_tables(tp, torch.float64, "cpu"),
                jtp=JD.time_params(jp, 80.25, jnp.float64),
                ttp=TD.time_params(tp, 80.25, torch.float64, "cpu"))


@pytest.fixture(scope="module")
def optics(cols):
    """Interfaces, cloud fraction, water path and optical inputs of the
    random columns, numpy."""
    p = cols["p"]
    pint = np.concatenate([cols["sp"][:, None], 0.5 * (p[:, :-1] + p[:, 1:]),
                           np.maximum(1.5 * p[:, -1:] - 0.5 * p[:, -2:-1],
                                      1.0)], axis=1)
    rng = np.random.default_rng(7)
    cld = np.where(rng.random((C, K)) > 0.4, rng.random((C, K)), 0.0)
    cwp = np.where(cld > 0, 150.0 * rng.random((C, K)), 0.0)
    o3 = 1e-7 + 8e-6 * np.exp(-((np.log(p) - np.log(1e3)) ** 2))
    return dict(pint=pint, cld=cld, cwp=cwp, o3=o3,
                aer=1e-9 * rng.random((C, K)))


# ---------------------------------------------------------------------------
# numpy copies
# ---------------------------------------------------------------------------

def test_saturation_tables_equal():
    t = np.linspace(150.0, 400.0, 701)
    for itype in (-20.0, -5.0, 1, 0):
        assert np.array_equal(JT.gffgch(t, itype), TT.gffgch(t, itype))
    for jt, tt in ((JT.gestbl(), TT.gestbl()), (JT.esinti(), TT.esinti()),
                   (JT.radini(), TT.radini()),
                   (JT.radini(JT.SaturationTables()),
                    TT.radini(TT.SaturationTables())),
                   (JT.radaeini(JT.gestbl()), TT.radaeini(TT.gestbl())),
                   (JT.camradinit(), TT.camradinit())):
        assert_same(jt, tt, "tables")
    jt, tt = JT.camradinit(), TT.camradinit()
    p = np.linspace(1e3, 1.05e5, 701)
    assert np.array_equal(JT.estblf(t, jt), TT.estblf(t, tt))
    for a, b in zip(JT.aqsat(t, p, jt), TT.aqsat(t, p, tt), strict=True):
        assert np.array_equal(a, b)


def test_radiation_support_copies_equal(cols, optics):
    for args in ((0.3, 0.7), (0.5, 0.6), (-0.1, 1.1)):
        assert JRS.validfactors(*args) == TRS.validfactors(*args)
    for args in ((True, 3, 75.0, 105.0, 90.0), (True, 0, 350.0, 16.0, 1.0),
                 (True, 0, 350.0, 16.0, 355.0), (False, 4, 105.0, 136.0, 120.0)):
        assert JRS.getfactors(*args) == TRS.getfactors(*args)
    ozmixm = TD.physics_init().ozmixm
    for julian in JULIANS:
        assert np.array_equal(JRS.oznint(julian, ozmixm),
                              TRS.oznint(julian, ozmixm))
        assert JRS.radconst(julian) == TRS.radconst(julian)
    pin, _ = TD.standard_ozone_profile()
    pmid = np.concatenate([cols["p"], [[50.0] * K, [1.2e5] * K]])
    ozmix = np.repeat(ozmixm[3][None], pmid.shape[0], axis=0)
    assert np.array_equal(JRS.radozn(pmid, pin, ozmix),
                          TRS.radozn(pmid, pin, ozmix))
    for a, b in zip(JRS.radinp(cols["p"], optics["pint"], cols["qv"]),
                    TRS.radinp(cols["p"], optics["pint"], cols["qv"]),
                    strict=True):
        assert np.array_equal(a, b)
    m_hybi, aerosolc = TD.background_aerosol()
    aer_cols = np.repeat(aerosolc[None], C, axis=0)
    assert np.array_equal(
        JRS.vert_interpolate(cols["sp"], aer_cols, m_hybi, optics["pint"]),
        TRS.vert_interpolate(cols["sp"], aer_cols, m_hybi, optics["pint"]))


@pytest.mark.parametrize("kind", ["tropical", "midlat_summer",
                                  "subarctic_winter"])
@pytest.mark.parametrize("nlev", [30, 60])
def test_standard_atmospheres_equal(kind, nlev):
    assert_same(JSA.standard_atmosphere(kind, nlev),
                TSA.standard_atmosphere(kind, nlev), kind)


def test_standard_atmosphere_unknown_kind_raises():
    with pytest.raises(ValueError):
        TSA.standard_atmosphere("martian")


def test_physics_init_equal():
    for a, b in zip(JD.standard_ozone_profile(), TD.standard_ozone_profile(),
                    strict=True):
        assert np.array_equal(a, b)
    for a, b in zip(JD.background_aerosol(), TD.background_aerosol(),
                    strict=True):
        assert np.array_equal(a, b)
    jp, tp = JD.physics_init(), TD.physics_init()
    assert_same(jp.tables, tp.tables, "tables")
    for f in dataclasses.fields(jp):
        if f.name != "tables":
            assert np.array_equal(getattr(jp, f.name), getattr(tp, f.name))


@pytest.mark.parametrize("julian", JULIANS)
def test_time_params_equal(julian):
    jp, tp = JD.physics_init(), TD.physics_init()
    j = JD.time_params(jp, julian, jnp.float64)
    t = TD.time_params(tp, julian, torch.float64, "cpu")
    assert set(j) == set(t)
    for k in j:
        assert t[k].dtype == torch.float64 and t[k].device.type == "cpu"
        assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k
    assert TD.time_params(tp, julian, torch.float32, "cpu")["ozmix"].dtype \
        == torch.float32


def test_radiation_constants_equal():
    names = [n for n in dir(JR) if n.isupper()
             and isinstance(getattr(JR, n), (int, float, tuple))]
    assert len(names) >= 15
    for n in names:
        assert getattr(TR, n) == getattr(JR, n), n


# ---------------------------------------------------------------------------
# torch functions against the JAX ones
# ---------------------------------------------------------------------------

def test_estblf_aqsat(physics):
    rng = np.random.default_rng(1)
    t = rng.uniform(150.0, 400.0, (C, K))       # below tmin and above tmax too
    p = rng.uniform(2e2, 1.05e5, (C, K))
    p[0, :3] = 10.0                              # qsat < 0: the bad branch
    assert_close(JT.estblf_j(J(t), physics["jtab"]),
                 TT.estblf_j(T(t), physics["ttab"]))
    j_out = JT.aqsat_j(J(t), J(p), physics["jtab"])
    t_out = TT.aqsat_j(T(t), T(p), physics["ttab"])
    assert bool((t_out[1] == 1.0).any())
    assert_close(j_out, t_out)


def test_radozn_radinp(cols, optics, physics):
    pin = physics["ttab"]["pin"]
    pmid = np.concatenate([cols["p"], [[50.0] * K, [1.2e5] * K]])
    ozmix = np.repeat(physics["t"].ozmixm[5][None], pmid.shape[0], axis=0)
    j_o3 = JRS.radozn(J(pmid), physics["jtab"]["pin"], J(ozmix))
    t_o3 = TRS.radozn(T(pmid), pin, T(ozmix))
    assert torch.is_tensor(t_o3)
    assert_close(j_o3, t_o3)
    # a [C, K] view of a level-major field, as the model passes it
    t_view = TRS.radozn(T(pmid.T).T, pin, T(ozmix))
    assert torch.equal(t_view, t_o3)
    assert_close(JRS.radinp(J(cols["p"]), J(optics["pint"]), j_o3[:C]),
                 TRS.radinp(T(cols["p"]), T(optics["pint"]), t_o3[:C]))


@pytest.mark.parametrize("ps_scale", [1.0, 0.7], ids=["surface", "shallow"])
def test_vert_interpolate_j(cols, optics, physics, ps_scale):
    """The aerosol path; with Match_ps cut to 0.7 of the surface pressure,
    the lowest model interfaces lie below the data and the 'below' branch
    runs."""
    ps = cols["sp"] * ps_scale
    args_j = (J(ps), physics["jtab"]["aerosolc"], physics["jtab"]["m_hybi"],
              J(optics["pint"]))
    args_t = (T(ps), physics["ttab"]["aerosolc"], physics["ttab"]["m_hybi"],
              T(optics["pint"]))
    j_out = JRS.vert_interpolate_j(*args_j)
    t_out = TRS.vert_interpolate_j(*args_t)
    assert float(t_out.max()) > 0.0
    assert_close(j_out, t_out)
    # and the numpy oracle with the climatology broadcast to the columns
    aer = np.repeat(physics["t"].aerosolc[None], C, axis=0)
    ref = TRS.vert_interpolate(ps, aer, physics["t"].m_hybi, optics["pint"])
    assert_close(ref, t_out)


def test_cloud_optics(cols, optics):
    t = cols["t"]
    assert_close(JR.cldefr(J(t)), TR.cldefr(T(t)))
    assert_close(JR.ice_fraction(J(t)), TR.ice_fraction(T(t)))
    rel, rei = TR.cldefr(T(t))
    fice = TR.ice_fraction(T(t))
    assert_close(JR.cldems(J(optics["cwp"]), J(rei.numpy()), J(fice.numpy())),
                 TR.cldems(T(optics["cwp"]), rei, fice))
    cld = optics["cld"].copy()
    cld[0] = 1.0                                 # clamped at 0.999
    assert_close(JR.cldovrlap(J(cld)), TR.cldovrlap(T(cld)))


def test_two_stream_and_adding():
    rng = np.random.default_rng(3)
    tau = 10.0 ** rng.uniform(-6.0, 2.5, (C, K))
    omega = np.clip(rng.uniform(0.0, 1.0, (C, K)), 0.0, 1.0)
    omega[:, :2] = 0.9999999                     # near-conservative layers
    g = rng.uniform(0.0, 0.9, (C, K))
    assert_close(JR._two_stream(J(tau), J(omega), J(g)),
                 TR._two_stream(T(tau), T(omega), T(g)))
    assert_close(JR._a_oz(J(tau)), TR._a_oz(T(tau)))
    inc = rng.uniform(0.0, 1000.0, C)
    assert_close(JR._sw_adding(J(tau), J(omega), J(g), J(inc), 0.2),
                 TR._sw_adding(T(tau), T(omega), T(g), T(inc), 0.2))


def _cloud_inputs(cols, optics, cloudy):
    t = cols["t"]
    rel, rei = (a.numpy() for a in TR.cldefr(T(t)))
    fice = TR.ice_fraction(T(t)).numpy()
    cld = optics["cld"] if cloudy else np.zeros((C, K))
    cwp = optics["cwp"] if cloudy else np.zeros((C, K))
    return cld, cwp, rel, rei, fice


@pytest.mark.parametrize("cloudy", [True, False], ids=["cloudy", "clear"])
@pytest.mark.parametrize("aerosol", [True, False], ids=["aerosol", "none"])
def test_sw_fluxes(cols, optics, cloudy, aerosol):
    cld, cwp, rel, rei, fice = _cloud_inputs(cols, optics, cloudy)
    args = (cols["mu0"], 1361.0, cols["p"], optics["pint"], cols["qv"],
            optics["o3"], cld, cwp, rel, rei, fice)
    aer = optics["aer"] if aerosol else None
    j_out = JR.sw_fluxes(*map(J, args[:1]), args[1], *map(J, args[2:]),
                         aer_mmr=J(aer), albedo=0.15)
    t_out = TR.sw_fluxes(T(args[0]), args[1], *map(T, args[2:]),
                         aer_mmr=T(aer), albedo=0.15)
    assert (cols["mu0"] < 0).any() and (cols["mu0"] > 0.5).any()
    assert float(t_out["qrs"].max()) > 0.0
    assert_close(j_out, t_out)


@pytest.mark.parametrize("cloudy", [True, False], ids=["cloudy", "clear"])
@pytest.mark.parametrize("emiss", [1.0, 0.95])
def test_lw_fluxes(cols, optics, cloudy, emiss):
    cld, cwp, _, rei, fice = _cloud_inputs(cols, optics, cloudy)
    emis = TR.cldems(T(cwp), T(rei), T(fice)).numpy()
    args = (cols["t"], cols["qv"], optics["o3"], cols["p"], optics["pint"],
            emis, cld, cols["t"][:, 0] + 2.0)
    assert_close(JR.lw_fluxes(*map(J, args), emiss=emiss),
                 TR.lw_fluxes(*map(T, args), emiss=emiss))


def test_cloudiness(cols, physics):
    _, qsat = TT.aqsat_j(T(cols["t"]), T(cols["p"]), physics["ttab"])
    qsat = qsat.numpy()
    qv, qc = cols["qv"], cols["qc"]
    assert_close(JD.calc_cldfraction(J(qv), J(qsat)),
                 TD.calc_cldfraction(T(qv), T(qsat)))
    for qi in (None, qc[::-1].copy()):
        j_inc = JD.calc_cldincidence(J(qc), J(qi))
        t_inc = TD.calc_cldincidence(T(qc), T(qi))
        assert t_inc.dtype == torch.float64
        assert_close(j_inc, t_inc)
    for scheme in ("cld_fraction", "cld_incidence"):
        for q in (None, qc):
            assert_close(JD.driver_cloudiness(J(qv), J(qsat), scheme, J(q)),
                         TD.driver_cloudiness(T(qv), T(qsat), scheme, T(q)))
    # the port keeps the input's dtype
    assert TD.calc_cldincidence(T(qc).float()).dtype == torch.float32


def test_column_pressures_and_zenith(cols, physics):
    j_out = JD._column_pressures(J(cols["p"]), J(cols["sp"]))
    t_out = TD._column_pressures(T(cols["p"].T).T, T(cols["sp"]))
    assert t_out[1].T.is_contiguous()            # level-major interfaces
    assert_close(j_out, t_out)
    jtp, ttp = physics["jtp"], physics["ttp"]
    cz = TD.cosine_zenith(T(cols["lat"]), T(cols["lon"]), ttp["declin"],
                          ttp["hour"])
    assert bool((cz < 0).any()) and bool((cz > 0).any())
    assert_close(JD.cosine_zenith(J(cols["lat"]), J(cols["lon"]),
                                  jtp["declin"], jtp["hour"]), cz)


@pytest.mark.parametrize("with_qc", [True, False], ids=["qc", "no_qc"])
def test_radctl(cols, optics, physics, with_qc):
    cld, cwp, *_ = _cloud_inputs(cols, optics, True)
    tsfc = cols["t"][:, 0] + 1.5
    jtp, ttp = physics["jtp"], physics["ttp"]
    cz = TD.cosine_zenith(T(cols["lat"]), T(cols["lon"]), ttp["declin"],
                          ttp["hour"]).numpy()
    qc = cols["qc"] if with_qc else None
    args = (cols["t"], cols["qv"], cols["p"], optics["pint"], cld, cwp, cz)
    j_out = JD.radctl(physics["jtab"], *map(J, args), jtp, tsfc=J(tsfc),
                      qc=J(qc))
    t_out = TD.radctl(physics["ttab"], *map(T, args), ttp, tsfc=T(tsfc),
                      qc=T(qc))
    assert set(j_out) == set(t_out)
    assert_close(j_out, t_out)


@pytest.mark.parametrize("qv,qc", [(True, True), (True, False),
                                   (False, False)],
                         ids=["qv_qc", "qv", "dry"])
def test_radiation_columns(cols, physics, qv, qc):
    """make_radiation_fn (JAX: jitted) on the model's inputs; the port's
    fields as [C, K] views of level-major tensors, as Model.apply_physics
    passes them."""
    jfn = JD.make_radiation_fn(physics["j"], jnp.float64)
    tfn = TD.make_radiation_fn(physics["t"], torch.float64, "cpu")
    names = ("theta_m", "exner", "p")
    view = lambda a: T(a.T).T
    j_args = [J(cols[n]) for n in names]
    t_args = [view(cols[n]) for n in names]
    j_q = [J(cols["qv"]) if qv else None, J(cols["qc"]) if qc else None]
    t_q = [view(cols["qv"]) if qv else None, view(cols["qc"]) if qc else None]
    j_rt, j_diag = jfn(J(cols["lat"]), J(cols["lon"]), *j_args,
                       J(cols["sp"]), *j_q, physics["jtp"])
    t_rt, t_diag = tfn(T(cols["lat"]), T(cols["lon"]), *t_args,
                       T(cols["sp"]), *t_q, physics["ttp"])
    cldfra = t_diag["cldfra"]
    assert bool((cldfra > 0).any()) == qv
    assert set(j_diag) == set(t_diag)
    assert_close(j_rt, t_rt)
    assert_close(j_diag, t_diag)


def test_physics_driver(physics):
    """The numpy-facing driver on the columns of tests/test_physics.py, and
    its sanity checks there."""
    Cn, Kn = 16, 12
    state = dict(theta_m=np.linspace(285, 600, Kn)[None, :].repeat(Cn, 0),
                 exner=np.linspace(1.0, 0.35, Kn)[None, :].repeat(Cn, 0),
                 pressure=np.linspace(1.0e5, 1.0e4, Kn)[None, :].repeat(Cn, 0),
                 surface_pressure=np.full(Cn, 1.013e5),
                 qv=np.full((Cn, Kn), 3e-3))

    class M:
        latCell = np.linspace(-1.4, 1.4, Cn)
        lonCell = np.zeros(Cn)

    j_out = JD.physics_driver(physics["j"], state, M, julian=80.25)
    out = TD.physics_driver(physics["t"], state, M, julian=80.25,
                            device="cpu")
    assert set(j_out) == set(out)
    assert_close(j_out, out)
    qrs_day, qrl_day = out["qrs"] * 86400, out["qrl"] * 86400
    assert np.all(qrs_day >= 0) and qrs_day.max() < 200.0
    assert qrl_day.mean() < 0.0
    assert qrl_day.min() > -50.0 and qrl_day.max() < 20.0
    assert np.all(np.isfinite(out["rthraten"]))
    assert np.all((out["cldfra"] >= 0) & (out["cldfra"] <= 1))
    assert np.all(out["fsnt"] + 1e-6 >= out["fsns"] - 1e-6)
    assert np.all(out["olr"] > 100.0) and np.all(out["olr"] < 400.0)


# ---------------------------------------------------------------------------
# the physical checks, on the port
# ---------------------------------------------------------------------------

LW_CASES = [("tropical", 288.0, 395.0), ("midlat_summer", 280.0, 345.0),
            ("subarctic_winter", 200.0, 163.0)]


def atmosphere(kind):
    """A standard atmosphere as one-column tensors."""
    a = TSA.standard_atmosphere(kind)
    return {k: (torch.from_numpy(np.asarray(v))[None] if np.ndim(v) else v)
            for k, v in a.items()}


def clear_lw(a):
    z = torch.zeros_like(a["t"])
    return TR.lw_fluxes(a["t"], a["q"], a["o3"], a["pmid"], a["pint"], z, z,
                        torch.full((1,), a["t_sfc"], dtype=torch.float64))


@pytest.mark.parametrize("kind,olr_t,dlr_t", LW_CASES)
def test_lw_clear_sky_benchmarks(kind, olr_t, dlr_t):
    """Clear-sky OLR and DLR within 4% of the ICRCCM-class line-by-line
    values (Ellingson et al. 1991) on McClatchey atmospheres."""
    out = clear_lw(atmosphere(kind))
    assert abs(float(out["olr"][0]) / olr_t - 1.0) < 0.04
    assert abs(float(out["lwdnb"][0]) / dlr_t - 1.0) < 0.04


def test_lw_tropospheric_cooling():
    cool = clear_lw(atmosphere("tropical"))["qrl"][0].numpy() * 86400.0
    assert -3.0 < cool[4:14].mean() < -1.0


def test_isothermal_atmosphere_olr_is_sigma_t4():
    Cn, Kn, T0 = 3, 24, 288.0
    pint = torch.linspace(1.0e5, 1.0e2, Kn + 1, dtype=torch.float64)[None]
    pint = pint.repeat(Cn, 1)
    pmid = 0.5 * (pint[:, :-1] + pint[:, 1:])
    t = torch.full((Cn, Kn), T0, dtype=torch.float64)
    q = torch.full((Cn, Kn), 3e-3, dtype=torch.float64) * torch.tensor(
        [0.1, 1.0, 10.0], dtype=torch.float64)[:, None]
    o3 = torch.full((Cn, Kn), 5e-8, dtype=torch.float64)
    zero = torch.zeros((Cn, Kn), dtype=torch.float64)
    out = TR.lw_fluxes(t, q, o3, pmid, pint, zero, zero,
                       torch.full((Cn,), T0, dtype=torch.float64))
    np.testing.assert_allclose(out["olr"].numpy(), constants.stbolt * T0 ** 4,
                               rtol=2e-3)
    assert float(out["qrl"].abs().max()) < 1e-3


def test_sw_h2o_fit_matches_lacis_hansen_1974():
    """The NIR k-distribution reproduces the LH74 water-vapour absorption
    function A(y) = 2.9y/((1+141.5y)^0.635+5.925y), normalised."""
    y = np.logspace(-3, 0.7, 40)
    frac_lh = 2.9 * y / ((1.0 + 141.5 * y) ** 0.635 + 5.925 * y) / TR.W_NIR
    frac_fit = sum(w * (1.0 - np.exp(-k * y))
                   for w, k in zip(TR.SW_H2O_W, TR.SW_H2O_K))
    rel = np.abs(frac_fit - frac_lh) / np.maximum(frac_lh, 0.02)
    assert rel.max() < 0.06
    assert abs(sum(TR.SW_H2O_W) - 1.0) < 2e-4
    assert abs(sum(TR.LW_H2O_W) + TR.LW_CO2_W + TR.LW_O3_W - 1.0) < 2e-3


def _sw_tropical(cld_layers=None, cwp_value=0.0, frac=0.0, mu=0.5):
    a = atmosphere("tropical")
    z = torch.zeros_like(a["t"])
    cld, cwp = z.clone(), z.clone()
    if cld_layers is not None:
        cld[:, cld_layers] = frac
        cwp[:, cld_layers] = cwp_value
    rel, rei = TR.cldefr(a["t"])
    out = TR.sw_fluxes(torch.full((1,), mu, dtype=torch.float64), 1365.0,
                       a["pmid"], a["pint"], a["q"], a["o3"], cld, cwp, rel,
                       rei, TR.ice_fraction(a["t"]))
    return a, cld, cwp, out


def test_sw_clear_sky_and_energy_closure():
    _, _, _, out = _sw_tropical()
    solin = float(out["solin"][0])
    assert 0.10 < float(out["swup_toa"][0]) / solin < 0.22
    qrs = out["qrs"][0].numpy() * 86400.0
    assert 2.0 < qrs[30:].max() < 12.0 and 0.4 < qrs[:14].mean() < 2.5
    a, _, _, out = _sw_tropical(slice(6, 8), 80.0, 0.5, mu=0.7)
    pint = a["pint"][0].numpy()
    atm = (out["qrs"][0].numpy() * constants.cp * np.abs(pint[:-1] - pint[1:])
           / constants.gravity).sum()
    total = float(out["swup_toa"][0]) + atm + float(out["fsns"][0])
    assert abs(total / float(out["solin"][0]) - 1.0) < 0.02


def test_cloud_effects_signs():
    """A thick low cloud raises planetary albedo, cuts surface SW, reduces
    OLR and raises DLR."""
    _, _, _, sw0 = _sw_tropical()
    a, cld, cwp, sw1 = _sw_tropical(slice(3, 5), 120.0, 0.9)
    emis = TR.cldems(cwp, TR.cldefr(a["t"])[1], TR.ice_fraction(a["t"]))
    z = torch.zeros_like(a["t"])
    tsfc = torch.full((1,), a["t_sfc"], dtype=torch.float64)
    lw0 = TR.lw_fluxes(a["t"], a["q"], a["o3"], a["pmid"], a["pint"], z, z,
                       tsfc)
    lw1 = TR.lw_fluxes(a["t"], a["q"], a["o3"], a["pmid"], a["pint"], emis,
                       cld, tsfc)
    assert float(sw1["swup_toa"][0]) > 2.0 * float(sw0["swup_toa"][0])
    assert float(sw1["fsns"][0]) < 0.6 * float(sw0["fsns"][0])
    assert float(lw1["olr"][0]) < float(lw0["olr"][0]) - 10.0
    assert float(lw1["lwdnb"][0]) > float(lw0["lwdnb"][0]) + 10.0


# ---------------------------------------------------------------------------
# the legacy escape hatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_legacy_relaxation_matches_oracle(dtype):
    if not legacy.available():
        pytest.skip("the native library could not be built (no C++ compiler)")
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((8, 321)) * 30 + 300
    ref = np.linspace(280.0, 400.0, 8)
    tau = 86400.0
    out = legacy.legacy_relaxation_tend(torch.from_numpy(theta).to(dtype),
                                        torch.from_numpy(ref), tau)
    assert out.dtype == dtype and out.device.type == "cpu"
    th = torch.from_numpy(theta).to(dtype).double().numpy()
    want = -(th - ref[:, None]) / tau
    assert torch.equal(out, torch.from_numpy(want).to(dtype))
    with pytest.raises(ValueError, match="theta_ref"):
        legacy.legacy_relaxation_tend(torch.from_numpy(theta),
                                      torch.from_numpy(ref[:5]), tau)


def test_native_build_without_a_compiler(tmp_path, monkeypatch):
    """Without a C++ compiler the build reports failure (and the legacy
    path is then unavailable) instead of raising; nothing is written."""
    from mpas_tpu_torch.parallel import native
    monkeypatch.setenv("CXX", "no-such-compiler-on-path")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    lib = tmp_path / "build" / "lib.so"
    assert native._build(lib) is False
    assert not lib.exists()
