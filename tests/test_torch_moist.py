"""mpas_tpu_torch's moist path against mpas_tpu's on the same inputs, float64
on the CPU.

  - per function at 1e-12 of each output's largest magnitude:
    compute_moist_coefficients with 3 species; the moist terms the dry
    operators already carry (qtot, cqw, cqu, rt_diabatic_tend in
    compute_dyn_tend, the acoustic step and the recovery) with non-trivial
    moisture; `_mass_divergence`, `advance_scalars` and
    `advance_scalars_mono` with 1 and 3 different species, in stencil and
    in cell form, and on the ownership-aligned numbering;
  - 2 steps of the whole model, per field at 1e-10, `scalars` and `rainnc`
    included, state carried across with `from_jax_numpy`: JW + WSM6 + PBL,
    the mountain wave (case 21), the squall line (case 22) + WSM6, JW +
    WSM6 on the ownership-aligned numbering, and the step's split options:
    config_dynamics_split_steps = 3 dry and with scalar transport (the
    dynamics substeps restart from `save`, scalars advance once over the
    whole step), config_number_of_sub_steps = 6 (3, 3 and 6 acoustic
    substeps in the three RK stages) (JW + Kessler is in
    tests/test_torch_physics.py, the cell-form run in
    tests/test_torch_cellform.py);
  - the port's own properties: a constant scalar stays constant, the FCT
    keeps a plume within its initial bounds, the species do not mix,
    cell form equals stencil form, the state handed in is not written.

Setup: generate_mesh(levels=3, lloyd_iterations=2 or 3) (642 cells), 8
levels (16 for the mountain wave and the squall line)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.ops import acoustic as JA
from mpas_tpu.ops import recover as JR
from mpas_tpu.ops import scalars as JSC
from mpas_tpu.ops import tendencies as JT

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics import srk3
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.ops import acoustic as TA
from mpas_tpu_torch.ops import recover as TR
from mpas_tpu_torch.ops import scalars as TSC
from mpas_tpu_torch.ops import tendencies as TT

from test_torch_cellform import KW, carry
from test_torch_copies import as_mpas_tpu
from test_torch_ops import assert_close

STEP_RTOL = 1e-10
DT = 720.0
DTS = 240.0
SQUALL = dict(config_init_case=22, config_coriolis=False,
              config_vertical_stretch=1.0, dtype="float64",
              config_sphere_radius=6371229.0 / 200.0, config_dt=16.0,
              config_number_of_sub_steps=4, config_nvertlevels=16,
              config_ztop=20000.0, config_zd=14000.0, config_xnutr=0.3,
              config_len_disp=4800.0, config_moisture=True,
              config_microphysics="wsm6", config_sq_bubble_dtheta=3.0)
MOUNTAIN = dict(config_init_case=21, config_coriolis=False,
                config_vertical_stretch=1.0, dtype="float64",
                config_sphere_radius=6371229.0 / 200.0, config_dt=12.0,
                config_nvertlevels=16, config_ztop=16000.0,
                config_zd=10000.0, config_xnutr=0.3, config_len_disp=4800.0,
                config_mtn_h0=250.0, config_mtn_halfwidth=20000.0,
                config_mtn_wavelength=80000.0)
# name -> (namelist, lloyd iterations of the level-3 mesh)
CONFIGS = {
    "jw_wsm6_pbl": (dict(KW, config_moisture=True, config_microphysics="wsm6",
                         config_pbl="ysu_lite"), 2),
    "mountain_wave": (MOUNTAIN, 2),
    "squall_wsm6": (SQUALL, 3),
    "jw_wsm6_aligned": (dict(KW, config_moisture=True,
                             config_microphysics="wsm6",
                             config_orient_edges=True), 2),
    "split3_dry": (dict(KW, config_dynamics_split_steps=3), 2),
    "split3_scalars": (dict(KW, config_dynamics_split_steps=3,
                            config_moisture=True,
                            config_scalar_advection=True), 2),
    "substeps6": (dict(KW, config_number_of_sub_steps=6), 2),
}
DRY = {"mountain_wave", "split3_dry", "substeps6"}
FIELDS = ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p", "scalars",
          "rainnc")


@pytest.fixture(scope="module")
def jax_models():
    """name of CONFIGS -> JAX model, built when first asked for."""
    done = {}

    def get(name):
        if name not in done:
            kw, lloyd = CONFIGS[name]
            done[name] = j_build(
                namelist=JNamelist(**kw),
                mesh=j_generate(levels=3, lloyd_iterations=lloyd,
                                sphere_radius=kw.get("config_sphere_radius",
                                                     6371229.0)))
        return done[name]

    return get


@pytest.fixture(scope="module")
def two_steps(jax_models):
    done = {}

    def get(name):
        if name not in done:
            m = jax_models(name)
            tm, tv, tst, ts = carry(m)
            nl = Namelist(**m.namelist.to_dict())
            for _ in range(2):
                ts = srk3.atm_srk3(ts, tst, tm, tv, nl, nl.config_dt)
            done[name] = (m.step_fn(m.step_fn(m.state)), ts)
        return done[name]

    return get


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_steps_match(two_steps, name, field):
    jstate, ts = two_steps(name)
    a, b = getattr(jstate, field), getattr(ts, field)
    if a is None:     # the dry configurations; rainnc without microphysics
        assert b is None
        assert name in DRY or (field == "rainnc" and "config_microphysics"
                               not in CONFIGS[name][0])
        return
    assert np.isfinite(b.numpy()).all()
    assert_close(np.asarray(a), b, rtol=STEP_RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_model_matches_reference_initial_state(jax_models, name):
    """The port's own host setup (init case, species, rainnc, nfall) gives
    the reference's initial state and namelist."""
    jm = jax_models(name)
    kw, lloyd = CONFIGS[name]
    model = build_model(
        Namelist(**kw),
        generate_mesh(levels=3, lloyd_iterations=lloyd,
                      sphere_radius=kw.get("config_sphere_radius", 6371229.0)),
        device="cpu")
    assert as_mpas_tpu(model.namelist.to_dict()) == jm.namelist.to_dict()
    stage = {2: "init_jw", 21: "init_mountain_wave", 22: "init_squall"}[
        model.namelist.config_init_case]
    assert stage in model.setup_seconds
    for f in dataclasses.fields(model.state):
        t, j = getattr(model.state, f.name), getattr(jm.state, f.name)
        if j is None:
            assert t is None, f.name
            continue
        assert t.is_contiguous(), f.name
        assert_close(np.asarray(j), t)
    for f in dataclasses.fields(model.static):
        assert_close(np.asarray(getattr(jm.static, f.name)),
                     getattr(model.static, f.name))


# ---------------------------------------------------------------------------
# per function
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(jax_models):
    """A moist JW state one step on (condensate present, fluxes averaged),
    in both packages, with 3 and 1 species to transport."""
    m = jax_models("jw_wsm6_pbl")
    jstate = m.step_fn(m.state)
    K, C = jstate.theta_m.shape
    rng = np.random.default_rng(99)
    # three different species: vapor as the step left it, a plume, noise
    lat = np.asarray(m.mesh_arrays.latCell)
    plume = (np.exp(-((lat - 0.6) / 0.25) ** 2)[None, :]
             * np.exp(-((np.arange(K) - 2.5) / 1.5) ** 2)[:, None]) * 4e-3
    plume[plume < 1e-4] = 0.0
    noise = 2e-4 * rng.random((K, C))
    q3 = np.stack([np.asarray(jstate.scalars[0]), plume, noise])
    jstate3 = jstate.replace(scalars=jnp.asarray(q3))
    tm, tv, tst, ts3 = carry(m, jstate3)
    nl = Namelist(**m.namelist.to_dict())
    return dict(j=(jstate3, m.static, m.mesh_arrays, m.vert, m.namelist),
                t=(ts3, tst, tm, tv, nl), q3=q3)


def test_compute_moist_coefficients(ref):
    js, _, jm = ref["j"][:3]
    ts, _, tm = ref["t"][:3]
    j_out = JR.compute_moist_coefficients(js, jm)
    t_out = TR.compute_moist_coefficients(ts, tm)
    assert float(t_out.qtot.max()) > 1e-3 and float(t_out.cqu.min()) < 0.999
    assert bool((t_out.cqw[0] == 1.0).all())
    for name in ("qtot", "cqw", "cqu"):
        assert_close(getattr(j_out, name), getattr(t_out, name))
    # fresh tensors: the state handed in keeps its own
    assert ts.qtot.data_ptr() != t_out.qtot.data_ptr()


@pytest.fixture(scope="module")
def moist_chain(ref):
    """The moist terms of the dry operators, with moisture that is not
    trivial: qtot / cqw / cqu from 3 species and a random diabatic tendency,
    through compute_dyn_tend (rk 0 and 1), set_smlstep_pert_variables, two
    acoustic substeps and the recovery, in both packages."""
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    rng = np.random.default_rng(5)
    heat = 1e-3 * rng.normal(size=tuple(ts.theta_m.shape))
    js = JR.compute_moist_coefficients(js, jm).replace(
        rt_diabatic_tend=jnp.asarray(heat))
    ts = TR.compute_moist_coefficients(ts, tm).replace(
        rt_diabatic_tend=torch.from_numpy(heat))
    jsave, tsave = JR.rk_integration_setup(js), TR.rk_integration_setup(ts)
    out = {}
    jt = tt = None
    for rk in range(2):
        jt = JT.compute_dyn_tend(js, jsave, jst, jm, jv, jnl, rk, DT, prev=jt)
        tt = TT.compute_dyn_tend(ts, tsave, tst, tm, tv, nl, rk, DT, prev=tt)
        out[f"dyn_tend_rk{rk}"] = (jt, tt)
    jt = JR.set_smlstep_pert_variables(jt, jst, jm, jv, nl=jnl)
    tt = TR.set_smlstep_pert_variables(tt, tst, tm, tv, nl=nl)
    jc = JA.compute_vert_imp_coefs(js, jst, jv, jnl, DTS)
    tc = TA.compute_vert_imp_coefs(ts, tst, tv, nl, DTS)
    out["vert_imp_coefs"] = (jc, tc)
    jz, tz = jnp.zeros_like, torch.zeros_like
    jac = JA.AcousticState(ru_p=jz(js.u), rho_pp=jz(js.rho_p),
                           rtheta_pp=jz(js.rtheta_p),
                           rtheta_pp_old=jz(js.rtheta_p), rw_p=jz(js.rw))
    tac = TA.AcousticState(ru_p=tz(ts.u), rho_pp=tz(ts.rho_p),
                           rtheta_pp=tz(ts.rtheta_p),
                           rtheta_pp_old=tz(ts.rtheta_p), rw_p=tz(ts.rw))
    jr, jw, tr, tw = jz(js.ruAvg), jz(js.wwAvg), tz(ts.ruAvg), tz(ts.wwAvg)
    for step in range(2):
        jac, jr, jw = JA.advance_acoustic_step(
            jac, jr, jw, jt, jc, js, jsave, jst, jm, jv, jnl, DTS, step,
            damp_previous=True)
        tac, tr, tw = TA.advance_acoustic_step(
            tac, tr, tw, tt, tc, ts, tsave, tst, tm, tv, nl, DTS, step,
            damp_previous=True)
    out["acoustic"] = ((jac, jr, jw), (tac, tr, tw))
    out["recover"] = (
        JR.recover_large_step_variables(js, jac, jr, jw, jsave, jst, jm, jv,
                                        jnl, 2, 2, DT),
        TR.recover_large_step_variables(ts, tac, tr, tw, tsave, tst, tm, tv,
                                        nl, 2, 2, DT))
    return out


@pytest.mark.parametrize("what", ["dyn_tend_rk0", "dyn_tend_rk1",
                                  "vert_imp_coefs", "acoustic", "recover"])
def test_moist_terms_of_the_dry_operators(moist_chain, what):
    j_out, t_out = moist_chain[what]
    assert_close(j_out, t_out)


def test_mass_divergence(ref):
    js, _, jm, jv, _ = ref["j"]
    ts, _, tm, tv, _ = ref["t"]
    assert_close(JSC._mass_divergence(js.ruAvg, js.wwAvg, jm, jv.rdzw),
                 TSC._mass_divergence(ts.ruAvg, ts.wwAvg, tm, tv.rdzw))


def _advance(ref, fn, n_species, cell_form, t_only=False, scalars=None):
    js, _, jm, jv, jnl = ref["j"]
    ts, _, tm, tv, nl = ref["t"]
    tq = ts.scalars[:n_species] if scalars is None else scalars
    t_out = getattr(TSC, fn)(tq, ts.rho_zz, ts.ruAvg, ts.wwAvg, tm, tv,
                             nl.replace(config_cell_form_ops=cell_form), DT)
    if t_only:
        return t_out
    j_out = getattr(JSC, fn)(js.scalars[:n_species], js.rho_zz, js.ruAvg,
                             js.wwAvg, jm, jv,
                             jnl.replace(config_cell_form_ops=cell_form), DT)
    return j_out, t_out


@pytest.mark.parametrize("cell_form", [False, True], ids=["stencil", "cell"])
@pytest.mark.parametrize("n_species", [1, 3])
@pytest.mark.parametrize("fn", ["advance_scalars", "advance_scalars_mono"])
def test_advance_scalars_match(ref, fn, n_species, cell_form):
    j_out, t_out = _advance(ref, fn, n_species, cell_form)
    assert t_out[0].shape == (n_species,) + tuple(ref["t"][0].theta_m.shape)
    assert_close(j_out, t_out)


@pytest.mark.parametrize("fn", ["advance_scalars", "advance_scalars_mono"])
def test_advance_scalars_match_on_aligned_mesh(jax_models, fn):
    m = jax_models("jw_wsm6_aligned")
    jstate = m.step_fn(m.state)
    K, C = jstate.theta_m.shape
    q = np.random.default_rng(2).random((2, K, C)) * 1e-3
    tm, tv, _, ts = carry(m, jstate)
    assert tm.owner_aligned
    nl = Namelist(**m.namelist.to_dict())
    assert_close(
        getattr(JSC, fn)(jnp.asarray(q), jstate.rho_zz, jstate.ruAvg,
                         jstate.wwAvg, m.mesh_arrays, m.vert, m.namelist, DT),
        getattr(TSC, fn)(torch.from_numpy(q), ts.rho_zz, ts.ruAvg, ts.wwAvg,
                         tm, tv, nl, DT))


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["advance_scalars", "advance_scalars_mono"])
def test_species_do_not_mix(ref, fn):
    """All species go through each operator together; each must come out as
    it does alone, bit for bit."""
    ts = ref["t"][0]
    together, _ = _advance(ref, fn, 3, False, t_only=True)
    for s in range(3):
        alone, _ = _advance(ref, fn, 1, False, t_only=True,
                            scalars=ts.scalars[s:s + 1])
        assert torch.equal(together[s], alone[0]), s


@pytest.mark.parametrize("cell_form", [False, True], ids=["stencil", "cell"])
@pytest.mark.parametrize("fn", ["advance_scalars", "advance_scalars_mono"])
def test_constant_scalar_stays_constant(ref, fn, cell_form):
    ones = torch.ones((2,) + tuple(ref["t"][0].theta_m.shape),
                      dtype=torch.float64)
    out, _ = _advance(ref, fn, 2, cell_form, t_only=True, scalars=ones)
    assert float((out - 1.0).abs().max()) < 1e-13


def test_fct_keeps_a_plume_within_its_bounds(ref):
    """The monotonic update makes no new extremum: the plume stays within
    [0, its initial maximum] over 5 updates, to round-off of that maximum
    (the limiter's factors are exact, the update's last sum is rounded),
    while one unlimited 3rd-order update undershoots zero by 1e-4 of
    it."""
    plume = torch.from_numpy(ref["q3"][1:2])
    top = float(plume.max())
    q = plume
    for _ in range(5):
        q, _ = _advance(ref, "advance_scalars_mono", 1, False, t_only=True,
                        scalars=q)
        assert float(q.min()) >= -1e-15 * top
        assert float(q.max()) <= top * (1 + 1e-15)
    assert not torch.equal(q, plume)
    free, _ = _advance(ref, "advance_scalars", 1, False, t_only=True,
                       scalars=plume)
    assert float(free.min()) < -1e-7


@pytest.mark.parametrize("fn", ["advance_scalars", "advance_scalars_mono"])
def test_scalar_cell_form_equals_stencil_form(ref, fn):
    stencil, _ = _advance(ref, fn, 3, False, t_only=True)
    cell, _ = _advance(ref, fn, 3, True, t_only=True)
    assert_close(stencil.numpy(), cell, rtol=1e-11)


def test_moist_step_does_not_write_its_input(jax_models):
    """The step's `save` holds the old arrays, so no function of the moist
    tail (transport, WSM6, PBL) may write into a tensor of the state it
    was given."""
    m = jax_models("jw_wsm6_pbl")
    tm, tv, tst, ts = carry(m)
    nl = Namelist(**m.namelist.to_dict())
    before = {f.name: getattr(ts, f.name).clone()
              for f in dataclasses.fields(ts)
              if getattr(ts, f.name) is not None}
    srk3.atm_srk3(ts, tst, tm, tv, nl, nl.config_dt)
    for name, old in before.items():
        assert torch.equal(getattr(ts, name), old), name
