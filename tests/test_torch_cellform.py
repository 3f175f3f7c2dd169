"""mpas_tpu_torch's cell-form operators and the Hollingsworth / APVM options
against mpas_tpu's on the same inputs, float64 on the CPU.

  - per function at 1e-12 of each output's largest magnitude: the cell-form
    stencils on random fields; compute_solve_diagnostics under each option,
    with the tangential velocity reconstructed and not; compute_dyn_tend in
    cell form;
  - 2 steps of the whole model with config_cell_form_ops,
    config_hollingsworth and config_apvm_upwinding together, on the default
    and on the ownership-aligned numbering, per field at 1e-10, state
    carried across with `from_jax_numpy`;
  - on the port alone: cell form equals stencil form at 1e-11; the index
    tables the cell form reads are range-checked.

Setup: generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.ops import diagnostics as JD
from mpas_tpu.ops import recover as JR
from mpas_tpu.ops import stencils as JS
from mpas_tpu.ops import tendencies as JT

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics import srk3
from mpas_tpu_torch.ops import diagnostics as TD
from mpas_tpu_torch.ops import recover as TR
from mpas_tpu_torch.ops import stencils as TS
from mpas_tpu_torch.ops import tendencies as TT
from mpas_tpu_torch.weights import from_jax_numpy

from test_torch_ops import as_dict, assert_close

STEP_RTOL = 1e-10
FORM_RTOL = 1e-11
DT = 720.0
KW = dict(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
          config_jw_u_perturbation=1.0)
CELLFORM = dict(config_cell_form_ops=True, config_hollingsworth=True,
                config_apvm_upwinding=0.5)
FIELDS = ("u", "w", "theta_m", "rho_zz", "rho_p", "rtheta_p", "v", "ke",
          "pv_edge")


def carry(m, state=None):
    """The port's containers from a JAX model (and, optionally, a state)."""
    return from_jax_numpy(
        as_dict(m.mesh_arrays), as_dict(m.vert), as_dict(m.static),
        as_dict(m.state if state is None else state), device="cpu",
        dtype=torch.float64)


@pytest.fixture(scope="module")
def ref():
    m = j_build(namelist=JNamelist(**KW),
                mesh=j_generate(levels=3, lloyd_iterations=2))
    # one step on, so that w, the diagnostics and v are all non-trivial
    jstate = JR.compute_moist_coefficients(m.step_fn(m.state), m.mesh_arrays)
    tm, tv, tst, ts = carry(m, jstate)
    return dict(j=(jstate, m.static, m.mesh_arrays, m.vert),
                t=(ts, tst, tm, tv))


@pytest.fixture(scope="module")
def fields(ref):
    mesh = ref["j"][2]
    C, E = mesh.nCells, mesh.nEdges
    rng = np.random.default_rng(4321)
    f = dict(cell=rng.normal(size=(8, C)), iface=rng.normal(size=(9, C)),
             cell2=rng.normal(size=(3, C)), edge=rng.normal(size=(8, E)),
             sgn=np.sign(rng.normal(size=(8, E))),
             slots=rng.normal(size=(6, 8, C)), slots2=rng.normal(size=(6, 5, C)))
    return ({k: jnp.asarray(v) for k, v in f.items()},
            {k: torch.from_numpy(v) for k, v in f.items()})


CASES = {
    "dir_second_deriv": lambda S, m, f: S.dir_second_deriv(
        m.dirHess, m.cellsOnCell, f["cell"], f["iface"], f["cell2"]),
    "edge_slot_pair": lambda S, m, f: S.edge_slot_pair(
        list(f["slots"]), m.cellsOnEdge, m.slotOnCell),
    "edge_slot_pairs": lambda S, m, f: S.edge_slot_pairs(
        m.cellsOnEdge, m.slotOnCell, list(f["slots"]), list(f["slots2"])),
    "cell_tangential": lambda S, m, f: S.cell_tangential(
        m.tanWeights, S.slot_gather(m.edgesOnCell, f["edge"])),
    "adv_flux_on_edge_cellform": lambda S, m, f: S.adv_flux_on_edge_cellform(
        f["cell"], f["sgn"], m, 0.25),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cellform_stencil_matches(ref, fields, name):
    assert_close(CASES[name](JS, ref["j"][2], fields[0]),
                 CASES[name](TS, ref["t"][2], fields[1]))


def test_cellform_tables_carried_and_built(ref):
    """from_jax_numpy carries the three cell-form tables, and the port's own
    mesh_arrays_from_mesh builds the same ones."""
    from mpas_tpu_torch.core.state import mesh_arrays_from_mesh
    from mpas_tpu_torch.mesh.generator import generate_mesh
    jm, tm = ref["j"][2], ref["t"][2]
    own = mesh_arrays_from_mesh(generate_mesh(levels=3, lloyd_iterations=2),
                                Namelist(**KW), torch.float64, "cpu")
    for name in ("dirHess", "tanWeights", "slotOnCell"):
        a = np.asarray(getattr(jm, name))
        assert np.array_equal(a, getattr(tm, name).numpy()), name
        assert np.array_equal(a, getattr(own, name).numpy()), name
    assert tm.slotOnCell.dtype == torch.int32
    kite = np.take_along_axis(
        np.asarray(jm.kiteAreasOnVertex)[np.asarray(jm.verticesOnCell)],
        np.asarray(jm.kiteForCell)[..., None], axis=2)[..., 0]
    assert np.array_equal(kite, tm.kiteAreaOnCell.numpy())
    assert "verticesOnCell" in tm.gather_sectors


@pytest.mark.parametrize("table,bad", [("slotOnCell", 6), ("cellsOnCell", -1),
                                       ("verticesOnCell", 10 ** 6)])
def test_cellform_index_tables_are_range_checked(ref, table, bad):
    t = getattr(ref["t"][2], table).clone()
    t[3, 1] = bad
    with pytest.raises(ValueError, match=table):
        ref["t"][2].replace(**{table: t})


@pytest.mark.parametrize("reconstruct_v", [True, False])
@pytest.mark.parametrize("option", [
    dict(hollingsworth=True), dict(apvm_upwinding=0.5, dt=DT),
    dict(cell_form=True), dict(hollingsworth=True, apvm_upwinding=0.5, dt=DT,
                               cell_form=True)],
    ids=["hollingsworth", "apvm", "cell_form", "all"])
def test_compute_solve_diagnostics_options(ref, option, reconstruct_v):
    kw = dict(dict(cell_form=False), **option, reconstruct_v=reconstruct_v)
    j_out = JD.compute_solve_diagnostics(ref["j"][0], ref["j"][2], **kw)
    t_out = TD.compute_solve_diagnostics(ref["t"][0], ref["t"][2], **kw)
    assert sorted(j_out) == sorted(t_out)
    assert_close(j_out, t_out)


def test_apvm_needs_dt(ref):
    with pytest.raises(ValueError, match="dt > 0"):
        TD.compute_solve_diagnostics(ref["t"][0], ref["t"][2],
                                     apvm_upwinding=0.5)


def _cell_form_tend_chain(ref, n_rk):
    js, jst, jm, jv = ref["j"]
    ts, tst, tm, tv = ref["t"]
    jnl = JNamelist(**KW, config_cell_form_ops=True)
    nl = Namelist(**KW, config_cell_form_ops=True)
    jsave, tsave = JR.rk_integration_setup(js), TR.rk_integration_setup(ts)
    jt = tt = None
    for rk in range(n_rk):
        jt = JT.compute_dyn_tend(js, jsave, jst, jm, jv, jnl, rk, DT, prev=jt)
        tt = TT.compute_dyn_tend(ts, tsave, tst, tm, tv, nl, rk, DT, prev=tt)
    return jt, tt


@pytest.mark.parametrize("rk_step", [0, 1])
def test_compute_dyn_tend_cell_form(ref, rk_step):
    jt, tt = _cell_form_tend_chain(ref, rk_step + 1)
    assert tt.v is None and jt.v is None
    assert_close(jt, tt)


def test_port_cell_form_equals_stencil_form(ref):
    """The two forms are one arithmetic in another order: on the port, the
    tangential velocity of compute_solve_diagnostics and, from a state that
    holds that velocity (the stencil form's Smagorinsky term takes it from
    its own Coriolis reduction, the cell form's from the state), the
    tendencies of both agree at 1e-11."""
    ts, tst, tm, tv = ref["t"]
    v = TD.compute_solve_diagnostics(ts, tm, cell_form=False)["v"]
    assert_close(v.numpy(),
                 TD.compute_solve_diagnostics(ts, tm, cell_form=True)["v"],
                 rtol=FORM_RTOL)
    ts = ts.replace(v=v)
    save = TR.rk_integration_setup(ts)
    stenc, cellf = (
        TT.compute_dyn_tend(ts, save, tst, tm, tv,
                            Namelist(**KW, config_cell_form_ops=form), 0, DT)
        for form in (False, True))
    for name in ("tend_u", "tend_w", "tend_theta", "tend_rho"):
        assert_close(getattr(stenc, name).numpy(), getattr(cellf, name),
                     rtol=FORM_RTOL)


@pytest.fixture(scope="module")
def two_steps():
    """{aligned: (JAX state, port state)} after 2 steps with every option
    of this file on, computed when first asked for."""
    done = {}

    def get(aligned):
        if aligned not in done:
            kw = dict(KW, **CELLFORM, config_orient_edges=aligned)
            m = j_build(namelist=JNamelist(**kw),
                        mesh=j_generate(levels=3, lloyd_iterations=2))
            tm, tv, tst, ts = carry(m)
            nl = Namelist(**kw)
            for _ in range(2):
                ts = srk3.atm_srk3(ts, tst, tm, tv, nl, nl.config_dt)
            done[aligned] = (m.step_fn(m.step_fn(m.state)), ts)
        return done[aligned]

    return get


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("aligned", [False, True], ids=["default", "aligned"])
def test_two_steps_cell_form_match(two_steps, aligned, field):
    jstate, ts = two_steps(aligned)
    b = getattr(ts, field).numpy()
    assert np.isfinite(b).all()
    assert_close(np.asarray(getattr(jstate, field)), b, rtol=STEP_RTOL)
