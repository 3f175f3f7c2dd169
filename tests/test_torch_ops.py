"""mpas_tpu_torch's ops against mpas_tpu's on the same inputs, float64 on the
CPU, at 1e-12 of each output's largest magnitude: the stencils on random
fields, and the diagnostics, tendencies, implicit coefficients, acoustic
step and recovery on a JW state carried across with `from_jax_numpy`.

Setup: generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.dynamics.model import build_model as j_build
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.ops import acoustic as JA
from mpas_tpu.ops import diagnostics as JD
from mpas_tpu.ops import recover as JR
from mpas_tpu.ops import stencils as JS
from mpas_tpu.ops import tendencies as JT

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.ops import acoustic as TA
from mpas_tpu_torch.ops import diagnostics as TD
from mpas_tpu_torch.ops import recover as TR
from mpas_tpu_torch.ops import stencils as TS
from mpas_tpu_torch.ops import tendencies as TT
from mpas_tpu_torch.weights import from_jax_numpy

RTOL = 1e-12
DTS = 240.0
DT = 720.0


def as_dict(x):
    return {f.name: (None if getattr(x, f.name) is None
                     else np.asarray(getattr(x, f.name)))
            for f in dataclasses.fields(x)}


def leaves(x):
    """Flatten a result (tensor, array, tuple/list, dict, dataclass) into
    a list of numpy arrays in a fixed order."""
    if x is None:
        return []
    if dataclasses.is_dataclass(x):
        return sum((leaves(getattr(x, f.name)) for f in dataclasses.fields(x)),
                   [])
    if isinstance(x, dict):
        return sum((leaves(x[k]) for k in sorted(x)), [])
    if isinstance(x, (list, tuple)):
        return sum((leaves(v) for v in x), [])
    if torch.is_tensor(x):
        return [x.detach().cpu().numpy()]
    return [np.asarray(x)]


def assert_close(j_out, t_out, rtol=RTOL):
    a, b = leaves(j_out), leaves(t_out)
    assert len(a) == len(b) and a
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, (i, x.shape, y.shape)
        scale = np.abs(x).max() if x.size else 0.0
        err = np.abs(x - y).max() if x.size else 0.0
        assert err <= rtol * scale + 1e-300, (i, err, scale)


@pytest.fixture(scope="module")
def ref():
    """The JAX model and the port's containers carried across from it."""
    mesh = j_generate(levels=3, lloyd_iterations=2)
    jnl = JNamelist(config_nvertlevels=8, config_ztop=30000.0,
                    dtype="float64", config_jw_u_perturbation=1.0)
    m = j_build(namelist=jnl, mesh=mesh)
    jstate = JR.compute_moist_coefficients(m.state, m.mesh_arrays)
    tm, tv, tst, ts = from_jax_numpy(
        as_dict(m.mesh_arrays), as_dict(m.vert), as_dict(m.static),
        as_dict(jstate), device="cpu", dtype=torch.float64)
    return dict(j=(jstate, m.static, m.mesh_arrays, m.vert, jnl),
                t=(ts, tst, tm, tv, Namelist(**jnl.to_dict())))


@pytest.fixture(scope="module")
def fields(ref):
    """Random level-major fields of every kind, the same numbers for both."""
    mesh = ref["j"][2]
    C, E, V = mesh.nCells, mesh.nEdges, mesh.nVertices
    rng = np.random.default_rng(1234)
    f = dict(cell=rng.normal(size=(8, C)), cell2=rng.normal(size=(5, C)),
             iface=rng.normal(size=(9, C)), edge=rng.normal(size=(8, E)),
             edge2=rng.normal(size=(3, E)), eiface=rng.normal(size=(9, E)),
             vert=rng.normal(size=(8, V)), wc=rng.normal(size=(C, 6)),
             wc2=rng.normal(size=(C, 6)), wv=rng.normal(size=(V, 3)),
             we=rng.normal(size=(E, 10)),
             sgn=np.sign(rng.normal(size=(8, E))))
    return ({k: jnp.asarray(v) for k, v in f.items()},
            {k: torch.from_numpy(v) for k, v in f.items()})


def _stencil_cases():
    """name -> fn(S, mesh, f) evaluated once with mpas_tpu's stencils and
    mesh/fields and once with the port's."""
    return {
        "gather": lambda S, m, f: S.gather(f["cell"], m.cellsOnEdge[:, 1]),
        "take_packed": lambda S, m, f: S.take_packed(
            m.cellsOnEdge[:, 0], f["cell"], f["iface"], f["cell2"]),
        "edge_pairs": lambda S, m, f: S.edge_pairs(
            m.cellsOnEdge, f["cell"], f["iface"]),
        "edge_pairs_m": lambda S, m, f: S.edge_pairs_m(m, f["cell"], f["cell2"]),
        "edge_pair": lambda S, m, f: S.edge_pair(f["cell"], m.cellsOnEdge),
        "edge_pair_m": lambda S, m, f: S.edge_pair_m(m, f["iface"]),
        "avg_cell_to_edge": lambda S, m, f: S.avg_cell_to_edge(
            f["cell"], m.cellsOnEdge),
        "avg_cell_to_edge_m": lambda S, m, f: S.avg_cell_to_edge_m(m, f["cell"]),
        "diff_cell_to_edge": lambda S, m, f: S.diff_cell_to_edge(
            f["cell"], m.cellsOnEdge),
        "diff_cell_to_edge_m": lambda S, m, f: S.diff_cell_to_edge_m(m, f["cell"]),
        # two fields sharing [wc, wc2] in different orders, one with its own
        "slot_reduce": lambda S, m, f: S.slot_reduce(
            m.edgesOnCell, [(f["edge"], [f["wc"], f["wc2"]]),
                            (f["eiface"], [f["wc2"], f["wc"]]),
                            (f["edge2"], [f["wc2"]])]),
        "slot_reduce_m": lambda S, m, f: S.slot_reduce_m(
            m, m.edgesOnCell, [(f["edge"], [f["wc"]]),
                               (f["edge2"], [f["wc"]])]),
        "slot_gather": lambda S, m, f: S.slot_gather(m.edgesOnCell, f["edge"]),
        "sum_edges_to_cell": lambda S, m, f: S.sum_edges_to_cell(
            f["edge"], m.edgesOnCell, f["wc"]),
        "sum_edges_to_cell_m": lambda S, m, f: S.sum_edges_to_cell_m(
            m, f["eiface"], f["wc"]),
        "sum_edges_to_vertex": lambda S, m, f: S.sum_edges_to_vertex(
            f["edge"], m.edgesOnVertex, f["wv"]),
        "sum_vertices_to_edge": lambda S, m, f: S.sum_vertices_to_edge(
            f["vert"], m.verticesOnEdge),
        "edges_on_edge_sum": lambda S, m, f: S.edges_on_edge_sum(
            f["edge"], m.edgesOnEdge, f["we"], m.edgesOnEdge_mask),
        "adv_flux_on_edge": lambda S, m, f: S.adv_flux_on_edge(
            f["cell"], f["sgn"], m.advCellsForEdge,
            m.adv_coefs, m.adv_coefs_3rd),
        "zb_metric": lambda S, m, f: S.zb_metric(
            f["eiface"], m.edgesOnCell, m.edgesOnCellSign, f["zb"], f["zb3"]),
        "zb_metric_m": lambda S, m, f: S.zb_metric_m(
            m, f["eiface"], m.edgesOnCellSign, f["zb"], f["zb3"]),
        "interface_interp": lambda S, m, f: S.interface_interp(
            f["cell"], f["fzm"], f["fzp"]),
        "delta": lambda S, m, f: S.delta(f["iface"]),
        "flux4": lambda S, m, f: S.flux4(f["cell"][0], f["cell"][1],
                                         f["cell"][2], f["cell"][3],
                                         f["cell"][4]),
        "flux3": lambda S, m, f: S.flux3(f["cell"][0], f["cell"][1],
                                         f["cell"][2], f["cell"][3],
                                         f["cell"][4], 0.25),
        "vflux_mass_to_iface": lambda S, m, f: S.vflux_mass_to_iface(
            f["cell"], f["iface"], f["fzm"], f["fzp"], 0.25),
        "vflux_iface_to_mass": lambda S, m, f: S.vflux_iface_to_mass(
            f["iface"], f["iface"] * 0.5 + 1.0, 1.0),
    }


@pytest.mark.parametrize("name", sorted(_stencil_cases()))
def test_stencil_matches(ref, fields, name):
    fn = _stencil_cases()[name]
    jf, tf = dict(fields[0]), dict(fields[1])
    jst, tst = ref["j"][1], ref["t"][1]
    jf.update(zb=jst.zb_cell, zb3=jst.zb3_cell, fzm=ref["j"][3].fzm,
              fzp=ref["j"][3].fzp)
    tf.update(zb=tst.zb_cell, zb3=tst.zb3_cell, fzm=ref["t"][3].fzm,
              fzp=ref["t"][3].fzp)
    assert_close(fn(JS, ref["j"][2], jf), fn(TS, ref["t"][2], tf))


def test_aligned_mesh_raises(ref):
    """A mesh flagged ownership-aligned whose edges are numbered otherwise
    is refused when its MeshArrays are made (the aligned `_m` stencils,
    held against mpas_tpu in tests/test_torch_numbering.py, would read the
    wrong edges)."""
    with pytest.raises(ValueError, match="owner_aligned"):
        ref["t"][2].replace(owner_aligned=True)


def test_compute_vert_imp_coefs(ref):
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    assert_close(JA.compute_vert_imp_coefs(js, jst, jv, jnl, DTS),
                 TA.compute_vert_imp_coefs(ts, tst, tv, nl, DTS))


def test_tridiag_solve(ref):
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    jc = JA.compute_vert_imp_coefs(js, jst, jv, jnl, DTS)
    tc = TA.compute_vert_imp_coefs(ts, tst, tv, nl, DTS)
    K, C = ts.theta_m.shape
    rng = np.random.default_rng(0)
    rhs = np.concatenate([np.zeros((1, C)), rng.normal(0, 1, (K - 1, C)),
                          np.zeros((1, C))], axis=0)
    w_j = np.asarray(JA._tridiag_solve(jnp.asarray(rhs), jc))
    w = TA._tridiag_solve(torch.from_numpy(rhs), tc).numpy()
    assert_close(w_j, w)
    # against a dense solve: a*w[k-1] + b*w[k] + c*w[k+1] = rhs
    a, alpha, gamma = (tc.a_tri.numpy(), tc.alpha_tri.numpy(),
                       tc.gamma_tri.numpy())
    for c_ in (0, 17, 401):
        b = 1.0 / alpha[1:K, c_] + a[1:K, c_] * np.concatenate(
            [[0], gamma[1:K - 1, c_]])
        cc = gamma[1:K, c_] / alpha[1:K, c_]
        A = np.diag(b) + np.diag(a[2:K, c_], -1) + np.diag(cc[:-1], 1)
        np.testing.assert_allclose(w[1:K, c_], np.linalg.solve(A, rhs[1:K, c_]),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("reconstruct_v", [True, False])
def test_compute_solve_diagnostics(ref, reconstruct_v):
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    assert_close(
        JD.compute_solve_diagnostics(js, jm, reconstruct_v=reconstruct_v,
                                     cell_form=False),
        TD.compute_solve_diagnostics(ts, tm, reconstruct_v=reconstruct_v,
                                     cell_form=False))


def test_reconstruct_velocity(ref):
    assert_close(JD.reconstruct_velocity(ref["j"][0].u, ref["j"][2]),
                 TD.reconstruct_velocity(ref["t"][0].u, ref["t"][2]))


def test_init_coupled_and_output_diagnostics(ref):
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    # treat the coupled state's rho_zz*zz as the physical density
    jin = js.replace(rho_zz=js.rho_zz * jst.zz)
    tin = ts.replace(rho_zz=ts.rho_zz * tst.zz)
    j_out = JD.init_coupled_diagnostics(jin, jst, jm, jv)
    t_out = TD.init_coupled_diagnostics(tin, tst, tm, tv)
    for n in ("rho_zz", "ru", "rw", "rho_p", "rtheta_p", "exner", "pressure_p"):
        assert_close(getattr(j_out, n), getattr(t_out, n))
    assert_close(JD.output_diagnostics(js, jst), TD.output_diagnostics(ts, tst))


def _tend_chain(ref, n_rk):
    """compute_dyn_tend for rk steps 0..n_rk-1 in both packages."""
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    jsave, tsave = JR.rk_integration_setup(js), TR.rk_integration_setup(ts)
    jt = tt = None
    for rk in range(n_rk):
        jt = JT.compute_dyn_tend(js, jsave, jst, jm, jv, jnl, rk, DT, prev=jt)
        tt = TT.compute_dyn_tend(ts, tsave, tst, tm, tv, nl, rk, DT, prev=tt)
    return jt, tt


@pytest.mark.parametrize("rk_step", [0, 1, 2])
def test_compute_dyn_tend(ref, rk_step):
    jt, tt = _tend_chain(ref, rk_step + 1)
    assert_close(jt, tt)


def test_set_smlstep_pert_variables(ref):
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    jt, tt = _tend_chain(ref, 1)
    assert_close(JR.set_smlstep_pert_variables(jt, jst, jm, jv, nl=jnl),
                 TR.set_smlstep_pert_variables(tt, tst, tm, tv, nl=nl))


@pytest.fixture(scope="module")
def acoustic_run(ref):
    """Two acoustic substeps (the second with damp_previous) and the final
    divergence damping, in both packages."""
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    jt, tt = _tend_chain(ref, 1)
    jt = JR.set_smlstep_pert_variables(jt, jst, jm, jv, nl=jnl)
    tt = TR.set_smlstep_pert_variables(tt, tst, tm, tv, nl=nl)
    jc = JA.compute_vert_imp_coefs(js, jst, jv, jnl, DTS)
    tc = TA.compute_vert_imp_coefs(ts, tst, tv, nl, DTS)
    jsave, tsave = JR.rk_integration_setup(js), TR.rk_integration_setup(ts)
    jz, tz = jnp.zeros_like, torch.zeros_like
    jac = JA.AcousticState(ru_p=jz(js.u), rho_pp=jz(js.rho_p),
                           rtheta_pp=jz(js.rtheta_p),
                           rtheta_pp_old=jz(js.rtheta_p), rw_p=jz(js.rw))
    tac = TA.AcousticState(ru_p=tz(ts.u), rho_pp=tz(ts.rho_p),
                           rtheta_pp=tz(ts.rtheta_p),
                           rtheta_pp_old=tz(ts.rtheta_p), rw_p=tz(ts.rw))
    jr, jw, tr, tw = jz(js.ruAvg), jz(js.wwAvg), tz(ts.ruAvg), tz(ts.wwAvg)
    out = []
    for step in range(2):
        jac, jr, jw = JA.advance_acoustic_step(
            jac, jr, jw, jt, jc, js, jsave, jst, jm, jv, jnl, DTS, step,
            damp_previous=True)
        tac, tr, tw = TA.advance_acoustic_step(
            tac, tr, tw, tt, tc, ts, tsave, tst, tm, tv, nl, DTS, step,
            damp_previous=True)
        out.append(((jac, jr, jw), (tac, tr, tw)))
    jd = JA.divergence_damping_3d(jac, js, jm, jnl, DTS, static=jst)
    td = TA.divergence_damping_3d(tac, ts, tm, nl, DTS, static=tst)
    out.append((jd, td))
    return out, (jsave, tsave)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_advance_acoustic_step(acoustic_run, which):
    """Substep 0, substep 1 (damp_previous) and the final damping."""
    j_out, t_out = acoustic_run[0][which]
    assert_close(j_out, t_out)


@pytest.mark.parametrize("rk_step", [0, 2])
def test_recover_large_step_variables(ref, acoustic_run, rk_step):
    js, jst, jm, jv, jnl = ref["j"]
    ts, tst, tm, tv, nl = ref["t"]
    (jac, jr, jw), (tac, tr, tw) = acoustic_run[0][1]
    jsave, tsave = acoustic_run[1]
    j_out = JR.recover_large_step_variables(js, jac, jr, jw, jsave, jst, jm,
                                            jv, jnl, 2, rk_step, DT)
    t_out = TR.recover_large_step_variables(ts, tac, tr, tw, tsave, tst, tm,
                                            tv, nl, 2, rk_step, DT)
    assert_close(j_out, t_out)


@pytest.mark.parametrize("substep,split", [(1, 1), (1, 2), (2, 2)])
def test_rk_dynamics_substep_finish(ref, substep, split):
    js, ts = ref["j"][0], ref["t"][0]
    jsave, tsave = JR.rk_integration_setup(js), TR.rk_integration_setup(ts)
    j_out = JR.rk_dynamics_substep_finish(js, jsave, substep, split,
                                          js.ruAvg * 0.5, js.wwAvg * 0.5)
    t_out = TR.rk_dynamics_substep_finish(ts, tsave, substep, split,
                                          ts.ruAvg * 0.5, ts.wwAvg * 0.5)
    assert_close(j_out, t_out)
