"""Discrete identities of the port's operators, on the port alone: the
mirror of tests/test_operators.py (whose model needs a grid file) on
generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels, float64,
the JW state without its perturbation.

  - the divergence (ops/stencils.sum_edges_to_cell) of a flow differenced
    from a streamfunction vanishes to round-off, and that of the JW wind to
    the mesh's truncation error;
  - the circulation (ops/stencils.sum_edges_to_vertex) of a solid-body
    rotation gives its vorticity 2 Omega sin(lat) to the mesh's
    truncation error;
  - the acoustic step's pre-factored tridiagonal solve
    (ops/acoustic._tridiag_solve) agrees with a dense solve of the system
    its factors stand for, in every column."""

import numpy as np
import pytest
import torch

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.ops import acoustic as A
from mpas_tpu_torch.ops import recover as R
from mpas_tpu_torch.ops import stencils as st


@pytest.fixture(scope="module")
def model():
    return build_model(Namelist(config_nvertlevels=8, config_ztop=30000.0,
                                dtype="float64", config_jw_u_perturbation=0.0),
                       generate_mesh(levels=3, lloyd_iterations=2),
                       device="cpu")


@pytest.mark.parametrize("flow", ["discrete", "jw"])
def test_divergence_of_streamfunction_flow(model, flow):
    """A flow differenced from a streamfunction on the vertices, u_e =
    (psi(v2) - psi(v1)) / dv, has zero discrete divergence (the sum around
    a cell telescopes): to round-off. The JW wind, the streamfunction flow
    sampled at the edges, to the truncation bound of
    tests/test_operators.py."""
    m, mesh = model.mesh, model.mesh_arrays
    w_div = (mesh.edgesOnCellSign * mesh.dvEdge[mesh.edgesOnCell.long()]
             * mesh.invAreaCell[:, None])
    if flow == "discrete":
        psi = np.random.default_rng(2).normal(0.0, 1e7, (3, m.nVertices))
        v1, v2 = m.verticesOnEdge[:, 0], m.verticesOnEdge[:, 1]
        u = torch.from_numpy((psi[:, v2] - psi[:, v1]) / m.dvEdge)
        bound = 1e-12
    else:
        u, bound = model.state.u, 1e-3
    div = st.sum_edges_to_cell(u, mesh.edgesOnCell, w_div)
    scale = float(u.abs().max()) / float(mesh.dcEdge.mean())
    assert float(u.abs().max()) > 1.0                  # a real flow
    assert float(div.abs().max()) < bound * scale


def test_vorticity_solid_body(model):
    """u_e = (G(v2) - G(v1)) / dv with G = Omega a^2 sin(lat) is the normal
    component of U = Omega a cos(lat); its discrete circulation over each
    triangle / area is 2 Omega sin(lat) up to the coarse mesh's truncation
    (~5% near pentagons)."""
    m, mesh = model.mesh, model.mesh_arrays
    om = 1e-5
    G = om * m.sphere_radius ** 2 * np.sin(m.latVertex)
    v1, v2 = m.verticesOnEdge[:, 0], m.verticesOnEdge[:, 1]
    u = torch.from_numpy((G[v2] - G[v1]) / m.dvEdge)[None, :]
    w_vortex = (mesh.edgesOnVertexSign
                * mesh.dcEdge[mesh.edgesOnVertex.long()])
    vort = st.sum_edges_to_vertex(u, mesh.edgesOnVertex, w_vortex)
    vort = vort[0].numpy() * m.invAreaTriangle
    target = 2.0 * om * np.sin(m.latVertex)
    assert np.abs(vort - target).max() / (2 * om) < 0.1
    assert np.corrcoef(vort, target)[0, 1] > 0.999


def test_tridiag_solve_against_dense(model):
    state = R.compute_moist_coefficients(model.state, model.mesh_arrays)
    coefs = A.compute_vert_imp_coefs(state, model.static, model.vert,
                                     model.namelist, 240.0)
    K, C = state.theta_m.shape
    rng = np.random.default_rng(0)
    rhs = torch.from_numpy(np.concatenate(
        [np.zeros((1, C)), rng.normal(0.0, 1.0, (K - 1, C)),
         np.zeros((1, C))]))
    w = A._tridiag_solve(rhs, coefs)
    assert float(w[0].abs().max()) == 0.0 and float(w[K].abs().max()) == 0.0
    # the system the factors stand for, on interfaces 1..K-1:
    # alpha_k = 1 / (b_k - a_k gamma_{k-1}), gamma_k = c_k alpha_k
    a = coefs.a_tri[1:K]
    alpha = coefs.alpha_tri[1:K]
    gamma = coefs.gamma_tri[1:K]
    gamma_prev = torch.cat([torch.zeros_like(gamma[:1]), gamma[:-1]])
    b = 1.0 / alpha + a * gamma_prev
    c = gamma / alpha
    n = K - 1
    dense = torch.zeros(C, n, n, dtype=torch.float64)
    i = torch.arange(n)
    dense[:, i, i] = b.T
    dense[:, i[1:], i[:-1]] = a[1:].T
    dense[:, i[:-1], i[1:]] = c[:-1].T
    want = torch.linalg.solve(dense, rhs[1:K].T.unsqueeze(-1))[..., 0].T
    err = float((w[1:K] - want).abs().max() / want.abs().max())
    assert err < 1e-12, err
    # and the residual of the solve in the tridiagonal system itself
    res = (a * torch.cat([w[:1], w[1:K - 1]]) + b * w[1:K] + c * w[2:K + 1]
           - rhs[1:K])
    assert float(res.abs().max()) < 1e-10
