"""Diagnostic operators: solve_diagnostics, velocity reconstruction, coupled
state initialization, output diagnostics.

The port of `mpas_tpu.ops.diagnostics` (atm_compute_solve_diagnostics,
mpas_reconstruct_2d, atm_init_coupled_diagnostics,
atm_compute_output_diagnostics) over level-major [K, N] fields. Reference defects corrected in mpas_tpu, and kept here: divergence
accumulates s * u; the tangential-velocity sum includes all nEdgesOnEdge
terms; rho_edge is computed.
"""

from __future__ import annotations

import torch

from .. import constants
from . import stencils as st


def compute_solve_diagnostics(state, mesh, reconstruct_v: bool = True):
    """Returns dict of updated diagnostic fields:
    ke, divergence, vorticity, pv_edge, rho_edge, v (if reconstruct_v)."""
    u = state.u
    h = state.rho_zz

    rho_edge = st.avg_cell_to_edge(h, mesh.cellsOnEdge)

    # circulation -> relative vorticity at vertices
    w_vortex = mesh.edgesOnVertexSign * mesh.dcEdge[mesh.edgesOnVertex]
    vorticity = st.sum_edges_to_vertex(u, mesh.edgesOnVertex, w_vortex)
    vorticity = vorticity * mesh.invAreaTriangle[None, :]

    # divergence and cell kinetic energy share the slot-gathered u
    w_div = (mesh.edgesOnCellSign * mesh.dvEdge[mesh.edgesOnCell]
             * mesh.invAreaCell[:, None])
    w_ke = (0.25 * mesh.edgesOnCell_mask * mesh.invAreaCell[:, None]
            * (mesh.dcEdge * mesh.dvEdge)[mesh.edgesOnCell])
    gu_slots = st.slot_gather(mesh.edgesOnCell, u)
    divergence = sum(w_div[:, m][None, :] * gu_slots[m]
                     for m in range(len(gu_slots)))
    ke = sum(w_ke[:, m][None, :] * gu_slots[m] ** 2
             for m in range(len(gu_slots)))

    out = dict(ke=ke, divergence=divergence, vorticity=vorticity,
               rho_edge=rho_edge)

    # tangential velocities (Thuburn et al JCP 2009)
    if reconstruct_v:
        out["v"] = st.edges_on_edge_sum(u, mesh.edgesOnEdge,
                                        mesh.weightsOnEdge,
                                        mesh.edgesOnEdge_mask)

    # potential vorticity at vertices and edges (dry: no 1/h factor)
    pv_vertex = mesh.fVertex[None, :] + vorticity
    out["pv_edge"] = st.sum_vertices_to_edge(pv_vertex, mesh.verticesOnEdge)
    return out


def reconstruct_velocity(u, mesh):
    """Cell-center zonal/meridional wind from edge normal velocities
    (tangent-plane LSQ coefficients, mesh/coefficients.py)."""
    ((ux, uy, uz),) = st.slot_reduce(
        mesh.edgesOnCell,
        [(u, [mesh.coeffs_reconstruct[..., 0],
              mesh.coeffs_reconstruct[..., 1],
              mesh.coeffs_reconstruct[..., 2]])])
    clat = torch.cos(mesh.latCell)[None, :]
    slat = torch.sin(mesh.latCell)[None, :]
    clon = torch.cos(mesh.lonCell)[None, :]
    slon = torch.sin(mesh.lonCell)[None, :]
    zonal = -ux * slon + uy * clon
    meridional = -(ux * clon + uy * slon) * slat + uz * clat
    return zonal, meridional


def init_coupled_diagnostics(state, static, mesh, vert):
    """Derive the coupled state (ru, rw, rho_p, rtheta_p, exner, pressure)
    from the uncoupled initial condition. Expects state.rho_zz to hold
    physical rho on input (divided by zz here)."""
    rgas, cp, p0 = constants.rgas, constants.cp, constants.p0
    rcv = rgas / (cp - rgas)

    rho_zz = state.rho_zz / static.zz
    ru = st.avg_cell_to_edge(rho_zz, mesh.cellsOnEdge) * state.u

    # rw = rho*omega from w and ru (inverse of the recover procedure)
    zz_i = st.interface_interp(static.zz, vert.fzm, vert.fzp)         # [K+1, C]
    rho_i = st.interface_interp(rho_zz, vert.fzm, vert.fzp)
    rw = state.w * rho_i * zz_i

    # subtract the sloping-coordinate metric transport
    flux_e = st.interface_interp(ru, vert.fzm, vert.fzp)              # [K+1, E]
    metric = st.zb_metric(flux_e, mesh.edgesOnCell, mesh.edgesOnCellSign,
                            static.zb_cell, static.zb3_cell)            # [K+1, C]
    rw = rw - metric * zz_i

    rho_p = rho_zz - static.rho_base
    rtheta_p = (state.theta_m * rho_p
                + static.rho_base * (state.theta_m - static.theta_base))
    exner = (static.zz * (rgas / p0) * (rtheta_p + static.rtheta_base)) ** rcv
    pressure_p = static.zz * rgas * (exner * rtheta_p
                                     + static.rtheta_base * (exner - static.exner_base))
    return state.replace(rho_zz=rho_zz, ru=ru, rw=rw, rho_p=rho_p,
                         rtheta_p=rtheta_p, exner=exner, pressure_p=pressure_p)


def output_diagnostics(state, static):
    """rho, theta, full pressure for output."""
    rho = state.rho_zz * static.zz
    qv = state.scalars[0] if state.scalars is not None else 0.0
    theta = state.theta_m / (1.0 + constants.rvord * qv)
    pressure = static.pressure_base + state.pressure_p
    return dict(rho=rho, theta=theta, pressure=pressure)
