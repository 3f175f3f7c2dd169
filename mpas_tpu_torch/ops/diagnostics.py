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


def compute_solve_diagnostics(state, mesh, hollingsworth: bool = False,
                              reconstruct_v: bool = True,
                              cell_form: bool = False,
                              apvm_upwinding: float = 0.0, dt: float = 0.0):
    """Returns dict of updated diagnostic fields:
    ke, divergence, vorticity, pv_edge, rho_edge, v (if reconstruct_v).

    `cell_form`: compute the tangential velocity via the per-cell Thuburn
    matrices (mesh.tanWeights + slot gathers) instead of the edgesOnEdge
    reduction: identical arithmetic.

    `apvm_upwinding` > 0 applies the anticipated-potential-vorticity
    upwinding of pv_edge (Ringler et al. JCP 2010 eq. 72):
    pv_edge -= apvm*dt*(v*gradPVt + u*gradPVn). `dt` is required (> 0)
    whenever apvm_upwinding > 0."""
    if apvm_upwinding > 0.0 and not dt > 0.0:
        raise ValueError(
            f"apvm_upwinding={apvm_upwinding} requires dt > 0 (got {dt}); "
            "a zero dt silently disables the APVM correction")
    u = state.u
    h = state.rho_zz

    rho_edge = st.avg_cell_to_edge_m(mesh, h)

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

    # vertex -> cell weights of the two options below: kite areas, a mesh
    # constant (MeshArrays.kiteAreaOnCell)
    w_kite = None
    if hollingsworth or apvm_upwinding > 0.0:
        w_kite = mesh.kiteAreaOnCell * mesh.edgesOnCell_mask

    if hollingsworth:
        # AG's KE construction: blend the cell KE with the kite-weighted
        # vertex KE
        ke_edge = (mesh.dcEdge * mesh.dvEdge)[None, :] * u * u
        r = 0.25 * mesh.invAreaTriangle[None, :]
        ke_vertex = st.sum_edges_to_vertex(
            ke_edge, mesh.edgesOnVertex,
            torch.ones_like(mesh.edgesOnVertexSign)) * r
        ke_fact = 1.0 - 0.375
        ke = ke * ke_fact
        ((kv_sum,),) = st.slot_reduce(mesh.verticesOnCell,
                                      [(ke_vertex, [w_kite])])
        ke = ke + (1.0 - ke_fact) * mesh.invAreaCell[None, :] * kv_sum

    out = dict(ke=ke, divergence=divergence, vorticity=vorticity,
               rho_edge=rho_edge)

    # tangential velocities (Thuburn et al JCP 2009)
    if reconstruct_v:
        if cell_form:
            t_u = st.cell_tangential(mesh.tanWeights, gu_slots)
            tu1, tu2 = st.edge_slot_pair(t_u, mesh.cellsOnEdge,
                                         mesh.slotOnCell)
            out["v"] = tu1 + tu2
        else:
            out["v"] = st.edges_on_edge_sum(u, mesh.edgesOnEdge,
                                            mesh.weightsOnEdge,
                                            mesh.edgesOnEdge_mask)

    # potential vorticity at vertices and edges (dry: no 1/h factor)
    pv_vertex = mesh.fVertex[None, :] + vorticity
    pv_edge = st.sum_vertices_to_edge(pv_vertex, mesh.verticesOnEdge)

    if apvm_upwinding > 0.0:
        # anticipated PV: advect pv_edge upstream by apvm*dt along the full
        # (normal u, tangential v) edge velocity
        pvv1 = torch.index_select(pv_vertex, 1, mesh.verticesOnEdge[:, 0])
        pvv2 = torch.index_select(pv_vertex, 1, mesh.verticesOnEdge[:, 1])
        gradPVt = (pvv2 - pvv1) / mesh.dvEdge[None, :]
        ((pvc_sum,),) = st.slot_reduce(mesh.verticesOnCell,
                                       [(pv_vertex, [w_kite])])
        pv_cell = mesh.invAreaCell[None, :] * pvc_sum
        gradPVn = st.diff_cell_to_edge_m(mesh, pv_cell) / mesh.dcEdge[None, :]
        # With reconstruct_v=False (RK stages 1-2 in srk3) this reuses the
        # stage-0 tangential velocity state.v while u and pv are of the
        # current stage, as MPAS does: v is refreshed only where
        # solve_diagnostics reconstructs it, and the APVM term is a small
        # dissipative correction insensitive to an O(dt) lag.
        v_edge = out.get("v", state.v)
        pv_edge = pv_edge - apvm_upwinding * dt * (v_edge * gradPVt
                                                   + u * gradPVn)

    out["pv_edge"] = pv_edge
    return out


def reconstruct_velocity(u, mesh):
    """Cell-center zonal/meridional wind from edge normal velocities
    (tangent-plane LSQ coefficients, mesh/coefficients.py)."""
    ((ux, uy, uz),) = st.slot_reduce_m(
        mesh, mesh.edgesOnCell,
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
    ru = st.avg_cell_to_edge_m(mesh, rho_zz) * state.u

    # rw = rho*omega from w and ru (inverse of the recover procedure)
    zz_i = st.interface_interp(static.zz, vert.fzm, vert.fzp)         # [K+1, C]
    rho_i = st.interface_interp(rho_zz, vert.fzm, vert.fzp)
    rw = state.w * rho_i * zz_i

    # subtract the sloping-coordinate metric transport
    flux_e = st.interface_interp(ru, vert.fzm, vert.fzp)              # [K+1, E]
    metric = st.zb_metric_m(mesh, flux_e, mesh.edgesOnCellSign,
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
