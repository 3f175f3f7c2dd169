"""Large-step tendencies: the atm_compute_dyn_tend rebuild.

The port of `mpas_tpu.ops.tendencies`, in stencil form and (with
`config_cell_form_ops`) in cell form: U section (pressure
gradient, vertical transport, nonlinear Coriolis, KE gradient, curvature,
del2/del4 mixing, Rayleigh damping), W section (horizontal 3rd-order
advection, curvature, mixing, vertical advection, buoyancy), THETA section
(flux-form advection, perturbation flux, mixing, vertical advection,
diabatic coupling). Every horizontal reduction goes through
`stencils.slot_reduce`, so through the gather-reduce kernel on the card.

Reference defects corrected in mpas_tpu, and kept here: separate tend_w
and flux temporaries; the `tend *= invAreaCell - rdzu*(...)` precedence
bugs unrolled; the Coriolis q accumulation runs once per level; Smagorinsky
kdiff uses per-level deformations; interior wdtz uses flux3.

Mixing (Euler) tendencies are computed on the first RK step only and reused
on steps 2/3, carried in the returned Tend.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import constants
from . import stencils as st


@dataclasses.dataclass
class Tend:
    tend_u: Any          # [K, E]
    tend_w: Any          # [K+1, C]
    tend_theta: Any      # [K, C]
    tend_rho: Any        # [K, C]
    h_divergence: Any    # [K, C]
    # rk_step-0 caches reused on later RK steps
    tend_u_euler: Any    # [K, E]
    tend_w_euler: Any    # [K+1, C]
    tend_theta_euler: Any  # [K, C]
    kdiff: Any           # [K, C]
    dpdz: Any            # [K, C]
    # diagnostics for physics couplings
    rthdynten: Any       # [K, C]
    # tangential velocity (stencil form): the Coriolis term's weighted
    # edgesOnEdge sum of u IS Thuburn's v, so the reduce is shared with
    # compute_solve_diagnostics; None in cell form
    v: Any = None        # [K, E]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _smagorinsky_kdiff(state, mesh, nl, invDt, v=None):
    """Horizontal Smagorinsky eddy viscosity; u and v share one
    gather-reduce (their weight lists hold the same two tensors)."""
    v = state.v if v is None else v
    (ua, ub), (vb, va) = st.slot_reduce(
        mesh.edgesOnCell, [(state.u, [mesh.defc_a, mesh.defc_b]),
                           (v, [mesh.defc_b, mesh.defc_a])])
    d_diag = ua - vb
    d_off = ub + va
    c_s = nl.config_smagorinsky_coef
    ld = nl.config_len_disp
    kdiff = torch.clamp(
        (c_s * ld) ** 2 * torch.sqrt(d_diag ** 2 + d_off ** 2),
        max=0.01 * ld ** 2 * invDt)
    if nl.config_mpas_cam_coef > 0.0:
        # 2nd-order filter floor in the top 3 levels (CAM-SE style)
        K = kdiff.shape[0]
        base = 2.0833 * ld * nl.config_mpas_cam_coef
        floor = torch.zeros(K, dtype=kdiff.dtype, device=kdiff.device)
        floor[K - 3], floor[K - 2], floor[K - 1] = base, 2 * base, 4 * base
        kdiff = torch.maximum(kdiff, floor[:, None])
    return kdiff


def compute_dyn_tend(state, save, static, mesh, vert, nl, rk_step: int,
                     dt: float, prev: Tend | None = None) -> Tend:
    K, C = state.theta_m.shape
    fzm, fzp, rdzw, rdzu = vert.fzm, vert.fzp, vert.rdzw, vert.rdzu
    coe = mesh.cellsOnEdge
    eoc = mesh.edgesOnCell
    inv_r_earth = 1.0 / getattr(nl, "config_sphere_radius",
                                constants.sphere_radius)
    omega_pl = constants.omega if getattr(nl, "config_coriolis", True) else 0.0
    prandtl_inv = 1.0 / constants.prandtl
    invDt = 1.0 / dt

    sign_dv = mesh.edgesOnCellSign * mesh.dvEdge[eoc]                 # [C, M]
    sign_only = mesh.edgesOnCellSign
    cell_form = getattr(nl, "config_cell_form_ops", False)

    # ---- nonlinear Coriolis edgesOnEdge reduction (stencil form): its
    # weighted sum of u IS the Thuburn tangential velocity, returned in
    # Tend.v ----
    if not cell_form:
        W_eoe = mesh.weightsOnEdge * mesh.edgesOnEdge_mask
        ((su,), (supv,)) = st.slot_reduce(
            mesh.edgesOnEdge, [(state.u, [W_eoe]),
                               (state.u * state.pv_edge, [W_eoe])])
        v_tan = su
    else:
        su = supv = v_tan = None

    # ---- packed cell-field edge pairs ----
    zz1, zz2 = st.edge_pair_m(mesh, static.zz)
    if rk_step == 0:
        kdiff0 = (torch.zeros_like(state.theta_m)
                  if nl.config_horiz_mixing == "2d_fixed"
                  else _smagorinsky_kdiff(state, mesh, nl, invDt, v=v_tan))
        zero_row_c = torch.zeros((1, C), dtype=kdiff0.dtype,
                                 device=kdiff0.device)
        kdiff_i = torch.cat(
            [zero_row_c, 0.5 * (kdiff0[1:] + kdiff0[:-1]), zero_row_c],
            dim=0)                                                     # [K+1, C]
        ((pp1, pp2), (ke1, ke2), (tm1, tm2), (div1, div2), (kd1, kd2),
         (w1, w2), (rw1, rw2), (kdi1, kdi2)) = st.edge_pairs_m(
            mesh, state.pressure_p, state.ke, state.theta_m,
            state.divergence, kdiff0, state.w, state.rw, kdiff_i)
    else:
        ((pp1, pp2), (ke1, ke2), (tm1, tm2), (w1, w2),
         (rw1, rw2)) = st.edge_pairs_m(
            mesh, state.pressure_p, state.ke, state.theta_m, state.w, state.rw)
    rw_e = 0.5 * (rw1 + rw2)                                           # [K+1, E]

    # ---- horizontal 3rd-order advective edge values ----
    ru_edge_w = st.interface_interp(state.ru, fzm, fzp)                # [K+1, E]
    if cell_form:
        # per-cell directional Hessians + flat slot gathers (identical
        # arithmetic to adv_coefs . q)
        Dc_t, Dc_w = st.dir_second_deriv(mesh.dirHess, mesh.cellsOnCell,
                                         state.theta_m, state.w)
        D1t, D2t = st.edge_slot_pair(Dc_t, coe, mesh.slotOnCell)
        D1w, D2w = st.edge_slot_pair(Dc_w, coe, mesh.slotOnCell)
        adv_scale = (mesh.dvEdge * mesh.dcEdge ** 2 / 12.0)[None, :]   # [1, E]
        c3 = nl.config_coef_3rd_order
        flux_arr_t = (0.5 * mesh.dvEdge[None, :] * (tm1 + tm2)
                      - adv_scale * ((D1t + D2t)
                                     + torch.sign(state.ru) * c3 * (D1t - D2t)))
        flux_arr_w = (0.5 * mesh.dvEdge[None, :] * (w1 + w2)
                      - adv_scale * ((D1w + D2w)
                                     + torch.sign(ru_edge_w) * c3 * (D1w - D2w)))
    else:
        # advCellsForEdge slot reductions over the neighbour slots; slots
        # 0/1 are cell1/cell2 and their theta/w values are the edge pairs
        # above
        a2 = mesh.advCellsForEdge[:, 2:]
        c_n, c3_n = mesh.adv_coefs[:, 2:], mesh.adv_coefs_3rd[:, 2:]
        ((bt, tt), (bw, tw)) = st.slot_reduce(
            a2, [(state.theta_m, [c_n, c3_n]), (state.w, [c_n, c3_n])])
        c0, c1 = mesh.adv_coefs[:, 0][None, :], mesh.adv_coefs[:, 1][None, :]
        d0, d1 = (mesh.adv_coefs_3rd[:, 0][None, :],
                  mesh.adv_coefs_3rd[:, 1][None, :])
        bt = c0 * tm1 + c1 * tm2 + bt
        tt = d0 * tm1 + d1 * tm2 + tt
        bw = c0 * w1 + c1 * w2 + bw
        tw = d0 * w1 + d1 * w2 + tw
        flux_arr_t = bt + torch.sign(state.ru) * tt
        flux_arr_w = bw + torch.sign(ru_edge_w) * tw

    # ---- perturbation theta flux needs theta_m_save edge values first ----
    if rk_step > 0:
        (ts1, ts2), = st.edge_pairs_m(mesh, save.theta_m_save)
        pert = (save.ru_save - state.ru) * 0.5 * (ts1 + ts2)           # [K, E]

    # ---- main edge->cell sums ----
    flux_w_e = ru_edge_w * flux_arr_w                                  # [K+1, E]
    flux_t_e = state.ru * flux_arr_t                                   # [K, E]
    specs = [(state.ru, [sign_dv]), (flux_w_e, [sign_only]),
             (flux_t_e, [sign_only])]
    if rk_step > 0:
        specs.append((pert, [sign_dv]))
    red = st.slot_reduce_m(mesh, eoc, specs)
    if cell_form:
        gu_slots = st.slot_gather(eoc, state.u)
        gupv_slots = st.slot_gather(eoc, state.u * state.pv_edge)
    h_divergence = red[0][0] * mesh.invAreaCell[None, :]
    tend_w = -red[1][0]                                                # [K+1, C]
    tend_theta = -red[2][0]                                            # [K, C]
    if rk_step > 0:
        tend_theta = tend_theta - red[3][0]

    if rk_step == 0:
        tend_rho = (-h_divergence - rdzw[:, None] * st.delta(state.rw)
                    + state.tend_rho_physics)
        dpdz = -constants.gravity * (static.rho_base * state.qtot
                                     + save.rho_p_save * (1.0 + state.qtot))
    else:
        tend_rho, dpdz = prev.tend_rho, prev.dpdz

    # ---- mixing coefficients (rk_step 0 only) ----
    if rk_step == 0:
        kdiff = kdiff0
        if nl.config_horiz_mixing == "2d_smagorinsky":
            h_mom_eddy_visc4 = nl.config_visc4_2dsmag * nl.config_len_disp ** 3
            h_theta_eddy_visc4 = h_mom_eddy_visc4
        else:
            h_mom_eddy_visc4 = nl.config_h_mom_eddy_visc4
            h_theta_eddy_visc4 = nl.config_h_theta_eddy_visc4
    else:
        kdiff = prev.kdiff

    # ---- edge pairs of cell fields computed within this call ----
    if rk_step == 0:
        (dpdz1, dpdz2), (hd1, hd2) = st.edge_pairs_m(mesh, dpdz, h_divergence)
    else:
        (hd1, hd2), = st.edge_pairs_m(mesh, h_divergence)

    # =================== U section ===================
    if rk_step == 0:
        tend_u_euler = -state.cqu * (
            (pp2 - pp1) * mesh.invDcEdge[None, :] / (0.5 * (zz1 + zz2))
            - 0.5 * static.zxu * (dpdz1 + dpdz2))
    else:
        tend_u_euler = prev.tend_u_euler

    # vertical transport of u
    wduz = st.vflux_mass_to_iface(state.u, rw_e, fzm, fzp, 1.0)
    tend_u = -rdzw[:, None] * st.delta(wduz)

    # nonlinear Coriolis / PV flux (Ringler et al JCP 2009):
    #   q[e] = sum_w W[e,w] * u[eoe] * 0.5*(pv[e] + pv[eoe])
    # split into 0.5*pv[e]*(sum W u) + 0.5*(sum W u*pv)
    if cell_form:
        # both sums come from the per-cell tangential matrices applied to
        # the slot-gathered u / u*pv values, read back per edge by slot-pair
        # gathers
        t_u = st.cell_tangential(mesh.tanWeights, gu_slots)
        t_upv = st.cell_tangential(mesh.tanWeights, gupv_slots)
        tu1, tu2 = st.edge_slot_pair(t_u, coe, mesh.slotOnCell)
        tupv1, tupv2 = st.edge_slot_pair(t_upv, coe, mesh.slotOnCell)
        q = 0.5 * state.pv_edge * (tu1 + tu2) + 0.5 * (tupv1 + tupv2)
    else:
        q = 0.5 * state.pv_edge * su + 0.5 * supv

    tend_u = tend_u + state.rho_edge * (q - (ke2 - ke1) * mesh.invDcEdge[None, :]) \
        - state.u * 0.5 * (hd1 + hd2)

    # curvature terms for the sphere
    if nl.config_curvature:
        w_avg = 0.25 * (w1[:-1] + w1[1:] + w2[:-1] + w2[1:])           # [K, E]
        tend_u = tend_u - (2.0 * omega_pl * torch.cos(mesh.angleEdge)
                           * torch.cos(mesh.latEdge))[None, :] * state.rho_edge * w_avg \
            - state.u * w_avg * state.rho_edge * inv_r_earth

    # ---- horizontal/vertical mixing for u (first RK step only) ----
    if rk_step == 0:
        # del^2 u as grad(divergence) - curl(vorticity)
        vort1 = torch.index_select(state.vorticity, 1, mesh.verticesOnEdge[:, 0])
        vort2 = torch.index_select(state.vorticity, 1, mesh.verticesOnEdge[:, 1])
        r_dc = mesh.invDcEdge[None, :]
        r_dv = torch.minimum(mesh.invDvEdge, 4.0 * mesh.invDcEdge)[None, :]
        u_diffusion = (div2 - div1) * r_dc - (vort2 - vort1) * r_dv
        delsq_u = u_diffusion
        tend_u_euler = tend_u_euler + (state.rho_edge * 0.5 * (kd1 + kd2)
                                       * u_diffusion * mesh.meshScalingDel2[None, :])

        # ---- mixing edge fields for the del^2 sums of u, w and theta and
        # their kdiff-scaled variants. MPAS uses (rho_edge(k) +
        # rho_edge(k-1)) at the interface, a plain sum ----
        zero_row_e = torch.zeros((1, state.rho_edge.shape[1]),
                                 dtype=state.rho_edge.dtype,
                                 device=state.rho_edge.device)
        rho_sum = torch.cat(
            [zero_row_e, state.rho_edge[1:] + state.rho_edge[:-1], zero_row_e],
            dim=0)
        edge_sign_w = (0.5 * mesh.invAreaCell[:, None] * sign_dv
                       * mesh.invDcEdge[eoc])                          # [C, M]
        w_turb = rho_sum * (w2 - w1)                                   # [K+1, E]
        kd_e = 0.5 * (kdi1 + kdi2)
        w_turb_k = w_turb * kd_e * mesh.meshScalingDel2[None, :]

        edge_sign_t = (mesh.invAreaCell[:, None] * sign_dv
                       * mesh.invDcEdge[eoc])                          # [C, M]
        theta_turb = (tm2 - tm1) * state.rho_edge                      # [K, E]
        kd_e2 = 0.5 * (kd1 + kd2)
        theta_turb_k = theta_turb * kd_e2 * (prandtl_inv * mesh.meshScalingDel2[None, :])

        ((delsq_w,), (tend_w_euler,), (delsq_theta,), (tend_theta_euler,),
         (du_sum,)) = st.slot_reduce_m(
            mesh, eoc, [(w_turb, [edge_sign_w]), (w_turb_k, [edge_sign_w]),
                        (theta_turb, [edge_sign_t]), (theta_turb_k, [edge_sign_t]),
                        (delsq_u, [sign_dv])])
        delsq_divergence = du_sum * mesh.invAreaCell[None, :]

        # del^4 = del^2(del^2)
        if h_mom_eddy_visc4 > 0.0 or h_theta_eddy_visc4 > 0.0:
            w_vort = mesh.edgesOnVertexSign * mesh.dcEdge[mesh.edgesOnVertex]
            delsq_vorticity = (st.sum_edges_to_vertex(delsq_u, mesh.edgesOnVertex, w_vort)
                               * mesh.invAreaTriangle[None, :])
            dv_v1 = torch.index_select(delsq_vorticity, 1, mesh.verticesOnEdge[:, 0])
            dv_v2 = torch.index_select(delsq_vorticity, 1, mesh.verticesOnEdge[:, 1])
            ((dd1, dd2), (dw1, dw2), (dt1, dt2)) = st.edge_pairs_m(
                mesh, delsq_divergence, delsq_w, delsq_theta)
            u_mix_scale = mesh.meshScalingDel4[None, :] * h_mom_eddy_visc4
            r_dc4 = u_mix_scale * nl.config_del4u_div_factor * mesh.invDcEdge[None, :]
            r_dv4 = u_mix_scale * torch.minimum(mesh.invDvEdge, 4.0 * mesh.invDcEdge)[None, :]
            u_diffusion4 = state.rho_edge * ((dd2 - dd1) * r_dc4
                                             - (dv_v2 - dv_v1) * r_dv4)
            tend_u_euler = tend_u_euler - u_diffusion4

            edge_sign_w4 = (h_mom_eddy_visc4 * mesh.invAreaCell[:, None] * sign_dv
                            * (mesh.invDcEdge * mesh.meshScalingDel4)[eoc])
            edge_sign_t4 = (h_theta_eddy_visc4 * prandtl_inv
                            * mesh.invAreaCell[:, None] * sign_dv
                            * (mesh.invDcEdge * mesh.meshScalingDel4)[eoc])
            ((ddw_sum,), (ddt_sum,)) = st.slot_reduce_m(
                mesh, eoc, [(dw2 - dw1, [edge_sign_w4]),
                            (dt2 - dt1, [edge_sign_t4])])
            tend_w_euler = tend_w_euler - ddw_sum
            tend_theta_euler = tend_theta_euler - ddt_sum

        # vertical 2nd-order mixing of u (perturbation form by default)
        if nl.config_v_mom_eddy_visc2 > 0.0:
            zg1 = torch.index_select(static.zgrid, 1, coe[:, 0])      # [K+1, E]
            zg2 = torch.index_select(static.zgrid, 1, coe[:, 1])
            z_edge = 0.5 * (zg1 + zg2)
            zmid = 0.5 * (z_edge[:-1] + z_edge[1:])
            if nl.config_mix_full:
                um = state.u
            else:
                um = state.u - (vert.u_init[:, None] * torch.cos(mesh.angleEdge)[None, :]
                                + vert.v_init[:, None] * torch.sin(mesh.angleEdge)[None, :])
            dzp = zmid[2:] - zmid[1:-1]
            dzm = zmid[1:-1] - zmid[:-2]
            mix = (nl.config_v_mom_eddy_visc2 * state.rho_edge[1:-1]
                   * ((um[2:] - um[1:-1]) / dzp
                      - (um[1:-1] - um[:-2]) / dzm) / (0.5 * (dzp + dzm)))
            tend_u_euler = tend_u_euler.clone()
            tend_u_euler[1:-1] += mix
    else:
        tend_u_euler = prev.tend_u_euler
        tend_w_euler = prev.tend_w_euler
        tend_theta_euler = prev.tend_theta_euler

    # Rayleigh damping on u
    if nl.config_rayleigh_damp_u:
        ndamp = nl.config_number_rayleigh_damp_u_levels
        rcoef = 1.0 / (ndamp * nl.config_rayleigh_damp_u_timescale_days
                       * constants.seconds_per_day)
        lev = torch.arange(K, dtype=tend_u.dtype, device=tend_u.device)
        coef = torch.clamp(lev - (K - ndamp) + 1.0, min=0.0) * rcoef
        tend_u = tend_u - state.rho_edge * state.u * coef[:, None]

    tend_u = tend_u + tend_u_euler + state.tend_ru_physics

    # =================== W section ===================
    zero_row = torch.zeros((1, C), dtype=tend_w.dtype, device=tend_w.device)

    # vertical advection of w
    wdwz = st.vflux_iface_to_mass(state.w, state.rw, 1.0)              # [K, C]
    d_wdwz = torch.cat([zero_row, st.delta(wdwz), zero_row], dim=0)    # [K+1, C]
    tend_w = tend_w * mesh.invAreaCell[None, :] - rdzu[:, None] * d_wdwz

    # curvature terms, added after the flux-divergence normalization
    if nl.config_curvature:
        rho_i = st.interface_interp(state.rho_zz, fzm, fzp)            # [K+1, C]
        ur_i = st.interface_interp(state.uReconstructZonal, fzm, fzp)
        vr_i = st.interface_interp(state.uReconstructMeridional, fzm, fzp)
        curv = (rho_i * (ur_i ** 2 + vr_i ** 2) * inv_r_earth
                + 2.0 * omega_pl * torch.cos(mesh.latCell)[None, :] * ur_i * rho_i)
        tend_w = tend_w + curv

    if rk_step == 0:
        # pressure gradient + buoyancy (dpdz) for w
        dpp = torch.cat([zero_row, st.delta(state.pressure_p), zero_row], dim=0)
        dpdz_i = st.interface_interp(dpdz, fzm, fzp)
        cqw_i = torch.cat([zero_row, state.cqw[1:], zero_row], dim=0)
        tend_w_euler = tend_w_euler - cqw_i * (rdzu[:, None] * dpp - dpdz_i)

        if nl.config_v_mom_eddy_visc2 > 0.0:
            rho_sum_c = state.rho_zz[1:] + state.rho_zz[:-1]           # [K-1, C]
            d_up = (state.w[2:] - state.w[1:-1]) * rdzw[1:, None]
            d_dn = (state.w[1:-1] - state.w[:-2]) * rdzw[:-1, None]
            mixw = (nl.config_v_mom_eddy_visc2 * rho_sum_c * 0.5
                    * (d_up - d_dn) * rdzu[1:K, None])
            tend_w_euler = tend_w_euler.clone()
            tend_w_euler[1:K] += mixw

    tend_w = tend_w + tend_w_euler
    # w is prognosed on interior interfaces only
    tend_w[0] = 0.0
    tend_w[K] = 0.0

    # =================== THETA section ===================
    if rk_step == 0:
        if nl.config_v_theta_eddy_visc2 > 0.0:
            tm = state.theta_m if nl.config_mix_full else state.theta_m - static.t_init
            zmid_c = 0.5 * (static.zgrid[:-1] + static.zgrid[1:])
            dzp = zmid_c[2:] - zmid_c[1:-1]
            dzm = zmid_c[1:-1] - zmid_c[:-2]
            mixt = (nl.config_v_theta_eddy_visc2 * prandtl_inv * state.rho_zz[1:-1]
                    * ((tm[2:] - tm[1:-1]) / dzp
                       - (tm[1:-1] - tm[:-2]) / dzm) / (0.5 * (dzp + dzm)))
            tend_theta_euler = tend_theta_euler.clone()
            tend_theta_euler[1:-1] += mixt

    # vertical advection + acoustic-consistency correction (wdtz)
    wdtz = st.vflux_mass_to_iface(state.theta_m, state.rw, fzm, fzp,
                                  nl.config_coef_3rd_order)            # [K+1, C]
    theta_save_i = st.interface_interp(save.theta_m_save, fzm, fzp)
    wdtz = wdtz + (save.rw_save - state.rw) * theta_save_i
    # top interface K-1 uses the pure save form (rtheta_pp redefinition)
    wdtz[K - 1] = save.rw_save[K - 1] * theta_save_i[K - 1]

    tend_theta = tend_theta * mesh.invAreaCell[None, :] - rdzw[:, None] * st.delta(wdtz)
    rthdynten = tend_theta / state.rho_zz
    tend_theta = tend_theta + state.rho_zz * state.rt_diabatic_tend
    tend_theta = tend_theta + tend_theta_euler + state.tend_rtheta_physics

    return Tend(tend_u=tend_u, tend_w=tend_w, tend_theta=tend_theta,
                tend_rho=tend_rho, h_divergence=h_divergence,
                tend_u_euler=tend_u_euler, tend_w_euler=tend_w_euler,
                tend_theta_euler=tend_theta_euler, kdiff=kdiff, dpdz=dpdz,
                rthdynten=rthdynten, v=v_tan)
