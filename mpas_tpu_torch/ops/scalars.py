"""Scalar (moisture) transport on the time-averaged acoustic mass fluxes.

The port of `mpas_tpu.ops.scalars` (atm_advance_scalars /
atm_advance_scalars_mono): flux-form advection of the scalar array using
ruAvg / wwAvg accumulated over the acoustic substeps, with

  - a 3rd-order horizontal flux via the adv_coefs stencil (or its cell
    form) and flux3 vertical transport (`advance_scalars`), and
  - a monotonic (Zalesak FCT) variant that limits the high-order correction
    against local min/max bounds, guaranteeing positivity for moisture
    (`advance_scalars_mono`), expressed scatter-free with gathers.

Both preserve a constant: the density used in the update is advanced with
the same discrete fluxes, so scalar == 1 stays exactly 1.

Layout: scalars are species-major [nS, K, C]. Where mpas_tpu maps one
species at a time (`jax.vmap`), all species go through each operator
together here: a horizontal operator sees them folded into the level axis,
[nS*K, C] (a view; the gather-reduce kernel takes any number of levels),
and a vertical operator works on [nS, K, C] along dim 1
(ops/stencils.py), so no species reads another's levels. The arithmetic of
each species is that of the one-species form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import stencils as st


def _mass_divergence(ruAvg, wwAvg, mesh, rdzw):
    """rho update implied by the averaged fluxes: drho = -div(ruAvg) -
    d(wwAvg)/dzeta, returned as the per-dt tendency."""
    sign_dv = mesh.edgesOnCellSign * mesh.dvEdge[mesh.edgesOnCell]
    h_div = st.sum_edges_to_cell_m(mesh, ruAvg, sign_dv) \
        * mesh.invAreaCell[None, :]
    return -h_div - rdzw[:, None] * st.delta(wwAvg)


def _fold(x):
    """[nS, K, N] -> [nS*K, N] (a view of a contiguous stack)."""
    return x.reshape(-1, x.shape[-1])


def _high_order_edge_value(q, flow_sign, mesh, nl):
    """3rd/4th-order edge value of every species: q [nS, K, C], flow_sign
    [K, E] -> [nS, K, E], in stencil or cell form."""
    nS, K, _ = q.shape
    sign_f = flow_sign.repeat(nS, 1)                      # [nS*K, E]
    if getattr(nl, "config_cell_form_ops", False):
        fe = st.adv_flux_on_edge_cellform(_fold(q), sign_f, mesh,
                                          nl.config_coef_3rd_order)
    else:
        fe = st.adv_flux_on_edge(_fold(q), sign_f, mesh.advCellsForEdge,
                                 mesh.adv_coefs, mesh.adv_coefs_3rd)
    return fe.view(nS, K, -1)


def _edges_to_cell(mesh, f_e, weights):
    """sum_edges_to_cell_m of every species: f_e [nS, K, E] -> [nS, K, C]."""
    nS, K, _ = f_e.shape
    return st.sum_edges_to_cell_m(mesh, _fold(f_e).contiguous(),
                                  weights).view(nS, K, -1)


def _zero_ends(f):
    """f [nS, K+1, C] with interfaces 0 and K set to zero, in place; `f` is
    always a tensor made here, never one of the caller's."""
    f[:, 0] = 0.0
    f[:, -1] = 0.0
    return f


def advance_scalars(scalars, rho_zz_old, ruAvg, wwAvg, mesh, vert, nl, dt):
    """3rd-order (non-monotonic) scalar update.

    scalars [nS, K, C]; returns (scalars_new, rho_zz_new)."""
    rdzw, fzm, fzp = vert.rdzw, vert.fzm, vert.fzp
    rho_new = rho_zz_old + dt * _mass_divergence(ruAvg, wwAvg, mesh, rdzw)

    q = scalars.contiguous()
    fe = _high_order_edge_value(q, torch.sign(ruAvg), mesh, nl)
    h_tend = -_edges_to_cell(mesh, ruAvg * fe, mesh.edgesOnCellSign) \
        * mesh.invAreaCell[None, :]
    wq = st.vflux_mass_to_iface(q, wwAvg, fzm, fzp, nl.config_coef_3rd_order)
    v_tend = -rdzw[:, None] * st.delta(wq)
    return (q * rho_zz_old + dt * (h_tend + v_tend)) / rho_new, rho_new


def advance_scalars_mono(scalars, rho_zz_old, ruAvg, wwAvg, mesh, vert, nl, dt):
    """Monotonic (FCT-limited) scalar update, the MPAS default for moisture.

    Low-order solution: first-order upwind fluxes (positivity-preserving).
    High-order correction: (3rd-order flux - upwind flux), limited per edge
    by the Zalesak factors computed from local min/max bounds."""
    nS, K, C = scalars.shape
    rdzw, fzm, fzp = vert.rdzw, vert.fzm, vert.fzp
    eoc = mesh.edgesOnCell
    inv_area = mesh.invAreaCell[None, :]
    sign_only = mesh.edgesOnCellSign
    M = eoc.shape[1]
    shape_e = (nS, K, ruAvg.shape[1])

    rho_new = rho_zz_old + dt * _mass_divergence(ruAvg, wwAvg, mesh, rdzw)
    flow_sign = torch.sign(ruAvg)
    up = 0.5 * (1.0 + flow_sign)          # 1 if flow from cell1 -> cell2

    q = scalars.contiguous()
    q1, q2 = (g.view(shape_e) for g in st.edge_pair_m(mesh, _fold(q)))

    # ---- low-order (upwind) fluxes ----
    f_low_e = ruAvg * (up * q1 + (1.0 - up) * q2) * mesh.dvEdge[None, :]
    # vertical upwind: interface k advects q[k-1] if wwAvg>0 else q[k]; the
    # pad is along each species' own level axis
    qk = F.pad(q, (0, 0, 0, 1))                   # q[k] for k<K
    qkm1 = F.pad(q, (0, 0, 1, 0))                 # q[k-1]
    f_low_v = _zero_ends(wwAvg * torch.where(wwAvg > 0, qkm1, qk))

    h_low = -_edges_to_cell(mesh, f_low_e, sign_only) * inv_area
    v_low = -rdzw[:, None] * st.delta(f_low_v)
    rq_td = q * rho_zz_old + dt * (h_low + v_low)   # transported-diffused
    q_td = rq_td / rho_new

    # ---- high-order fluxes and anti-diffusive corrections ----
    f_high_e = ruAvg * _high_order_edge_value(q, flow_sign, mesh, nl)
    a_e = f_high_e - f_low_e                        # [nS, K, E]
    f_high_v = st.vflux_mass_to_iface(q, wwAvg, fzm, fzp,
                                      nl.config_coef_3rd_order)
    a_v = _zero_ends(f_high_v - f_low_v)

    # ---- Zalesak limiter bounds from neighborhood min/max ----
    big = 1e30
    valid = mesh.edgesOnCell_mask > 0
    q_max_h = None
    q_min_h = None
    for m in range(M):
        g = st.gather(_fold(q), mesh.cellsOnCell[:, m]).view(nS, K, C)
        gm = torch.where(valid[:, m], g, -big)
        gn = torch.where(valid[:, m], g, big)
        q_max_h = gm if q_max_h is None else torch.maximum(q_max_h, gm)
        q_min_h = gn if q_min_h is None else torch.minimum(q_min_h, gn)
    q_up = torch.cat([q[:, 1:], q[:, -1:]], dim=1)         # level above
    q_dn = torch.cat([q[:, :1], q[:, :-1]], dim=1)         # level below
    q_max = torch.maximum(torch.maximum(q, q_max_h), torch.maximum(q_up, q_dn))
    q_min = torch.minimum(torch.minimum(q, q_min_h), torch.minimum(q_up, q_dn))
    q_max = torch.maximum(q_max, q_td)
    q_min = torch.minimum(q_min, q_td)

    # net in/out anti-diffusive fluxes per cell (per-slot gathers; the
    # inflow contribution to the cell is -sign*flux when positive)
    p_in_h = None
    p_out_h = None
    a_e_f = _fold(a_e)
    for m in range(M):
        g = st.gather(a_e_f, eoc[:, m]).view(nS, K, C)
        signed = mesh.edgesOnCellSign[:, m] * g
        pi = torch.clamp(-signed, min=0.0)
        po = torch.clamp(signed, min=0.0)
        p_in_h = pi if p_in_h is None else p_in_h + pi
        p_out_h = po if p_out_h is None else p_out_h + po
    # vertical: d/dzeta contributes -(a_v[k+1]-a_v[k]) * rdzw
    a_top = a_v[:, 1:]      # interface above mass level
    a_bot = a_v[:, :-1]
    p_in_v = torch.clamp(-a_top, min=0.0) + torch.clamp(a_bot, min=0.0)
    p_out_v = torch.clamp(a_top, min=0.0) + torch.clamp(-a_bot, min=0.0)

    p_in = dt * (p_in_h * inv_area + p_in_v * rdzw[:, None])
    p_out = dt * (p_out_h * inv_area + p_out_v * rdzw[:, None])

    tiny = 1e-30
    r_plus = torch.clamp((q_max - q_td) * rho_new / (p_in + tiny), max=1.0)
    r_minus = torch.clamp((q_td - q_min) * rho_new / (p_out + tiny), max=1.0)
    r_plus = torch.clamp(r_plus, min=0.0)
    r_minus = torch.clamp(r_minus, min=0.0)

    # edge limiter: min of donor r_minus and receiver r_plus; one stacked
    # gather serves both limiter fields
    (rp1, rp2), (rm1, rm2) = (
        (a.view(shape_e), b.view(shape_e))
        for a, b in st.edge_pairs_m(mesh, _fold(r_plus), _fold(r_minus)))
    # positive a_e moves mass from cell1 to cell2
    lim_e = torch.where(a_e > 0, torch.minimum(rm1, rp2),
                        torch.minimum(rm2, rp1))
    a_e_lim = lim_e * a_e
    # vertical at interface k: positive a_v moves from k-1 to k
    rpk = F.pad(r_plus, (0, 0, 0, 1))
    rpkm = F.pad(r_plus, (0, 0, 1, 0))
    rmk = F.pad(r_minus, (0, 0, 0, 1))
    rmkm = F.pad(r_minus, (0, 0, 1, 0))
    lim_v = torch.where(a_v > 0, torch.minimum(rmkm, rpk),
                        torch.minimum(rmk, rpkm))
    a_v_lim = _zero_ends(lim_v * a_v)

    h_corr = -_edges_to_cell(mesh, a_e_lim, sign_only) * inv_area
    v_corr = -rdzw[:, None] * st.delta(a_v_lim)
    return (rq_td + dt * (h_corr + v_corr)) / rho_new, rho_new
