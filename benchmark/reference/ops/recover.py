"""RK stage bookkeeping and large-step variable recovery.

The port of `mpas_tpu.ops.recover`: atm_rk_integration_setup,
atm_set_smlstep_pert_variables, atm_recover_large_step_variables,
atm_rk_dynamics_substep_finish and atm_compute_moist_coefficients. All fields are level-major [K, N] (core/state.py).

Reference defects corrected in mpas_tpu, and kept here:
  - ru = ru_save + ru_p;
  - the interface flux in the w recovery is fzm*ru(k) + fzp*ru(k-1);
  - the w recovery separates the normalize and metric-add steps;
  - atm_srk3 actually calls the recovery.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import constants
from . import stencils as st


@dataclasses.dataclass
class RKSave:
    """State snapshots taken at the top of each dynamics substep."""
    ru_save: Any        # [K, E]
    u_2: Any            # [K, E]
    rw_save: Any        # [K+1, C]
    rtheta_p_save: Any  # [K, C]
    rho_p_save: Any     # [K, C]
    w_2: Any            # [K+1, C]
    theta_m_save: Any   # [K, C] (theta_m_2)
    rho_zz_2: Any       # [K, C]
    rho_zz_old_split: Any  # [K, C]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def rk_integration_setup(state) -> RKSave:
    return RKSave(
        ru_save=state.ru, u_2=state.u, rw_save=state.rw,
        rtheta_p_save=state.rtheta_p, rho_p_save=state.rho_p,
        w_2=state.w, theta_m_save=state.theta_m, rho_zz_2=state.rho_zz,
        rho_zz_old_split=state.rho_zz,
    )


def compute_moist_coefficients(state, mesh):
    """qtot, cqw (interface slots 1..K-1), cqu; the dry limit (no scalars)
    gives qtot = 0 and cqw = cqu = 1 exactly."""
    if state.scalars is None:
        return state.replace(qtot=torch.zeros_like(state.theta_m),
                             cqw=torch.ones_like(state.cqw),
                             cqu=torch.ones_like(state.cqu))
    # moist: sum the water species (index 0 = qv by convention)
    qtot = torch.sum(state.scalars, dim=0)                   # [K, C]
    q_i = 0.5 * (qtot[1:] + qtot[:-1])                       # interfaces 1..K-1
    cqw = torch.cat([torch.ones_like(qtot[:1]), 1.0 / (1.0 + q_i)], dim=0)
    q1, q2 = st.edge_pair(qtot, mesh.cellsOnEdge)
    cqu = 1.0 / (1.0 + 0.5 * (q1 + q2))
    return state.replace(qtot=qtot, cqw=cqw, cqu=cqu)


def set_smlstep_pert_variables(tend, static, mesh, vert):
    """Convert the large-step w tendency to the coupled perturbation form
    used by the acoustic solver: subtract the sloping-coordinate metric
    transport implied by tend_u, then couple with zz at interfaces."""
    Kp1 = tend.tend_w.shape[0]
    flux_e = st.interface_interp(tend.tend_u, vert.fzm, vert.fzp)    # [K+1, E]
    metric = st.zb_metric(flux_e, mesh.edgesOnCell, mesh.edgesOnCellSign,
                            static.zb_cell, static.zb3_cell)
    zz_i = st.interface_interp(static.zz, vert.fzm, vert.fzp)
    tend_w = (tend.tend_w - metric) * zz_i
    tend_w[0] = 0.0
    tend_w[Kp1 - 1] = 0.0
    return tend.replace(tend_w=tend_w)


def recover_large_step_variables(state, ac, ruAvg, wwAvg, save, static, mesh,
                                 vert, nl, ns: int, rk_step: int, dt):
    """Recover the full prognostic state from the acoustic perturbations."""
    K, C = state.theta_m.shape
    rgas, p0 = constants.rgas, constants.p0
    rcv = constants.rcv
    fzm, fzp = vert.fzm, vert.fzp
    inv_ns = 1.0 / float(ns)

    rho_p = save.rho_p_save + ac.rho_pp
    rho_zz = rho_p + static.rho_base

    wwAvg = save.rw_save + wwAvg * inv_ns
    rw = save.rw_save + ac.rw_p

    if rk_step == 2:
        rtheta_p = (save.rtheta_p_save + ac.rtheta_pp
                    - dt * rho_zz * state.rt_diabatic_tend)
        theta_m = (rtheta_p + static.rtheta_base) / rho_zz
        exner = (static.zz * (rgas / p0) * (rtheta_p + static.rtheta_base)) ** rcv
        pressure_p = static.zz * rgas * (exner * rtheta_p + static.rtheta_base
                                         * (exner - static.exner_base))
    else:
        rtheta_p = save.rtheta_p_save + ac.rtheta_pp
        theta_m = (rtheta_p + static.rtheta_base) / rho_zz
        exner = state.exner
        pressure_p = state.pressure_p

    ruAvg = save.ru_save + ruAvg * inv_ns
    ru = save.ru_save + ac.ru_p
    rz1, rz2 = st.edge_pair(rho_zz, mesh.cellsOnEdge)
    u = 2.0 * ru / (rz1 + rz2)

    # --- diagnose w from rho*omega (Klemp et al 2003 flux-divergence form) ---
    zz_i = st.interface_interp(static.zz, fzm, fzp)                  # [K+1, C]
    w = torch.zeros_like(rw)
    w[1:K] = rw[1:K] / zz_i[1:K]

    # edge fluxes: surface via cf1..3 extrapolation, interior via fzm/fzp
    flux_e = st.interface_interp(ru, fzm, fzp)                       # [K+1, E]
    flux_e[0] = vert.cf1 * ru[0] + vert.cf2 * ru[1] + vert.cf3 * ru[2]

    metric = st.zb_metric(flux_e, mesh.edgesOnCell, mesh.edgesOnCellSign,
                            static.zb_cell, static.zb3_cell)
    w = w + metric                                                   # adds surface row too

    rho_i = st.interface_interp(rho_zz, fzm, fzp)
    rho_sfc = (vert.cf1 * rho_zz[0] + vert.cf2 * rho_zz[1]
               + vert.cf3 * rho_zz[2])
    w[0] = w[0] / rho_sfc
    w[1:K] = w[1:K] / rho_i[1:K]
    w[K] = 0.0

    return state.replace(
        u=u, w=w, theta_m=theta_m, rho_zz=rho_zz, ru=ru, rw=rw,
        rho_p=rho_p, rtheta_p=rtheta_p, exner=exner, pressure_p=pressure_p,
        ruAvg=ruAvg, wwAvg=wwAvg)


def rk_dynamics_substep_finish(state, save: RKSave, dynamics_substep: int,
                               dynamics_split: int, ruAvg_split, wwAvg_split):
    """Dynamics-split bookkeeping between/after substeps.
    Returns (state', save', ruAvg_split', wwAvg_split')."""
    inv_split = 1.0 / float(dynamics_split)

    if dynamics_substep < dynamics_split:
        save = save.replace(ru_save=state.ru, rw_save=state.rw,
                            rtheta_p_save=state.rtheta_p, rho_p_save=state.rho_p)
        state = state.replace(u=save.u_2, w=save.w_2, theta_m=save.theta_m_save,
                              rho_zz=save.rho_zz_2)

    if dynamics_substep == 1:
        ruAvg_split = state.ruAvg
        wwAvg_split = state.wwAvg
    else:
        ruAvg_split = state.ruAvg + ruAvg_split
        wwAvg_split = state.wwAvg + wwAvg_split

    if dynamics_substep == dynamics_split:
        state = state.replace(ruAvg=ruAvg_split * inv_split,
                              wwAvg=wwAvg_split * inv_split,
                              rho_zz=save.rho_zz_old_split)

    return state, save, ruAvg_split, wwAvg_split
