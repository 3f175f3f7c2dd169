"""Acoustic substeps: vertically implicit gravity/acoustic-wave integration.

The port of `mpas_tpu.ops.acoustic`: atm_compute_vert_imp_coefs,
atm_advance_acoustic_step and atm_divergence_damping_3d (Klemp et al. MWR
2007: forward-backward horizontal, implicit vertical with off-centering
epssm, implicit Rayleigh w damping from Klemp et al. 2008).

Layout: all fields are level-major (core/state.py). The recurrences over K
are Python loops over [C]-wide rows. The column section of each acoustic
substep (rs/ts assembly, implicit solve, damping, recovery) is one call of
ops/acoustic_column.py: the CUDA kernel on the card, its plain version on
the CPU.

Reference defects corrected in mpas_tpu, and kept here:
  - the horizontal momentum (pressure-gradient) update is implemented;
  - the tridiagonal solve performs both the forward sweep and the
    back-substitution;
  - b_tri uses cofwt(k-1) in its second difference term;
  - the acoustic right-hand sides use the dyn_tend tendencies.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import constants
from . import stencils as st
from .acoustic_column import acoustic_column_update


@dataclasses.dataclass
class ImplicitCoefs:
    """Tridiagonal coefficients for the vertically implicit w solve."""
    cofrz: Any      # [K]      mass levels
    cofwr: Any      # [K+1, C] interfaces (1..K-1)
    cofwz: Any      # [K+1, C]
    coftz: Any      # [K+1, C]
    cofwt: Any      # [K, C]   mass levels
    a_tri: Any      # [K+1, C]
    alpha_tri: Any  # [K+1, C]
    gamma_tri: Any  # [K+1, C]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class AcousticState:
    """Perturbation variables advanced by the acoustic loop."""
    ru_p: Any           # [K, E]
    rho_pp: Any         # [K, C]
    rtheta_pp: Any      # [K, C]
    rtheta_pp_old: Any  # [K, C]
    rw_p: Any           # [K+1, C]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def compute_vert_imp_coefs(state, static, vert, nl, dts) -> ImplicitCoefs:
    """Coefficients for the implicit acoustic/gravity-wave solve; the
    alpha/gamma LU recurrence is a loop over the vertical."""
    K, C = state.theta_m.shape
    fzm, fzp, rdzw, rdzu = vert.fzm, vert.fzp, vert.rdzw, vert.rdzu
    g = constants.gravity
    rcv = constants.rcv
    c2 = constants.cp * rcv
    dtseps = 0.5 * dts * (1.0 + nl.config_epssm)

    cofrz = dtseps * rdzw                                       # [K]

    zz_i = st.interface_interp(static.zz, fzm, fzp)             # [K+1, C]
    exner_i = st.interface_interp(state.exner, fzm, fzp)
    theta_i = st.interface_interp(state.theta_m, fzm, fzp)

    cofwr = 0.5 * dtseps * g * zz_i
    # cqw is stored at interface slots 1..K-1 (row k = interface k)
    zero = torch.zeros((1, C), dtype=zz_i.dtype, device=zz_i.device)
    cqw_i = torch.cat([zero, state.cqw[1:], zero], dim=0)
    cofwz = dtseps * c2 * zz_i * rdzu[:, None] * cqw_i * exner_i
    coftz = dtseps * theta_i
    cofwt = (0.5 * dtseps * rcv * static.zz * g * static.rho_base
             / (1.0 + state.qtot) * state.exner
             / ((static.rtheta_base + state.rtheta_p) * static.exner_base))

    # tridiagonal rows at interfaces k = 1..K-1
    km = slice(1, K)
    zz = static.zz
    a_int = (-cofwz[km] * coftz[0:K - 1] * rdzw[0:K - 1, None] * zz[0:K - 1]
             + cofwr[km] * cofrz[0:K - 1, None]
             - cofwt[0:K - 1] * coftz[0:K - 1] * rdzw[0:K - 1, None])
    b_int = (1.0 + cofwz[km] * (coftz[km] * rdzw[1:K, None] * zz[1:K]
                                + coftz[km] * rdzw[0:K - 1, None] * zz[0:K - 1])
             - coftz[km] * (cofwt[1:K] * rdzw[1:K, None]
                            - cofwt[0:K - 1] * rdzw[0:K - 1, None])
             + cofwr[km] * (cofrz[1:K, None] - cofrz[0:K - 1, None]))
    c_int = (-cofwz[km] * coftz[2:K + 1] * rdzw[1:K, None] * zz[1:K]
             - cofwr[km] * cofrz[1:K, None]
             + cofwt[1:K] * coftz[2:K + 1] * rdzw[1:K, None])
    a_tri = torch.zeros_like(cofwr)
    a_tri[km] = a_int

    # LU factors: alpha(k) = 1/(b(k) - a(k)*gamma(k-1)); gamma(k) = c(k)*alpha(k)
    alpha_tri = torch.zeros_like(a_tri)
    gamma_tri = torch.zeros_like(a_tri)
    gamma_prev = torch.zeros_like(a_int[0])
    for j in range(K - 1):
        alpha_k = 1.0 / (b_int[j] - a_int[j] * gamma_prev)
        gamma_prev = c_int[j] * alpha_k
        alpha_tri[j + 1] = alpha_k
        gamma_tri[j + 1] = gamma_prev

    return ImplicitCoefs(cofrz=cofrz, cofwr=cofwr, cofwz=cofwz, coftz=coftz,
                         cofwt=cofwt, a_tri=a_tri, alpha_tri=alpha_tri,
                         gamma_tri=gamma_tri)


def _tridiag_solve(rhs, coefs: ImplicitCoefs):
    """Solve the pre-factored tridiagonal system for rw_p on interfaces
    1..K-1 (rows 0 and K are 0): forward substitution then
    back-substitution, each a loop over the level axis with [C]-wide rows."""
    K = rhs.shape[0] - 1
    w = torch.zeros_like(rhs)
    w_prev = torch.zeros_like(rhs[0])
    for k in range(1, K):
        w_prev = (rhs[k] - coefs.a_tri[k] * w_prev) * coefs.alpha_tri[k]
        w[k] = w_prev
    w_next = torch.zeros_like(rhs[0])
    for k in range(K - 1, 0, -1):
        w_next = w[k] - coefs.gamma_tri[k] * w_next
        w[k] = w_next
    return w


def _stage_constant_edge_pairs(state, static, mesh):
    """Stacked edge pairs of the fields constant within one RK stage (zz,
    exner, theta_m). The JAX reference relies on XLA to share them across
    the substeps; here each substep gathers them again."""
    return st.edge_pairs(mesh.cellsOnEdge, static.zz, state.exner,
                         state.theta_m)


def advance_acoustic_step(ac: AcousticState, ruAvg, wwAvg, tend, coefs,
                          state, save, static, mesh, vert, nl, dts,
                          small_step: int, damp_previous: bool = False):
    """One forward-backward acoustic substep. Returns (ac', ruAvg', wwAvg').
    Step 0 initializes the perturbation state from the large-step
    tendencies.

    `damp_previous`: apply the 3-D divergence damping of the PREVIOUS
    substep's ru_p here, folding its rtheta_pp difference into this
    substep's stacked pressure-gradient gather. The caller applies a
    standalone damping after the final substep."""
    K, C = ac.rho_pp.shape
    epssm = nl.config_epssm
    c2 = constants.cp * constants.rcv
    g = constants.gravity

    (zz1, zz2), (ex1, ex2), (th1, th2) = _stage_constant_edge_pairs(
        state, static, mesh)

    if small_step != 0:
        if damp_previous:
            (rtpp1, rtpp2), (rpp1, rpp2), (dpp1, dpp2) = st.edge_pairs(
                mesh.cellsOnEdge, ac.rtheta_pp, ac.rho_pp,
                ac.rtheta_pp - ac.rtheta_pp_old)
            coef_d = 2.0 * nl.config_smdiv * nl.config_len_disp / dts
            ru_p_in = ac.ru_p + coef_d * (dpp1 - dpp2) / (th1 + th2)
        else:
            (rtpp1, rtpp2), (rpp1, rpp2) = st.edge_pairs(
                mesh.cellsOnEdge, ac.rtheta_pp, ac.rho_pp)
            ru_p_in = ac.ru_p
        pgrad = ((rtpp2 - rtpp1) * mesh.invDcEdge[None, :]) / (0.5 * (zz1 + zz2))
        pgrad = state.cqu * 0.5 * c2 * (ex1 + ex2) * pgrad
        pgrad = pgrad + 0.5 * static.zxu * g * (rpp1 + rpp2)
        ru_p = ru_p_in + dts * (tend.tend_u - pgrad)
        ruAvg = ruAvg + ru_p
        rtheta_pp_old = ac.rtheta_pp
        rho_pp, rtheta_pp, rw_p = ac.rho_pp, ac.rtheta_pp, ac.rw_p
    else:
        ru_p = dts * tend.tend_u
        ruAvg = ru_p
        rtheta_pp_old = torch.zeros_like(ac.rtheta_pp)
        rho_pp = torch.zeros_like(ac.rho_pp)
        rtheta_pp = torch.zeros_like(ac.rtheta_pp)
        rw_p = torch.zeros_like(ac.rw_p)
        wwAvg = torch.zeros_like(wwAvg)

    # --- cell column update ---
    # horizontal divergence of ru_p into mass & theta right-hand sides
    theta_e = 0.5 * (th1 + th2)                                         # [K, E]
    sign_dv = mesh.edgesOnCellSign * mesh.dvEdge[mesh.edgesOnCell]
    wdiv = dts * mesh.invAreaCell[None, :]
    ((ru_sum,), (rut_sum,)) = st.slot_reduce(
        mesh.edgesOnCell,
        [(ru_p, [sign_dv]), (ru_p * theta_e, [sign_dv])])
    rs0 = -wdiv * ru_sum
    ts0 = -wdiv * rut_sum

    zz_i = st.interface_interp(static.zz, vert.fzm, vert.fzp)
    rho_i = st.interface_interp(state.rho_zz, vert.fzm, vert.fzp)
    zero = torch.zeros((1, C), dtype=static.zz.dtype, device=static.zz.device)
    dss_i = torch.cat([zero, static.dss[1:], zero], dim=0)
    rho_pp_n, rtheta_pp_n, rw_p_n, wwAvg_n = acoustic_column_update(
        rs0 + dts * tend.tend_rho, ts0 + dts * tend.tend_theta,
        rho_pp, rtheta_pp, rw_p, wwAvg, None, None, tend.tend_w,
        coefs, static.zz, dss_i, zz_i * rho_i, state.w,
        save.rw_save - state.rw, dts, epssm)
    ac_new = AcousticState(ru_p=ru_p, rho_pp=rho_pp_n, rtheta_pp=rtheta_pp_n,
                           rtheta_pp_old=rtheta_pp_old, rw_p=rw_p_n)
    return ac_new, ruAvg, wwAvg_n


def divergence_damping_3d(ac: AcousticState, state, mesh, nl, dts,
                          static=None):
    """Scaled 3-D divergence damping of ru_p:
    ru_p += coef * d(rtheta_pp - rtheta_pp_old)/dx / theta_edge.
    The theta_m edge pair comes from the stage-constant pack when `static`
    is given, else from its own gather."""
    coef = 2.0 * nl.config_smdiv * nl.config_len_disp / dts
    dpp = ac.rtheta_pp - ac.rtheta_pp_old
    dpp1, dpp2 = st.edge_pair(dpp, mesh.cellsOnEdge)
    if static is not None:
        _, _, (th1, th2) = _stage_constant_edge_pairs(state, static, mesh)
    else:
        th1, th2 = st.edge_pair(state.theta_m, mesh.cellsOnEdge)
    ru_p = ac.ru_p + coef * (dpp1 - dpp2) / (th1 + th2)
    return ac.replace(ru_p=ru_p)
