"""The fused vertically-implicit acoustic column update, as plain PyTorch.

It assembles rs/ts with resm off-centring, builds the implicit-w right-hand
side, runs the forward and backward substitution with the pre-factored
a_tri/alpha_tri/gamma_tri, applies the implicit Rayleigh damping,
accumulates wwAvg and recovers rho_pp/rtheta_pp. All arrays are level-major
[K, C] / [K+1, C]; `coefs.cofrz` is [K].
"""

from __future__ import annotations

import torch


def acoustic_column_update_plain(rs0, ts0, ac_rho_pp, ac_rtheta_pp, ac_rw_p,
                                 wwAvg, tend_rho, tend_rt, tend_w, coefs, zz,
                                 dss_i, zz_rho_i, w, dw_save, dts: float,
                                 epssm: float):
    """The plain PyTorch version, step for step the TPU kernel's arithmetic.
    `tend_rho`/`tend_rt` may be None (read as zero)."""
    K, C = rs0.shape
    resm = (1.0 - epssm) / (1.0 + epssm)
    rho_pp, rtheta_pp, rw_p = ac_rho_pp, ac_rtheta_pp, ac_rw_p
    cofrz = coefs.cofrz.reshape(K, 1).to(rs0.dtype)
    coftz = coefs.coftz

    d_rwp = rw_p[1:K + 1] - rw_p[0:K]
    rs = rho_pp if tend_rho is None else rho_pp + dts * tend_rho
    rs = rs + rs0 - cofrz * resm * d_rwp
    ctz_rwp = coftz * rw_p
    dtseps = 0.5 * dts * (1.0 + epssm)
    rdzw = cofrz / dtseps                     # [K, 1] (cofrz = dtseps * rdzw)
    ts = rtheta_pp if tend_rt is None else rtheta_pp + dts * tend_rt
    ts = ts + ts0 - resm * rdzw * (ctz_rwp[1:K + 1] - ctz_rwp[0:K])

    cofwz, cofwr, cofwt = coefs.cofwz, coefs.cofwr, coefs.cofwt
    zz_ts = zz * ts
    zz_rtpp = zz * rtheta_pp
    rhs = (rw_p[1:K] + dts * tend_w[1:K]
           - cofwz[1:K] * ((zz_ts[1:K] - zz_ts[0:K - 1])
                           + resm * (zz_rtpp[1:K] - zz_rtpp[0:K - 1]))
           - cofwr[1:K] * ((rs[1:K] + rs[0:K - 1])
                           + resm * (rho_pp[1:K] + rho_pp[0:K - 1]))
           + cofwt[1:K] * (ts[1:K] + resm * rtheta_pp[1:K])
           + cofwt[0:K - 1] * (ts[0:K - 1] + resm * rtheta_pp[0:K - 1]))
    # rhs rows are interfaces 1..K-1

    a_tri, alpha_tri, gamma_tri = coefs.a_tri, coefs.alpha_tri, coefs.gamma_tri
    rows = []
    w_prev = torch.zeros_like(rs0[0])
    for k in range(1, K):
        w_prev = (rhs[k - 1] - a_tri[k] * w_prev) * alpha_tri[k]
        rows.append(w_prev)
    w_next = torch.zeros_like(w_prev)
    outs = [None] * (K - 1)
    for k in range(K - 1, 0, -1):
        w_next = rows[k - 1] - gamma_tri[k] * w_next
        outs[k - 1] = w_next
    # [K-1, C] interfaces 1..K-1 (none for K = 1)
    w_solved = torch.stack(outs, dim=0) if outs else rhs

    sl = slice(1, K)
    damped = ((w_solved + dw_save[sl]
               - dts * dss_i[sl] * zz_rho_i[sl] * w[sl])
              / (1.0 + dts * dss_i[sl]) - dw_save[sl])
    zero = torch.zeros_like(rs0[:1])
    rw_p_new = torch.cat([zero, damped, zero], dim=0)
    wwAvg_new = wwAvg + torch.cat(
        [zero, 0.5 * (1.0 - epssm) * rw_p[sl] + 0.5 * (1.0 + epssm) * damped,
         zero], dim=0)

    d_rwp_new = rw_p_new[1:K + 1] - rw_p_new[0:K]
    rho_pp_new = rs - cofrz * d_rwp_new
    ctz_new = coftz * rw_p_new
    rtheta_pp_new = ts - rdzw * (ctz_new[1:K + 1] - ctz_new[0:K])
    return rho_pp_new, rtheta_pp_new, rw_p_new, wwAvg_new


def acoustic_column_update(rs0, ts0, ac_rho_pp, ac_rtheta_pp, ac_rw_p, wwAvg,
                           tend_rho, tend_rt, tend_w, coefs, zz, dss_i,
                           zz_rho_i, w, dw_save, dts: float, epssm: float):
    """Returns (rho_pp, rtheta_pp, rw_p, wwAvg)."""
    return acoustic_column_update_plain(
        rs0, ts0, ac_rho_pp, ac_rtheta_pp, ac_rw_p, wwAvg, tend_rho, tend_rt,
        tend_w, coefs, zz, dss_i, zz_rho_i, w, dw_save, dts, epssm)
