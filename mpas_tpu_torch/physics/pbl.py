"""Surface-layer fluxes + K-profile boundary-layer mixing (YSU-lite).

The port of `mpas_tpu.physics.pbl`: everything is columnar, elementwise on
level-major [K, C] tensors plus a tridiagonal solve over the (small)
vertical.

Physics (the classic formulations, reduced to their cores):

  * Surface layer: bulk aerodynamic fluxes with Louis (1979) stability
    functions over a uniform water-like lower boundary at skin temperature
    `config_sst` and roughness `config_roughness`:
        Cd = fm(Rib) * (k / ln(z1/z0))^2,   Ch = fh(Rib) * Cd-shape
        tau = rho Cd |V| u,   H = rho cp Ch |V| (th_skin - th_1)
  * PBL height: first interface where the bulk Richardson number from the
    lowest level exceeds Ric = 0.25 (Troen & Mahrt 1986 diagnosis).
  * K-profile: Km(z) = k u* z (1 - z/h)^2 inside the PBL (YSU's
    first-order closure without the countergradient/entrainment terms),
    Kh = Km / Pr, plus a small local-Ri background above the PBL.
  * Implicit (backward-Euler) vertical diffusion of theta, qv and
    edge-normal u via a Thomas solve; the surface drag on u is folded
    implicitly into the lowest row.

Coupling matches physics/kessler.py: update theta/u/scalars, rediagnose
the coupled thermodynamic state from the equation of state.
"""

from __future__ import annotations

import math

import torch

from .. import constants
from ..ops import stencils as st
from .kessler import rediagnose

KARMAN = 0.4
RIC = 0.25          # critical bulk Richardson number for the PBL top
PRANDTL = 1.0       # PBL Prandtl number (YSU surface value ~0.8-1.0)
B_LOUIS = 9.4       # Louis (1979) constants
C_STAR = 7.4


def _louis_fm_fh(rib, z1, z0):
    """Louis (1979) stability functions of the bulk Richardson number:
    unstable  f = 1 + b|Ri| / (1 + c sqrt(|Ri|)),
              c = C* b (k/ln(z1/z0))^2 sqrt(z1/z0)   (bounded as Ri -> -inf)
    stable    f = 1 / (1 + b/2 Ri)^2."""
    lnz = torch.log(z1 / z0)
    cd_n = (KARMAN / lnz) ** 2
    c = C_STAR * B_LOUIS * cd_n * torch.sqrt(z1 / z0)
    absri = torch.abs(rib)
    unstable = 1.0 + B_LOUIS * absri / (1.0 + c * torch.sqrt(absri))
    stable = 1.0 / (1.0 + 0.5 * B_LOUIS * torch.clamp(rib, min=0.0)) ** 2
    fm = torch.where(rib < 0.0, unstable, stable)
    return fm, fm  # fh = fm at this reduction level


def surface_and_kprofile(theta, u_cell_sq, zgrid, rho, nl):
    """Surface exchange coefficients, u*, PBL height and the K profiles.

    theta [K, C] dry potential temperature; u_cell_sq [K, C] squared wind
    speed at cell centers; zgrid [K+1, C]; rho [K, C].
    Returns (Km_i, Kh_i [K+1, C] interface diffusivities with zero top/bottom
    rows, ustar [C], wth_sfc [C] kinematic heat flux, drag [C] = Cd*|V|)."""
    K, C = theta.shape
    g = constants.gravity
    z0 = nl.config_roughness
    zsfc = zgrid[0]
    zmid = 0.5 * (zgrid[:-1] + zgrid[1:]) - zsfc[None, :]   # AGL mass levels
    z1 = zmid[0]
    # flux wind-speed floor (WRF-style): keeps the bulk Ri and the exchange
    # coefficients bounded in calm columns
    spd1 = torch.sqrt(torch.clamp(u_cell_sq[0], min=1.0))

    th_skin = (torch.full_like(z1, nl.config_sst) if nl.config_sst > 0.0
               else theta[0])
    rib_s = g * (theta[0] - th_skin) * z1 / (theta[0] * spd1 ** 2)
    lnz = torch.log(z1 / z0)
    fm, fh = _louis_fm_fh(rib_s, z1, z0)
    cd_n = (KARMAN / lnz) ** 2
    drag = cd_n * fm * spd1                                  # Cd |V|  [m/s]
    ustar = torch.sqrt(cd_n * fm) * spd1
    wth_sfc = cd_n * fh * spd1 * (th_skin - theta[0])        # K m/s

    # PBL height: first interface above which bulk Ri exceeds RIC
    spd2 = torch.clamp(u_cell_sq, min=1e-4)
    rib = g * (theta - theta[0:1]) * zmid / (theta[0:1] * spd2)
    above = rib > RIC
    any_above = torch.any(above, dim=0)
    kh_top = torch.argmax(above.to(torch.int8), dim=0)       # first True
    h = torch.where(any_above,
                    torch.gather(zmid, 0, kh_top[None, :])[0], zmid[-1])
    h = torch.maximum(h, 1.5 * z1)

    # K profile on interior interfaces (1..K-1)
    z_i = zgrid[1:-1] - zsfc[None, :]                        # [K-1, C] AGL
    shape = torch.clamp(1.0 - z_i / h[None, :], min=0.0) ** 2
    km = KARMAN * ustar[None, :] * z_i * shape
    # weakly-stable background above the PBL: local-Ri mixing, capped
    dz_i = zmid[1:] - zmid[:-1]
    dth = (theta[1:] - theta[:-1]) / dz_i
    du2 = torch.clamp((torch.sqrt(spd2[1:]) - torch.sqrt(spd2[:-1])) ** 2
                      / dz_i ** 2, min=1e-8)
    ri_loc = g / theta[1:] * dth / du2
    l_mix = 30.0
    km_bg = (l_mix ** 2 * torch.sqrt(du2)
             * torch.clamp(1.0 - ri_loc / RIC, min=0.0) ** 2)
    km = torch.maximum(km, torch.clamp(km_bg, max=100.0))
    zero = torch.zeros((1, C), dtype=theta.dtype, device=theta.device)
    km_i = torch.cat([zero, km, zero], dim=0)                # [K+1, C]
    return km_i, km_i / PRANDTL, ustar, wth_sfc, drag


def implicit_diffusion(x, k_i, rho, rho_i, zgrid, dt,
                       sfc_flux=None, sfc_drag=None):
    """Backward-Euler d(rho x)/dt = d/dz(rho_i K dx/dz) on mass levels.

    k_i/rho_i at interfaces [K+1, N]; `sfc_flux` [N] is a kinematic surface
    flux (x m/s) added explicitly to the lowest level; `sfc_drag` [N]
    (= Cd|V|, m/s) applies implicit surface friction to the lowest level.
    Thomas algorithm: 2 K sequential rows, each a few [N]-wide operations.
    The columns are independent, so several fields that share the
    coefficients may be stacked along N (apply_pbl does so for theta and
    qv)."""
    K, _ = x.shape
    dzw = zgrid[1:] - zgrid[:-1]                             # [K, N]
    zmid = 0.5 * (zgrid[:-1] + zgrid[1:])
    dzu = zmid[1:] - zmid[:-1]                               # [K-1, N]

    cond = rho_i[1:K] * k_i[1:K] / dzu                       # [K-1, N]
    zero = torch.zeros_like(x[:1])
    up = torch.cat([cond, zero], dim=0)                      # flux to k+1
    dn = torch.cat([zero, cond], dim=0)                      # flux to k-1
    inv = dt / (rho * dzw)
    a = -inv * dn                                            # couples k-1
    c = -inv * up                                            # couples k+1
    b = 1.0 - a - c                                          # a fresh tensor
    rhs = x
    if sfc_drag is not None:
        b[0] += inv[0] * rho[0] * sfc_drag
    if sfc_flux is not None:
        rhs = x.clone()
        rhs[0] += inv[0] * rho[0] * sfc_flux

    # forward elimination
    cps, dps = [], []
    cp_prev = dp_prev = zero[0]
    for k in range(K):
        den = b[k] - a[k] * cp_prev
        cp_prev = c[k] / den
        dp_prev = (rhs[k] - a[k] * dp_prev) / den
        cps.append(cp_prev)
        dps.append(dp_prev)
    # back substitution
    xs = [None] * K
    x_next = zero[0]
    for k in range(K - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        xs[k] = x_next
    return torch.stack(xs, dim=0)


def apply_pbl(state, static, vert, mesh, nl, dt: float):
    """Couple the surface layer + PBL diffusion into the step (the pattern
    of physics/kessler.apply_kessler): diffuse theta/qv/u, apply surface
    fluxes, rediagnose the coupled thermodynamic state."""
    qv = state.scalars[0] if state.scalars is not None else None
    theta = (state.theta_m / (1.0 + constants.rvord * qv)
             if qv is not None else state.theta_m)
    rho = state.rho_zz * static.zz
    C = theta.shape[1]

    u2 = state.uReconstructZonal ** 2 + state.uReconstructMeridional ** 2
    km_i, kh_i, ustar, wth, drag = surface_and_kprofile(
        theta, u2, static.zgrid, rho, nl)
    rho_i = st.interface_interp(rho, vert.fzm, vert.fzp)     # a fresh tensor
    rho_i[0] = rho[0]
    rho_i[-1] = rho[-1]

    if qv is None:
        theta_new = implicit_diffusion(theta, kh_i, rho, rho_i, static.zgrid,
                                       dt, sfc_flux=wth)
        qv_new = None
    else:
        if nl.config_sst > 0.0:
            # ocean-like moisture flux with Ce = Ch toward saturation at SST
            es = 610.78 * math.exp(17.27 * (nl.config_sst - 273.15)
                                   / (nl.config_sst - 35.85))
            psfc = (static.pressure_base + state.pressure_p)[0]
            qsat = 0.622 * es / torch.clamp(psfc - es, min=1e3)
            wq = drag * (qsat - qv[0]) * (1.0 / PRANDTL)
        else:
            wq = torch.zeros_like(wth)                       # no moisture flux
        # theta and qv diffuse with the same coefficients: one solve on the
        # two fields side by side, [K, 2C]
        two = lambda f: f.repeat(1, 2)
        both = implicit_diffusion(
            torch.cat([theta, qv], dim=1), two(kh_i), two(rho), two(rho_i),
            two(static.zgrid), dt, sfc_flux=torch.cat([wth, wq]))
        theta_new, qv_new = both[:, :C], both[:, C:]

    # momentum: diffuse edge-normal u with cell quantities averaged to edges
    (km1, km2), (rho1, rho2), (rhoi1, rhoi2), (drag1, drag2) = st.edge_pairs_m(
        mesh, km_i, rho, rho_i, drag[None, :])
    km_e = 0.5 * (km1 + km2)
    rho_e = 0.5 * (rho1 + rho2)
    rhoi_e = 0.5 * (rhoi1 + rhoi2)
    drag_e = 0.5 * (drag1[0] + drag2[0])
    zg1, zg2 = st.edge_pair_m(mesh, static.zgrid)
    zg_e = 0.5 * (zg1 + zg2)
    u_new = implicit_diffusion(state.u, km_e, rho_e, rhoi_e, zg_e, dt,
                               sfc_drag=drag_e)

    theta_m = (theta_new * (1.0 + constants.rvord * qv_new)
               if qv_new is not None else theta_new)
    # recouple ru exactly as atm_init_coupled_diagnostics does
    ru_new = st.avg_cell_to_edge_m(mesh, state.rho_zz) * u_new
    out = dict(rediagnose(state, static, theta_m), u=u_new, ru=ru_new)
    if qv_new is not None:
        out["scalars"] = torch.cat([qv_new[None], state.scalars[1:]], dim=0)
    return state.replace(**out)
