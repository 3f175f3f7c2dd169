"""Schar-type mountain-wave initial condition on a reduced-radius planet
(config_init_case == 21). A numpy copy of `mpas_tpu.init.mountain_wave`,
held array_equal to it.

DCMIP-2012 test 2-1/2-2 style (Ullrich et al., "Dynamical Core Model
Intercomparison Project test case document", 2012): an isothermal,
non-rotating atmosphere in solid-body zonal flow over a circular Schar
mountain (Schar et al. MWR 2002) centered on the equator of a small planet
(radius = Earth/X), so that the flow regime is genuinely NONHYDROSTATIC —
|w| of order m/s — and the vertically implicit acoustic/gravity-wave solver
(ops/acoustic.py) can be held against linear mountain-wave theory
(`linear_schar_solution`), not just by internal equivalence.

Analytic state (all host-side f64):
  T = T0 everywhere (isothermal; buoyancy frequency N^2 = g^2/(cp*T0))
  u(lat) = u0 * cos(lat)   (via the discrete streamfunction flux, exactly
                            divergence-free on the C-grid like the JW init)
  ps(lat) = p0 * exp(-u0^2 * sin(lat)^2 / (2*Rd*T0))  (cyclostrophic balance)
  h(r) = h0 * exp(-(r/d)^2) * cos(pi*r/xi)^2   (r = great-circle distance
                                                from the mountain center)
The vertical structure is balanced DISCRETELY by the same fixed-point
hydrostatic iteration as the JW case (init/jw.py), with the surface-pressure
boundary value ps(lat) instead of the uniform p0.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..core.vertical import VerticalGrid
from ..mesh.loader import Mesh
from . import common


def schar_mountain(mesh: Mesh, nl):
    """Surface height hx [C] for the circular Schar mountain."""
    a = mesh.sphere_radius
    lat_c = nl.config_mtn_lat_center
    lon_c = nl.config_mtn_lon_center
    arg = (np.sin(lat_c) * np.sin(mesh.latCell)
           + np.cos(lat_c) * np.cos(mesh.latCell)
           * np.cos(mesh.lonCell - lon_c))
    r = a * np.arccos(np.clip(arg, -1.0, 1.0))            # [C] metres
    hx = (nl.config_mtn_h0 * np.exp(-(r / nl.config_mtn_halfwidth) ** 2)
          * np.cos(np.pi * r / nl.config_mtn_wavelength) ** 2)
    return hx


def init_mountain_wave(mesh: Mesh, vg: VerticalGrid, nl,
                       deriv_two: np.ndarray):
    """Build the mountain-wave initial condition; same return signature as
    init_jw (static, init dicts)."""
    g, rgas, cp, p0 = constants.gravity, constants.rgas, constants.cp, constants.p0
    C, E, K = mesh.nCells, mesh.nEdges, vg.nVertLevels
    T0 = nl.config_mtn_t0
    u0 = nl.config_mtn_u0

    # ---- terrain-following grid over the Schar mountain ----
    hx = schar_mountain(mesh, nl)
    zgrid, zz = common.terrain_grid(mesh, vg, hx)
    zxu = common.edge_slope(mesh, zgrid)
    dss = common.damping_profile(mesh, vg, nl, zgrid)
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])

    # ---- isothermal base state at T0 (same split as the JW init) ----
    ppb = p0 * np.exp(-g * zmid / (rgas * T0))            # [C, K]
    pb = (ppb / p0) ** (rgas / cp)
    rb = ppb / (rgas * T0 * zz)
    tb = T0 / pb
    rtb = rb * tb

    # ---- balanced surface pressure (cyclostrophic, Omega = 0) ----
    ps = p0 * np.exp(-u0 ** 2 * np.sin(mesh.latCell) ** 2 / (2.0 * rgas * T0))

    # ---- discrete hydrostatic balance iteration (init/jw.py's loop with
    # T = T0 and the lat-dependent surface pressure) ----
    pp = np.zeros((C, K))
    rr = np.zeros((C, K))
    tt = np.full((C, K), T0)
    for _ in range(30):
        rr = (pp / (rgas * zz) - rb * (tt - T0)) / tt
        ppi = np.zeros((C, K))
        ppi[:, 0] = (ps - 0.5 * vg.dzw[0] * g
                     * (1.25 * (rr[:, 0] + rb[:, 0])
                        - 0.25 * (rr[:, 1] + rb[:, 1]))
                     - ppb[:, 0])
        for k in range(K - 1):
            ppi[:, k + 1] = ppi[:, k] - vg.dzu[k + 1] * g * (
                rr[:, k] * vg.fzp[k + 1] + rr[:, k + 1] * vg.fzm[k + 1])
        pp = 0.5 * ppi + 0.5 * pp

    exner = ((ppb + pp) / p0) ** (rgas / cp)
    theta_m = tt / exner
    rho_zz_coupled = rb + rr
    rho_physical = rho_zz_coupled * zz
    surface_pressure = ps

    # ---- edge winds: u = u0*cos(lat) via the discrete streamfunction
    # psi = -a*u0*sin(lat) (exactly divergence-free, like the JW flux) ----
    v1 = mesh.verticesOnEdge[:, 0]
    v2 = mesh.verticesOnEdge[:, 1]
    flux = ((np.sin(mesh.latVertex[v2]) - np.sin(mesh.latVertex[v1]))
            * mesh.sphere_radius / mesh.dvEdge)           # [E]
    u = np.broadcast_to((u0 * flux)[:, None], (E, K)).copy()
    c1 = mesh.cellsOnEdge[:, 0]
    c2 = mesh.cellsOnEdge[:, 1]
    ru = 0.5 * (rho_zz_coupled[c1] + rho_zz_coupled[c2]) * u

    # ---- metric terms + initial rw/w/v (shared machinery) ----
    zb, zb3 = common.omega_metrics(mesh, nl, deriv_two, zgrid)
    rw, w = common.initial_rw_w(mesh, vg, nl, zz, rho_zz_coupled, ru, zb, zb3)
    v = common.tangential_v(mesh, u)
    zb_cell, zb3_cell = common.zb_cell_tables(mesh, nl, zb, zb3)

    rcv = constants.rcv
    exner_base = (zz * (rgas / p0) * rtb) ** rcv
    t_init = theta_m.copy()

    static = dict(zgrid=zgrid, zz=zz, dss=dss, zxu=zxu,
                  zb_cell=zb_cell, zb3_cell=zb3_cell,
                  rho_base=rb, theta_base=tb, rtheta_base=rtb,
                  exner_base=exner_base, pressure_base=ppb, t_init=t_init)
    init = dict(u=u, w=w, theta_m=theta_m, rho=rho_physical, v=v, rw=rw,
                surface_pressure=surface_pressure, pressure_p=pp,
                qv=np.zeros((C, K)), exner=exner, relhum=np.zeros((C, K)))
    return static, init


def linear_schar_solution(x, z, nl, n_pad: int = 4):
    """Steady linear mountain-wave solution w(x, z) for the Schar profile in
    a uniform flow (Schar et al. MWR 2002 eq. 15ff; Smith 1979):
    Fourier transform of h, vertical wavenumber m^2 = N^2/U^2 - k^2 -
    1/(4 H^2) with the isothermal density amplitude factor exp(z/(2H)).
    Propagating modes (m^2 > 0) use the upward-radiation branch sign(k)*|m|;
    evanescent modes decay.  `x` is the periodic coordinate (length L =
    2*pi*a at the equator); returns w [len(z), len(x)]."""
    g, rgas, cp = constants.gravity, constants.rgas, constants.cp
    T0, U = nl.config_mtn_t0, nl.config_mtn_u0
    N2 = g * g / (cp * T0)
    H = rgas * T0 / g

    L = x[-1] - x[0] + (x[1] - x[0])
    n = len(x) * n_pad                       # pad for spectral resolution
    xs = np.arange(n) * (L / n)
    xc = L / 2.0
    r = np.abs(xs - xc)
    h = (nl.config_mtn_h0 * np.exp(-(r / nl.config_mtn_halfwidth) ** 2)
         * np.cos(np.pi * r / nl.config_mtn_wavelength) ** 2)
    hk = np.fft.rfft(h)
    k = 2.0 * np.pi * np.fft.rfftfreq(n, d=L / n)

    m2 = N2 / U ** 2 - k ** 2 - 1.0 / (4.0 * H * H)
    m = np.where(m2 > 0, np.sqrt(np.maximum(m2, 0.0)), 0.0)
    decay = np.sqrt(np.maximum(-m2, 0.0))

    w_out = np.zeros((len(z), len(x)))
    for j, zj in enumerate(z):
        phase = np.where(m2 > 0,
                         np.exp(1j * m * zj),
                         np.exp(-decay * zj))
        wk = 1j * k * U * hk * phase * np.exp(zj / (2.0 * H))
        w_full = np.fft.irfft(wk, n=n)
        # sample back at the model's x positions (shift mountain center
        # back to x's origin convention: caller passes x already centered)
        w_out[j] = np.interp(x, xs - xc, w_full, period=L)
    return w_out
