"""Weisman-Klemp convective storm case on a reduced-radius planet
(config_init_case == 22). A numpy copy of `mpas_tpu.init.squall`, held
array_equal to it.

The standard idealized deep-convection setup (Weisman & Klemp MWR 1982;
the squall-line / supercell benchmark of WRF and MPAS's own
supercell.nml): a conditionally unstable analytic sounding, a low-level
westerly shear layer, and a warm thermal bubble that triggers convection —
here wrapped onto a small planet (radius = Earth/X, config_sphere_radius)
so a coarse icosahedral mesh becomes convection-permitting, exercising the
nonhydrostatic solver + FCT scalar transport + WSM6 graupel microphysics
together.

Sounding (WK82 eq. 1-3):
  theta(z) = theta0 + (theta_tr - theta0) (z/z_tr)^(5/4)      z <= z_tr
           = theta_tr exp(g (z - z_tr)/(cp T_tr))             z >  z_tr
  RH(z)    = 1 - 0.75 (z/z_tr)^(5/4)  (floor 0.25; qv capped at
             config_sq_qv0, the WK82 boundary-layer cap)
  u(z)     = us tanh(z/z_s) * cos(lat)  (solid-body shear profile applied
             through the discrete streamfunction, divergence-free per level)
with theta0=300 K, theta_tr=343 K, T_tr=213 K, z_tr=12 km.

Balance: the same discrete fixed-point hydrostatic iteration as the other
cases (init/jw.py, init/mountain_wave.py) against an isothermal base
state, with the moist coupling T_m = T (1 + rvord qv) inside the equation
of state so the moist column is discretely balanced.  The bubble
(+config_sq_bubble_dtheta K, cos^2 profile) is added AFTER balancing —
its buoyancy is the convective trigger.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..core.vertical import VerticalGrid
from ..mesh.loader import Mesh
from . import common

THETA_TR = 343.0               # tropopause potential temperature [K]
T_TR = 213.0                   # tropopause temperature [K]
Z_TR = 12000.0                 # tropopause height [m]


def wk_sounding(zmid, nl):
    """(theta, relhum) of the WK82 analytic sounding at heights zmid."""
    g, cp = constants.gravity, constants.cp
    theta0 = nl.config_sq_theta0
    frac = np.minimum(zmid / Z_TR, 1.0) ** 1.25
    theta = np.where(zmid <= Z_TR,
                     theta0 + (THETA_TR - theta0) * frac,
                     THETA_TR * np.exp(g * (zmid - Z_TR) / (cp * T_TR)))
    relhum = np.where(zmid <= Z_TR, 1.0 - 0.75 * frac, 0.25)
    return theta, np.maximum(relhum, 0.25)


def _qsat(t, p):
    """Tetens saturation mixing ratio over water (kessler.py constants)."""
    from ..physics.kessler import EP2, SVP1, SVP2, SVP3
    es = np.minimum(1000.0 * SVP1 * np.exp(SVP2 * (t - 273.15)
                                           / (t - SVP3)), 0.99 * p)
    return EP2 * es / (p - es)


def init_squall(mesh: Mesh, vg: VerticalGrid, nl, deriv_two: np.ndarray):
    """Build the WK82 storm initial condition; same return signature as
    init_jw / init_mountain_wave (static, init dicts)."""
    g, rgas, cp, p0 = (constants.gravity, constants.rgas, constants.cp,
                       constants.p0)
    rvord = constants.rvord
    C, E, K = mesh.nCells, mesh.nEdges, vg.nVertLevels
    T0 = nl.config_sq_theta0                 # isothermal base temperature

    # ---- flat terrain ----
    hx = np.zeros(C)
    zgrid, zz = common.terrain_grid(mesh, vg, hx)
    zxu = common.edge_slope(mesh, zgrid)
    dss = common.damping_profile(mesh, vg, nl, zgrid)
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])           # [C, K]

    # ---- isothermal base state (same split as init/mountain_wave.py) ----
    ppb = p0 * np.exp(-g * zmid / (rgas * T0))
    pb = (ppb / p0) ** (rgas / cp)
    rb = ppb / (rgas * T0 * zz)
    tb = T0 / pb
    rtb = rb * tb

    theta_prof, relhum = wk_sounding(zmid, nl)            # [C, K]
    ps = np.full(C, p0)

    # ---- discrete moist hydrostatic iteration ----
    pp = np.zeros((C, K))
    rr = np.zeros((C, K))
    qv = np.zeros((C, K))
    for _ in range(30):
        exner = np.maximum((ppb + pp) / p0, 1e-8) ** (rgas / cp)
        tt = theta_prof * exner
        if nl.config_moisture:
            qv = np.minimum(relhum * _qsat(tt, ppb + pp), nl.config_sq_qv0)
        tt_m = tt * (1.0 + rvord * qv)                    # moist coupling
        rr = (pp / (rgas * zz) - rb * (tt_m - T0)) / tt_m
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
    tt = theta_prof * exner
    theta_m = theta_prof * (1.0 + rvord * qv)
    rho_zz_coupled = rb + rr
    rho_physical = rho_zz_coupled * zz

    # ---- warm bubble trigger (added unbalanced, on theta_m) ----
    a = mesh.sphere_radius
    lat_c = nl.config_mtn_lat_center
    lon_c = nl.config_mtn_lon_center
    arg = (np.sin(lat_c) * np.sin(mesh.latCell)
           + np.cos(lat_c) * np.cos(mesh.latCell)
           * np.cos(mesh.lonCell - lon_c))
    r_h = a * np.arccos(np.clip(arg, -1.0, 1.0))          # [C]
    rad = np.sqrt((r_h[:, None] / nl.config_sq_bubble_radius) ** 2
                  + ((zmid - nl.config_sq_bubble_height)
                     / nl.config_sq_bubble_depth) ** 2)
    dtheta = (nl.config_sq_bubble_dtheta
              * np.cos(0.5 * np.pi * np.minimum(rad, 1.0)) ** 2)
    theta_m = theta_m + dtheta * (1.0 + rvord * qv)

    # ---- sheared zonal wind through the discrete streamfunction ----
    v1 = mesh.verticesOnEdge[:, 0]
    v2 = mesh.verticesOnEdge[:, 1]
    flux = ((np.sin(mesh.latVertex[v2]) - np.sin(mesh.latVertex[v1]))
            * a / mesh.dvEdge)                            # [E] cos(lat) factor
    ze = 0.5 * (zmid[mesh.cellsOnEdge[:, 0]] + zmid[mesh.cellsOnEdge[:, 1]])
    uprof = nl.config_sq_shear_u * np.tanh(ze / nl.config_sq_shear_depth)
    u = uprof * flux[:, None]                             # [E, K]
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
                surface_pressure=ps, pressure_p=pp,
                qv=qv, exner=exner, relhum=relhum)
    return static, init
