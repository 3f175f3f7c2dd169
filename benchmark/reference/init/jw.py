"""Jablonowski-Williamson baroclinic wave initial condition.

Rebuilds init_atm_case_jw (vertical_init/init_atm_cases.rg:24-743) with the
correct MPAS/Fortran index semantics — the reference's 0-based translation
shifts several vertical arrays by one level (sh/zw/ah at :176-213, the
hydrostatic-iteration pressure integral at :360-366, surface pressure at
:519-520; see SURVEY.md section 8).  All computation is host-side numpy
float64, vectorized over cells/edges (the 10x25 nested hydrostatic-balance
fixed-point iteration runs on whole [C, K] arrays).

Additions over the reference (MPAS semantics it left out):
  - 3rd-order z_edge / zb3 metric terms via deriv_two (the reference
    hardwires the 2nd-order branch, :625-654);
  - the Gaussian u perturbation for config_init_case == 2 (:540-554);
  - optional moisture initialization (:450-475, commented out there).
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..config import Namelist
from ..core.vertical import VerticalGrid
from ..mesh.loader import Mesh
from . import common

# JW case parameters (init_atm_cases.rg:51-70)
U0 = 35.0
T0B = 250.0          # isothermal base-state temperature
T0 = 288.0
DELTA_T = 4.8e5
DTDZ = 0.005
ETA_T = 0.2
U_PERTURBATION = 1.0
PERT_RADIUS = 0.1
LATITUDE_PERT = 40.0
LONGITUDE_PERT = 20.0
RH_MAX = 0.40


def _zonal_mean_profile(lat, eta, qv):
    """JW temperature at (lat, eta) including the horizontal-mean part and
    the baroclinic deviation (init_atm_cases.rg:432-445)."""
    g, rgas, a = constants.gravity, constants.rgas, constants.sphere_radius
    omega_e = constants.omega
    etav = (eta - 0.252) * np.pi / 2.0
    teta = T0 * eta ** (rgas * DTDZ / g)
    teta = teta + np.where(eta < ETA_T, DELTA_T * np.maximum(ETA_T - eta, 0.0) ** 5, 0.0)
    phi = lat
    t = teta + (0.75 * eta * np.pi * U0 / rgas * np.sin(etav)
                * np.sqrt(np.abs(np.cos(etav)))
                * ((-2.0 * np.sin(phi) ** 6 * (np.cos(phi) ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
                   * 2.0 * U0 * np.cos(etav) ** 1.5
                   + (1.6 * np.cos(phi) ** 3 * (np.sin(phi) ** 2 + 2.0 / 3.0) - np.pi / 4.0)
                   * a * omega_e)) / (1.0 + 0.61 * qv)
    return t


def surface_height(lat):
    """JW surface geopotential height hx (init_atm_cases.rg:155-160)."""
    g, a, omega_e = constants.gravity, constants.sphere_radius, constants.omega
    etavs = (1.0 - 0.252) * np.pi / 2.0
    cos_etavs_15 = np.cos(etavs) ** 1.5
    return (U0 / g * cos_etavs_15
            * ((-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
               * U0 * cos_etavs_15
               + (1.6 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0) - np.pi / 4.0)
               * a * omega_e))


def init_jw(mesh: Mesh, vg: VerticalGrid, nl: Namelist, deriv_two: np.ndarray):
    """Build the JW baroclinic-wave initial condition.

    Returns (static, init) dicts of numpy arrays:
      static: zgrid, zz, dss, zxu, zb, zb3, rho_base, theta_base,
              rtheta_base, exner_base, pressure_base, t_init
      init:   u, w, theta_m, rho (physical), v, rw, surface_pressure,
              pressure_p (perturbation), qv
    """
    g, rgas, cp, p0 = constants.gravity, constants.rgas, constants.cp, constants.p0
    C, E, K = mesh.nCells, mesh.nEdges, vg.nVertLevels
    zt = vg.ztop
    moisture = nl.config_moisture

    # ---- terrain-following grid ----
    hx = surface_height(mesh.latCell)                               # [C]
    zgrid, zz = common.terrain_grid(mesh, vg, hx)
    zxu = common.edge_slope(mesh, zgrid)                            # [E, K]
    dss = common.damping_profile(mesh, vg, nl, zgrid)
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])                     # [C, K]

    # ---- isothermal base state (init_atm_cases.rg:417-428) ----
    ppb = p0 * np.exp(-g * zmid / (rgas * T0B))                     # [C, K]
    pb = (ppb / p0) ** (rgas / cp)
    rb = ppb / (rgas * T0B * zz)                                    # coupled rho_base
    tb = T0B / pb
    rtb = rb * tb

    # ---- hydrostatic-balance iteration for the JW state ----
    # It runs on level-major [K, C] copies (suffix T), so each level of the
    # K-recurrence is one contiguous row; every operation is elementwise
    # the column form's, so the results are bit for bit the same.
    ppbT, zzT, rbT = (np.ascontiguousarray(a.T) for a in (ppb, zz, rb))
    rzzT = rgas * zzT
    dzu_g = (vg.dzu[1:K] * g)[:, None]
    fzp, fzm = vg.fzp[1:K, None], vg.fzm[1:K, None]
    ppT = np.zeros((K, C))
    rrT = np.zeros((K, C))
    qvT = np.zeros((K, C))
    relhumT = np.zeros((K, C))
    lat = mesh.latCell[None, :]
    for _ in range(10):
        eta = (ppbT + ppT) / p0
        temperature = _zonal_mean_profile(lat, eta, qvT)

        if moisture:
            ptemp = ppbT + ppT
            # clamp the base before the fractional power: columns where
            # ptemp > p0 would otherwise raise a negative number to 1.25
            # and poison the whole iteration with NaN (the ptemp > p0
            # branch below overwrites those entries with 1.0 anyway)
            relhumT = np.clip(
                1.0 - (np.maximum(p0 - ptemp, 0.0) / 50000.0) ** 1.25,
                0.0, 1.0)
            relhumT = np.where(ptemp < 50000.0, 0.0, relhumT)
            relhumT = np.where(ptemp > p0, 1.0, relhumT)
            relhumT = np.minimum(RH_MAX, relhumT)
            es = np.where(
                temperature > 273.15,
                1000.0 * 0.6112 * np.exp(17.67 * (temperature - 273.15)
                                         / (temperature - 29.65)),
                1000.0 * 0.6112 * np.exp(21.8745584 * (temperature - 273.15)
                                         / (temperature - 7.66)))
            qsat = (287.04 / 461.6) * es / (ptemp - es)
            qsat = np.where(relhumT == 0.0, 0.0, qsat)
            qvT = relhumT * qsat

        ttT = temperature * (1.0 + 1.61 * qvT)
        rb_tt = rbT * (ttT - T0B)

        for _ in range(25):
            rrT = (ppT / rzzT - rb_tt) / ttT
            # downward-extrapolated surface pressure, then upward hydrostatic
            # integration (init_atm_cases.rg:360-366, corrected indices):
            # ppi[k+1] = ppi[k] - inc[k] as one sequential np.cumsum over
            # the rows (ppi[0], -inc[0], ...), since x + (-y) is x - y exactly
            ppi = np.empty((K, C))
            ppi[0] = (p0 - 0.5 * vg.dzw[0] * g
                      * (1.25 * (rrT[0] + rbT[0]) * (1.0 + qvT[0])
                         - 0.25 * (rrT[1] + rbT[1]) * (1.0 + qvT[1]))
                      - ppbT[0])
            moist = rrT + (rrT + rbT) * qvT
            ppi[1:] = -(dzu_g * (moist[:-1] * fzp + moist[1:] * fzm))
            ppT = 0.2 * np.cumsum(ppi, axis=0) + 0.8 * ppT

    pp, rr, qv, relhum, tt = (np.ascontiguousarray(a.T)
                              for a in (ppT, rrT, qvT, relhumT, ttT))
    exner = ((ppb + pp) / p0) ** (rgas / cp)
    theta_m = tt / exner                      # moist theta (= theta for dry)
    rho_zz_coupled = rb + rr
    rho_physical = rho_zz_coupled * zz

    surface_pressure = (0.5 * vg.dzw[0] * g
                        * (1.25 * (rr[:, 0] + rb[:, 0]) * (1.0 + qv[:, 0])
                           - 0.25 * (rr[:, 1] + rb[:, 1]) * (1.0 + qv[:, 1]))
                        + pp[:, 0] + ppb[:, 0])

    # ---- edge winds (init_atm_cases.rg:530-589) ----
    v1 = mesh.verticesOnEdge[:, 0]
    v2 = mesh.verticesOnEdge[:, 1]
    lat1 = mesh.latVertex[v1]
    lat2 = mesh.latVertex[v2]
    flux = ((0.5 * (lat2 - lat1) - 0.125 * (np.sin(4.0 * lat2) - np.sin(4.0 * lat1)))
            * constants.sphere_radius / mesh.dvEdge)                # [E]
    c1 = mesh.cellsOnEdge[:, 0]
    c2 = mesh.cellsOnEdge[:, 1]
    p_edge = 0.5 * (ppb[c1] + ppb[c2] + pp[c1] + pp[c2])            # [E, K]
    etavs_e = (p_edge / p0 - 0.252) * np.pi / 2.0
    u = U0 * flux[:, None] * np.cos(etavs_e) ** 1.5

    if nl.config_init_case == 2 and nl.config_jw_u_perturbation != 0.0:
        lat_p = LATITUDE_PERT * np.pi / 180.0
        lon_p = LONGITUDE_PERT * np.pi / 180.0
        # great-circle distance on the unit sphere
        arg = (np.sin(lat_p) * np.sin(mesh.latEdge)
               + np.cos(lat_p) * np.cos(mesh.latEdge) * np.cos(mesh.lonEdge - lon_p))
        r_pert = np.arccos(np.clip(arg, -1.0, 1.0)) / PERT_RADIUS
        u_pert = (nl.config_jw_u_perturbation * np.exp(-r_pert ** 2)
                  * (lat2 - lat1) * constants.sphere_radius / mesh.dvEdge)
        u = u + u_pert[:, None]

    ru = 0.5 * (rho_zz_coupled[c1] + rho_zz_coupled[c2]) * u        # [E, K]

    # ---- omega metric terms zb/zb3 (init_atm_cases.rg:616-665 + the
    # 3rd-order z_edge branch via deriv_two) ----
    zb, zb3 = common.omega_metrics(mesh, nl, deriv_two, zgrid)

    # ---- initial rw and diagnosed w (init_atm_cases.rg:668-704, using the
    # init_coupled/recover-consistent metric sign) ----
    rw, w = common.initial_rw_w(mesh, vg, nl, zz, rho_zz_coupled, ru, zb, zb3)

    # tangential winds (init_atm_cases.rg:710-723)
    v = common.tangential_v(mesh, u)

    # zb_cell/zb3_cell (atm_compute_signs + atm_couple_coef_3rd_order)
    zb_cell, zb3_cell = common.zb_cell_tables(mesh, nl, zb, zb3)

    # exner_base from the equation of state (consistent with the dycore)
    rcv = constants.rcv
    exner_base = (zz * (rgas / p0) * rtb) ** rcv
    t_init = theta_m.copy()

    static = dict(zgrid=zgrid, zz=zz, dss=dss, zxu=zxu,
                  zb_cell=zb_cell, zb3_cell=zb3_cell,
                  rho_base=rb, theta_base=tb, rtheta_base=rtb,
                  exner_base=exner_base, pressure_base=ppb, t_init=t_init)
    init = dict(u=u, w=w, theta_m=theta_m, rho=rho_physical, v=v, rw=rw,
                surface_pressure=surface_pressure, pressure_p=pp, qv=qv,
                exner=exner, relhum=relhum)
    return static, init
