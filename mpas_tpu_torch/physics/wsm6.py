"""WSM6 ice-phase microphysics (columnar).

The port of `mpas_tpu.physics.wsm6`: the WRF Single-Moment 6-class scheme
(Hong & Lim, JKMS 2006) in two tiers:

* ``wsm6lite`` (config_microphysics="wsm6lite"): five species, graupel
  folded into snow.
* ``wsm6full`` (config_microphysics="wsm6"): the full six species with a
  prognostic graupel class qg: snow->graupel autoconversion above the
  Hong-Lim threshold, graupel riming of cloud water and accretion
  (freezing) of rain with a wet-/dry-growth heat-balance cap (accreted
  liquid that cannot freeze without heating the air past 0 C is shed,
  i.e. stays liquid), Bigg (1953) immersion freezing of supercooled rain,
  graupel share of vapor deposition/sublimation, graupel melting, and
  graupel sedimentation with the Hong-Lim fall law
  (V = a Gamma(4+b)/6 lambda^-b, a=330, b=0.8, rho_g=500, n0g=4e6).

Shared process set (both tiers):

  warm rain:   Kessler-form autoconversion qc->qr and accretion (shared
               constants with physics/kessler.py), saturation adjustment
               over water, rain evaporation;
  ice phase:   Fletcher (1962) ice nucleation, vapor deposition /
               sublimation on ice toward ice saturation, autoconversion
               qi->qs above the Hong et al. threshold, snow accretion of
               ice and riming of cloud water, snow deposition, melting of
               ice and snow above freezing, homogeneous freezing of cloud
               water at -40 C;
  sedimentation: upwind flux for rain (Kessler fall law), snow
               (vt = 11.72 (rho qs)^0.25 / sqrt(rho-fac), capped) and
               graupel, CFL substeps as in physics/kessler.py, all species
               in one call of physics/sediment.py (one launch of Kernel 5
               on the card).

Latent heating uses Lv / Ls / Lf consistently so a closed column conserves
total water (vapor + condensate + accumulated precip) and the moist
enthalpy cp T + Lv qv - Lf (qi+qs+qg) pointwise.

Scalar layout: scalars[0]=qv, [1]=qc, [2]=qr, [3]=qi, [4]=qs, [5]=qg (dry
mixing ratios), level-major [K, C]; all ops elementwise plus the
sedimentation substeps.
"""

from __future__ import annotations

import math

import torch

from .. import constants
from . import kessler
from .kessler import (C1, C2, C3, C4, EP2, SVP1, SVP2, SVP3, SVPT0,
                      column_inputs, density_factor, recouple)
from .sediment import sediment_species

XLV = constants.xlv
XLS = constants.xls
XLF = constants.xlf
T0 = SVPT0
TICE_HOMOG = 233.15            # homogeneous freezing of cloud water
QI0 = 8.0e-5                   # ice -> snow autoconversion threshold [kg/kg]
QCK1 = 1.0e-3                  # riming efficiency factor
N0_FLETCHER = 1.0e-2           # Fletcher nucleation prefactor [1/m^3 /rho]
MI0 = 1.0e-12                  # initial ice crystal mass [kg]
MAX_VT_SNOW = 8.0

# --- graupel class (wsm6full) ---
QS0 = 6.0e-4                   # snow -> graupel autoconversion threshold
GRAUPEL_PIRN = 6.2832e9        # pi * rho_g * n0g (rho_g=500, n0g=4e6 m^-4)
# mass-weighted fall speed a*Gamma(4+b)/6 * lambda^-b with a=330, b=0.8:
# 330 * Gamma(4.8)/6 = 981; lambda^-0.8 = (rho qg / (pi rho_g n0g))^0.2
GRAUPEL_VCOEF = 981.0
MAX_VT_GRAUPEL = 15.0
BIGG_A = 0.66                  # Bigg (1953) immersion-freezing exponent [1/K]
BIGG_K = 1.0e-5                # rate prefactor [1/s]; tau ~ 2 min at -10 C


def max_fall_speed(full: bool) -> float:
    """The largest fall-speed cap of the species that sediment: what the
    number of sedimentation substeps is sized against, since all species
    share one substep count."""
    caps = [kessler.MAX_VT, MAX_VT_SNOW] + ([MAX_VT_GRAUPEL] if full else [])
    return max(caps)


def saturation_pressures(t):
    """(es_water, es_ice) [Pa], Tetens over water and ice."""
    esw = 1000.0 * SVP1 * torch.exp(SVP2 * (t - SVPT0) / (t - SVP3))
    esi = 1000.0 * SVP1 * torch.exp(21.8745584 * (t - SVPT0) / (t - 7.66))
    return esw, torch.where(t < T0, esi, esw)


def _qsat(es, p):
    p = torch.clamp(p, min=100.0)
    es = torch.minimum(es, 0.99 * p)
    return EP2 * es / (p - es)


def _snow_fall_velocity(qs, rho, rhofac=None):
    rhofac = density_factor(rho) if rhofac is None else rhofac
    vt = 11.72 * torch.clamp(rho * qs, min=0.0) ** 0.25 * rhofac
    return torch.clamp(vt, max=MAX_VT_SNOW)


def _graupel_fall_velocity(qg, rho, rhofac=None):
    rhofac = density_factor(rho) if rhofac is None else rhofac
    vt = (GRAUPEL_VCOEF
          * (torch.clamp(rho * qg, min=0.0) / GRAUPEL_PIRN) ** 0.2 * rhofac)
    return torch.clamp(vt, max=MAX_VT_GRAUPEL)


def _wsm6_core(theta, qv, qc, qr, qi, qs, qg, rho, exner, pressure, dz,
               dt: float, nfall: int):
    """Shared 5-/6-class update.  qg=None selects the lite (5-class) path;
    with qg the full graupel process set is inserted.  Returns
    (theta, qv, qc, qr, qi, qs, qg|None, rain, snow, graup|0)."""
    cp = constants.cp
    p = torch.clamp(pressure, min=100.0)
    has_g = qg is not None
    zero = torch.zeros_like(theta)
    pos = lambda x: torch.clamp(x, min=0.0)

    # --- 1. sedimentation: every falling species in one call ---
    falling, laws = [qr, qs], ("rain", "snow")
    if has_g:
        falling, laws = falling + [qg], laws + ("graupel",)
    falling, precip = sediment_species(falling, laws, rho, dz, dt, nfall)
    qr, qs = falling[:2]
    rain, snow = precip[:2]
    graup = 0.0
    if has_g:
        qg, graup = falling[2], precip[2]

    # --- 2. warm-rain conversions (Kessler form) ---
    factorn = 1.0 / (1.0 + C3 * dt * pos(qr) ** C4)
    qrprod = qc * (1.0 - factorn) + factorn * C1 * dt * pos(qc - C2)
    qrprod = torch.minimum(qrprod, qc)
    qc = qc - qrprod
    qr = qr + qrprod

    t = theta * exner
    cold = t < T0

    # --- 3. ice nucleation + depositional growth (cold, ice-supersaturated) ---
    esw, esi = saturation_pressures(t)
    qsi = _qsat(esi, p)
    si_excess = qv - qsi                               # ice-supersaturation
    # Fletcher number concentration n_i = 1e-2 exp(0.6 (T0 - T)) [1/m^3]
    ni = N0_FLETCHER * torch.exp(torch.clamp(0.6 * (T0 - t), max=25.0))
    # nucleation: bring up to the crystal mass implied by n_i, bounded by
    # available supersaturation
    qi_nuc = torch.where(cold, torch.minimum(pos(ni * MI0 / rho - qi),
                                             pos(si_excess)), zero)
    # deposition/sublimation: relax qv toward ice saturation on existing ice
    # (timescale shortens with ice mass; linearized capacitance form)
    tau_dep = 600.0
    qice_tot = qi + qs + (qg if has_g else 0.0)
    grow = torch.where(cold & (qice_tot > 1e-12),
                       (1.0 - math.exp(-dt / tau_dep)) * si_excess, zero)
    dep = torch.minimum(torch.maximum(grow, -qice_tot), pos(si_excess))
    dep_i = torch.where(dep >= 0,
                        dep * qi / torch.clamp(qice_tot, min=1e-12),
                        -torch.minimum(-dep, qi))
    if has_g:
        # deposit proportional to mass; sublimate qi first, then qs, then qg
        rest = dep - dep_i
        dep_s = torch.where(dep >= 0,
                            dep * qs / torch.clamp(qice_tot, min=1e-12),
                            torch.maximum(rest, -qs))
        dep_g = dep - dep_i - dep_s
        dep_g = torch.maximum(dep_g, -qg)
        qg = qg + dep_g
    else:
        dep_s = torch.maximum(dep - dep_i, -qs)
        dep_g = 0.0

    qv = qv - qi_nuc - dep_i - dep_s - dep_g
    qi = qi + qi_nuc + dep_i
    qs = qs + dep_s
    theta = theta + XLS / (cp * exner) * (qi_nuc + dep_i + dep_s + dep_g)
    t = theta * exner
    cold = t < T0

    # --- 4. ice -> snow autoconversion + snow collection ---
    praut_i = torch.where(cold, pos(qi - QI0) * (1.0 - math.exp(-1.0e-3 * dt)),
                          zero)
    # snow accretes ice and rimes cloud water (cold only)
    vts = _snow_fall_velocity(qs, rho)
    sweep = 1.0 - torch.exp(-QCK1 * dt * rho * qs * (1.0 + vts))
    pacr_i = torch.where(cold, qi * sweep, zero)
    prim_c = torch.where(cold, qc * sweep, zero)       # riming: liquid->snow
    qi = qi - praut_i - pacr_i
    qs = qs + praut_i + pacr_i + prim_c
    qc = qc - prim_c
    theta = theta + XLF / (cp * exner) * prim_c        # freezing heat
    t = theta * exner

    if has_g:
        cold = t < T0
        # snow -> graupel autoconversion above the Hong-Lim threshold
        # (heavily rimed snow graupelizes)
        pgaut = torch.where(cold, pos(qs - QS0)
                            * (1.0 - math.exp(-1.0e-3 * dt)), zero)
        qs = qs - pgaut
        qg = qg + pgaut
        # graupel sweeps out cloud water (riming) and rain (freezing on
        # contact), continuous-collection form like the snow sweep
        vtg = _graupel_fall_velocity(qg, rho)
        sweep_g = 1.0 - torch.exp(-QCK1 * dt * rho * qg * (1.0 + vtg))
        pgacw = torch.where(cold, qc * sweep_g, zero)
        pgacr = torch.where(cold, qr * sweep_g, zero)
        # Bigg (1953) immersion freezing of supercooled rain
        bigg = BIGG_K * (torch.exp(torch.clamp(BIGG_A * (T0 - t), max=25.0))
                         - 1.0)
        pgfrz = torch.where(cold, qr * (1.0 - torch.exp(-dt * pos(bigg))),
                            zero)
        pgfrz = torch.minimum(pgfrz, qr - pgacr)
        # wet-/dry-growth heat balance: freezing heats the air by XLF/cp per
        # unit mass; liquid that would push t past T0 cannot freeze (wet
        # growth) and is shed: a proportional cap on the liquid->graupel
        # conversions
        freeze_cap = cp * pos(T0 - t) / XLF
        liq2g = pgacw + pgacr + pgfrz
        scale = torch.clamp(freeze_cap / torch.clamp(liq2g, min=1e-30),
                            max=1.0)
        pgacw, pgacr, pgfrz = pgacw * scale, pgacr * scale, pgfrz * scale
        qc = qc - pgacw
        qr = qr - pgacr - pgfrz
        qg = qg + pgacw + pgacr + pgfrz
        theta = theta + XLF / (cp * exner) * (pgacw + pgacr + pgfrz)
        t = theta * exner

    # --- 5. homogeneous freezing of cloud water; melting above T0 ---
    frz = torch.where(t < TICE_HOMOG, qc, zero)
    qc = qc - frz
    qi = qi + frz
    theta = theta + XLF / (cp * exner) * frz
    t = theta * exner

    warm = t > T0
    # melt rate limited by available sensible heat above freezing
    melt_cap = cp * pos(t - T0) / XLF
    melt_i = torch.where(warm, torch.minimum(qi, melt_cap), zero)
    qi = qi - melt_i
    qc = qc + melt_i
    theta = theta - XLF / (cp * exner) * melt_i
    t = theta * exner
    melt_cap = cp * pos(t - T0) / XLF
    melt_s = torch.where(
        t > T0, torch.minimum(qs * (1.0 - math.exp(-dt / 600.0)), melt_cap),
        zero)
    qs = qs - melt_s
    qr = qr + melt_s
    theta = theta - XLF / (cp * exner) * melt_s
    t = theta * exner

    if has_g:
        # graupel melts more slowly than snow (denser, smaller area/mass)
        melt_cap = cp * pos(t - T0) / XLF
        melt_g = torch.where(
            t > T0,
            torch.minimum(qg * (1.0 - math.exp(-dt / 900.0)), melt_cap), zero)
        qg = qg - melt_g
        qr = qr + melt_g
        theta = theta - XLF / (cp * exner) * melt_g
        t = theta * exner

    # --- 6. saturation adjustment over water + rain evaporation ---
    esw, _ = saturation_pressures(t)
    qvs = _qsat(esw, p)
    f5 = SVP2 * (SVPT0 - SVP3) * XLV / cp
    prod = (qv - qvs) / (1.0 + p / (p - torch.minimum(esw, 0.99 * p))
                         * qvs * f5 / (t - SVP3) ** 2)
    product = torch.maximum(prod, -qc)

    rqr = pos(rho * qr * 0.001)
    ern = (dt * ((1.6 + 124.9 * rqr ** 0.2046) * rqr ** 0.525)
           / (rho * (2.55e8 / (p * qvs) + 5.4e5))
           * pos(qvs - qv) / qvs)
    ern = torch.minimum(ern, pos(-prod - qc))
    ern = torch.minimum(pos(ern), qr)

    theta = theta + XLV / (cp * exner) * (product - ern)
    qv = pos(qv - product + ern)
    qc = pos(qc + product)
    qr = pos(qr - ern)
    qi = pos(qi)
    qs = pos(qs)
    if has_g:
        qg = pos(qg)
    return theta, qv, qc, qr, qi, qs, qg, rain, snow, graup


def wsm6lite(theta, qv, qc, qr, qi, qs, rho, exner, pressure, dz, dt: float,
             nfall: int):
    """One WSM6-lite (5-class) update.  Inputs level-major [K, C]; theta is
    the dry potential temperature.  Returns
    (theta, qv, qc, qr, qi, qs, rain, snow) with rain/snow surface
    accumulations [C] in kg/m^2 (mm)."""
    out = _wsm6_core(theta, qv, qc, qr, qi, qs, None, rho, exner, pressure,
                     dz, dt, nfall)
    theta, qv, qc, qr, qi, qs, _, rain, snow, _ = out
    return theta, qv, qc, qr, qi, qs, rain, snow


def wsm6full(theta, qv, qc, qr, qi, qs, qg, rho, exner, pressure, dz,
             dt: float, nfall: int):
    """One full WSM6 (6-class) update with prognostic graupel.  Returns
    (theta, qv, qc, qr, qi, qs, qg, rain, snow, graup) with surface
    accumulations [C] in kg/m^2 (mm)."""
    return _wsm6_core(theta, qv, qc, qr, qi, qs, qg, rho, exner, pressure,
                      dz, dt, nfall)


def apply_wsm6(state, static, vert, nl, dt: float, full: bool = False):
    """Couple WSM6 into the SRK3 step (the rediagnosis of
    kessler.apply_kessler).  full=False: 5-class lite; full=True: 6-class
    with prognostic graupel in scalars[5]."""
    qv, qc, qr, qi, qs = (state.scalars[i] for i in range(5))
    qg = state.scalars[5] if full else None
    theta = state.theta_m / (1.0 + constants.rvord * qv)
    rho, pressure, dz = column_inputs(state, static)

    theta, qv, qc, qr, qi, qs, qg, rain, snow, graup = _wsm6_core(
        theta, qv, qc, qr, qi, qs, qg, rho, state.exner, pressure, dz, dt,
        nfall=nl.config_kessler_nfall)

    species = [qv, qc, qr, qi, qs] + ([qg] if full else [])
    return recouple(state, static, theta, species, rain + snow + graup)
