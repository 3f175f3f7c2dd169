"""Kessler warm-rain microphysics (columnar).

The port of `mpas_tpu.physics.kessler`: the classic Kessler (1969) warm-rain
scheme in the MPAS/WRF formulation (module_mp_kessler semantics):

  1. rain sedimentation (upwind flux with substeps bounded by the fall-speed
     CFL; fall speed vt = 36.34 (rho qr)^0.1364 sqrt(rho_sfc/rho) m/s),
  2. autoconversion of cloud to rain above the 1 g/kg threshold and
     accretion of cloud by rain (Berry-type factors c1=1e-3 s^-1, c2=1e-3,
     c3=2.2, c4=0.875),
  3. saturation adjustment (condensation/evaporation of cloud) and rain
     evaporation against Tetens saturation vapor pressure, with the latent
     heating applied to theta.

Scalar layout convention: scalars[0]=qv, [1]=qc, [2]=qr (dry mixing
ratios). The update runs inside the SRK3 step after scalar transport and
rediagnoses the coupled state (rtheta_p, exner, pressure_p) from the
equation of state exactly as atm_init_coupled_diagnostics does.

All operations are elementwise on level-major [K, C] tensors; the
sedimentation substeps are a Python loop of `nfall` passes (`nfall` is
static, from the namelist).
"""

from __future__ import annotations

import math

import torch

from .. import constants

# Kessler/WRF constants (module_mp_kessler.F)
XLV = constants.xlv
EP2 = constants.rgas / constants.rv        # 0.622
SVP1 = 0.6112                              # kPa
SVP2 = 17.67
SVP3 = 29.65
SVPT0 = 273.15
C1 = 0.001                                 # autoconversion rate [1/s]
C2 = 0.001                                 # autoconversion threshold [kg/kg]
C3 = 2.2                                   # accretion rate
C4 = 0.875                                 # accretion exponent
MAX_VT = 15.0                              # bound on rain fall speed [m/s]
MAX_CR_SEDIMENTATION = 0.75                # per-substep fall CFL target


def fall_substeps(dt: float, dz_min: float, max_vt: float = MAX_VT) -> int:
    """Static number of sedimentation substeps (host-side) for fall speeds
    capped at `max_vt`."""
    return max(1, min(60, math.ceil(max_vt * dt
                                    / (MAX_CR_SEDIMENTATION * dz_min))))


def density_factor(rho):
    """sqrt(rho_sfc / rho) [K, C]: the low-density amplification every fall
    law shares."""
    return torch.sqrt(rho[:1] / torch.clamp(rho, min=1e-12))


def _fall_velocity(qr, rho, rhofac=None):
    """Rain terminal fall speed [m/s]; rho is dry air density [kg/m^3].
    Capped at MAX_VT, the bound fall_substeps sizes the sedimentation CFL
    against (the low-density rhofac amplification could otherwise exceed it
    aloft in extreme columns)."""
    rhofac = density_factor(rho) if rhofac is None else rhofac
    vt = 36.34 * torch.clamp(qr * rho * 0.001, min=0.0) ** 0.1364 * rhofac
    return torch.clamp(vt, max=MAX_VT)


def sediment(q, rho, dz, dt: float, nfall: int, fall_velocity):
    """Upwind sedimentation of one species over `nfall` substeps with the
    fall law `fall_velocity(q, rho, rhofac)`.

    Returns (q_new, surface accumulation [C] in mm == kg/m^2 of water)."""
    dtfall = dt / nfall
    rho_dz = rho * dz
    rhofac = density_factor(rho)
    top = torch.zeros_like(q[:1])
    accum = torch.zeros_like(q[0])
    for _ in range(nfall):
        vt = fall_velocity(q, rho, rhofac)
        flux = rho * q * vt                        # downward mass flux [kg/m^2/s]
        # level k receives flux from k+1 above, loses its own; top gets none
        flux_in = torch.cat([flux[1:], top], dim=0)
        q = torch.clamp(q + dtfall * (flux_in - flux) / rho_dz, min=0.0)
        accum = accum + flux[0] * dtfall           # surface precipitation
    return q, accum


def _sediment(qr, rho, dz, dt: float, nfall: int):
    """Upwind rain sedimentation over `nfall` substeps.

    Returns (qr_new, rain_accum [C] in mm == kg/m^2 of water)."""
    return sediment(qr, rho, dz, dt, nfall, _fall_velocity)


def kessler(theta, qv, qc, qr, rho, exner, pressure, dz, dt: float,
            nfall: int):
    """One Kessler update.  All inputs level-major [K, C]; theta is the
    dry potential temperature.  Returns (theta, qv, qc, qr, rain [C] mm)."""
    # --- 1. sedimentation ---
    qr, rain = _sediment(qr, rho, dz, dt, nfall)

    # --- 2. autoconversion + accretion (production of rain) ---
    factorn = 1.0 / (1.0 + C3 * dt * torch.clamp(qr, min=0.0) ** C4)
    qrprod = (qc * (1.0 - factorn)
              + factorn * C1 * dt * torch.clamp(qc - C2, min=0.0))
    qrprod = torch.minimum(qrprod, qc)
    qc = torch.clamp(qc - qrprod, min=0.0)
    qr = torch.clamp(qr + qrprod, min=0.0)

    # --- 3. saturation adjustment + rain evaporation ---
    t = theta * exner
    p = torch.clamp(pressure, min=100.0)
    es = 1000.0 * SVP1 * torch.exp(SVP2 * (t - SVPT0) / (t - SVP3))   # Pa
    es = torch.minimum(es, 0.99 * p)
    qvs = EP2 * es / (p - es)
    f5 = SVP2 * (SVPT0 - SVP3) * XLV / constants.cp
    # linearized supersaturation removal (WRF kessler.F "prod")
    prod = (qv - qvs) / (1.0 + p / (p - es) * qvs * f5 / (t - SVP3) ** 2)

    # rain evaporation (ventilation form), limited by available subsaturation
    rqr = torch.clamp(rho * qr * 0.001, min=0.0)
    ern = (dt * ((1.6 + 124.9 * rqr ** 0.2046) * rqr ** 0.525)
           / (rho * (2.55e8 / (p * qvs) + 5.4e5))
           * torch.clamp(qvs - qv, min=0.0) / qvs)
    ern = torch.minimum(ern, torch.clamp(-prod - qc, min=0.0))
    ern = torch.minimum(ern, qr)
    ern = torch.clamp(ern, min=0.0)

    # condensation can't exceed available cloud when evaporating
    product = torch.maximum(prod, -qc)

    theta = theta + XLV / (constants.cp * exner) * (product - ern)
    qv = torch.clamp(qv - product + ern, min=0.0)
    qc = qc + product
    qr = qr - ern
    return theta, qv, qc, qr, rain


def column_inputs(state, static):
    """What a column scheme reads from the state: (rho, pressure, dz), with
    rho the dry density."""
    return (state.rho_zz * static.zz,
            static.pressure_base + state.pressure_p,
            static.zgrid[1:] - static.zgrid[:-1])


def rediagnose(state, static, theta_m):
    """theta_m and the coupled thermodynamic variables that follow from it
    by the equation of state (as atm_init_coupled_diagnostics does), as the
    fields of a State."""
    rgas, cp, p0 = constants.rgas, constants.cp, constants.p0
    rcv = rgas / (cp - rgas)
    rtheta_p = state.rho_zz * theta_m - static.rtheta_base
    exner = (static.zz * (rgas / p0) * (rtheta_p + static.rtheta_base)) ** rcv
    pressure_p = static.zz * rgas * (
        exner * rtheta_p + static.rtheta_base * (exner - static.exner_base))
    return dict(theta_m=theta_m, rtheta_p=rtheta_p, exner=exner,
                pressure_p=pressure_p)


def recouple(state, static, theta, species, precip):
    """Write a column scheme's result back: theta_m from the dry `theta` and
    qv = species[0], the coupled thermodynamic variables rediagnosed,
    `species` in the leading slots of a fresh scalars stack, and `precip`
    [C] added to rainnc."""
    theta_m = theta * (1.0 + constants.rvord * species[0])
    extra = [state.scalars[i]
             for i in range(len(species), state.scalars.shape[0])]
    scalars = torch.stack(list(species) + extra, dim=0)
    rainnc = (state.rainnc + precip) if state.rainnc is not None else precip
    return state.replace(**rediagnose(state, static, theta_m),
                         scalars=scalars, rainnc=rainnc)


def apply_kessler(state, static, vert, nl, dt: float):
    """Couple Kessler into the SRK3 step: update scalars + theta_m from the
    current state and rediagnose the coupled thermodynamic variables."""
    qv, qc, qr = (state.scalars[i] for i in range(3))
    theta = state.theta_m / (1.0 + constants.rvord * qv)
    rho, pressure, dz = column_inputs(state, static)
    theta, qv, qc, qr, rain = kessler(
        theta, qv, qc, qr, rho, state.exner, pressure, dz, dt,
        nfall=nl.config_kessler_nfall)
    return recouple(state, static, theta, [qv, qc, qr], rain)
