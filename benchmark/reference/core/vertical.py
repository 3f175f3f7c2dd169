"""Terrain-following hybrid vertical coordinate metrics.

Rebuilds the vertical-grid setup of the JW init (init_atm_cases.rg:163-237)
with the correct MPAS index semantics (the reference's 0-based translation of
the Fortran `(k-1)` shifts the stretching arrays by one level; here k=0 maps
to the surface, sh[0]=0, zw[0]=0, ah[0]=0).
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass
class VerticalGrid:
    """1-D vertical metric coefficients (vertical_fs, data_structures.rg:558-575).

    Index convention: K mass levels (0..K-1), K+1 interfaces (0..K).
    fzm/fzp/dzu/rdzu are interface quantities valid for k in 1..K-1 (slots 0
    and K are zero and never used); cf1..3 extrapolate interface-0 values from
    the lowest three mass levels.
    """
    nVertLevels: int
    ztop: float
    sh: np.ndarray      # [K+1] stretching of height surfaces
    zw: np.ndarray      # [K+1] zeta-coordinate interface heights (uniform)
    ah: np.ndarray      # [K+1] terrain-following -> height blend
    dzw: np.ndarray     # [K]
    rdzw: np.ndarray    # [K]
    zu: np.ndarray      # [K] zeta at mass levels
    dzu: np.ndarray     # [K+1] (valid 1..K-1)
    rdzu: np.ndarray    # [K+1]
    fzm: np.ndarray     # [K+1]
    fzp: np.ndarray     # [K+1]
    cf1: float
    cf2: float
    cf3: float
    # reference 1-D profiles for perturbation-form vertical mixing
    u_init: np.ndarray = None   # [K]
    v_init: np.ndarray = None   # [K]
    t_init: np.ndarray = None   # [K] (per-cell t_init lives in StaticState)


def make_vertical_grid(nVertLevels: int, ztop: float, stretch: float = 1.5) -> VerticalGrid:
    """Stretched height levels: sh[k] = (k*dz/zt)**stretch (init_atm_cases.rg:181),
    uniform zeta zw[k] = k*dz, blend ah[k] = 1 - cos(pi/2 * k*dz/zt)**6."""
    K = nVertLevels
    nz = K + 1
    dz = ztop / K
    k = np.arange(nz, dtype=np.float64)
    sh = (k * dz / ztop) ** stretch
    zw = k * dz
    ah = 1.0 - np.cos(0.5 * np.pi * k * dz / ztop) ** 6

    dzw = zw[1:] - zw[:-1]
    rdzw = 1.0 / dzw
    zu = 0.5 * (zw[:-1] + zw[1:])

    dzu = np.zeros(nz)
    rdzu = np.zeros(nz)
    fzm = np.zeros(nz)
    fzp = np.zeros(nz)
    dzu[1:K] = 0.5 * (dzw[1:] + dzw[:-1])
    rdzu[1:K] = 1.0 / dzu[1:K]
    fzp[1:K] = 0.5 * dzw[1:] / dzu[1:K]
    fzm[1:K] = 0.5 * dzw[:-1] / dzu[1:K]

    # surface extrapolation weights (init_atm_cases.rg:233-237)
    cof1 = (2.0 * dzu[1] + dzu[2]) / (dzu[1] + dzu[2]) * dzw[0] / dzu[1]
    cof2 = dzu[1] / (dzu[1] + dzu[2]) * dzw[0] / dzu[2]
    cf1 = fzp[1] + cof1
    cf2 = fzm[1] - cof1 - cof2
    cf3 = cof2

    return VerticalGrid(
        nVertLevels=K, ztop=ztop, sh=sh, zw=zw, ah=ah, dzw=dzw, rdzw=rdzw,
        zu=zu, dzu=dzu, rdzu=rdzu, fzm=fzm, fzp=fzp,
        cf1=float(cf1), cf2=float(cf2), cf3=float(cf3),
        u_init=np.zeros(K), v_init=np.zeros(K), t_init=np.zeros(K),
    )
