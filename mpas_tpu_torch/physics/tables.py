"""Saturation vapor pressure tables (CAM radiation initialization).

The port of `mpas_tpu.physics.tables`. The table constructors are numpy,
copied as they are (held array-equal to the original); `estblf_j` /
`aqsat_j` are the device lookups, on torch tensors. The original rebuilds
the fully-implemented part of the reference physics
(physics/atmphys_camrad_init.rg): Goff & Gratch (1946) saturation vapor
pressure over water/ice with a blended transition (gffgch, :37-123), the
es lookup table (gestbl, :174-245), the H2O path-temperature table
(radaeini, :125-148), and the camradinit orchestration (:310-322) — all
vectorized instead of per-scalar task calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import constants

PLENEST = constants.plenest   # 250
NTEMP = constants.ntemp       # 192


def gffgch(t, itype: float = -20.0):
    """Saturation vapor pressure [Pa] at temperature(s) t [K]
    (atmphys_camrad_init.rg:37-123), vectorized.

    itype semantics follow the reference: 0 -> water only; 1 -> ice below
    freezing; negative -> |itype|-degree blended transition below freezing.
    """
    t = np.asarray(t, dtype=np.float64)
    tmelt = constants.tmelt
    if itype < 0:
        tr = abs(float(itype))
        use_ice = True
    elif itype == 1:
        tr = 0.0
        use_ice = True
    else:
        tr = 0.0
        use_ice = False

    # water branch (Goff-Gratch over liquid)
    ps = 1013.246
    ts = 373.16
    e1 = 11.344 * (1.0 - t / ts)
    e2 = -3.49149 * (ts / t - 1.0)
    f1 = -7.90298 * (ts / t - 1.0)
    f2 = 5.02808 * np.log10(ts / t)
    f3 = -1.3816 * (10.0 ** e1 - 1.0) / 1.0e7
    f4 = 8.1328 * (10.0 ** e2 - 1.0) / 1.0e3
    f5 = np.log10(ps)
    es_water = 10.0 ** (f1 + f2 + f3 + f4 + f5) * 100.0

    if not use_ice:
        return es_water

    # ice branch (Goff-Gratch over ice)
    t0 = tmelt
    term1 = 2.01889049 / (t0 / t)
    term2 = 3.56654 * np.log(t0 / t)
    term3 = 20.947031 * (t0 / t)
    es_ice = 575.185606e10 * np.exp(-(term1 + term2 + term3))

    if tr > 0.0:
        weight = np.minimum((tmelt - t) / tr, 1.0)
        es_blend = weight * es_ice + (1.0 - weight) * es_water
        es = np.where(t >= tmelt, es_water,
                      np.where(t < tmelt - tr, es_ice, es_blend))
    else:
        es = np.where(t >= tmelt, es_water, es_ice)
    return es


@dataclass
class SaturationTables:
    """phys_tbls_fs equivalent (data_structures.rg:586-618)."""
    tmin: float = 173.16
    tmax: float = 375.16
    ttrice: float = 20.0
    icephs: bool = True
    epsqs: float = constants.ep_2
    hlatv: float = 2.501e6
    hlatf: float = 3.336e5
    rgasv: float = constants.R_v
    cp: float = constants.cp
    tmelt: float = 273.16
    lentbl: int = 0
    estbl: np.ndarray = None       # [PLENEST]
    estblh2o: np.ndarray = None    # [NTEMP]
    pcf: np.ndarray = None         # [5] degree-5 polynomial coefficients


def gestbl() -> SaturationTables:
    """Build the es lookup table (atmphys_camrad_init.rg:174-245)."""
    tb = SaturationTables()
    tb.lentbl = int(tb.tmax - tb.tmin + 2.000001)
    itype = -tb.ttrice if (tb.icephs and tb.ttrice != 0.0) else (1 if tb.icephs else 0)
    t = tb.tmin + np.arange(tb.lentbl, dtype=np.float64)
    estbl = np.full(PLENEST, -99999.0)
    estbl[:tb.lentbl] = gffgch(t, itype)
    tb.estbl = estbl
    # degree-5 polynomial: es_water - es_ice difference in the transition range
    tb.pcf = np.array([5.04469588506e-01, -5.47288442819e+00,
                       -3.67471858735e-01, -8.95963532403e-03,
                       -7.78053686625e-05])
    return tb


def radaeini(tb: SaturationTables) -> SaturationTables:
    """H2O path-temperature saturation table for abs/emis RH (water only;
    atmphys_camrad_init.rg:125-148)."""
    tmin = round(constants.min_tp_h2o)
    tmax = round(constants.max_tp_h2o) + 1
    t = np.arange(tmin - 1, tmax, dtype=np.float64)
    estblh2o = np.zeros(NTEMP)
    estblh2o[:len(t)] = gffgch(t, itype=0)
    tb.estblh2o = estblh2o
    return tb


def esinti() -> SaturationTables:
    return gestbl()


def radini(tb: SaturationTables | None = None) -> SaturationTables:
    tb = tb or SaturationTables()
    if tb.estbl is None:
        tb = gestbl()
    return radaeini(tb)


def camradinit() -> SaturationTables:
    """camradinit: radini -> esinti (-> oznini/aerosol_init handled by the
    climatology loaders in physics/driver.py); atmphys_camrad_init.rg:310-322."""
    tb = gestbl()
    tb = radaeini(tb)
    return tb


def estblf(td, tb: SaturationTables):
    """Vectorized table lookup of saturation vapor pressure
    (ra_cam_radctl_support.rg:277-289)."""
    e = np.clip(td, tb.tmin, tb.tmax)
    ai = np.floor(e - tb.tmin)
    i = ai.astype(np.int32)
    w = (tb.tmin + ai - e + 1.0)
    return w * tb.estbl[i] - (tb.tmin + ai - e) * tb.estbl[i + 1]


def aqsat(t, p, tb: SaturationTables):
    """Saturation vapor pressure + specific humidity
    (ra_cam_radctl_support.rg:299-339), vectorized."""
    omeps = 1.0 - constants.ep_2
    esat = estblf(t, tb)
    qsat = constants.ep_2 * esat / (p - omeps * esat)
    qsat = np.minimum(1.0, qsat)
    bad = qsat < 0.0
    qsat = np.where(bad, 1.0, qsat)
    esat = np.where(bad, p, esat)
    return esat, qsat


# ---------------------------------------------------------------------------
# device variants (the `_j` names of mpas_tpu's jnp lookups); the tables
# come as tensors in the dict that driver._device_tables builds
# ---------------------------------------------------------------------------

def estblf_j(td, phys_j):
    """estblf on the device-resident estbl tensor: the index is the floor
    cast to int64, read by indexing."""
    tmin, tmax = phys_j["tmin"], phys_j["tmax"]
    e = torch.clamp(td, tmin, tmax)
    ai = torch.floor(e - tmin)
    i = ai.to(torch.int64)
    w = tmin + ai - e + 1.0
    estbl = phys_j["estbl"]
    return w * estbl[i] - (tmin + ai - e) * estbl[i + 1]


def aqsat_j(t, p, phys_j):
    """aqsat on tensors (ra_cam_radctl_support.rg:299-339)."""
    omeps = 1.0 - constants.ep_2
    esat = estblf_j(t, phys_j)
    qsat = constants.ep_2 * esat / (p - omeps * esat)
    qsat = torch.clamp(qsat, max=1.0)
    bad = qsat < 0.0
    qsat = torch.where(bad, 1.0, qsat)
    esat = torch.where(bad, p, esat)
    return esat, qsat
