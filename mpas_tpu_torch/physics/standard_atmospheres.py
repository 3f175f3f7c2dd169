"""Approximate McClatchey et al. (1972) standard atmospheres.

A numpy copy of `mpas_tpu.physics.standard_atmospheres` (held array-equal
to it). Used by tools/calibrate_radiation.py to calibrate the LW
k-distribution and by tests/test_physics.py to validate the column solver
against ICRCCM-class published clear-sky benchmarks.  Profiles are analytic approximations
(linear tropospheric lapse, exponential water vapor normalized to the
published precipitable water, lognormal ozone normalized to the published
column) — good to the few-percent level that broadband flux benchmarks
resolve.
"""

from __future__ import annotations

import numpy as np

G = 9.80665
RD = 287.0


def standard_atmosphere(kind: str, K: int = 60):
    """Returns dict(t [K], q [kg/kg], o3 [kg/kg], pmid, pint [Pa], t_sfc) on
    K layers, index 0 = surface (MPAS vertical convention)."""
    zi = np.linspace(0.0, 50e3, K + 1)
    zm = 0.5 * (zi[:-1] + zi[1:])
    if kind == "tropical":
        t_sfc, trop_z, t_trop = 300.0, 17e3, 195.0
        pw_cm, o3_du = 4.1, 253.0
        q_scale = 1.9e3
    elif kind == "midlat_summer":
        t_sfc, trop_z, t_trop = 294.0, 13e3, 216.0
        pw_cm, o3_du = 2.9, 334.0
        q_scale = 2.1e3
    elif kind == "subarctic_winter":
        t_sfc, trop_z, t_trop = 257.0, 9e3, 217.0
        pw_cm, o3_du = 0.42, 486.0
        q_scale = 2.4e3
    else:
        raise ValueError(kind)

    lapse = (t_sfc - t_trop) / trop_z

    def temp(z):
        t = np.where(z < trop_z, t_sfc - lapse * z, t_trop)
        # stratospheric warming above 25 km toward ~270 K at 50 km
        t = np.where(z > 25e3, t_trop + (z - 25e3) * (270.0 - t_trop) / 25e3, t)
        return t

    tm = temp(zm)
    pint = np.zeros(K + 1)
    pint[0] = 101325.0
    for i in range(K):
        pint[i + 1] = pint[i] * np.exp(-G * (zi[i + 1] - zi[i]) / (RD * tm[i]))
    pmid = np.sqrt(pint[:-1] * pint[1:])

    # water vapor: exponential in z, normalized to the precipitable water
    q_raw = np.exp(-zm / q_scale)
    dp = pint[:-1] - pint[1:]
    col = (q_raw * dp / G).sum()            # kg/m^2 per unit q0
    q0 = (pw_cm * 10.0) / col               # 1 cm PW = 10 kg/m^2
    q = np.clip(q0 * q_raw, 2e-6, 0.03)

    # ozone: lognormal peak at 25 km (tropics) / 21 km, normalized to DU
    zpk = 25e3 if kind == "tropical" else 21e3
    o3_raw = np.exp(-0.5 * ((zm - zpk) / 5.5e3) ** 2) + 0.02
    colo3 = (o3_raw * dp / G).sum()
    o3_kg = o3_du * 2.1415e-5               # 1 DU = 2.1415e-5 kg/m^2
    o3 = o3_kg / colo3 * o3_raw
    return dict(t=tm, q=q, o3=o3, pmid=pmid, pint=pint, t_sfc=t_sfc)
