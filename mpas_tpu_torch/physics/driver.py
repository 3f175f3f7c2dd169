"""Physics driver: cloudiness + multi-band CAM-style SW/LW radiation.

The port of `mpas_tpu.physics.driver`, which rebuilds the reference
physics-driver call tree (atmphys_driver.rg:23-62,
atmphys_driver_cloudiness.rg, atmphys_driver_radiation_swlw.rg, ra_cam.rg)
— physics_init -> per-interval driver: cloudiness -> SW radiation -> LW
radiation — with working column physics where the reference has empty
stubs: an RH cloud fraction with condensate incidence, the cloud optics and
the multi-band solver of physics/radiation.py, a built-in ozone climatology
through oznint -> radozn -> radinp, and a background sulfate aerosol through
vert_interpolate.

The host half (the climatologies, `PhysicsState`, `physics_init`,
`time_params`) is numpy, as in mpas_tpu. The per-interval path is torch on
the model's device: `make_radiation_fn` returns a closure over device
tables built once; the time-dependent scalars (ozone month weights, solar
declination and eccentricity, hour angle) come from `time_params` each
radiation interval.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants
from . import radiation as rad
from . import radiation_support as rs
from . import tables as tbl


# ---------------------------------------------------------------------------
# initialization (physics_init / camradinit)
# ---------------------------------------------------------------------------

def standard_ozone_profile(levsiz: int = constants.nOznLevels):
    """Built-in climatological ozone: pressure levels [Pa] + volume mixing
    ratio with a stratospheric peak near 10 hPa (oznini slot,
    atmphys_camrad_init.rg:258-264)."""
    pin = np.logspace(np.log10(100.0), np.log10(1.0e5), levsiz)   # 1..1000 hPa
    p_hpa = pin / 100.0
    # single-mode lognormal peak ~ 8 ppmv at 10 hPa, ~0.03 ppmv at surface
    o3 = 8.0e-6 * np.exp(-0.5 * (np.log(p_hpa / 10.0) / 1.1) ** 2) + 3.0e-8
    return pin, o3


def background_aerosol(naer: int = constants.naer,
                       paerlev: int = constants.nAerLevels):
    """Background sulfate-like climatology in the reference's aerosolc
    layout (aerosol_fs, data_structures.rg:631-639): cumulative column mass
    [kg/m^2] BELOW each hybrid data interface — aerosolc[0] = the column
    total at the data top, aerosolc[-1] = 0 at the data surface (the
    convention radiation_support.vert_interpolate consumes).  Total burden
    4 mg/m^2 split over the species slots, mass concentrated in the
    boundary layer (hybrid coordinate ~ p/ps)."""
    m_hybi = np.linspace(0.0, 1.0, paerlev + 1)
    total = 4.0e-6                                        # kg/m^2 column
    # atmospheric mass between hybrid level eta and the surface falls like
    # 1 - eta^2 (low-level aerosol): everything is below the eta=0 top
    # interface, nothing below the eta=1 surface interface
    below = total * (1.0 - m_hybi ** 2)                   # mass below interface
    aerosolc = np.repeat(below[:, None], naer, axis=1) / naer
    return m_hybi, aerosolc


@dataclass
class PhysicsState:
    """Tables + climatologies (phys_tbls_fs / ozn_fs / aerosol_fs analog)."""
    tables: tbl.SaturationTables
    pin: np.ndarray          # [nOznLevels] ozone data pressures
    ozmixm: np.ndarray       # [nMonths, nOznLevels] monthly ozone vmr
    m_hybi: np.ndarray       # [nAerLevels+1] aerosol hybrid interface coords
    aerosolc: np.ndarray     # [nAerLevels+1, naer] cumulative column mass


def physics_init(n_cells: int | None = None) -> PhysicsState:
    """physics_init -> camradinit (atmphys_init.rg:9-23)."""
    tables = tbl.camradinit()
    pin, o3 = standard_ozone_profile()
    # annual cycle: +-15% seasonal modulation of the column
    months = np.arange(constants.nMonths)
    seasonal = 1.0 + 0.15 * np.cos(2 * np.pi * (months - 3) / 12.0)
    ozmixm = seasonal[:, None] * o3[None, :]
    m_hybi, aerosolc = background_aerosol()
    return PhysicsState(tables=tables, pin=pin, ozmixm=ozmixm, m_hybi=m_hybi,
                        aerosolc=aerosolc)


def time_params(phys: PhysicsState, julian: float, dtype=torch.float32,
                device="cuda"):
    """Host-side per-interval time factors (the physics_timetracker slot):
    month-interpolated ozone, solar declination + eccentricity-scaled solar
    constant, hour angle; computed in numpy, returned as tensors of `dtype`
    on `device`."""
    ozmix_now = rs.oznint(julian, phys.ozmixm)
    declin, solcon = rs.radconst(max(julian % constants.daysperyear, 1e-3))
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return dict(ozmix=as_t(ozmix_now), declin=as_t(declin),
                solcon=as_t(solcon), hour=as_t(2.0 * np.pi * (julian % 1.0)))


# ---------------------------------------------------------------------------
# cloudiness (driver_cloudiness)
# ---------------------------------------------------------------------------

def calc_cldfraction(qv, qsat):
    """RH-based fractional cloudiness (the empty calc_cldfraction slot):
    cldfra = ((RH - RHc)/(1 - RHc))^2, RHc = 0.80."""
    rh = torch.clamp(qv / torch.clamp(qsat, min=1e-12), 0.0, 1.0)
    rhc = 0.80
    return torch.clamp((rh - rhc) / (1.0 - rhc), 0.0, 1.0) ** 2


def calc_cldincidence(qc, qi=None):
    """0/1 cloud incidence from condensate (calc_cldincidence slot), in the
    input's dtype."""
    qtot = qc if qi is None else qc + qi
    return (qtot > 1e-8).to(qtot.dtype)


def driver_cloudiness(qv, qsat, scheme: str = "cld_fraction", qc=None):
    if scheme == "cld_incidence":
        return calc_cldincidence(qc if qc is not None else torch.zeros_like(qv))
    cf = calc_cldfraction(qv, qsat)
    if qc is not None:
        cf = torch.maximum(cf, calc_cldincidence(qc))
    return cf


# ---------------------------------------------------------------------------
# column pressures & zenith angle
# ---------------------------------------------------------------------------

def _column_pressures(pressure, pressure_sfc):
    """Mid and interface pressures per column from 3-D pressure [C, K];
    the interfaces [C, K+1] are built level-major (a view of a contiguous
    [K+1, C] tensor), as the solver reads them."""
    p = pressure.T
    p_top = torch.clamp(1.5 * p[-1] - 0.5 * p[-2], min=1.0)
    pint = torch.cat([pressure_sfc[None], 0.5 * (p[:-1] + p[1:]),
                      p_top[None]])
    return pressure, pint.T


def cosine_zenith(lat, lon, declin, hour):
    """Cosine solar zenith angle; `hour` = 2*pi*(julian % 1); declin and
    hour are tensors (0-d)."""
    hour_angle = hour + lon - math.pi
    return (torch.sin(lat) * torch.sin(declin)
            + torch.cos(lat) * torch.cos(declin) * torch.cos(hour_angle))


# ---------------------------------------------------------------------------
# radctl: the full chain
# ---------------------------------------------------------------------------

def radctl(phys_j: dict, t, qv, pmid, pint, cldfra, cwp, coszrs, tp,
           albedo=0.2, emiss=0.95, tsfc=None, qc=None):
    """The radctl chain (ra_cam.rg:31-128): ozone time/vertical
    interpolation, cgs conversion, saturation humidity, aerosol vertical
    interpolation, then the multi-band SW/LW solves.

    `phys_j`: device-side tables from `_device_tables`.  `tp`: time_params.
    Returns dict with heating rates [K/s] (qrs, qrl), surface fluxes and
    TOA diagnostics."""
    C = t.shape[0]
    ozmix = tp["ozmix"][None, :].expand(C, -1)
    o3vmr = rs.radozn(pmid, phys_j["pin"], ozmix)
    _, _, o3mmr = rs.radinp(pmid, pint, o3vmr)
    esat, qsat = tbl.aqsat_j(t, pmid, phys_j)

    # aerosol path: vert_interpolate (ra_cam_radctl_support.rg:353-532) from
    # the background climatology to model levels, summed over species
    aer = rs.vert_interpolate_j(pint[:, 0], phys_j["aerosolc"],
                                phys_j["m_hybi"], pint)
    aer_mmr = aer.sum(dim=-1)

    tsfc = tsfc if tsfc is not None else t[:, 0]
    rel, rei = rad.cldefr(t)
    fice = rad.ice_fraction(t)
    cld_emis = rad.cldems(cwp, rei, fice)

    sw = rad.sw_fluxes(coszrs, tp["solcon"], pmid, pint, qv, o3mmr, cldfra,
                       cwp, rel, rei, fice, aer_mmr=aer_mmr, albedo=albedo)
    lw = rad.lw_fluxes(t, qv, o3mmr, pmid, pint, cld_emis, cldfra, tsfc,
                       emiss=emiss)
    return dict(qrs=sw["qrs"], qrl=lw["qrl"], o3vmr=o3vmr, qsat=qsat,
                esat=esat, aer_mmr=aer_mmr, swdnb=sw["swdnb"],
                fsns=sw["fsns"], fsnt=sw["fsnt"], swup_toa=sw["swup_toa"],
                solin=sw["solin"], lwdnb=lw["lwdnb"], olr=lw["olr"],
                flns=lw["flns"], solcon=tp["solcon"], declin=tp["declin"])


def _device_tables(phys: PhysicsState, dtype, device):
    tb = phys.tables
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return dict(estbl=as_t(tb.estbl), tmin=tb.tmin, tmax=tb.tmax,
                pin=as_t(phys.pin), m_hybi=as_t(phys.m_hybi),
                aerosolc=as_t(phys.aerosolc))


def radiation_columns(phys_j, lat, lon, theta_m, exner, pressure,
                      surface_pressure, qv, qc, tp):
    """Pure columnar radiation update on [C, K] fields.

    Returns (rthraten [C, K], diags dict)."""
    qv = torch.zeros_like(theta_m) if qv is None else qv
    t = theta_m * exner / (1.0 + constants.rvord * qv)
    pmid, pint = _column_pressures(pressure, surface_pressure)
    _, qsat = tbl.aqsat_j(t, pmid, phys_j)
    cldfra = driver_cloudiness(qv, qsat, qc=qc)
    g = constants.gravity
    dp = (pint[:, :-1] - pint[:, 1:]).abs()
    if qc is not None:
        # grid-mean condensate -> in-cloud water path [g/m^2]
        cwp = qc * dp / g * 1e3 / torch.clamp(cldfra, min=0.05)
    else:
        # no prognostic condensate: climatological in-cloud CWP
        cwp = torch.where(cldfra > 0.0, 60.0, torch.zeros_like(cldfra))
    coszrs = cosine_zenith(lat, lon, tp["declin"], tp["hour"])
    out = radctl(phys_j, t, qv, pmid, pint, cldfra, cwp, coszrs, tp)
    rthraten = (out["qrs"] + out["qrl"]) / exner
    out["cldfra"] = cldfra
    return rthraten, out


def make_radiation_fn(phys: PhysicsState, dtype=torch.float32, device="cuda"):
    """Returns radiation(lat, lon, theta_m, exner, pressure, sp, qv, qc, tp)
    -> (rthraten, diags), closed over the device tables (built once)."""
    phys_j = _device_tables(phys, dtype, device)

    def radiation(lat, lon, theta_m, exner, pressure, sp, qv, qc, tp):
        return radiation_columns(phys_j, lat, lon, theta_m, exner, pressure,
                                 sp, qv, qc, tp)

    return radiation


# ---------------------------------------------------------------------------
# numpy-facing driver (kept for tests / host-side use)
# ---------------------------------------------------------------------------

def physics_driver(phys: PhysicsState, state_np: dict, mesh, julian: float,
                   device="cuda"):
    """Per-interval physics driver (atmphys_driver.rg:23-62): cloudiness ->
    SW radiation -> LW radiation -> diabatic theta tendency, on `device`.

    `state_np` needs: theta_m [C,K], exner [C,K], pressure [C,K],
    surface_pressure [C], qv [C,K] (zeros if dry), optional qc.
    Returns dict with rthraten (d(theta)/dt, K/s), cldfra, and flux
    diagnostics (numpy)."""
    dtype = (torch.float64 if state_np["theta_m"].dtype == np.float64
             else torch.float32)
    phys_j = _device_tables(phys, dtype, device)
    tp = time_params(phys, julian, dtype, device)
    as_t = lambda a: None if a is None else torch.as_tensor(
        np.asarray(a), dtype=dtype, device=device)
    rthraten, out = radiation_columns(
        phys_j, as_t(mesh.latCell), as_t(mesh.lonCell),
        as_t(state_np["theta_m"]), as_t(state_np["exner"]),
        as_t(state_np["pressure"]), as_t(state_np["surface_pressure"]),
        as_t(state_np.get("qv")), as_t(state_np.get("qc")), tp)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res["rthraten"] = rthraten.cpu().numpy()
    return res
