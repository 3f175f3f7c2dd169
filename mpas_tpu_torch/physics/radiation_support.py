"""CAM radiation support kernels.

The port of `mpas_tpu.physics.radiation_support`. The numpy functions are
copied as they are; `radozn` and `radinp` take torch tensors too, and
`vert_interpolate_j` is the device variant on tensors. The original
rebuilds the implemented support routines of physics/ra_cam_radctl_support.rg
(getfactors/validfactors :20-69, oznint :71-131, radozn :136-215,
radinp :227-272, vert_interpolate :353-532) and radconst
(atmphys_driver_radiation_swlw.rg:28-66), vectorized: the reference's
per-column index-search loops become searchsorted interpolation.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants

DATE_OZ = np.array([16, 45, 75, 105, 136, 166, 197, 228, 258, 289, 319, 350])


def validfactors(fact1, fact2, delta=1e-6):
    return (abs(fact1 + fact2 - 1.0) <= delta
            and -delta <= fact1 <= 1.0 + delta
            and -delta <= fact2 <= 1.0 + delta)


def getfactors(cycflag: bool, np1: int, cdayminus: float, cdayplus: float,
               cday: float):
    """Linear time interpolation weights for a cyclic boundary dataset
    (ra_cam_radctl_support.rg:39-69; the reference's out-of-range weights at
    year start — 'Bad fact1/fact2' in output.txt — stem from passing julian=0
    with np1=0; the wrap branch below handles it)."""
    if cycflag and np1 == 0:
        deltat = cdayplus + constants.daysperyear - cdayminus
        if cday > cdayplus:
            fact1 = (cdayplus + constants.daysperyear - cday) / deltat
            fact2 = (cday - cdayminus) / deltat
        else:
            fact1 = (cdayplus - cday) / deltat
            fact2 = (cday + constants.daysperyear - cdayminus) / deltat
    else:
        deltat = cdayplus - cdayminus
        fact1 = (cdayplus - cday) / deltat
        fact2 = (cday - cdayminus) / deltat
    assert validfactors(fact1, fact2), (fact1, fact2)
    return fact1, fact2


def oznint(julian: float, ozmixm: np.ndarray, ozncyc: bool = True):
    """Time-interpolate monthly ozone climatology to the current julian day
    (ra_cam_radctl_support.rg:71-131).  ozmixm: [nMonths, ..., levsiz]."""
    intjulian = julian + 1.0
    ijul = int(np.floor(intjulian))
    intjulian = intjulian - ijul
    ijul = ijul % constants.daysperyear
    if ijul == 0:
        ijul = constants.daysperyear
    intjulian = intjulian + ijul

    later = np.nonzero(DATE_OZ > intjulian)[0]
    np1 = int(later[0]) if len(later) else 0
    cdayozp = DATE_OZ[np1]
    nm = np1 - 1 if np1 > 0 else 11
    cdayozm = DATE_OZ[nm]
    fact1, fact2 = getfactors(ozncyc, np1, cdayozm, cdayozp, intjulian)
    return ozmixm[nm] * fact1 + ozmixm[np1] * fact2


def radozn(pmid, pin, ozmix):
    """Interpolate ozone from data pressure levels to model levels
    (ra_cam_radctl_support.rg:136-215), vectorized with searchsorted.

    pmid [cols, pver] model mid-level pressures; pin [levsiz] data pressures
    (ascending); ozmix [cols, levsiz].  Extrapolation matches the reference:
    above the top data level o3 scales with p/pin[0]; below the bottom it is
    held constant.  Numpy arrays in, numpy out; tensors in, tensors out."""
    if torch.is_tensor(pmid):
        return _radozn_torch(pmid, pin, ozmix)
    levsiz = pin.shape[0]
    kupper = np.clip(np.searchsorted(pin, pmid, side="right") - 1, 0, levsiz - 2)
    dpu = pmid - pin[kupper]
    dpl = pin[kupper + 1] - pmid
    oz_u = np.take_along_axis(ozmix, kupper, axis=1)
    oz_l = np.take_along_axis(ozmix, kupper + 1, axis=1)
    o3 = (oz_u * dpl + oz_l * dpu) / (dpl + dpu)
    o3 = np.where(pmid < pin[0], ozmix[:, :1] * pmid / pin[0], o3)
    o3 = np.where(pmid > pin[-1], ozmix[:, -1:], o3)
    return o3


def _radozn_torch(pmid, pin, ozmix):
    """radozn on tensors: searchsorted on the 1-D data pressures, the
    bracketing values read with torch.gather."""
    levsiz = pin.shape[0]
    kupper = torch.clamp(
        torch.searchsorted(pin, pmid.contiguous(), right=True) - 1,
        0, levsiz - 2)
    dpu = pmid - pin[kupper]
    dpl = pin[kupper + 1] - pmid
    oz_u = torch.gather(ozmix, 1, kupper)
    oz_l = torch.gather(ozmix, 1, kupper + 1)
    o3 = (oz_u * dpl + oz_l * dpu) / (dpl + dpu)
    o3 = torch.where(pmid < pin[0], ozmix[:, :1] * pmid / pin[0], o3)
    o3 = torch.where(pmid > pin[-1], ozmix[:, -1:], o3)
    return o3


def radinp(pmid, pint, o3vmr):
    """Convert to cgs + ozone volume->mass mixing ratio
    (ra_cam_radctl_support.rg:227-272)."""
    pbr = pmid * 10.0
    pnm = pint * 10.0
    vmmr = constants.amo / constants.amd
    o3mmr = vmmr * o3vmr
    return pbr, pnm, o3mmr


def vert_interpolate(Match_ps, aerosolc, m_hybi, pint):
    """Aerosol column mass -> model levels -> mass mixing ratio
    (ra_cam_radctl_support.rg:353-532), vectorized.

    Match_ps [cols]; aerosolc [cols, paerlev+1, naer] cumulative column mass
    below each data interface (aerosolc[0] = column total at the data top,
    aerosolc[-1] = 0 at the data surface); m_hybi [paerlev+1] ascending
    top->surface; pint [cols, pver+1] model interfaces **bottom-up**
    (index 0 = surface).  AER[:, k] = mass below model interface k, so it
    increases with k and layer mass = AER[:, k+1] - AER[:, k]."""
    cols, pverp = pint.shape
    pver = pverp - 1
    naer = aerosolc.shape[2]
    paerlev = m_hybi.shape[0] - 1

    # cumulative aerosol mass (below) at model interfaces, bottom-up
    AER = np.zeros((cols, pverp, naer))
    AER[:, 0] = aerosolc[:, -1]                            # surface: 0 below
    v = m_hybi[None, :] * Match_ps[:, None]                # [cols, paerlev+1]
    for k in range(1, pverp):
        x = pint[:, k]
        ku = np.clip((v < x[:, None]).sum(axis=1) - 1, 0, paerlev - 1)
        dpu = x - np.take_along_axis(v, ku[:, None], 1)[:, 0]
        dpl = np.take_along_axis(v, (ku + 1)[:, None], 1)[:, 0] - x
        au = np.take_along_axis(aerosolc, ku[:, None, None], 1)[:, 0]
        al = np.take_along_axis(aerosolc, (ku + 1)[:, None, None], 1)[:, 0]
        interp = (au * dpl[:, None] + al * dpu[:, None]) / (dpl + dpu)[:, None]
        above = x < v[:, 0]
        below = x > v[:, -1]
        AER[:, k] = np.where(above[:, None], aerosolc[:, 0],
                             np.where(below[:, None], aerosolc[:, -1], interp))
    AER[AER < 1e-40] = 0.0

    diff = AER[:, 1:] - AER[:, :-1]                         # [cols, pver, naer]
    small = np.abs(diff) < 1e-15 * AER[:, -1:]
    diff = np.where(small, 0.0, diff)
    m_to_mmr = constants.gravity / (pint[:, :-1] - pint[:, 1:])
    return np.maximum(diff, 0.0) * m_to_mmr[:, :, None]


def radconst(julian: float):
    """Solar declination and eccentricity-scaled solar constant
    (atmphys_driver_radiation_swlw.rg:28-66)."""
    degrad, dpd = constants.degrad, constants.dpd
    obecl = 23.5 * degrad
    sinob = np.sin(obecl)
    sxlong = dpd * (julian - 80.0) if julian > 80.0 else dpd * (julian + 285.0)
    sxlong *= degrad
    declin = np.arcsin(sinob * np.sin(sxlong))
    rjul = julian * 360.0 / 365.0 * degrad
    eccfac = (1.000110 + 0.034221 * np.cos(rjul) + 0.001280 * np.sin(rjul)
              + 0.000719 * np.cos(2 * rjul) + 0.000077 * np.sin(2 * rjul))
    solcon = constants.solcon_0 * eccfac
    return float(declin), float(solcon)


# ---------------------------------------------------------------------------
# device variant (the per-interval path; the numpy versions above stay as
# init-time/host tools and test oracles)
# ---------------------------------------------------------------------------

def vert_interpolate_j(Match_ps, aerosolc, m_hybi, pint):
    """vert_interpolate on tensors (ra_cam_radctl_support.rg:353-532):
    cumulative aerosol column mass on hybrid data interfaces -> model-level
    mass mixing ratios.  aerosolc [paerlev+1, naer] (column-independent
    climatology; mass below each data interface — aerosolc[0] = column total
    at the data top, aerosolc[-1] = 0 at the data surface), m_hybi
    [paerlev+1], pint [cols, pver+1] model interfaces **bottom-up** (index 0
    = surface), Match_ps [cols].  AER[:, k] = mass below model interface k,
    increasing with k; layer mass = AER[:, k+1] - AER[:, k].

    mpas_tpu loops over the model interfaces, one independent search each;
    here all interfaces k >= 1 are searched at once on a [cols, pver,
    paerlev+1] comparison, with the same arithmetic per element."""
    cols = pint.shape[0]
    paerlev = m_hybi.shape[0] - 1
    naer = aerosolc.shape[1]

    v = m_hybi[None, :] * Match_ps[:, None]               # [cols, paerlev+1]
    x = pint[:, 1:]                                       # [cols, pver]
    ku = torch.clamp((v[:, None, :] < x[:, :, None]).sum(dim=2) - 1,
                     0, paerlev - 1)
    vu = torch.gather(v, 1, ku)
    vl = torch.gather(v, 1, ku + 1)
    dpu = x - vu
    dpl = vl - x
    au = aerosolc[ku]                                     # [cols, pver, naer]
    al = aerosolc[ku + 1]
    interp = (au * dpl[..., None] + al * dpu[..., None]) / (dpl + dpu)[..., None]
    above = (x < v[:, :1])[..., None]
    below = (x > v[:, -1:])[..., None]
    levels = torch.where(above, aerosolc[0], torch.where(below, aerosolc[-1],
                                                         interp))
    surface = aerosolc[-1].expand(cols, 1, naer)          # surface: 0 below
    AER = torch.cat([surface, levels], dim=1)             # [cols, pver+1, naer]
    AER = torch.where(AER < 1e-40, 0.0, AER)

    diff = AER[:, 1:] - AER[:, :-1]
    diff = torch.where(diff.abs() < 1e-15 * AER[:, -1:], 0.0, diff)
    m_to_mmr = constants.gravity / (pint[:, :-1] - pint[:, 1:]).abs()
    return torch.clamp(diff, min=0.0) * m_to_mmr[:, :, None]
