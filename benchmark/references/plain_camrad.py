"""A plain CAM-slot radiation for the benchmark's references: the cloudiness,
the ozone and aerosol climatologies, the multi-band Lacis-Hansen shortwave
and the k-distribution longwave that fill CAM's radcswmx / radclwmx slots,
and the heating they give the dycore (rt_diabatic_tend).

The equations are those of mpas_tpu/physics/driver.py, radiation.py,
radiation_support.py and tables.py, read and written out again: plain
torch in the state's precision (float64 for the comparison), [C, K]
columns with k = 0 the lowest layer, one spectral term at a time (the
visible region and 6 near-infrared water-vapour terms in the shortwave, 4
water-vapour, 3 carbon-dioxide and 1 ozone term in the longwave), and a
Python loop over levels for every scan. Nothing of the program under test
is imported. Where this file departs from mpas_tpu's form, a comment says
so; no departure changes a value beyond rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import constants as c

# ---------------------------------------------------------------------------
# the solver's calibrated constants (mpas_tpu/physics/radiation.py)
# ---------------------------------------------------------------------------

W_NIR = 2.9 / 5.925
SW_H2O_W = (0.564197, 0.170715, 0.108440, 0.075501, 0.052213, 0.028934)
SW_H2O_K = (3.200809e-03, 7.470748e-02, 4.354802e-01, 2.552351e+00,
            1.834175e+01, 1.427858e+02)
LW_H2O_W = (0.1795333, 0.06720974, 0.4838243, 0.1036203)
LW_H2O_K = (9.532292e-03, 1.350079e-01, 1.714313e+01, 3.564001e+06)
LW_CO2_W = 0.125812
LW_CO2_K = 0.802783
LW_CO2_SPLIT = ((0.55, 1.0), (0.30, 25.0), (0.15, 625.0))
LW_O3_W = 0.04
LW_O3_K = 0.126267
LW_CNT_K = 0.212141
DIFF = 1.66
CO2_VMR = 3.8e-4
AER_K_EXT = 3.0
AER_OMEGA = 0.95
AER_G = 0.65
ALBEDO = 0.2                 # radctl's surface albedo (no land surface)
EMISS = 0.95                 # radctl's surface emissivity
RH_CLOUD = 0.80              # calc_cldfraction's critical humidity

# ---------------------------------------------------------------------------
# host tables and climatologies (tables.py, driver.py), numpy float64
# ---------------------------------------------------------------------------

T_MIN, T_MAX = 173.16, 375.16
DATE_OZ = (16, 45, 75, 105, 136, 166, 197, 228, 258, 289, 319, 350)


def goff_gratch(t):
    """Saturation vapour pressure [Pa] over water above freezing, over ice
    20 K below it, blended in between (gffgch with itype -20)."""
    ts = 373.16
    e1 = 11.344 * (1.0 - t / ts)
    e2 = -3.49149 * (ts / t - 1.0)
    f1 = -7.90298 * (ts / t - 1.0)
    f2 = 5.02808 * np.log10(ts / t)
    f3 = -1.3816 * (10.0 ** e1 - 1.0) / 1.0e7
    f4 = 8.1328 * (10.0 ** e2 - 1.0) / 1.0e3
    f5 = np.log10(1013.246)
    water = 10.0 ** (f1 + f2 + f3 + f4 + f5) * 100.0
    t0 = c.tmelt
    ice = 575.185606e10 * np.exp(-(2.01889049 / (t0 / t)
                                   + 3.56654 * np.log(t0 / t)
                                   + 20.947031 * (t0 / t)))
    weight = np.minimum((c.tmelt - t) / 20.0, 1.0)
    blend = weight * ice + (1.0 - weight) * water
    return np.where(t >= c.tmelt, water,
                    np.where(t < c.tmelt - 20.0, ice, blend))


def saturation_table():
    """The es table at 1 K steps from T_MIN (gestbl), padded to plenest
    entries with -99999."""
    n = int(T_MAX - T_MIN + 2.000001)
    table = np.full(c.plenest, -99999.0)
    table[:n] = goff_gratch(T_MIN + np.arange(n, dtype=np.float64))
    return table


def ozone_climatology():
    """(data pressures [Pa] ascending, [12, levels] monthly volume mixing
    ratios): a lognormal peak of 8 ppmv at 10 hPa over 0.03 ppmv, with a
    +-15% seasonal cycle."""
    pin = np.logspace(np.log10(100.0), np.log10(1.0e5), c.nOznLevels)
    o3 = (8.0e-6 * np.exp(-0.5 * (np.log(pin / 100.0 / 10.0) / 1.1) ** 2)
          + 3.0e-8)
    months = np.arange(c.nMonths)
    seasonal = 1.0 + 0.15 * np.cos(2 * np.pi * (months - 3) / 12.0)
    return pin, seasonal[:, None] * o3[None, :]


def aerosol_climatology():
    """(hybrid data interfaces, top 0 to surface 1; [interfaces, species]
    column mass [kg/m^2] below each): 4 mg/m^2 in all, the mass below eta
    falling as 1 - eta^2, split evenly over the species."""
    eta = np.linspace(0.0, 1.0, c.nAerLevels + 1)
    below = 4.0e-6 * (1.0 - eta ** 2)
    return eta, np.repeat(below[:, None], c.naer, axis=1) / c.naer


def ozone_now(ozmixm, julian):
    """The ozone profile at `julian`: the two bracketing monthly profiles,
    linear in the day of the year, cyclic over its end (oznint,
    getfactors)."""
    day = julian + 1.0
    whole = int(np.floor(day))
    frac = day - whole
    whole = whole % c.daysperyear
    if whole == 0:
        whole = c.daysperyear
    day = frac + whole
    later = [i for i, d in enumerate(DATE_OZ) if d > day]
    nxt = later[0] if later else 0
    prev = nxt - 1 if nxt > 0 else 11
    d_next, d_prev = DATE_OZ[nxt], DATE_OZ[prev]
    if nxt == 0:
        span = d_next + c.daysperyear - d_prev
        if day > d_next:
            w_prev = (d_next + c.daysperyear - day) / span
            w_next = (day - d_prev) / span
        else:
            w_prev = (d_next - day) / span
            w_next = (day + c.daysperyear - d_prev) / span
    else:
        span = d_next - d_prev
        w_prev = (d_next - day) / span
        w_next = (day - d_prev) / span
    return ozmixm[prev] * w_prev + ozmixm[nxt] * w_next


def sun(julian):
    """(declination [rad], eccentricity-scaled solar constant [W/m^2]) of
    the day of the year (radconst)."""
    day = max(julian % c.daysperyear, 1e-3)
    longitude = (c.dpd * (day - 80.0) if day > 80.0
                 else c.dpd * (day + 285.0)) * c.degrad
    declin = math.asin(math.sin(23.5 * c.degrad) * math.sin(longitude))
    r = day * 360.0 / 365.0 * c.degrad
    ecc = (1.000110 + 0.034221 * math.cos(r) + 0.001280 * math.sin(r)
           + 0.000719 * math.cos(2 * r) + 0.000077 * math.sin(2 * r))
    return declin, c.solcon_0 * ecc


# ---------------------------------------------------------------------------
# the columns, torch [C, K]
# ---------------------------------------------------------------------------

def saturation(table, t, p):
    """(es, qs) from the table by linear interpolation (estblf, aqsat)."""
    e = torch.clamp(t, T_MIN, T_MAX)
    below = torch.floor(e - T_MIN)
    i = below.long()
    es = ((T_MIN + below - e + 1.0) * table[i]
          - (T_MIN + below - e) * table[i + 1])
    qs = c.ep_2 * es / (p - (1.0 - c.ep_2) * es)
    qs = torch.clamp(qs, max=1.0)
    bad = qs < 0.0
    return torch.where(bad, p, es), torch.where(bad, 1.0, qs)


def ozone_on_levels(pin, profile, p):
    """The profile's volume mixing ratio at pressures p, linear in
    pressure between data levels, scaled with p above the top level, held
    below the bottom one (radozn). mpas_tpu broadcasts the profile over
    the columns and gathers; the profile is the same in every column, so
    it is indexed here."""
    n = pin.shape[0]
    upper = torch.clamp(torch.searchsorted(pin, p.contiguous(), right=True)
                        - 1, 0, n - 2)
    dpu = p - pin[upper]
    dpl = pin[upper + 1] - p
    o3 = (profile[upper] * dpl + profile[upper + 1] * dpu) / (dpl + dpu)
    o3 = torch.where(p < pin[0], profile[0] * p / pin[0], o3)
    return torch.where(p > pin[-1], profile[-1], o3)


def aerosol_on_levels(eta, column, pint):
    """Aerosol mass mixing ratio [kg/kg] of each layer, summed over the
    species: the climatology's cumulative mass interpolated to the model's
    interfaces, one interface at a time (vert_interpolate, as mpas_tpu's
    numpy form loops), then differenced."""
    C, K1 = pint.shape
    n = eta.shape[0] - 1
    v = eta[None, :] * pint[:, :1]                        # [C, n+1]
    rows = [column[-1].expand(C, -1)]                     # surface: 0 below
    for k in range(1, K1):
        x = pint[:, k]
        ku = torch.clamp((v < x[:, None]).sum(dim=1) - 1, 0, n - 1)
        vu = v.gather(1, ku[:, None])[:, 0]
        vl = v.gather(1, (ku + 1)[:, None])[:, 0]
        dpu, dpl = x - vu, vl - x
        interp = ((column[ku] * dpl[:, None] + column[ku + 1] * dpu[:, None])
                  / (dpl + dpu)[:, None])
        row = torch.where((x > v[:, -1])[:, None], column[-1], interp)
        rows.append(torch.where((x < v[:, 0])[:, None], column[0], row))
    mass = torch.stack(rows, dim=1)                       # [C, K+1, species]
    mass = torch.where(mass < 1e-40, 0.0, mass)
    layer = mass[:, 1:] - mass[:, :-1]
    layer = torch.where(layer.abs() < 1e-15 * mass[:, -1:], 0.0, layer)
    per_kg = c.gravity / (pint[:, :-1] - pint[:, 1:]).abs()
    return (torch.clamp(layer, min=0.0) * per_kg[:, :, None]).sum(dim=-1)


def ozone_absorption(x):
    """Lacis-Hansen (1974) ozone absorption, UV and visible, of a path x
    [cm STP]."""
    uv = (1.082 * x / (1.0 + 138.6 * x) ** 0.805
          + 0.0658 * x / (1.0 + (103.6 * x) ** 3))
    return uv + 0.02118 * x / (1.0 + 0.042 * x + 0.000323 * x ** 2)


def two_stream(tau, omega, g):
    """Delta-Eddington reflectance and transmittance of each layer."""
    f = g * g
    tau = (1.0 - omega * f) * tau
    omega = torch.clamp((1.0 - f) * omega / (1.0 - omega * f), 0.0, 0.999999)
    g = g / (1.0 + g)
    lam = torch.sqrt(3.0 * (1.0 - omega) * (1.0 - omega * g))
    u = 1.5 * (1.0 - omega * g) / torch.clamp(lam, min=1e-12)
    lt = torch.clamp(lam * tau, 0.0, 50.0)
    ep, em = torch.exp(lt), torch.exp(-lt)
    d = (u + 1.0) ** 2 * ep - (u - 1.0) ** 2 * em
    r = torch.clamp((u * u - 1.0) * (ep - em) / d, 0.0, 1.0)
    t = torch.clamp(4.0 * u / d, 0.0, 1.0)
    return r, t


def adding(tau, omega, g, incident):
    """The adding method over the layers of each column, the top layer
    last: (absorbed [C, K], absorbed at the surface [C], reflected at the
    top [C]) of the flux `incident` [C] at the top."""
    r, t = two_stream(tau, omega, g)
    K = tau.shape[1]
    below = [None] * K            # reflectance of all below layer k
    rb = torch.full_like(incident, ALBEDO)
    for k in range(K):
        below[k] = rb
        rb = r[:, k] + t[:, k] * t[:, k] * rb / (1.0 - r[:, k] * rb)
    top = rb
    absorbed = [None] * K
    f = incident
    for k in range(K - 1, -1, -1):
        with_k = below[k + 1] if k + 1 < K else top
        f_next = f * t[:, k] / (1.0 - r[:, k] * below[k])
        absorbed[k] = f * (1.0 - with_k) - f_next * (1.0 - below[k])
        f = f_next
    return (torch.stack(absorbed, dim=1), f * (1.0 - ALBEDO),
            incident * top)


def overlapped_cover(cloud):
    """The column's total cloud cover under maximum-random overlap,
    scanning down from the top (cldovrlap)."""
    cover = torch.clamp(cloud, 0.0, 0.999)
    clear = torch.ones_like(cover[:, 0])
    above = torch.zeros_like(cover[:, 0])
    for k in range(cover.shape[1] - 1, -1, -1):
        clear = (clear * (1.0 - torch.maximum(cover[:, k], above))
                 / (1.0 - above))
        above = cover[:, k]
    return 1.0 - clear


def shortwave(mu0, solcon, pmid, pint, q, o3mmr, cloud, cwp, fice, rei,
              aer):
    """Shortwave heating [K/s] of each layer: ozone on the direct and the
    reflected beam, then one adding solve for the visible region and one
    for each near-infrared water-vapour term, with clouds, Rayleigh
    scattering (visible) and aerosol."""
    mu = torch.clamp(mu0, min=0.0)
    day = (mu > 1e-4).to(pmid.dtype)
    mu_safe = torch.clamp(mu, min=0.05)
    dp = (pint[:, :-1] - pint[:, 1:]).abs()
    path = dp / c.gravity

    du = o3mmr * path / 2.1415e-2                         # cm STP a layer
    x_above = du.flip(1).cumsum(1).flip(1)                # with the layer
    x_top = x_above - du
    mag = 35.0 / torch.sqrt(1224.0 * mu_safe ** 2 + 1.0)
    s_toa = solcon * mu * day
    oz_dn = s_toa[:, None] * (ozone_absorption(mag[:, None] * x_above)
                              - ozone_absorption(mag[:, None] * x_top))
    x_col = x_above[:, 0]

    c_eff = torch.clamp(overlapped_cover(cloud), min=1e-6)[:, None]
    tau_cld = ((1.5 * cwp * (1.0 - fice) / 10.0               # rel = 10 um
                + 1.5 * cwp * fice / torch.clamp(rei, min=1.0))
               * cloud / c_eff)
    tau_aer = AER_K_EXT * (aer * 1e3) * path
    tau_ray = 0.09 * dp / pint[:, :1]

    def region(weight, tau_gas, tau_r, omega_c):
        scatter = tau_r + omega_c * tau_cld + AER_OMEGA * tau_aer
        tau = tau_gas + tau_r + tau_cld + tau_aer + 1e-12
        g = ((0.85 * omega_c * tau_cld + AER_G * AER_OMEGA * tau_aer)
             / torch.clamp(scatter, min=1e-12))
        return adding(tau, scatter / tau, g, weight * s_toa)

    zero = torch.zeros_like(pmid)
    w_vis = 1.0 - W_NIR
    abs_v, sfc_v, refl_v = region(w_vis, zero, tau_ray, 0.999999)
    deplete = torch.where(s_toa > 0, 1.0 - oz_dn.sum(dim=1) / torch.clamp(
        w_vis * s_toa, min=1e-6), 1.0)
    deplete = torch.clamp(deplete, 0.0, 1.0)
    abs_v = abs_v * deplete[:, None]
    sfc_v = sfc_v * deplete
    refl_v = refl_v * deplete
    direct = (mag * x_col)[:, None]
    oz_up = refl_v[:, None] * (
        ozone_absorption(1.9 * (x_col[:, None] - x_top) + direct)
        - ozone_absorption(1.9 * (x_col[:, None] - x_above) + direct))

    y_slant = ((q * path * 0.1) * (pmid / 1.01325e5) ** 0.9
               / mu_safe[:, None])
    abs_n = zero
    for w_i, k_i in zip(SW_H2O_W, SW_H2O_K):
        abs_i, _, _ = region(W_NIR * w_i, k_i * y_slant, zero, 0.98)
        abs_n = abs_n + abs_i

    absorbed = abs_v + abs_n + oz_dn + oz_up
    return absorbed / (c.cp * path) * day[:, None]


def longwave(t, q, o3mmr, pmid, pint, cld_emis, cloud):
    """Longwave heating [K/s] of each layer: for each term, the emission
    and transmission of every layer, a sweep down from the top and one up
    from the surface; the net flux's divergence."""
    dp = (pint[:, :-1] - pint[:, 1:]).abs()
    path = dp / c.gravity
    u_h2o = q * path * 0.1
    u_co2 = CO2_VMR * (44.0 / 28.97) * dp / c.gravity * 0.1
    u_o3 = o3mmr * path * 0.1
    pscale = (pmid / 1.01325e5) ** 0.8
    u_cnt = u_h2o * ((q * pmid / 0.622) / 1000.0) * (296.0 / t) ** 4
    b = c.stbolt * t ** 4
    b_sfc = c.stbolt * t[:, 0] ** 4                       # skin = lowest layer
    eps_c = torch.clamp(cld_emis * cloud, 0.0, 0.999)

    terms = ([(w, DIFF * k * u_h2o * pscale + DIFF * LW_CNT_K * u_cnt)
              for w, k in zip(LW_H2O_W, LW_H2O_K)]
             + [(LW_CO2_W * f, DIFF * LW_CO2_K * r * u_co2 * pscale)
                for f, r in LW_CO2_SPLIT]
             + [(LW_O3_W, DIFF * LW_O3_K * u_o3)])
    C, K = t.shape
    down = torch.zeros(C, K + 1, dtype=t.dtype, device=t.device)
    up = torch.zeros(C, K + 1, dtype=t.dtype, device=t.device)
    for w, tau in terms:
        tr = torch.exp(-torch.clamp(tau, 0.0, 80.0)) * (1.0 - eps_c)
        f = torch.zeros_like(t[:, 0])
        f_down = [None] * K                               # at layer bottoms
        for k in range(K - 1, -1, -1):
            f = f * tr[:, k] + w * b[:, k] * (1.0 - tr[:, k])
            f_down[k] = f
        f = w * EMISS * b_sfc + (1.0 - EMISS) * f_down[0]
        f_up = [f]
        for k in range(K):
            f = f * tr[:, k] + w * b[:, k] * (1.0 - tr[:, k])
            f_up.append(f)
        down = down + torch.cat([torch.stack(f_down, dim=1),
                                 torch.zeros_like(down[:, :1])], dim=1)
        up = up + torch.stack(f_up, dim=1)
    net = up - down
    return -(net[:, 1:] - net[:, :-1]) / dp * c.gravity / c.cp


class PlainRadiation:
    """The radiation of a model's state: `tendency(state, julian)` is the
    potential-temperature tendency [K/s] as [K, C], for rt_diabatic_tend.
    `lat`, `lon` [C] in radians; `cf` the vertical grid's three weights
    that extrapolate the surface pressure; `pressure_base` [K, C]."""

    def __init__(self, lat, lon, cf, pressure_base):
        dtype, device = pressure_base.dtype, pressure_base.device
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=device)
        self.lat, self.lon = as_t(lat), as_t(lon)
        self.cf = cf
        self.pressure_base = pressure_base
        self.table = as_t(saturation_table())
        pin, self.ozmixm = ozone_climatology()
        self.pin = as_t(pin)
        eta, column = aerosol_climatology()
        self.eta, self.column = as_t(eta), as_t(column)

    def tendency(self, state, julian: float):
        dtype = self.pressure_base.dtype
        p_lm = self.pressure_base + state.pressure_p           # [K, C]
        psfc = (self.cf[0] * p_lm[0] + self.cf[1] * p_lm[1]
                + self.cf[2] * p_lm[2])
        p = p_lm.T.contiguous()                                # [C, K]
        exner = state.exner.T.contiguous()
        scalars = state.scalars
        qv = (scalars[0].T.contiguous() if scalars is not None
              else torch.zeros_like(p))
        qc = (scalars[1].T.contiguous() if scalars is not None
              and scalars.shape[0] > 1 else None)
        t = state.theta_m.T * exner / (1.0 + c.rvord * qv)

        # column pressures: interfaces halfway between levels, the surface
        # below, the top extrapolated
        p_top = torch.clamp(1.5 * p[:, -1] - 0.5 * p[:, -2], min=1.0)
        pint = torch.cat([psfc[:, None], 0.5 * (p[:, :-1] + p[:, 1:]),
                          p_top[:, None]], dim=1)
        _, qs = saturation(self.table, t, p)

        # cloudiness: squared excess of humidity over RH_CLOUD, and full
        # cover where there is condensate
        rh = torch.clamp(qv / torch.clamp(qs, min=1e-12), 0.0, 1.0)
        cloud = torch.clamp((rh - RH_CLOUD) / (1.0 - RH_CLOUD), 0.0, 1.0) ** 2
        dp = (pint[:, :-1] - pint[:, 1:]).abs()
        if qc is not None:
            cloud = torch.maximum(cloud, (qc > 1e-8).to(dtype))
            cwp = qc * dp / c.gravity * 1e3 / torch.clamp(cloud, min=0.05)
        else:
            cwp = torch.where(cloud > 0.0, 60.0, torch.zeros_like(cloud))

        declin, solcon = sun(julian)
        hour = 2.0 * np.pi * (julian % 1.0)
        mu0 = (torch.sin(self.lat) * math.sin(declin) + torch.cos(self.lat)
               * math.cos(declin) * torch.cos(hour + self.lon - math.pi))
        profile = torch.as_tensor(ozone_now(self.ozmixm, julian), dtype=dtype,
                                  device=p.device)
        o3mmr = c.amo / c.amd * ozone_on_levels(self.pin, profile, p)
        aer = aerosol_on_levels(self.eta, self.column, pint)

        # cloud optics: ice share and ice radius ramp with temperature
        # (liquid radius 10 um), emissivity from CAM's absorptivities
        fice = torch.clamp((263.0 - t) / 30.0, 0.0, 1.0)
        rei = torch.clamp(10.0 + 0.5 * (263.0 - t), 10.0, 30.0)
        kabs = 0.090361 * (1.0 - fice) + (0.005 + 1.0 / rei) * fice
        cld_emis = 1.0 - torch.exp(-DIFF * kabs * cwp)

        qrs = shortwave(mu0, solcon, p, pint, qv, o3mmr, cloud, cwp, fice,
                        rei, aer)
        qrl = longwave(t, qv, o3mmr, p, pint, cld_emis, cloud)
        return ((qrs + qrl) / exner).T.contiguous()
