"""Multi-band column radiation: the real solver for the radcswmx/radclwmx
slots the reference leaves as stubs (ra_cam_radctl_support.rg:546,552), plus
the cloud-optics chain (cldefr/cldems/cldovrlap — ra_cam_cld_support.rg:4-11,
also empty in the reference).

The port of `mpas_tpu.physics.radiation`, with its calibrated constants
(provenance: tools/calibrate_radiation.py) and its [C, K] signatures (k = 0
the lowest layer). Columns are independent of each other.

Shortwave — Lacis & Hansen (1974, JAS 31, 118) gas absorption with a
delta-Eddington / adding-method scattering solve: a visible/UV region
(weight 1-W_NIR: ozone, Rayleigh, clouds) and a near-IR region (weight
W_NIR: a 6-term water-vapour k-distribution fitted to the LH74 absorption
function, clouds), aerosols as a scattering/absorbing extra.
Longwave — k-distribution emissivity method (diffusivity factor 1.66): H2O
(4 terms + e-type continuum), CO2 15 um (3-term sub-distribution), O3
9.6 um. Clouds enter through the cldems emissivity: SW uses maximum-random
overlap (cldovrlap); LW applies eps = emis*cldfra per layer.

Layout. mpas_tpu scans over levels with `jax.lax.scan`; here each scan is a
Python loop over levels on level-major, contiguous [K, C] rows (the
transpose of a [C, K] view of a level-major field, as the model passes, is
free). The spectral terms go through the loops together on a leading axis:
the visible region and the six NIR terms as one [7, K, C] adding solve, the
8 longwave terms (4 H2O, 3 CO2, 1 O3) as one [8, K, C] pair of sweeps; their
sums are taken afterwards in mpas_tpu's order. Every per-element operation
is mpas_tpu's, in its order, so float64 results agree to round-off.
"""

from __future__ import annotations

import torch

from .. import constants

# ---------------------------------------------------------------------------
# calibrated constants (provenance: tools/calibrate_radiation.py)
# ---------------------------------------------------------------------------

W_NIR = 2.9 / 5.925          # LH74 A_wv saturation = NIR region weight
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

DIFF = 1.66                  # diffusivity factor
CO2_VMR = 3.8e-4
AER_K_EXT = 3.0              # sulfate mass extinction [m^2/g]
AER_OMEGA = 0.95
AER_G = 0.65

# single-scattering albedo of cloud in the visible and the NIR region
OMEGA_C_VIS = 0.999999
OMEGA_C_NIR = 0.98


def _lm(x):
    """[..., C, K] -> contiguous level-major [..., K, C]."""
    return x.transpose(-1, -2).contiguous()


def term_tables(dtype, device) -> dict:
    """The per-term coefficients of the SW and LW solves, each a [n, 1, 1]
    tensor of `dtype` on `device` (each value rounded to the dtype as a
    Python scalar operand would be). Building them copies from the host,
    so they are built once (driver._device_tables) and every solve takes
    them as `terms`."""
    def col(values):
        return torch.tensor(values, dtype=dtype, device=device).view(-1, 1, 1)

    omega_c = (OMEGA_C_VIS,) + (OMEGA_C_NIR,) * len(SW_H2O_W)
    return dict(
        sw_h2o_k=col(SW_H2O_K), omega_c=col(omega_c),
        g_c=col([0.85 * w for w in omega_c]),
        w_region=col([1.0 - W_NIR] + [W_NIR * w_i for w_i in SW_H2O_W]),
        lw_h2o_k=col([DIFF * k for k in LW_H2O_K]),
        lw_co2_k=col([DIFF * LW_CO2_K * r for _, r in LW_CO2_SPLIT]),
        lw_w=col(list(LW_H2O_W) + [LW_CO2_W * f for f, _ in LW_CO2_SPLIT]
                 + [LW_O3_W]))


# ---------------------------------------------------------------------------
# cloud optics (cldefr / cldems / cldovrlap equivalents)
# ---------------------------------------------------------------------------

def cldefr(t):
    """Effective radii [um] for liquid and ice (the cldefr slot,
    ra_cam_cld_support.rg:4): rel fixed at 10 um; rei ramping 10->30 um as
    temperature drops 263->223 K (CAM's Kristjansson-style table collapsed
    to its linear trend)."""
    rel = torch.full_like(t, 10.0)
    rei = torch.clamp(10.0 + 0.5 * (263.0 - t), 10.0, 30.0)
    return rel, rei


def ice_fraction(t):
    """Condensate ice fraction: linear ramp 0 -> 1 over 263 -> 233 K."""
    return torch.clamp((263.0 - t) / 30.0, 0.0, 1.0)


def cldems(cwp, rei, fice):
    """Cloud LW emissivity (the cldems slot): 1 - exp(-D kabs CWP) with
    CAM's mass absorption coefficients kabs_liq = 0.090361 m^2/g,
    kabs_ice = 0.005 + 1/rei.  cwp in g/m^2."""
    kabs = 0.090361 * (1.0 - fice) + (0.005 + 1.0 / rei) * fice
    return 1.0 - torch.exp(-DIFF * kabs * cwp)


def _cldovrlap_lm(c):
    """cldovrlap on level-major clamped cover c [K, C]: tot_above [K+1, C].
    The factors of each level's update do not depend on the carry, so they
    are formed for all levels at once; the loop multiplies and divides."""
    c_above = torch.cat([c[1:], torch.zeros_like(c[:1])])   # c_prev of level k
    num = 1.0 - torch.maximum(c, c_above)
    den = 1.0 - c_above
    clear = torch.ones_like(c[0])
    clear_below = [None] * c.shape[0]
    for k in range(c.shape[0] - 1, -1, -1):                 # from the top
        clear = clear * num[k] / den[k]
        clear_below[k] = clear
    clear_below.append(torch.ones_like(clear))
    return 1.0 - torch.stack(clear_below)


def cldovrlap(cldfra):
    """Maximum-random overlap (the cldovrlap slot): effective cloud cover
    above each interface, scanning from the top.  cldfra [C, K] with k=0 the
    lowest layer; returns (tot_above [C, K+1], column total [C]).

    clear(i) = clear(i+1) * (1 - max(c_i, c_{i+1})) / (1 - c_{i+1}):
    adjacent layers overlap maximally, separated blocks randomly."""
    tot_above = _cldovrlap_lm(_lm(torch.clamp(cldfra, 0.0, 0.999)))
    return tot_above.T, tot_above[0]


# ---------------------------------------------------------------------------
# shortwave
# ---------------------------------------------------------------------------

def _a_oz(x):
    """LH74 ozone absorption (fraction of total solar flux) for path x
    [cm STP]."""
    a_uv = (1.082 * x / (1.0 + 138.6 * x) ** 0.805
            + 0.0658 * x / (1.0 + (103.6 * x) ** 3))
    a_vis = 0.02118 * x / (1.0 + 0.042 * x + 0.000323 * x ** 2)
    return a_uv + a_vis


def _two_stream(tau, omega, g):
    """Delta-Eddington two-stream diffuse reflectance/transmittance of one
    layer (elementwise, any shape).  Returns (R, T)."""
    f = g * g
    of = omega * f
    tau = (1.0 - of) * tau
    omega = torch.clamp((1.0 - f) * omega / (1.0 - of), 0.0, 0.999999)
    g = g / (1.0 + g)
    lam = torch.sqrt(3.0 * (1.0 - omega) * (1.0 - omega * g))
    u = 1.5 * (1.0 - omega * g) / torch.clamp(lam, min=1e-12)
    lt = torch.clamp(lam * tau, 0.0, 50.0)
    ep, em = torch.exp(lt), torch.exp(-lt)
    D = (u + 1.0) ** 2 * ep - (u - 1.0) ** 2 * em
    R = (u * u - 1.0) * (ep - em) / D
    T = 4.0 * u / D
    # clamp f32 cancellation noise in the near-conservative limit
    R = torch.clamp(R, 0.0, 1.0)
    T = torch.clamp(T, 0.0, 1.0)
    return R, T


def _adding_lm(R, T, inc, albedo):
    """The adding method on level-major layers: R, T [..., K, C] (top =
    level K-1), inc [..., C] incident at the top, a surface of `albedo`.
    Returns (absorbed [..., K, C], absorbed at the surface [..., C],
    reflected at the top [..., C]).

    The upward pass carries the reflectance below each layer (rb_below[i]
    excludes layer i); its denominators 1 - r_i rb_below[i] are the ones the
    downward pass divides by, so they are kept. The downward pass keeps the
    flux entering each layer, and the absorption of all layers follows from
    those fluxes at once."""
    K = R.shape[-2]
    rb0 = torch.full_like(inc, albedo)
    tt = T * T
    rb, rb_below, den = rb0, [], []
    for i in range(K):                                   # upward
        r = R[..., i, :]
        d = 1.0 - r * rb
        rb_below.append(rb)
        den.append(d)
        rb = r + tt[..., i, :] * rb / d
    rb_final = rb
    f, f_in = inc, [None] * K
    for i in range(K - 1, -1, -1):                       # downward
        f_in[i] = f
        f = f * T[..., i, :] / den[i]
    f_sfc = f
    f_in = torch.stack(f_in, dim=-2)                     # entering layer i
    f_out = torch.cat([f_sfc.unsqueeze(-2), f_in[..., :-1, :]], dim=-2)
    om = 1.0 - torch.stack(rb_below + [rb_final], dim=-2)   # [..., K+1, C]
    absorbed = f_in * om[..., 1:, :] - f_out * om[..., :-1, :]
    return absorbed, f_sfc * (1.0 - rb0), inc * rb_final


def _sw_adding(tau, omega, g, inc, albedo):
    """Adding method over K layers (top = index K-1): per-layer two-stream
    (R_i, T_i) composed with the surface.  tau, omega, g [C, K], inc [C]
    flux incident at TOA. Returns (abs_layer [C, K], abs_sfc [C],
    reflected_toa [C])."""
    R, T = _two_stream(_lm(tau), _lm(omega), _lm(g))
    abs_layer, abs_sfc, reflected = _adding_lm(R, T, inc, albedo)
    return abs_layer.T, abs_sfc, reflected


def sw_fluxes(mu0, solcon, pmid, pint, q, o3mmr, cldfra, cwp, rel, rei, fice,
              aer_mmr=None, albedo=0.2, *, terms):
    """Shortwave heating + surface/TOA fluxes.

    All fields [C, K] (k=0 lowest), pint [C, K+1], mu0 [C]; solcon a
    tensor or a Python float; `terms` from term_tables.
    Returns dict(qrs [K/s] [C, K], swdnb, swups, fsnt, fsntc...)."""
    g_grav, cp = constants.gravity, constants.cp
    mu = torch.clamp(mu0, min=0.0)
    day = (mu > 1e-4).to(pmid.dtype)
    mu_safe = torch.clamp(mu, min=0.05)
    pmid, pint, q, o3mmr, cldfra, cwp, rel, rei, fice = map(
        _lm, (pmid, pint, q, o3mmr, cldfra, cwp, rel, rei, fice))

    dp = (pint[:-1] - pint[1:]).abs()                     # [K, C]
    path = dp / g_grav                                    # kg/m^2

    # --- ozone on the direct + reflected path (decoupled, LH74) ---
    # cumulative ozone above each interface [cm STP]: 1 cm STP = 21.415 kg/m^2
    du_o3 = o3mmr * path / 2.1415e-2                      # cm STP per layer
    x_above = du_o3.flip(0).cumsum(0).flip(0)             # incl. own layer
    x_top = x_above - du_o3                               # above layer top
    M = 35.0 / torch.sqrt(1224.0 * mu_safe ** 2 + 1.0)
    s_toa = solcon * mu * day
    a_dn = _a_oz(M * x_above) - _a_oz(M * x_top)
    oz_dn = s_toa * a_dn                                  # W/m^2 per layer
    x_col = x_above[0]

    # --- effective scattering scene (max-random overlap) ---
    c_tot = _cldovrlap_lm(torch.clamp(cldfra, 0.0, 0.999))[0]
    # in-scene cloud optical depth: scale tau by the effective overlapped
    # cover so one adding solve represents the ICA average
    c_eff = torch.clamp(c_tot, min=1e-6)
    tau_liq = 1.5 * cwp * (1.0 - fice) / torch.clamp(rel, min=1.0)
    tau_ice = 1.5 * cwp * fice / torch.clamp(rei, min=1.0)
    tau_cld = (tau_liq + tau_ice) * cldfra / c_eff

    tau_aer = torch.zeros_like(pmid)
    if aer_mmr is not None:
        tau_aer = AER_K_EXT * (_lm(aer_mmr) * 1e3) * path  # mmr kg/kg -> g/kg
    # Rayleigh optical depth per layer in the visible region (column ~0.09,
    # the broadband value behind LH74's R_r(mu) reflection formulas)
    tau_ray_v = 0.09 * dp / pint[:1]

    # --- the visible region and the 6 NIR H2O terms as one [7, K, C] solve:
    # term 0 is the visible region (no gas, Rayleigh), terms 1-6 the NIR
    # k-distribution (the water-vapour path on the direct beam, no Rayleigh)
    y_layer = (q * path * 0.1) * (pmid / 1.01325e5) ** 0.9  # g/cm^2 scaled
    y_slant = y_layer / mu_safe                           # direct-beam slant
    nir = len(SW_H2O_W)
    tau_gas = torch.cat([torch.zeros_like(pmid)[None],
                         terms["sw_h2o_k"] * y_slant])
    tau_r = torch.cat([tau_ray_v[None],
                       torch.zeros_like(pmid).expand(nir, -1, -1)])
    tau = tau_gas + tau_r + tau_cld + tau_aer + 1e-12
    scat = tau_r + terms["omega_c"] * tau_cld + AER_OMEGA * tau_aer
    omega = scat / tau
    gsc = (terms["g_c"] * tau_cld
           + AER_G * AER_OMEGA * tau_aer) / torch.clamp(scat, min=1e-12)
    w_vis = 1.0 - W_NIR
    inc = terms["w_region"][:, :, 0] * s_toa              # [7, C]
    R, T = _two_stream(tau, omega, gsc)
    abs_all, sfc_all, refl_all = _adding_lm(R, T, inc, albedo)

    # --- visible region: ozone removed from the beam first ---
    abs_v, sfc_v, refl_v = abs_all[0], sfc_all[0], refl_all[0]
    oz_total = oz_dn.sum(dim=0)
    # renormalize the visible region for the ozone-depleted beam
    deplete = torch.where(s_toa > 0, 1.0 - oz_total / torch.clamp(
        w_vis * s_toa, min=1e-6), 1.0)
    deplete = torch.clamp(deplete, 0.0, 1.0)
    abs_v = abs_v * deplete
    sfc_v = sfc_v * deplete
    refl_v = refl_v * deplete
    # ozone absorption of the reflected beam (diffuse magnification 1.9)
    a_up = (_a_oz(1.9 * (x_col - x_top) + M * x_col)
            - _a_oz(1.9 * (x_col - x_above) + M * x_col))
    oz_up = refl_v * a_up
    refl_v = torch.clamp(refl_v - oz_up.sum(dim=0), min=0.0)

    # --- NIR region: the six terms summed in mpas_tpu's order ---
    abs_n, sfc_n, refl_n = abs_all[1], sfc_all[1], refl_all[1]
    for j in range(2, nir + 1):
        abs_n = abs_n + abs_all[j]
        sfc_n = sfc_n + sfc_all[j]
        refl_n = refl_n + refl_all[j]

    abs_layer = abs_v + abs_n + oz_dn + oz_up
    qrs = abs_layer / (cp * path)
    swdnb = (sfc_v + sfc_n) / max(1.0 - albedo, 1e-6)
    fsns = sfc_v + sfc_n
    fsnt = s_toa - refl_v - refl_n
    return dict(qrs=(qrs * day).T, swdnb=swdnb * day, fsns=fsns * day,
                fsnt=fsnt * day, swup_toa=(refl_v + refl_n) * day,
                solin=s_toa)


# ---------------------------------------------------------------------------
# longwave
# ---------------------------------------------------------------------------

def lw_fluxes(t, q, o3mmr, pmid, pint, cld_emis, cldfra, tsfc, emiss=1.0,
              *, terms):
    """Longwave fluxes and heating via the calibrated k-distribution
    emissivity method.  Fields [C, K], k=0 lowest; `terms` from
    term_tables; returns dict(qrl [K/s] [C, K], olr, lwdnb, flns)."""
    sb, g_grav, cp = constants.stbolt, constants.gravity, constants.cp
    t, q, o3mmr, pmid, pint, cld_emis, cldfra = map(
        _lm, (t, q, o3mmr, pmid, pint, cld_emis, cldfra))
    K = t.shape[0]
    dp = (pint[:-1] - pint[1:]).abs()
    path = dp / g_grav

    u_h2o = q * path * 0.1                                # g/cm^2
    u_co2 = CO2_VMR * (44.0 / 28.97) * dp / g_grav * 0.1
    u_o3 = o3mmr * path * 0.1
    pscale = (pmid / 1.01325e5) ** 0.8
    e_vap = q * pmid / 0.622
    u_cnt = u_h2o * (e_vap / 1000.0) * (296.0 / t) ** 4

    B = sb * t ** 4
    B_sfc = sb * tsfc ** 4

    # effective per-layer cloud emissivity; LW uses per-layer random
    # overlap (eps = emis * cldfra applied independently per layer) —
    # max-random overlap (cldovrlap) is used only on the SW side
    eps_c = torch.clamp(cld_emis * cldfra, 0.0, 0.999)

    # the 8 terms on a leading axis: 4 H2O (+ continuum), 3 CO2, 1 O3
    tau = torch.cat([
        terms["lw_h2o_k"] * u_h2o * pscale + DIFF * LW_CNT_K * u_cnt,
        terms["lw_co2_k"] * u_co2 * pscale,
        (DIFF * LW_O3_K * u_o3)[None]])                   # [8, K, C]
    w = terms["lw_w"]                                     # [8, 1, 1]
    tr = torch.exp(-torch.clamp(tau, 0.0, 80.0)) * (1.0 - eps_c)
    src = w * B * (1.0 - tr)                              # emission of a layer

    f, fdn = torch.zeros_like(tr[:, 0]), [None] * K
    for i in range(K - 1, -1, -1):                        # downward sweep
        f = f * tr[:, i] + src[:, i]
        fdn[i] = f
    fdn = torch.stack(fdn, dim=1)                         # [8, K, C] at layer bottoms
    f0 = w[:, :, 0] * emiss * B_sfc + (1.0 - emiss) * fdn[:, 0]
    f, fup = f0, [f0]
    for i in range(K):                                    # upward sweep
        f = f * tr[:, i] + src[:, i]
        fup.append(f)
    fup = torch.stack(fup, dim=1)                         # [8, K+1, C]

    Fdn, Fup = fdn[0], fup[0]                             # summed in term order
    for j in range(1, w.shape[0]):
        Fdn = Fdn + fdn[j]
        Fup = Fup + fup[j]
    Fdn = torch.cat([Fdn, torch.zeros_like(Fdn[:1])])     # [K+1, C]

    net = Fup - Fdn                                       # [K+1, C]
    qrl = -(net[1:] - net[:-1]) / dp * g_grav / cp
    return dict(qrl=qrl.T, olr=Fup[-1], lwdnb=Fdn[0],
                flns=net[0], lwup_sfc=Fup[0])
