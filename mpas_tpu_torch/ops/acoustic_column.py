"""Kernel 1: the fused vertically-implicit acoustic column update.

`acoustic_column_update` launches the CUDA kernel in
csrc/acoustic_column.cu for tensors on the card and runs
`acoustic_column_update_plain` for tensors on the CPU. It replaces the TPU
kernel mpas_tpu/ops/pallas_acoustic.py:_kernel and keeps the argument list
of its wrapper `acoustic_column_update` (without `block_c`/`interpret`); the
source note in the .cu file says what bounds it on the H100 and what its
design does about that.

It assembles rs/ts with resm off-centring, builds the implicit-w right-hand
side, runs the forward and backward substitution with the pre-factored
a_tri/alpha_tri/gamma_tri, applies the implicit Rayleigh damping,
accumulates wwAvg and recovers rho_pp/rtheta_pp. All arrays are level-major
[K, C] / [K+1, C]; `coefs.cofrz` is [K].

On the card a CTA owns a tile of `column_tile(K, itemsize)` adjacent columns
and all their levels in `PLANES` shared-memory planes of [K+1][tile];
`tile_plan` gives the tile, the level lanes and the shared-memory bytes a
launch is made with.
"""

from __future__ import annotations

import torch

# kernel launches since the counter was last set to 0
launches = 0

_COEF_ROWS = (("cofwz", 1), ("coftz", 1), ("cofwr", 1), ("cofwt", 0),
              ("a_tri", 1), ("alpha_tri", 1), ("gamma_tri", 1))

PLANES = 18                      # shared planes of [K+1][tile], as in the .cu
SMEM_LIMIT = 232448              # 227 KB: what one CTA may use on Hopper
SMEM_PER_SM = 233472             # 228 KB an SM, of which each resident CTA
SMEM_RESERVED = 1024             # gives up 1 KB to the system
LINE_BYTES = 128                 # a tile's row segment is at most one line
TILE_WIDTHS = (32, 16, 8, 4)     # columns a tile, widest first
# Set from tiles timed in turns on an NVIDIA H100 80GB HBM3 at 700.00 W
# (chip_smoke.py `acoustic_column`, `tiles_ms`; K = 41, C = 40962, float32,
# columns x lanes): 16 x 21 0.078 ms and 16 x 14 0.078 (3 and 4 CTAs an SM),
# 32 x 14 0.080 and 32 x 8 0.087 (2 CTAs), 8 x 21 0.089, 8 x 42 0.095. So a
# tile leaves room for three CTAs where it can, and the lanes split the
# K + 1 interface levels evenly over their passes, none left nearly empty.
RESIDENT_CTAS = 3                # CTAs an SM the tile should leave room for
THREADS = 384                    # threads a CTA at most: tile x level lanes


class ColumnTileError(ValueError):
    """No tile of the acoustic column kernel holds this many levels."""


def tile_bytes(K: int, tile: int, itemsize: int) -> int:
    """Shared memory of one CTA: PLANES planes of [K+1][tile] elements."""
    return PLANES * (K + 1) * tile * itemsize


def column_tile(K: int, itemsize: int) -> int:
    """Columns of a CTA's tile for K levels of `itemsize`-byte elements. Of
    the TILE_WIDTHS whose row segment is at most one 128-byte line: the
    widest that leaves an SM room for RESIDENT_CTAS CTAs; where none does,
    the widest whose planes fit the 227 KB a CTA may use. Raises
    ColumnTileError for a K that fits none."""
    if K < 1:
        raise ColumnTileError(f"acoustic column kernel: K = {K} levels")
    widths = [t for t in TILE_WIDTHS if t * itemsize <= LINE_BYTES]
    for limit in (SMEM_PER_SM // RESIDENT_CTAS - SMEM_RESERVED, SMEM_LIMIT):
        for tile in widths:
            if tile_bytes(K, tile, itemsize) <= limit:
                return tile
    raise ColumnTileError(
        f"acoustic column kernel: K = {K} levels of {itemsize}-byte elements "
        f"need {tile_bytes(K, TILE_WIDTHS[-1], itemsize)} bytes of shared "
        f"memory at the narrowest tile ({TILE_WIDTHS[-1]} columns), over the "
        f"{SMEM_LIMIT} a CTA may use")


def max_levels(itemsize: int) -> int:
    """The largest K that `column_tile` accepts."""
    return SMEM_LIMIT // (PLANES * TILE_WIDTHS[-1] * itemsize) - 1


def level_lanes(K: int, tile: int) -> int:
    """Level lanes of a CTA: the K + 1 interface levels split evenly over
    the fewest passes that THREADS // tile lanes can make."""
    most = max(1, THREADS // tile)
    passes = -(-(K + 1) // most)
    return -(-(K + 1) // passes)


def tile_plan(K: int, itemsize: int, tile: int | None = None,
              lanes: int | None = None):
    """(tile columns, level lanes, shared-memory bytes) of a launch. `tile`
    and `lanes` default to `column_tile` and `level_lanes`."""
    if tile is None:
        tile = column_tile(K, itemsize)
    if lanes is None:
        lanes = level_lanes(K, tile)
    return tile, lanes, tile_bytes(K, tile, itemsize)


def acoustic_column_update_plain(rs0, ts0, ac_rho_pp, ac_rtheta_pp, ac_rw_p,
                                 wwAvg, tend_rho, tend_rt, tend_w, coefs, zz,
                                 dss_i, zz_rho_i, w, dw_save, dts: float,
                                 epssm: float):
    """The plain PyTorch version, step for step the TPU kernel's arithmetic.
    `tend_rho`/`tend_rt` may be None (read as zero)."""
    K, C = rs0.shape
    resm = (1.0 - epssm) / (1.0 + epssm)
    rho_pp, rtheta_pp, rw_p = ac_rho_pp, ac_rtheta_pp, ac_rw_p
    cofrz = coefs.cofrz.reshape(K, 1).to(rs0.dtype)
    coftz = coefs.coftz

    d_rwp = rw_p[1:K + 1] - rw_p[0:K]
    rs = rho_pp if tend_rho is None else rho_pp + dts * tend_rho
    rs = rs + rs0 - cofrz * resm * d_rwp
    ctz_rwp = coftz * rw_p
    dtseps = 0.5 * dts * (1.0 + epssm)
    rdzw = cofrz / dtseps                     # [K, 1] (cofrz = dtseps * rdzw)
    ts = rtheta_pp if tend_rt is None else rtheta_pp + dts * tend_rt
    ts = ts + ts0 - resm * rdzw * (ctz_rwp[1:K + 1] - ctz_rwp[0:K])

    cofwz, cofwr, cofwt = coefs.cofwz, coefs.cofwr, coefs.cofwt
    zz_ts = zz * ts
    zz_rtpp = zz * rtheta_pp
    rhs = (rw_p[1:K] + dts * tend_w[1:K]
           - cofwz[1:K] * ((zz_ts[1:K] - zz_ts[0:K - 1])
                           + resm * (zz_rtpp[1:K] - zz_rtpp[0:K - 1]))
           - cofwr[1:K] * ((rs[1:K] + rs[0:K - 1])
                           + resm * (rho_pp[1:K] + rho_pp[0:K - 1]))
           + cofwt[1:K] * (ts[1:K] + resm * rtheta_pp[1:K])
           + cofwt[0:K - 1] * (ts[0:K - 1] + resm * rtheta_pp[0:K - 1]))
    # rhs rows are interfaces 1..K-1

    a_tri, alpha_tri, gamma_tri = coefs.a_tri, coefs.alpha_tri, coefs.gamma_tri
    rows = []
    w_prev = torch.zeros_like(rs0[0])
    for k in range(1, K):
        w_prev = (rhs[k - 1] - a_tri[k] * w_prev) * alpha_tri[k]
        rows.append(w_prev)
    w_next = torch.zeros_like(w_prev)
    outs = [None] * (K - 1)
    for k in range(K - 1, 0, -1):
        w_next = rows[k - 1] - gamma_tri[k] * w_next
        outs[k - 1] = w_next
    # [K-1, C] interfaces 1..K-1 (none for K = 1)
    w_solved = torch.stack(outs, dim=0) if outs else rhs

    sl = slice(1, K)
    damped = ((w_solved + dw_save[sl]
               - dts * dss_i[sl] * zz_rho_i[sl] * w[sl])
              / (1.0 + dts * dss_i[sl]) - dw_save[sl])
    zero = torch.zeros_like(rs0[:1])
    rw_p_new = torch.cat([zero, damped, zero], dim=0)
    wwAvg_new = wwAvg + torch.cat(
        [zero, 0.5 * (1.0 - epssm) * rw_p[sl] + 0.5 * (1.0 + epssm) * damped,
         zero], dim=0)

    d_rwp_new = rw_p_new[1:K + 1] - rw_p_new[0:K]
    rho_pp_new = rs - cofrz * d_rwp_new
    ctz_new = coftz * rw_p_new
    rtheta_pp_new = ts - rdzw * (ctz_new[1:K + 1] - ctz_new[0:K])
    return rho_pp_new, rtheta_pp_new, rw_p_new, wwAvg_new


def resident_ctas(K: int, dtype, tile: int | None = None,
                  lanes: int | None = None) -> int:
    """CTAs of the launch's tile that fit on one SM, as the CUDA occupancy
    calculator counts them for the built kernel. Needs a card."""
    from .. import cuda_build
    lib = cuda_build.library()
    fn = (lib.acoustic_column_resident_f32 if dtype == torch.float32
          else lib.acoustic_column_resident_f64)
    n = fn(K, *tile_plan(K, torch.empty((), dtype=dtype).element_size(),
                         tile, lanes))
    if n < 0:
        cuda_build.check(-n, "acoustic_column_update (occupancy)")
    return n


def acoustic_column_update(rs0, ts0, ac_rho_pp, ac_rtheta_pp, ac_rw_p, wwAvg,
                           tend_rho, tend_rt, tend_w, coefs, zz, dss_i,
                           zz_rho_i, w, dw_save, dts: float, epssm: float,
                           tile: int | None = None, lanes: int | None = None):
    """Fused acoustic cell update; returns (rho_pp, rtheta_pp, rw_p, wwAvg).
    `tend_rho`/`tend_rt` may be None: the one call site folds them into
    rs0/ts0. `tile` and `lanes` override `tile_plan`'s choice on the card
    (for the sweep that set it)."""
    if rs0.device.type == "cpu":
        return acoustic_column_update_plain(
            rs0, ts0, ac_rho_pp, ac_rtheta_pp, ac_rw_p, wwAvg, tend_rho,
            tend_rt, tend_w, coefs, zz, dss_i, zz_rho_i, w, dw_save, dts,
            epssm)
    if rs0.device.type != "cuda":
        raise ValueError(f"acoustic_column_update: unsupported device "
                         f"{rs0.device}")
    global launches
    from .. import cuda_build

    K, C = rs0.shape
    dtype = rs0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"acoustic_column_update: dtype {dtype}")
    if C < 1:
        raise ValueError("acoustic_column_update: no columns")
    plan = tile_plan(K, rs0.element_size(), tile, lanes)
    level = (K, C)
    iface = (K + 1, C)
    named = [("rs0", rs0, level), ("ts0", ts0, level),
             ("rho_pp", ac_rho_pp, level), ("rtheta_pp", ac_rtheta_pp, level),
             ("rw_p", ac_rw_p, iface), ("wwAvg", wwAvg, iface),
             ("tend_rho", tend_rho, level), ("tend_rt", tend_rt, level),
             ("tend_w", tend_w, iface), ("cofrz", coefs.cofrz, (K,))]
    named += [(n, getattr(coefs, n), (K + extra, C)) for n, extra in _COEF_ROWS]
    named += [("zz", zz, level), ("dss_i", dss_i, iface),
              ("zz_rho_i", zz_rho_i, iface), ("w", w, iface),
              ("dw_save", dw_save, iface)]
    ptrs = []
    for name, t, shape in named:
        if t is None and name in ("tend_rho", "tend_rt"):
            ptrs.append(None)
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"acoustic_column_update: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype or t.device != rs0.device:
            raise TypeError(f"acoustic_column_update: {name} is {t.dtype} on "
                            f"{t.device}, expected {dtype} on {rs0.device}")
        if not t.is_contiguous():
            raise ValueError(f"acoustic_column_update: {name} not contiguous")
        ptrs.append(t.data_ptr())
    outs = (torch.empty(level, dtype=dtype, device=rs0.device),
            torch.empty(level, dtype=dtype, device=rs0.device),
            torch.empty(iface, dtype=dtype, device=rs0.device),
            torch.empty(iface, dtype=dtype, device=rs0.device))
    lib = cuda_build.library()
    fn = (lib.acoustic_column_update_f32 if dtype == torch.float32
          else lib.acoustic_column_update_f64)
    code = fn(*ptrs, *(o.data_ptr() for o in outs), K, C, float(dts),
              float(epssm), *plan,
              torch.cuda.current_stream(rs0.device).cuda_stream)
    cuda_build.check(code, "acoustic_column_update")
    launches += 1
    return outs
