"""Lateral boundary conditions (LBC) for regional runs.

The port of `mpas_tpu.io.lbc`: a boundary-data stream sampled from a
driving run, time interpolation, and Davies (1976)-type relaxation that
blends the outer rings toward the driving data, feeding the zones that
mesh/coefficients.mark_regional_zones stamps and ops/recover's
specified-zone hold.

The stream is an npz of zone-restricted snapshots (write_lbc/read_lbc),
typically generated from a global run on the same mesh (extract_lbc inside
a stepping loop) or from any coarser driving model interpolated to the
zone entities (CoarseToFine); MPAS-convention lbc.*.nc files are read and
written too. The host side (streams, files, weights, interpolation
operators) is numpy, array for array mpas_tpu's, so a file written by
either package reads in the other; the blend and the re-diagnosis of the
zone run in torch on the model's device.

Zone semantics (MPAS regional, ops/recover.py):
  bdyMaskCell == 0                 interior (never touched)
  1 <= bdyMaskCell <= nRelaxZone   relaxation rings (Davies-blended here)
  bdyMaskCell > nRelaxZone         specified zone (hard-set here; the
                                   dycore holds it frozen within a step)

All per-column fields are level-major [K, N] (core/state.py).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from .. import constants
from ..mesh.netcdf_io import read_netcdf, write_netcdf
from ..ops import stencils as st

# prognostic cell fields carried in an LBC stream, in storage order
CELL_FIELDS = ("theta_m", "rho_zz", "w")
EDGE_FIELDS = ("u",)


def _np(x):
    """Host numpy view of a tensor (any device) or array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class LBCStream:
    """Time series of boundary-zone snapshots.

    times   [T] seconds since run start (strictly increasing)
    cells   [Zc] zone cell indices (bdyMaskCell > 0), int32
    edges   [Ze] zone edge indices (bdyMaskEdge > 0), int32
    cell_data  {name: [T, K(+1), Zc]}
    edge_data  {name: [T, K, Ze]}
    scalars    optional [T, nS, K, Zc]
    """
    times: Any
    cells: Any
    edges: Any
    cell_data: dict
    edge_data: dict
    scalars: Any = None

    def window(self, t: float):
        """(i0, i1, w1) bracketing indices + interpolation weight at time t
        (clamped to the stream's range)."""
        times = np.asarray(self.times)
        if t <= times[0]:
            return 0, 0, 0.0
        if t >= times[-1]:
            return len(times) - 1, len(times) - 1, 0.0
        i1 = int(np.searchsorted(times, t, side="right"))
        i0 = i1 - 1
        w1 = float((t - times[i0]) / (times[i1] - times[i0]))
        return i0, i1, w1


def zone_indices(mesh_or_masks):
    """(cells, edges) int32 index arrays of the boundary zone (mask > 0)."""
    bdy_c = _np(getattr(mesh_or_masks, "bdyMaskCell", None))
    bdy_e = _np(getattr(mesh_or_masks, "bdyMaskEdge", None))
    return (np.where(bdy_c > 0)[0].astype(np.int32),
            np.where(bdy_e > 0)[0].astype(np.int32))


def extract_lbc(state, cells, edges):
    """One zone-restricted snapshot (host numpy dict) of the prognostics an
    LBC stream carries."""
    snap_c = {n: _np(getattr(state, n))[:, cells] for n in CELL_FIELDS}
    snap_e = {n: _np(getattr(state, n))[:, edges] for n in EDGE_FIELDS}
    scal = (_np(state.scalars)[:, :, cells]
            if state.scalars is not None else None)
    return snap_c, snap_e, scal


def build_stream(times, cells, edges, snapshots):
    """Assemble an LBCStream from per-time (snap_c, snap_e, scal) tuples."""
    cell_data = {n: np.stack([s[0][n] for s in snapshots])
                 for n in CELL_FIELDS}
    edge_data = {n: np.stack([s[1][n] for s in snapshots])
                 for n in EDGE_FIELDS}
    scal = (np.stack([s[2] for s in snapshots])
            if snapshots and snapshots[0][2] is not None else None)
    return LBCStream(times=np.asarray(times, np.float64),
                     cells=np.asarray(cells, np.int32),
                     edges=np.asarray(edges, np.int32),
                     cell_data=cell_data, edge_data=edge_data, scalars=scal)


def write_lbc(path: str, stream: LBCStream):
    arrays = dict(times=stream.times, cells=stream.cells, edges=stream.edges)
    for n, v in stream.cell_data.items():
        arrays[f"cell_{n}"] = v
    for n, v in stream.edge_data.items():
        arrays[f"edge_{n}"] = v
    if stream.scalars is not None:
        arrays["scalars"] = stream.scalars
    np.savez_compressed(path, **arrays)
    return path


def read_lbc(path: str) -> LBCStream:
    with np.load(path) as d:
        return LBCStream(
            times=d["times"], cells=d["cells"], edges=d["edges"],
            cell_data={n: d[f"cell_{n}"] for n in CELL_FIELDS},
            edge_data={n: d[f"edge_{n}"] for n in EDGE_FIELDS},
            scalars=d["scalars"] if "scalars" in d else None)


# ---------------------------------------------------------------------------
# MPAS-convention lbc.*.nc streams
# ---------------------------------------------------------------------------

def lbc_filename(t_seconds: float, prefix: str = "lbc"):
    """MPAS stream naming: lbc.YYYY-MM-DD_hh.mm.ss.nc with a synthetic
    calendar starting 0001-01-01 (idealized runs carry no real dates)."""
    day = int(t_seconds // 86400)
    rem = int(t_seconds) % 86400
    hh, rem = divmod(rem, 3600)
    mm, ss = divmod(rem, 60)
    return f"{prefix}.0001-01-{day + 1:02d}_{hh:02d}.{mm:02d}.{ss:02d}.nc"


def write_lbc_netcdf(path: str, t_seconds: float, state, model):
    """Write ONE boundary time as an MPAS-convention lbc file: full-domain
    element-major `lbc_u [Time, nEdges, nVertLevels]`, `lbc_w`, `lbc_theta`
    (dry potential temperature), `lbc_rho` (physical dry density) and
    `lbc_qv`, exactly the fields MPAS limited-area lbc streams carry.
    The level-major coupled dycore state is uncoupled at this boundary
    (theta = theta_m/(1+Rv/Rd qv), rho = rho_zz * zz)."""
    m = model.mesh
    zz = _np(model.static.zz)                            # [K, C]
    K = zz.shape[0]
    qv = (_np(state.scalars[0]) if state.scalars is not None
          else np.zeros_like(zz))
    theta = _np(state.theta_m) / (1.0 + 1.61 * qv)
    rho = _np(state.rho_zz) * zz
    dims = {"Time": 1, "nCells": m.nCells, "nEdges": m.nEdges,
            "nVertLevels": K, "nVertLevelsP1": K + 1, "StrLen": 64}
    xtime = np.zeros((1, 64), dtype="S1")
    stamp = lbc_filename(t_seconds).split(".", 1)[1].rsplit(".", 1)[0]
    for i, ch in enumerate(stamp.encode()):
        xtime[0, i] = bytes([ch])
    tr = lambda a: _np(a).T[None]                        # -> [1, N, K]
    variables = {
        "xtime": (("Time", "StrLen"), xtime),
        "lbc_u": (("Time", "nEdges", "nVertLevels"), tr(state.u)),
        "lbc_w": (("Time", "nCells", "nVertLevelsP1"), tr(state.w)),
        "lbc_theta": (("Time", "nCells", "nVertLevels"), tr(theta)),
        "lbc_rho": (("Time", "nCells", "nVertLevels"), tr(rho)),
        "lbc_qv": (("Time", "nCells", "nVertLevels"), tr(qv)),
    }
    write_netcdf(path, dims, variables,
                 attrs={"lbc_seconds": float(t_seconds)})
    return path


def _lbc_seconds(path: str) -> float:
    """The file's `lbc_seconds` attribute, else the time its MPAS name
    spells."""
    from scipy.io import netcdf_file
    f = netcdf_file(path, "r", mmap=False)
    try:
        t = f._attributes.get("lbc_seconds")
    finally:
        f.close()
    if t is not None:
        return float(t)
    mre = re.search(r"01-(\d\d)_(\d\d)\.(\d\d)\.(\d\d)", path)
    return float((int(mre.group(1)) - 1) * 86400 + int(mre.group(2)) * 3600
                 + int(mre.group(3)) * 60 + int(mre.group(4)))


def read_lbc_netcdf(paths, model, n_scalars: int = 0) -> LBCStream:
    """Read MPAS-convention lbc.*.nc files (write_lbc_netcdf) into an
    LBCStream restricted to the model's boundary zone, recoupling to the
    dycore's (theta_m, rho_zz) variables."""
    cells, edges = zone_indices(model.mesh)
    zz = _np(model.static.zz)                            # [K, C]
    times, snaps = [], []
    for p in sorted(paths):
        d = read_netcdf(p, ["lbc_u", "lbc_w", "lbc_theta", "lbc_rho",
                            "lbc_qv"])
        qv = d["lbc_qv"][0].T                            # [K, C]
        theta_m = d["lbc_theta"][0].T * (1.0 + 1.61 * qv)
        rho_zz = d["lbc_rho"][0].T / zz
        snap_c = {"theta_m": theta_m[:, cells], "rho_zz": rho_zz[:, cells],
                  "w": d["lbc_w"][0].T[:, cells]}
        snap_e = {"u": d["lbc_u"][0].T[:, edges]}
        scal = None
        if n_scalars:
            K, _ = zz.shape
            scal = np.zeros((n_scalars, K, len(cells)))
            scal[0] = qv[:, cells]
        times.append(_lbc_seconds(p))
        snaps.append((snap_c, snap_e, scal))
    order = np.argsort(times)
    snaps = [snaps[i] for i in order]
    times = [times[i] for i in order]
    return build_stream(times, cells, edges, snaps)


# ---------------------------------------------------------------------------
# coarse-to-fine driving: a regional mesh driven by a COARSER global run,
# the standard MPAS nesting workflow
# ---------------------------------------------------------------------------

class CoarseToFine:
    """Horizontal interpolation operators from a coarse global mesh onto a
    fine regional mesh's boundary-zone entities.

    Cell fields: inverse-distance weights over the 3 nearest coarse cells
    (chord distance on the sphere). Edge normal velocity: the coarse run's
    RECONSTRUCTED cell-center (zonal, meridional) velocity is interpolated
    to the fine edge midpoint and projected onto the fine edge normal
    (u_n = uz*cos(angleEdge) + um*sin(angleEdge)) — interpolating normal
    components directly across meshes is ill-defined because edge
    orientations differ. The vertical grids must match level-for-level
    (same nVertLevels/ztop/stretch); terrain-height differences between the
    meshes are neglected (fine for idealized JW-type driving)."""

    def __init__(self, coarse_mesh, fine_mesh, cells, edges, k_neighbors=3):
        from scipy.spatial import cKDTree
        self.cells = np.asarray(cells)
        self.edges = np.asarray(edges)
        xyz_c = np.stack([coarse_mesh.xCell, coarse_mesh.yCell,
                          coarse_mesh.zCell], axis=1) / coarse_mesh.sphere_radius
        tree = cKDTree(xyz_c)

        def weights(x, y, z, radius):
            pts = np.stack([x, y, z], axis=1) / radius
            d, i = tree.query(pts, k=k_neighbors)
            w = 1.0 / np.maximum(d, 1e-12)
            return i, w / w.sum(axis=1, keepdims=True)

        self.ci, self.cw = weights(fine_mesh.xCell[self.cells],
                                   fine_mesh.yCell[self.cells],
                                   fine_mesh.zCell[self.cells],
                                   fine_mesh.sphere_radius)
        self.ei, self.ew = weights(fine_mesh.xEdge[self.edges],
                                   fine_mesh.yEdge[self.edges],
                                   fine_mesh.zEdge[self.edges],
                                   fine_mesh.sphere_radius)
        self.angle = fine_mesh.angleEdge[self.edges]

    def cell_field(self, f):
        """f [K(.), C_coarse] level-major -> [K(.), Zc_fine]."""
        f = _np(f)
        return np.einsum("...nk,nk->...n", f[..., self.ci], self.cw)

    def edge_normal_u(self, uz, um):
        """Reconstructed zonal/meridional cell winds [K, C_coarse] ->
        normal velocity at fine zone edges [K, Ze_fine]."""
        uz_e = np.einsum("...nk,nk->...n", _np(uz)[..., self.ei], self.ew)
        um_e = np.einsum("...nk,nk->...n", _np(um)[..., self.ei], self.ew)
        return uz_e * np.cos(self.angle) + um_e * np.sin(self.angle)

    def snapshot(self, coarse_state):
        """Zone snapshot tuple (like extract_lbc) from a coarse state."""
        snap_c = {n: self.cell_field(getattr(coarse_state, n))
                  for n in CELL_FIELDS}
        snap_e = {"u": self.edge_normal_u(coarse_state.uReconstructZonal,
                                          coarse_state.uReconstructMeridional)}
        scal = (self.cell_field(coarse_state.scalars)
                if coarse_state.scalars is not None else None)
        return snap_c, snap_e, scal


def davies_weights(bdy_mask, n_relax: int):
    """Per-entity blend weight toward the driving data applied once per
    step: 1 in the specified zone, (1 - (r-1)/n_relax)^2 decaying across
    relaxation rings r = 1..n_relax (Davies 1976-type profile; ring 1 —
    adjacent to the specified zone — is nudged hardest), 0 in the
    interior."""
    m = _np(bdy_mask)
    w = np.zeros(m.shape, np.float64)
    relax = (m >= 1) & (m <= n_relax)
    w[relax] = (1.0 - (m[relax] - 1.0) / float(n_relax)) ** 2
    w[m > n_relax] = 1.0
    return w


def _blend(x, idx, w, target, dim):
    """x with its columns idx along `dim` moved the fraction w toward
    target: cur + w * (target - cur), a new tensor."""
    cur = x.index_select(dim, idx)
    return x.index_copy(dim, idx, cur + w * (target - cur))


def make_lbc_apply_fn(mesh_arrays, nl, stream: LBCStream, dtype):
    """Returns apply(state, fields_t) -> state: hard-set the specified zone
    and Davies-blend the relaxation rings toward the time-interpolated
    driving fields. `fields_t` is the dict interp_fields() produces; zone
    indices and weights are built once, on the mesh arrays' device. The
    state given is not written."""
    dev = mesh_arrays.bdyMaskCell.device
    cells = torch.from_numpy(np.asarray(stream.cells, np.int64)).to(dev)
    edges = torch.from_numpy(np.asarray(stream.edges, np.int64)).to(dev)
    w_c = torch.from_numpy(davies_weights(mesh_arrays.bdyMaskCell, nl.nRelaxZone)
                           [stream.cells]).to(dev, dtype)
    w_e = torch.from_numpy(davies_weights(mesh_arrays.bdyMaskEdge, nl.nRelaxZone)
                           [stream.edges]).to(dev, dtype)

    def apply(state, fields_t):
        upd = {n: _blend(getattr(state, n), cells, w_c[None, :], fields_t[n], 1)
               for n in CELL_FIELDS}
        for n in EDGE_FIELDS:
            upd[n] = _blend(getattr(state, n), edges, w_e[None, :],
                            fields_t[n], 1)
        if state.scalars is not None and "scalars" in fields_t:
            upd["scalars"] = _blend(state.scalars, cells, w_c[None, None, :],
                                    fields_t["scalars"], 2)
        return state.replace(**upd)

    return apply


def interp_fields(stream: LBCStream, t: float, dtype, device="cuda"):
    """Time-interpolated zone fields at model time t (host -> device dict)."""
    i0, i1, w1 = stream.window(t)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    out = {}
    for n, v in stream.cell_data.items():
        out[n] = to((1.0 - w1) * v[i0] + w1 * v[i1])
    for n, v in stream.edge_data.items():
        out[n] = to((1.0 - w1) * v[i0] + w1 * v[i1])
    if stream.scalars is not None:
        out["scalars"] = to((1.0 - w1) * stream.scalars[i0]
                            + w1 * stream.scalars[i1])
    return out


class RegionalDriver:
    """Steps a regional model with LBC forcing: blend at the step's start
    time before each step (the dycore holds the specified zone within the
    step; the relaxation rings are nudged here).

    Derived prognostics of the ZONE entities (ru, rw, rho_p, rtheta_p,
    exner, pressure_p) are re-diagnosed from the blended uncoupled fields
    so the zone stays thermodynamically consistent; interior entities are
    left untouched."""

    def __init__(self, model, stream: LBCStream):
        if not model.namelist.config_apply_lbcs:
            raise ValueError("regional runs need config_apply_lbcs=True")
        self.model = model
        self.stream = stream
        self.apply_fn = make_lbc_apply_fn(model.mesh_arrays, model.namelist,
                                          stream, model.dtype)
        self._recouple = _make_recouple_fn(model)

    def step(self, n: int = 1):
        m = self.model
        dt = m.namelist.config_dt
        for _ in range(n):
            t = m.step_count * dt
            fields = interp_fields(self.stream, t, m.dtype, m.device)
            m.state = self._recouple(self.apply_fn(m.state, fields))
            m.step()
        return m.state


def _make_recouple_fn(model):
    """Rediagnosis of the coupled variables from (u, w, theta_m, rho_zz),
    written into the ZONE entities only. Candidates are computed
    whole-domain (cheap on regional meshes) with the same algebra as
    diagnostics.init_coupled_diagnostics — including the sloping-coordinate
    metric transport in rw — but the interior keeps its own evolved values
    (the w <-> rw inversion is only identity-consistent where
    recover_large_step_variables produced both)."""
    static, marr, vert = model.static, model.mesh_arrays, model.vert
    rcv = constants.rcv
    cells = torch.nonzero(marr.bdyMaskCell > 0)[:, 0]
    edges = torch.nonzero(marr.bdyMaskEdge > 0)[:, 0]
    zz_i = st.interface_interp(static.zz, vert.fzm, vert.fzp)

    def recouple(state):
        rho_zz = state.rho_zz
        ru = st.avg_cell_to_edge_m(marr, rho_zz) * state.u
        rho_i = st.interface_interp(rho_zz, vert.fzm, vert.fzp)
        flux_e = st.interface_interp(ru, vert.fzm, vert.fzp)
        metric = st.zb_metric(flux_e, marr.edgesOnCell, marr.edgesOnCellSign,
                              static.zb_cell, static.zb3_cell)
        rw = state.w * rho_i * zz_i - metric * zz_i
        rho_p = rho_zz - static.rho_base
        rtheta_p = rho_zz * state.theta_m - static.rtheta_base
        exner = (static.zz * (constants.rgas / constants.p0)
                 * (rtheta_p + static.rtheta_base)) ** rcv
        pressure_p = static.zz * constants.rgas * (
            exner * rtheta_p + static.rtheta_base * (exner - static.exner_base))
        zc = lambda full, cand: full.index_copy(1, cells,
                                                cand.index_select(1, cells))
        return state.replace(
            ru=state.ru.index_copy(1, edges, ru.index_select(1, edges)),
            rw=zc(state.rw, rw), rho_p=zc(state.rho_p, rho_p),
            rtheta_p=zc(state.rtheta_p, rtheta_p),
            exner=zc(state.exner, exner),
            pressure_p=zc(state.pressure_p, pressure_p))

    return recouple
