"""Model state as dataclasses of torch tensors on one device.

The port of `mpas_tpu.core.state`: every field is a dense tensor with the
vertical level MAJOR and the element index (cell/edge/vertex) minor.

Array shape conventions (C=nCells, E=nEdges, V=nVertices, K=nVertLevels):
  cell fields      [K, C]       (mass levels)    e.g. theta_m, rho_zz
  cell w-fields    [K+1, C]     (interfaces)     e.g. w, rw, zgrid
  edge fields      [K, E]                        e.g. u, ru
  vertex fields    [K, V]                        e.g. vorticity
  scalars          [nS, K, C]   (species major)
Per-slot coefficient tables are slot-major: dirHess [M, 1+M, C],
tanWeights [M, M, C], zb_cell/zb3_cell [M, K+1, C].

Index tables are int32: `torch.index_select` takes them as they are, and the
gather-reduce kernel (ops/gather_reduce.py) reads them without a copy. On an
ownership-aligned mesh `MeshArrays.eoc_split` holds the split of
edgesOnCell into owned planes and non-owned slots (`EocSplit`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import constants
from ..mesh.loader import Mesh
from ..mesh import coefficients as mcoef
from ..core.vertical import VerticalGrid
from ..ops.gather_reduce import index_scatter


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class EocSplit:
    """edgesOnCell of an ownership-aligned mesh, split once on the host:
    each cell c owns the edges s*C + c (s = 0, 1, 2) and lists at most Mn
    edges it does not own. Column j of the [C, 3 + Mn] tables is

      j < 3:  the plane-s owned edge, idx = s*C + c (a contiguous read);
      j >= 3: the (j-3)-th non-owned edge of the row, in slot order
              (an absent entry points at the row's first edge);

    `sel` is the slot of column j in the original row (0 where absent) and
    `pres` is 1 where the edge is present, 0 where not. This is
    mpas_tpu.ops.stencils._eoc_split laid out as one table, in its summation
    order (planes 0, 1, 2, then the non-owned slots)."""

    def __init__(self, idx, sel, pres):
        self.idx, self.sel, self.pres = idx, sel, pres
        self._zb = None

    @classmethod
    def build(cls, edgesOnCell, edgesOnCell_mask) -> "EocSplit":
        eoc = edgesOnCell.cpu().numpy().astype(np.int64)
        mask = edgesOnCell_mask.cpu().numpy() > 0
        C = eoc.shape[0]
        cid = np.arange(C)
        owned = mask & ((eoc % C) == cid[:, None])
        plane = eoc // C
        idx, sel, pres = [], [], []
        for s in range(3):
            sel_s = owned & (plane == s)
            p = sel_s.any(axis=1)
            idx.append(s * C + cid)
            sel.append(np.where(p, sel_s.argmax(axis=1), 0))
            pres.append(p)
        non = mask & ~owned
        Mn = int(non.sum(axis=1).max())
        order = np.argsort(~non, axis=1, kind="stable")[:, :Mn]
        p_no = np.take_along_axis(non, order, axis=1)
        i_no = np.where(p_no, np.take_along_axis(eoc, order, axis=1),
                        eoc[:, :1])
        idx = np.concatenate([np.stack(idx, 1), i_no], axis=1)
        sel = np.concatenate([np.stack(sel, 1), order], axis=1)
        pres = np.concatenate([np.stack(pres, 1), p_no], axis=1)
        dev = edgesOnCell.device
        return cls(to_index(idx, dev),
                   torch.from_numpy(np.ascontiguousarray(sel)).to(dev),
                   torch.from_numpy(pres.astype(np.float64)).to(
                       dev, edgesOnCell_mask.dtype))

    @property
    def width(self) -> int:
        return self.idx.shape[1]

    def weights(self, w):
        """[..., C, M] weights of edgesOnCell's slots -> [..., C, 3 + Mn]
        weights of the split's columns, zero where a column is absent."""
        sel = self.sel.expand(w.shape[:-1] + (self.width,))
        return torch.gather(w, -1, sel) * self.pres

    def zb_planes(self, zb_cell, zb3_cell, sign):
        """The slot-major zb_cell/zb3_cell [M, K+1, C] re-indexed to the
        split's columns, [3 + Mn, K+1, C], and sign [C, M] to [C, 3 + Mn].
        They are static: built at the first call and kept while the same
        tensors are passed (the split holds them, so identity is safe)."""
        hit = self._zb
        if (hit is None or hit[0] is not zb_cell or hit[1] is not zb3_cell
                or hit[2] is not sign):
            J = self.width
            sel = self.sel.t()[:, None, :].expand(J, zb_cell.shape[1], -1)
            hit = (zb_cell, zb3_cell, sign,
                   torch.gather(zb_cell, 0, sel),
                   torch.gather(zb3_cell, 0, sel), self.weights(sign))
            self._zb = hit
        return hit[3:]


@dataclasses.dataclass
class MeshArrays(_Replace):
    """Static horizontal mesh on the device: adjacency + geometry +
    precomputed stencil coefficients."""

    # adjacency (int32) and masks
    cellsOnEdge: Any          # [E, 2]
    verticesOnEdge: Any       # [E, 2]
    edgesOnCell: Any          # [C, M]
    cellsOnCell: Any          # [C, M]
    verticesOnCell: Any       # [C, M]
    edgesOnCell_mask: Any     # [C, M]
    edgesOnCellSign: Any      # [C, M]
    cellsOnVertex: Any        # [V, D]
    edgesOnVertex: Any        # [V, D]
    edgesOnVertexSign: Any    # [V, D]
    edgesOnEdge: Any          # [E, W2]
    edgesOnEdge_mask: Any     # [E, W2]
    weightsOnEdge: Any        # [E, W2]
    kiteForCell: Any          # [C, M]
    kiteAreasOnVertex: Any    # [V, D]

    # geometry
    latCell: Any              # [C]
    lonCell: Any
    latEdge: Any              # [E]
    lonEdge: Any
    angleEdge: Any            # [E]
    dvEdge: Any               # [E]
    dcEdge: Any
    invDvEdge: Any
    invDcEdge: Any
    areaCell: Any             # [C]
    invAreaCell: Any
    invAreaTriangle: Any      # [V]
    meshScalingDel2: Any      # [E]
    meshScalingDel4: Any      # [E]
    meshScalingRegionalCell: Any  # [C]
    meshScalingRegionalEdge: Any  # [E]
    bdyMaskCell: Any          # [C] int32
    bdyMaskEdge: Any          # [E] int32

    # advection stencil (atm_adv_coef_compression)
    advCellsForEdge: Any      # [E, S]
    advMaskForEdge: Any       # [E, S]
    adv_coefs: Any            # [E, S]
    adv_coefs_3rd: Any        # [E, S]

    # cell-form operators (mesh/coefficients.py compute_dir_hessian /
    # compute_tangential_matrix / compute_edge_slots)
    dirHess: Any              # [M, 1+M, C] (slot-major)
    tanWeights: Any           # [M, M, C] (slot-major)
    slotOnCell: Any           # [E, 2] int32

    # velocity reconstruction + deformation
    coeffs_reconstruct: Any   # [C, M, 3]
    defc_a: Any               # [C, M]
    defc_b: Any               # [C, M]

    # Coriolis
    fEdge: Any                # [E]
    fVertex: Any              # [V]

    # ownership-aligned edge numbering (mesh/orient.py): edge s*C + c is the
    # s-th edge owned by cell c. `eoc_split` is the split of edgesOnCell
    # that the aligned `_m` stencils use; it is built here, once, when
    # owner_aligned is true, and is None otherwise
    owner_aligned: bool = False
    eoc_split: Any = None

    # `gather_reduce.index_scatter` of each index table that the step's
    # reductions read (the statistic that picks the gather-reduce kernel's
    # form), by table name; computed here, once, with the bounds check
    gather_sectors: Any = None

    # kite area of the vertex in each slot of verticesOnCell, [C, M]: the
    # weights of the vertex -> cell sums of the Hollingsworth correction and
    # the APVM upwinding; a mesh constant, gathered here once
    kiteAreaOnCell: Any = None

    def __post_init__(self):
        # the gather-reduce kernel reads through these tables without a
        # bounds check, so an out-of-range entry is refused here, once
        bounds = (("edgesOnCell", self.nEdges), ("edgesOnVertex", self.nEdges),
                  ("edgesOnEdge", self.nEdges),
                  ("advCellsForEdge", self.nCells),
                  ("cellsOnCell", self.nCells),
                  ("verticesOnCell", self.nVertices),
                  ("slotOnCell", self.maxEdges))
        for name, n in bounds:
            t = getattr(self, name)
            if t.numel() and (int(t.min()) < 0 or int(t.max()) >= n):
                raise ValueError(f"MeshArrays.{name}: entries outside "
                                 f"[0, {n})")
        if self.owner_aligned and self.eoc_split is None:
            # the aligned stencils read cell c's owned edges at s*C + c
            # without looking them up, so a wrong flag would go unseen
            owner = torch.arange(self.nEdges, device=self.cellsOnEdge.device)
            if (self.nEdges != 3 * self.nCells or not bool(
                    (self.cellsOnEdge[:, 0] == owner % self.nCells).all())):
                raise ValueError("MeshArrays.owner_aligned: the edges are not "
                                 "numbered s*nCells + owner (mesh/orient.py)")
            self.eoc_split = EocSplit.build(self.edgesOnCell,
                                            self.edgesOnCell_mask)
        if self.kiteAreaOnCell is None:
            self.kiteAreaOnCell = torch.gather(
                self.kiteAreasOnVertex[self.verticesOnCell.long()], 2,
                self.kiteForCell.long()[..., None])[..., 0].contiguous()
        tables = {name: getattr(self, name) for name in
                  ("edgesOnCell", "edgesOnVertex", "edgesOnEdge",
                   "verticesOnCell", "advCellsForEdge")}
        # the dynamics' advection reduction reads the neighbour slots only
        # (scalar transport reads them all)
        tables["advCellsForEdge[:, 2:]"] = self.advCellsForEdge[:, 2:]
        if self.eoc_split is not None:
            tables["eoc_split.idx"] = self.eoc_split.idx
        itemsize = self.edgesOnCell_mask.element_size()
        self.gather_sectors = {
            name: index_scatter(t, itemsize)
            for name, t in tables.items() if t.numel()}

    @property
    def nCells(self):
        return self.edgesOnCell.shape[0]

    @property
    def nEdges(self):
        return self.cellsOnEdge.shape[0]

    @property
    def nVertices(self):
        return self.cellsOnVertex.shape[0]

    @property
    def maxEdges(self):
        return self.edgesOnCell.shape[1]


@dataclasses.dataclass
class VerticalArrays(_Replace):
    """1-D vertical metrics on the device."""
    rdzw: Any     # [K]
    dzw: Any      # [K]
    rdzu: Any     # [K+1]
    fzm: Any      # [K+1]
    fzp: Any      # [K+1]
    zw: Any       # [K+1]
    cf1: Any      # 0-d tensor
    cf2: Any
    cf3: Any
    u_init: Any   # [K]
    v_init: Any   # [K]


@dataclasses.dataclass
class StaticState(_Replace):
    """Per-column static fields set at initialization: terrain-following
    metrics and the dry reference (base) state."""
    zgrid: Any          # [K+1, C] physical interface heights
    zz: Any             # [K, C]   d zeta / d z
    dss: Any            # [K, C]   w-damping profile
    zxu: Any            # [K, E]   edge slope dz/dx
    zb_cell: Any        # [M, K+1, C] omega metric, slot-major
    zb3_cell: Any       # [M, K+1, C] (scaled by coef_3rd_order)
    rho_base: Any       # [K, C]
    theta_base: Any     # [K, C]
    rtheta_base: Any    # [K, C]
    exner_base: Any     # [K, C]
    pressure_base: Any  # [K, C]
    t_init: Any         # [K, C] initial theta_m


@dataclasses.dataclass
class State(_Replace):
    """Prognostic + persistent diagnostic state advanced by the SRK3 step."""
    u: Any              # [K, E] normal velocity
    w: Any              # [K+1, C]
    theta_m: Any        # [K, C] moist potential temperature
    rho_zz: Any         # [K, C] coupled dry density rho/zz

    ru: Any             # [K, E]
    rw: Any             # [K+1, C]
    rho_p: Any          # [K, C]
    rtheta_p: Any       # [K, C]
    exner: Any          # [K, C]
    pressure_p: Any     # [K, C]

    ruAvg: Any          # [K, E]
    wwAvg: Any          # [K+1, C]

    ke: Any             # [K, C]
    divergence: Any     # [K, C]
    vorticity: Any      # [K, V]
    pv_edge: Any        # [K, E]
    rho_edge: Any       # [K, E]
    v: Any              # [K, E] tangential velocity
    uReconstructZonal: Any       # [K, C]
    uReconstructMeridional: Any  # [K, C]

    rt_diabatic_tend: Any   # [K, C]
    tend_rho_physics: Any   # [K, C]
    tend_rtheta_physics: Any  # [K, C]
    tend_ru_physics: Any    # [K, E]

    qtot: Any           # [K, C]
    cqw: Any            # [K, C] (interface slots 1..K-1 in rows 1..K-1)
    cqu: Any            # [K, E]

    # scalars (moisture etc.), [nScalars, K, C]; None when dry
    scalars: Any = None
    # accumulated grid-scale precipitation [C] (mm); None without microphysics
    rainnc: Any = None


def zero_state(C: int, E: int, V: int, K: int, dtype=torch.float32,
               device="cuda", n_scalars: int = 0) -> State:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    o = lambda *s: torch.ones(s, dtype=dtype, device=device)
    return State(
        u=z(K, E), w=z(K + 1, C), theta_m=z(K, C), rho_zz=z(K, C),
        ru=z(K, E), rw=z(K + 1, C), rho_p=z(K, C), rtheta_p=z(K, C),
        exner=z(K, C), pressure_p=z(K, C),
        ruAvg=z(K, E), wwAvg=z(K + 1, C),
        ke=z(K, C), divergence=z(K, C), vorticity=z(K, V),
        pv_edge=z(K, E), rho_edge=z(K, E), v=z(K, E),
        uReconstructZonal=z(K, C), uReconstructMeridional=z(K, C),
        rt_diabatic_tend=z(K, C), tend_rho_physics=z(K, C),
        tend_rtheta_physics=z(K, C), tend_ru_physics=z(K, E),
        # dry atmosphere: moisture coupling coefficients are exactly 1
        qtot=z(K, C), cqw=o(K, C), cqu=o(K, E),
        scalars=(z(n_scalars, K, C) if n_scalars else None),
    )


def to_float(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float64, order="C")).to(device=device,
                                                        dtype=dtype)


def to_index(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32, order="C")).to(device)


def mesh_arrays_from_mesh(mesh: Mesh, namelist, dtype=torch.float32,
                          device="cuda", deriv_two=None) -> MeshArrays:
    """Build device MeshArrays (including the derived stencil coefficients)
    from a host Mesh."""
    if deriv_two is None:
        deriv_two = mcoef.compute_deriv_two(mesh)
    adv = mcoef.compute_advection_coefficients(
        mesh, deriv_two, coef_3rd_order=namelist.config_coef_3rd_order)
    # trim the advection stencil to its true width (10 on hex meshes)
    s_used = int(adv.nAdvCellsForEdge.max())
    adv_cells = adv.advCellsForEdge[:, :s_used]
    adv_mask = adv.advMaskForEdge[:, :s_used]
    adv_c = adv.adv_coefs[:, :s_used]
    adv_c3 = adv.adv_coefs_3rd[:, :s_used]
    dirHess = mcoef.compute_dir_hessian(mesh, deriv_two)
    tanWeights = mcoef.compute_tangential_matrix(mesh)
    slotOnCell = mcoef.compute_edge_slots(mesh)
    if getattr(namelist, "config_reconstruct_method", "lsq") == "rbf":
        coeffs_reconstruct = mcoef.compute_reconstruct_coefficients_rbf(mesh)
    else:
        coeffs_reconstruct = mcoef.compute_reconstruct_coefficients(mesh)
    defc_a, defc_b = mcoef.compute_deformation_weights(mesh)
    ms2, ms4, msrc, msre = mcoef.compute_mesh_scaling(
        mesh, namelist.config_h_ScaleWithMesh)
    bdy_c = getattr(mesh, "bdyMaskCell", np.zeros(mesh.nCells))
    bdy_e = getattr(mesh, "bdyMaskEdge", np.zeros(mesh.nEdges))

    # rotated Coriolis parameter, alpha_grid = 0; non-rotating small-planet
    # cases (config_coriolis=False) zero it
    omega_pl = (constants.omega
                if getattr(namelist, "config_coriolis", True) else 0.0)
    fEdge = 2.0 * omega_pl * np.sin(mesh.latEdge)
    fVertex = 2.0 * omega_pl * np.sin(mesh.latVertex)

    f = lambda a: to_float(a, dtype, device)
    i = lambda a: to_index(a, device)
    return MeshArrays(
        cellsOnEdge=i(mesh.cellsOnEdge), verticesOnEdge=i(mesh.verticesOnEdge),
        edgesOnCell=i(mesh.edgesOnCell), cellsOnCell=i(mesh.cellsOnCell),
        verticesOnCell=i(mesh.verticesOnCell),
        edgesOnCell_mask=f(mesh.edgesOnCell_mask),
        edgesOnCellSign=f(mesh.edgesOnCellSign),
        cellsOnVertex=i(mesh.cellsOnVertex), edgesOnVertex=i(mesh.edgesOnVertex),
        edgesOnVertexSign=f(mesh.edgesOnVertexSign),
        edgesOnEdge=i(mesh.edgesOnEdge), edgesOnEdge_mask=f(mesh.edgesOnEdge_mask),
        weightsOnEdge=f(mesh.weightsOnEdge),
        kiteForCell=i(mesh.kiteForCell), kiteAreasOnVertex=f(mesh.kiteAreasOnVertex),
        latCell=f(mesh.latCell), lonCell=f(mesh.lonCell),
        latEdge=f(mesh.latEdge), lonEdge=f(mesh.lonEdge),
        angleEdge=f(mesh.angleEdge),
        dvEdge=f(mesh.dvEdge), dcEdge=f(mesh.dcEdge),
        invDvEdge=f(mesh.invDvEdge), invDcEdge=f(mesh.invDcEdge),
        areaCell=f(mesh.areaCell), invAreaCell=f(mesh.invAreaCell),
        invAreaTriangle=f(mesh.invAreaTriangle),
        meshScalingDel2=f(ms2), meshScalingDel4=f(ms4),
        meshScalingRegionalCell=f(msrc), meshScalingRegionalEdge=f(msre),
        bdyMaskCell=i(bdy_c), bdyMaskEdge=i(bdy_e),
        advCellsForEdge=i(adv_cells), advMaskForEdge=f(adv_mask),
        adv_coefs=f(adv_c), adv_coefs_3rd=f(adv_c3),
        # slot-major layouts: each weight row is a contiguous [C] vector
        dirHess=f(np.moveaxis(dirHess, 0, 2)),
        tanWeights=f(np.moveaxis(tanWeights, 0, 2)),
        slotOnCell=i(slotOnCell),
        coeffs_reconstruct=f(coeffs_reconstruct),
        defc_a=f(defc_a), defc_b=f(defc_b),
        fEdge=f(fEdge), fVertex=f(fVertex),
        owner_aligned=bool(getattr(mesh, "edges_owner_aligned", False)),
    )


def vertical_arrays_from_grid(vg: VerticalGrid, dtype=torch.float32,
                              device="cuda") -> VerticalArrays:
    f = lambda a: to_float(a, dtype, device)
    return VerticalArrays(
        rdzw=f(vg.rdzw), dzw=f(vg.dzw), rdzu=f(vg.rdzu),
        fzm=f(vg.fzm), fzp=f(vg.fzp), zw=f(vg.zw),
        cf1=f(vg.cf1), cf2=f(vg.cf2), cf3=f(vg.cf3),
        u_init=f(vg.u_init), v_init=f(vg.v_init),
    )
