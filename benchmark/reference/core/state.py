"""Model state as dataclasses of torch tensors on one device.

The port of `mpas_tpu.core.state`: every field is a dense tensor with the
vertical level MAJOR and the element index (cell/edge/vertex) minor.

Array shape conventions (C=nCells, E=nEdges, V=nVertices, K=nVertLevels):
  cell fields      [K, C]       (mass levels)    e.g. theta_m, rho_zz
  cell w-fields    [K+1, C]     (interfaces)     e.g. w, rw, zgrid
  edge fields      [K, E]                        e.g. u, ru
  vertex fields    [K, V]                        e.g. vorticity
  scalars          [nS, K, C]   (species major)
Per-slot coefficient tables are slot-major: zb_cell/zb3_cell [M, K+1, C].

Index tables are int32: `torch.index_select` takes them as they are.
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


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


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

    # advection stencil (atm_adv_coef_compression)
    advCellsForEdge: Any      # [E, S]
    advMaskForEdge: Any       # [E, S]
    adv_coefs: Any            # [E, S]
    adv_coefs_3rd: Any        # [E, S]

    # velocity reconstruction + deformation
    coeffs_reconstruct: Any   # [C, M, 3]
    defc_a: Any               # [C, M]
    defc_b: Any               # [C, M]

    # Coriolis
    fEdge: Any                # [E]
    fVertex: Any              # [V]

    def __post_init__(self):
        # the gather-reduce kernel reads through these tables without a
        # bounds check, so an out-of-range entry is refused here, once
        bounds = (("edgesOnCell", self.nEdges), ("edgesOnVertex", self.nEdges),
                  ("edgesOnEdge", self.nEdges),
                  ("advCellsForEdge", self.nCells),
                  ("cellsOnCell", self.nCells),
                  ("verticesOnCell", self.nVertices))
        for name, n in bounds:
            t = getattr(self, name)
            if t.numel() and (int(t.min()) < 0 or int(t.max()) >= n):
                raise ValueError(f"MeshArrays.{name}: entries outside "
                                 f"[0, {n})")

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
    coeffs_reconstruct = mcoef.compute_reconstruct_coefficients(mesh)
    defc_a, defc_b = mcoef.compute_deformation_weights(mesh)
    ms2, ms4, _, _ = mcoef.compute_mesh_scaling(
        mesh, namelist.config_h_ScaleWithMesh)

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
        latCell=f(mesh.latCell), lonCell=f(mesh.lonCell),
        latEdge=f(mesh.latEdge), lonEdge=f(mesh.lonEdge),
        angleEdge=f(mesh.angleEdge),
        dvEdge=f(mesh.dvEdge), dcEdge=f(mesh.dcEdge),
        invDvEdge=f(mesh.invDvEdge), invDcEdge=f(mesh.invDcEdge),
        areaCell=f(mesh.areaCell), invAreaCell=f(mesh.invAreaCell),
        invAreaTriangle=f(mesh.invAreaTriangle),
        meshScalingDel2=f(ms2), meshScalingDel4=f(ms4),
        advCellsForEdge=i(adv_cells), advMaskForEdge=f(adv_mask),
        adv_coefs=f(adv_c), adv_coefs_3rd=f(adv_c3),
        coeffs_reconstruct=f(coeffs_reconstruct),
        defc_a=f(defc_a), defc_b=f(defc_b),
        fEdge=f(fEdge), fVertex=f(fVertex),
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
