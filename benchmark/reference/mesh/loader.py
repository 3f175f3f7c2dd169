"""MPAS mesh ingest: netCDF grid file -> padded dense index arrays.

Rebuilds the reference's `load_mesh` (mesh_loading/mesh_loading.rg:27-390)
TPU-first: instead of an array-of-structs region, the mesh becomes a bundle of
dense, padded numpy arrays (int32 adjacency + float64 geometry) ready to feed
gather-based finite-volume stencils.  All indices are converted to 0-based;
padded adjacency slots hold index 0 with a separate {0,1} mask (the zero-weight
masking strategy replacing the reference's `<= nEdges` sentinel branches,
dynamics_tasks.rg:62,76).

Derived orientation/geometry fields that the reference computes in
`atm_compute_signs` and scattered init tasks (dynamics_tasks.rg:46-130) are
computed here once, host-side, in float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import numpy as np

from .netcdf_io import read_netcdf
from .. import constants

# Variables read by the reference loader (mesh_loading.rg:39-201)
GRID_VARIABLES = [
    "latCell", "lonCell", "xCell", "yCell", "zCell", "indexToCellID",
    "latEdge", "lonEdge", "xEdge", "yEdge", "zEdge", "indexToEdgeID",
    "latVertex", "lonVertex", "xVertex", "yVertex", "zVertex", "indexToVertexID",
    "nEdgesOnCell", "nEdgesOnEdge", "cellsOnCell", "edgesOnCell",
    "verticesOnCell", "cellsOnEdge", "verticesOnEdge", "edgesOnEdge",
    "cellsOnVertex", "edgesOnVertex", "weightsOnEdge",
    "dvEdge", "dv1Edge", "dv2Edge", "dcEdge", "angleEdge",
    "areaCell", "areaTriangle", "kiteAreasOnVertex", "meshDensity",
]


@dataclass
class Mesh:
    """Static horizontal mesh: topology + geometry (host-side numpy)."""

    nCells: int
    nEdges: int
    nVertices: int
    maxEdges: int
    maxEdges2: int
    vertexDegree: int
    sphere_radius: float
    on_a_sphere: bool = True

    # cell geometry
    latCell: np.ndarray = None
    lonCell: np.ndarray = None
    xCell: np.ndarray = None
    yCell: np.ndarray = None
    zCell: np.ndarray = None
    areaCell: np.ndarray = None
    invAreaCell: np.ndarray = None
    meshDensity: np.ndarray = None

    # edge geometry
    latEdge: np.ndarray = None
    lonEdge: np.ndarray = None
    xEdge: np.ndarray = None
    yEdge: np.ndarray = None
    zEdge: np.ndarray = None
    dvEdge: np.ndarray = None
    dcEdge: np.ndarray = None
    invDvEdge: np.ndarray = None
    invDcEdge: np.ndarray = None
    angleEdge: np.ndarray = None

    # vertex geometry
    latVertex: np.ndarray = None
    lonVertex: np.ndarray = None
    xVertex: np.ndarray = None
    yVertex: np.ndarray = None
    zVertex: np.ndarray = None
    areaTriangle: np.ndarray = None
    invAreaTriangle: np.ndarray = None
    kiteAreasOnVertex: np.ndarray = None      # [V, vertexDegree]

    # adjacency (0-based int32; invalid slots = 0, see masks)
    nEdgesOnCell: np.ndarray = None           # [C]
    nEdgesOnEdge: np.ndarray = None           # [E]
    cellsOnCell: np.ndarray = None            # [C, maxEdges]
    edgesOnCell: np.ndarray = None            # [C, maxEdges]
    verticesOnCell: np.ndarray = None         # [C, maxEdges]
    cellsOnEdge: np.ndarray = None            # [E, 2]
    verticesOnEdge: np.ndarray = None         # [E, 2]
    edgesOnEdge: np.ndarray = None            # [E, maxEdges2]
    cellsOnVertex: np.ndarray = None          # [V, vertexDegree]
    edgesOnVertex: np.ndarray = None          # [V, vertexDegree]
    weightsOnEdge: np.ndarray = None          # [E, maxEdges2]

    # validity masks (float64 {0,1})
    edgesOnCell_mask: np.ndarray = None       # [C, maxEdges]
    edgesOnEdge_mask: np.ndarray = None       # [E, maxEdges2]

    # orientation (atm_compute_signs, dynamics_tasks.rg:46-130)
    edgesOnCellSign: np.ndarray = None        # [C, maxEdges] +-1 (0 in padding)
    edgesOnVertexSign: np.ndarray = None      # [V, vertexDegree]
    kiteForCell: np.ndarray = None            # [C, maxEdges] index into kiteAreasOnVertex

    def validate(self):
        """Partition-style sanity checks (cf. mesh_loading.rg:473-478)."""
        C, E, V = self.nCells, self.nEdges, self.nVertices
        assert self.cellsOnEdge.min() >= 0 and self.cellsOnEdge.max() < C
        assert self.verticesOnEdge.min() >= 0 and self.verticesOnEdge.max() < V
        assert self.cellsOnVertex.min() >= 0 and self.cellsOnVertex.max() < C
        assert self.edgesOnVertex.min() >= 0 and self.edgesOnVertex.max() < E
        # Euler characteristic of the sphere: C - E + V = 2
        if self.on_a_sphere:
            assert C - E + V == 2, (C, E, V)
        # every edge signed once + and once - by its two cells
        sign_sum = np.zeros(E)
        np.add.at(sign_sum, self.edgesOnCell.ravel(),
                  (self.edgesOnCellSign * self.edgesOnCell_mask).ravel())
        assert np.abs(sign_sum).max() == 0.0
        # total area = 4 pi a^2
        if self.on_a_sphere:
            target = 4.0 * np.pi * self.sphere_radius ** 2
            assert abs(self.areaCell.sum() / target - 1.0) < 1e-9
            assert abs(self.areaTriangle.sum() / target - 1.0) < 1e-9


def _to_zero_based(idx: np.ndarray, counts: np.ndarray | None, width_valid: int | None = None):
    """1-based padded index array -> (0-based int32 with 0 padding, mask)."""
    idx = np.asarray(idx, dtype=np.int64)
    if counts is not None:
        cols = np.arange(idx.shape[1])[None, :]
        mask = (cols < counts[:, None])
    else:
        mask = idx > 0
    out = np.where(mask, idx - 1, 0).astype(np.int32)
    return out, mask.astype(np.float64)


def load_mesh(path: str, sphere_radius: float = constants.sphere_radius) -> Mesh:
    """Load an MPAS grid file and scale the unit sphere to `sphere_radius`.

    The reference performs the scaling at the top of the JW init task
    (init_atm_cases.rg:87-111); here it is part of mesh loading so every
    consumer sees physical units.  Grid files that are already in physical
    units (sphere_radius attr != 1) are left unscaled.
    """
    raw = read_netcdf(path, GRID_VARIABLES)
    dims = raw["_dims"]
    C, E, V = dims["nCells"], dims["nEdges"], dims["nVertices"]
    maxEdges, maxEdges2, vdeg = dims["maxEdges"], dims["maxEdges2"], dims["vertexDegree"]

    # detect whether coordinates are on the unit sphere
    r = float(np.sqrt(raw["xCell"][0] ** 2 + raw["yCell"][0] ** 2 + raw["zCell"][0] ** 2))
    scale = sphere_radius / r

    m = Mesh(nCells=C, nEdges=E, nVertices=V, maxEdges=maxEdges,
             maxEdges2=maxEdges2, vertexDegree=vdeg, sphere_radius=sphere_radius)

    f8 = lambda a: np.asarray(a, dtype=np.float64)
    m.latCell, m.lonCell = f8(raw["latCell"]), f8(raw["lonCell"])
    m.latEdge, m.lonEdge = f8(raw["latEdge"]), f8(raw["lonEdge"])
    m.latVertex, m.lonVertex = f8(raw["latVertex"]), f8(raw["lonVertex"])
    for p, nm in (("x", "Cell"), ("y", "Cell"), ("z", "Cell"),
                  ("x", "Edge"), ("y", "Edge"), ("z", "Edge"),
                  ("x", "Vertex"), ("y", "Vertex"), ("z", "Vertex")):
        setattr(m, p + nm, f8(raw[p + nm]) * scale)
    m.areaCell = f8(raw["areaCell"]) * scale ** 2
    m.areaTriangle = f8(raw["areaTriangle"]) * scale ** 2
    m.kiteAreasOnVertex = f8(raw["kiteAreasOnVertex"]) * scale ** 2
    m.dvEdge = f8(raw["dvEdge"]) * scale
    m.dcEdge = f8(raw["dcEdge"]) * scale
    m.angleEdge = f8(raw["angleEdge"])
    m.meshDensity = f8(raw["meshDensity"])
    m.weightsOnEdge = f8(raw["weightsOnEdge"])

    m.invAreaCell = 1.0 / m.areaCell
    m.invAreaTriangle = 1.0 / m.areaTriangle
    m.invDvEdge = 1.0 / m.dvEdge
    m.invDcEdge = 1.0 / m.dcEdge

    m.nEdgesOnCell = np.asarray(raw["nEdgesOnCell"], dtype=np.int32)
    m.nEdgesOnEdge = np.asarray(raw["nEdgesOnEdge"], dtype=np.int32)

    m.cellsOnCell, _ = _to_zero_based(raw["cellsOnCell"], m.nEdgesOnCell)
    m.edgesOnCell, m.edgesOnCell_mask = _to_zero_based(raw["edgesOnCell"], m.nEdgesOnCell)
    m.verticesOnCell, _ = _to_zero_based(raw["verticesOnCell"], m.nEdgesOnCell)
    m.cellsOnEdge, _ = _to_zero_based(raw["cellsOnEdge"], None)
    m.verticesOnEdge, _ = _to_zero_based(raw["verticesOnEdge"], None)
    m.edgesOnEdge, m.edgesOnEdge_mask = _to_zero_based(raw["edgesOnEdge"], m.nEdgesOnEdge)
    m.cellsOnVertex, _ = _to_zero_based(raw["cellsOnVertex"], None)
    m.edgesOnVertex, _ = _to_zero_based(raw["edgesOnVertex"], None)

    _compute_signs(m)
    trim_mesh_widths(m)
    return m


def trim_mesh_widths(m: Mesh) -> Mesh:
    """Trim padded adjacency widths to their actual maxima.

    The file format pads cellsOnCell/edgesOnCell/verticesOnCell to
    maxEdges=10 and edgesOnEdge/weightsOnEdge to maxEdges2=20, but hexagonal
    CVT meshes use at most 6 and 10 slots — gathers over the padding are
    pure wasted HBM traffic (the widest gathers in the solver).  Safe because
    every consumer is width-agnostic and masked."""
    me = int(m.nEdgesOnCell.max())
    mee = int(m.nEdgesOnEdge.max())
    if me < m.maxEdges:
        for f in ("cellsOnCell", "edgesOnCell", "verticesOnCell",
                  "edgesOnCell_mask", "edgesOnCellSign", "kiteForCell"):
            setattr(m, f, np.ascontiguousarray(getattr(m, f)[:, :me]))
        m.maxEdges = me
    if mee < m.maxEdges2:
        for f in ("edgesOnEdge", "edgesOnEdge_mask", "weightsOnEdge"):
            setattr(m, f, np.ascontiguousarray(getattr(m, f)[:, :mee]))
        m.maxEdges2 = mee
    return m


def compute_evc(m: Mesh) -> np.ndarray:
    """EVC triples [C, maxEdges, 3]: for vertex slot j of each cell,
    (vertex id, edge1, edge2) where edge1/edge2 are the (up to two) edges of
    the cell incident to that vertex (-1 when absent).  Parity feature with
    the reference's brute-force EVC loop (mesh_loading.rg:306-344), used by
    its plotting/partitioning tooling; vectorized here."""
    C, M = m.nCells, m.maxEdges
    evc = np.full((C, M, 3), -1, dtype=np.int32)
    evc[:, :, 0] = np.where(m.edgesOnCell_mask > 0, m.verticesOnCell, -1)
    # an edge of the cell is incident to the vertex iff the vertex appears in
    # its verticesOnEdge pair
    voe = m.verticesOnEdge[m.edgesOnCell]            # [C, M, 2]
    for j in range(M):
        v = m.verticesOnCell[:, j][:, None]          # [C, 1]
        hit = ((voe[:, :, 0] == v) | (voe[:, :, 1] == v)) & (m.edgesOnCell_mask > 0)
        hit &= (m.edgesOnCell_mask[:, j] > 0)[:, None]
        # first and second matching edge slots
        first = np.argmax(hit, axis=1)
        has1 = hit.any(axis=1)
        hit2 = hit.copy()
        hit2[np.arange(C), first] = False
        second = np.argmax(hit2, axis=1)
        has2 = hit2.any(axis=1)
        evc[:, j, 1] = np.where(has1, m.edgesOnCell[np.arange(C), first], -1)
        evc[:, j, 2] = np.where(has2, m.edgesOnCell[np.arange(C), second], -1)
    return evc


def _compute_signs(m: Mesh):
    """Edge-orientation signs and kite indices (atm_compute_signs semantics,
    dynamics_tasks.rg:46-130, with the reference's per-element loops replaced
    by vectorized numpy)."""
    # +1 where the cell is cellsOnEdge[edge, 0] (edge normal points away)
    first_cell = m.cellsOnEdge[m.edgesOnCell, 0]                      # [C, maxEdges]
    cell_ids = np.arange(m.nCells, dtype=np.int32)[:, None]
    m.edgesOnCellSign = np.where(first_cell == cell_ids, 1.0, -1.0) * m.edgesOnCell_mask

    # +1 where the vertex is verticesOnEdge[edge, 1] (positive circulation)
    second_vert = m.verticesOnEdge[m.edgesOnVertex, 1]                # [V, vdeg]
    vert_ids = np.arange(m.nVertices, dtype=np.int32)[:, None]
    m.edgesOnVertexSign = np.where(second_vert == vert_ids, 1.0, -1.0)

    # kiteForCell[c, i]: which kite of vertex verticesOnCell[c, i] touches c
    cov = m.cellsOnVertex[m.verticesOnCell]                           # [C, maxEdges, vdeg]
    match = (cov == np.arange(m.nCells, dtype=np.int32)[:, None, None])
    kite = np.argmax(match, axis=2).astype(np.int32)
    m.kiteForCell = np.where(m.edgesOnCell_mask > 0, kite, 0).astype(np.int32)
