"""Spherical centroidal-Voronoi mesh generator.

The reference ships only the bundled x1.2562 grid (mesh_loading/, SURVEY.md
section 2.2); production configurations need the x1.10242/40962/163842
family.  This module generates the same quasi-uniform icosahedral CVT meshes
from scratch: subdivide the icosahedron k times (10*4^k+2 cells), optionally
Lloyd-relax to a CVT, take the spherical Delaunay triangulation (convex
hull), and derive the full MPAS mesh data structure including the Thuburn
tangential-reconstruction weights (validated against the bundled grid's
weightsOnEdge in tests/test_generator.py).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull

from .. import constants
from .loader import Mesh, _compute_signs, trim_mesh_widths


# ---------------------------------------------------------------------------
# point generation
# ---------------------------------------------------------------------------

def icosahedron_points():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    pts = []
    for a in (-1.0, 1.0):
        for b in (-phi, phi):
            pts += [(0, a, b), (a, b, 0), (b, 0, a)]
    pts = np.array(pts, dtype=np.float64)
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


def _triangulate(points):
    hull = ConvexHull(points)
    # orient all triangles outward (counterclockwise seen from outside)
    tris = hull.simplices.copy()
    normals = np.cross(points[tris[:, 1]] - points[tris[:, 0]],
                       points[tris[:, 2]] - points[tris[:, 0]])
    centers = points[tris].mean(axis=1)
    flip = np.einsum("ij,ij->i", normals, centers) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return tris


def subdivide(points, levels: int):
    """Loop-style bisection of the icosahedral triangulation `levels` times."""
    for _ in range(levels):
        tris = _triangulate(points)
        edges = set()
        for t in tris:
            for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                edges.add((min(a, b), max(a, b)))
        edges = np.array(sorted(edges))
        mid = points[edges[:, 0]] + points[edges[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        points = np.vstack([points, mid])
    return points


def lloyd_relax(points, iterations: int = 4, density_fn=None,
                overrelax: float = 1.0):
    """Spherical Lloyd iterations toward a centroidal Voronoi tessellation.

    Each generator moves to the (area-weighted) centroid of its Voronoi
    cell, computed exactly from the kite decomposition: the part of the cell
    inside each Delaunay triangle is the kite (p, m1, circumcenter, m2),
    split into two planar sub-triangles.

    `density_fn(xyz [N,3]) -> rho [N]` makes the CVT variable-resolution
    (Ringler et al. 2008 / MPAS variable meshes): each sub-triangle's
    contribution is weighted by the density at its centroid, so converged
    cell spacing goes as rho^(-1/4).  `overrelax` > 1 steps past the
    centroid (x + w*(centroid - x)), accelerating the slow point migration
    of plain Lloyd on variable-density problems."""
    for _ in range(iterations):
        tris = _triangulate(points)
        cc = _circumcenters(points, tris)
        num = np.zeros_like(points)
        den = np.zeros(len(points))
        for corner in range(3):
            idx = tris[:, corner]
            p = points[idx]
            pn = points[tris[:, (corner + 1) % 3]]
            pp = points[tris[:, (corner + 2) % 3]]
            m1 = p + pn
            m1 /= np.linalg.norm(m1, axis=1, keepdims=True)
            m2 = p + pp
            m2 /= np.linalg.norm(m2, axis=1, keepdims=True)
            for a, b in ((m1, cc), (cc, m2)):
                area = 0.5 * np.linalg.norm(np.cross(a - p, b - p), axis=1)
                cen = (p + a + b) / 3.0
                if density_fn is not None:
                    csph = cen / np.linalg.norm(cen, axis=1, keepdims=True)
                    area = area * density_fn(csph)
                np.add.at(num, idx, cen * area[:, None])
                np.add.at(den, idx, area)
        new = num / den[:, None]
        if overrelax != 1.0:
            new = points + overrelax * (new - points)
        points = new / np.linalg.norm(new, axis=1, keepdims=True)
    return points


def circular_refinement_density(lat_c: float, lon_c: float,
                                ratio: float = 2.0, radius: float = 0.5,
                                transition: float = 0.2):
    """Density function for a circular refinement region: cell spacing is
    `ratio`x finer than the background inside the great-circle `radius`
    (radians) around (lat_c, lon_c), blended by tanh over `transition`.
    Density normalized to max 1 in the fine region (rho = (h_max/h)^4,
    the MPAS meshDensity convention)."""
    g4 = float(ratio) ** 4
    cx = np.array([np.cos(lat_c) * np.cos(lon_c),
                   np.cos(lat_c) * np.sin(lon_c),
                   np.sin(lat_c)])

    def density(xyz):
        r = _arc(xyz, cx[None, :])
        w = 0.5 * (1.0 + np.tanh((radius - r) / transition))  # 1 inside
        return (1.0 + (g4 - 1.0) * w) / g4

    return density


def _circumcenters(points, tris):
    a, b, c = points[tris[:, 0]], points[tris[:, 1]], points[tris[:, 2]]
    cc = np.cross(b - a, c - a)
    cc /= np.linalg.norm(cc, axis=1, keepdims=True)
    # orient outward
    flip = np.einsum("ij,ij->i", cc, (a + b + c) / 3.0) < 0
    cc[flip] *= -1.0
    return cc


def _spherical_angle(a, b, c):
    """Angle at vertex a of the spherical triangle abc (unit vectors)."""
    ab = b - np.einsum("...i,...i->...", a, b)[..., None] * a
    ac = c - np.einsum("...i,...i->...", a, c)[..., None] * a
    ab /= np.maximum(np.linalg.norm(ab, axis=-1, keepdims=True), 1e-300)
    ac /= np.maximum(np.linalg.norm(ac, axis=-1, keepdims=True), 1e-300)
    cosang = np.clip(np.einsum("...i,...i->...", ab, ac), -1.0, 1.0)
    return np.arccos(cosang)


def _triangle_areas(points, tris):
    """Spherical excess of each triangle (unit sphere)."""
    a, b, c = points[tris[:, 0]], points[tris[:, 1]], points[tris[:, 2]]
    return (_spherical_angle(a, b, c) + _spherical_angle(b, c, a)
            + _spherical_angle(c, a, b) - np.pi)


def _signed_excess(a, b, c):
    """Signed spherical-triangle area (Oosterom-Strackee): positive when
    a,b,c wind counterclockwise seen from outside the sphere.  Needed for
    kite decompositions on variable-resolution meshes, where an obtuse
    Delaunay triangle puts the circumcenter outside the triangle and one
    kite sub-triangle flips orientation (its area must subtract)."""
    det = np.einsum("...i,...i->...", a, np.cross(b, c))
    denom = (1.0 + np.einsum("...i,...i->...", a, b)
             + np.einsum("...i,...i->...", b, c)
             + np.einsum("...i,...i->...", c, a))
    return 2.0 * np.arctan2(det, denom)


def _arc(a, b):
    return np.arccos(np.clip(np.einsum("...i,...i->...", a, b), -1.0, 1.0))


# ---------------------------------------------------------------------------
# mesh assembly
# ---------------------------------------------------------------------------

def generate_mesh(levels: int = 4, lloyd_iterations: int = 4,
                  sphere_radius: float = constants.sphere_radius,
                  density_fn=None, overrelax: float = 1.0) -> Mesh:
    """Generate the x1.{10*4^levels+2} CVT mesh.

    levels=4 -> 2562 cells (the bundled grid), 5 -> 10242, 6 -> 40962,
    7 -> 163842.  `density_fn` (see circular_refinement_density) makes the
    tessellation variable-resolution; meshDensity is then stamped from it so
    the del2/del4 meshScaling* and w-damping dss consume the real local
    density (atm_compute_mesh_scaling, dynamics_tasks.rg:595-646).  Variable
    meshes want more Lloyd iterations (>=20) to migrate points into the
    refinement region."""
    pts = subdivide(icosahedron_points(), levels)
    if lloyd_iterations:
        pts = lloyd_relax(pts, lloyd_iterations, density_fn=density_fn,
                          overrelax=overrelax)

    # order cells for horizontal-gather locality: latitude bands, then lon
    lat = np.arcsin(np.clip(pts[:, 2], -1, 1))
    lon = np.mod(np.arctan2(pts[:, 1], pts[:, 0]), 2 * np.pi)
    nbands = max(int(np.sqrt(len(pts) / 2)), 4)
    band = np.clip(((lat + np.pi / 2) / np.pi * nbands).astype(int), 0, nbands - 1)
    order = np.lexsort((lon, band))
    pts = pts[order]

    C = len(pts)
    tris = _triangulate(pts)                  # [T, 3] CCW from outside
    V = len(tris)
    vxyz = _circumcenters(pts, tris)

    # --- edges from triangle adjacency (vectorized: sort by pair key; every
    # edge appears in exactly two triangles) ---
    pairs = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    tri_of_pair = np.concatenate([np.arange(V)] * 3).astype(np.int64)
    key = (np.minimum(pairs[:, 0], pairs[:, 1]) * np.int64(C)
           + np.maximum(pairs[:, 0], pairs[:, 1]))
    order = np.argsort(key, kind="stable")
    E = len(order) // 2
    k_sorted = key[order]
    assert np.all(k_sorted[0::2] == k_sorted[1::2])
    cellsOnEdge = np.stack([k_sorted[0::2] // C, k_sorted[0::2] % C], axis=1)
    verticesOnEdge = np.stack([tri_of_pair[order[0::2]],
                               tri_of_pair[order[1::2]]], axis=1)
    edge_key_sorted = k_sorted[0::2]          # ascending, for edge lookup

    # orientation: v1 -> v2 must be 90 deg counterclockwise from c1 -> c2
    # (t_hat = k_hat x n_hat), matching the bundled grid's convention
    c1p, c2p = pts[cellsOnEdge[:, 0]], pts[cellsOnEdge[:, 1]]
    v1p, v2p = vxyz[verticesOnEdge[:, 0]], vxyz[verticesOnEdge[:, 1]]
    emid = c1p + c2p
    emid /= np.linalg.norm(emid, axis=1, keepdims=True)
    cross = np.cross(c2p - c1p, v2p - v1p)
    wrong = np.einsum("ij,ij->i", cross, emid) < 0
    verticesOnEdge[wrong] = verticesOnEdge[wrong][:, ::-1]

    # --- per-cell orderings (CCW), vectorized over all (cell, edge) pairs ---
    east = np.cross([0.0, 0.0, 1.0], pts)
    east /= np.maximum(np.linalg.norm(east, axis=1, keepdims=True), 1e-12)
    north = np.cross(pts, east)

    pair_cell = np.concatenate([cellsOnEdge[:, 0], cellsOnEdge[:, 1]])
    pair_edge = np.tile(np.arange(E, dtype=np.int64), 2)
    pair_other = np.concatenate([cellsOnEdge[:, 1], cellsOnEdge[:, 0]])
    d = pts[pair_other] - pts[pair_cell]
    ang = np.arctan2(np.einsum("pj,pj->p", d, north[pair_cell]),
                     np.einsum("pj,pj->p", d, east[pair_cell]))
    po = np.lexsort((ang, pair_cell))
    pc, pe = pair_cell[po], pair_edge[po]
    counts = np.bincount(pc, minlength=C)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_cell = np.arange(2 * E) - starts[pc]
    nEdgesOnCell = counts.astype(np.int32)
    # Quasi-uniform CVT meshes are hexagonal (12 pentagons), but density-
    # weighted Lloyd produces heptagons in refinement transition zones, so
    # the padded width must come from the actual tessellation.
    maxEdges = max(6, int(counts.max()))
    edgesOnCell = np.zeros((C, maxEdges), dtype=np.int64)
    edgesOnCell[pc, pos_in_cell] = pe
    # position of each edge within each of its two cells' CCW lists
    j0_of = np.zeros((E, 2), dtype=np.int64)
    side = (pair_other[po] == cellsOnEdge[pe, 0]).astype(np.int64)  # 1 if pc is cell2
    j0_of[pe, side] = pos_in_cell

    ecol = np.arange(maxEdges)[None, :]
    emask = ecol < nEdgesOnCell[:, None]
    eoc_safe = np.where(emask, edgesOnCell, 0)
    cellsOnCell = np.where(
        cellsOnEdge[eoc_safe, 0] == np.arange(C)[:, None],
        cellsOnEdge[eoc_safe, 1], cellsOnEdge[eoc_safe, 0])
    cellsOnCell = np.where(emask, cellsOnCell, 0)
    # vertex i of the cell: shared by CCW edges i and i+1
    nxt = (ecol + 1) % nEdgesOnCell[:, None]
    eoc_next = np.where(emask, edgesOnCell[np.arange(C)[:, None], nxt], 0)
    v1 = verticesOnEdge[eoc_safe]            # [C, M, 2]
    v2 = verticesOnEdge[eoc_next]
    shared_is_0 = ((v1[..., 0] == v2[..., 0]) | (v1[..., 0] == v2[..., 1]))
    verticesOnCell = np.where(shared_is_0, v1[..., 0], v1[..., 1])
    verticesOnCell = np.where(emask, verticesOnCell, 0)

    cellsOnVertex = tris.astype(np.int64)             # [V, 3] CCW
    # edgesOnVertex: edge between consecutive cells of the triangle, found by
    # binary search on the sorted edge keys
    a_ = cellsOnVertex
    b_ = np.roll(cellsOnVertex, -1, axis=1)
    vkey = (np.minimum(a_, b_) * np.int64(C) + np.maximum(a_, b_))
    edgesOnVertex = np.searchsorted(edge_key_sorted, vkey).astype(np.int64)

    # --- geometry ---
    dcEdge = _arc(c1p, c2p)
    dvEdge = _arc(vxyz[verticesOnEdge[:, 0]], vxyz[verticesOnEdge[:, 1]])
    latEdge = np.arcsin(np.clip(emid[:, 2], -1, 1))
    lonEdge = np.mod(np.arctan2(emid[:, 1], emid[:, 0]), 2 * np.pi)
    latV = np.arcsin(np.clip(vxyz[:, 2], -1, 1))
    lonV = np.mod(np.arctan2(vxyz[:, 1], vxyz[:, 0]), 2 * np.pi)

    # angleEdge: azimuth of the edge normal (c1->c2 direction) at the edge
    east_e = np.cross([0.0, 0.0, 1.0], emid)
    east_e /= np.maximum(np.linalg.norm(east_e, axis=1, keepdims=True), 1e-12)
    north_e = np.cross(emid, east_e)
    dce = c2p - c1p
    dce -= np.einsum("ij,ij->i", dce, emid)[:, None] * emid
    angleEdge = np.arctan2(np.einsum("ij,ij->i", dce, north_e),
                           np.einsum("ij,ij->i", dce, east_e))

    areaTriangle = np.zeros(V)
    kiteAreasOnVertex = np.zeros((V, 3))
    for i in range(3):
        # kite of cell i at vertex v: quadrilateral (cell_i, em1, v, em2)
        # computed as two spherical triangles
        ci = pts[cellsOnVertex[:, i]]
        cprev = pts[cellsOnVertex[:, (i + 2) % 3]]
        cnext = pts[cellsOnVertex[:, (i + 1) % 3]]
        m1 = ci + cprev
        m1 /= np.linalg.norm(m1, axis=1, keepdims=True)
        m2 = ci + cnext
        m2 /= np.linalg.norm(m2, axis=1, keepdims=True)
        kiteAreasOnVertex[:, i] = (_signed_excess(ci, m2, vxyz)
                                   + _signed_excess(ci, vxyz, m1))
    areaTriangle = kiteAreasOnVertex.sum(axis=1)

    areaCell = np.zeros(C)
    np.add.at(areaCell, cellsOnVertex.ravel(), kiteAreasOnVertex.ravel())

    # --- Thuburn tangential weights (Ringler et al 2010 eq 33), vectorized ---
    maxEdges2 = 2 * (maxEdges - 1)
    nEdgesOnEdge = np.zeros(E, dtype=np.int32)
    edgesOnEdge = np.zeros((E, maxEdges2), dtype=np.int64)
    weightsOnEdge = np.zeros((E, maxEdges2))
    # kite share of each (cell, vertex-slot): kiteAreasOnVertex row of the
    # vertex, at the position where that cell appears in cellsOnVertex
    cov_of_voc = cellsOnVertex[verticesOnCell]            # [C, M, 3]
    kpos = np.argmax(cov_of_voc == np.arange(C)[:, None, None], axis=2)
    kite_cv = np.take_along_axis(kiteAreasOnVertex[verticesOnCell],
                                 kpos[..., None], axis=2)[..., 0]   # [C, M]
    kite_cv = np.where(emask, kite_cv, 0.0)

    eidx = np.arange(E, dtype=np.int64)
    for s in range(2):
        c = cellsOnEdge[:, s]                              # [E]
        n = nEdgesOnCell[c].astype(np.int64)               # [E]
        j0 = j0_of[:, s]
        ne_c = 1.0 if s == 0 else -1.0
        R = np.zeros(E)
        for j in range(1, maxEdges):
            valid = j < n
            fj = edgesOnCell[c, (j0 + j) % n]              # [E]
            vslot = (j0 + j - 1) % n
            R = R + np.where(valid, kite_cv[c, vslot] / areaCell[c], 0.0)
            nf_c = np.where(cellsOnEdge[fj, 0] == c, 1.0, -1.0)
            w = ne_c * nf_c * (0.5 - R) * dvEdge[fj] / dcEdge[eidx]
            slot = (j - 1) + s * np.maximum(nEdgesOnCell[cellsOnEdge[:, 0]] - 1, 0)
            edgesOnEdge[eidx, slot] = np.where(valid, fj, edgesOnEdge[eidx, slot])
            weightsOnEdge[eidx, slot] = np.where(valid, w, weightsOnEdge[eidx, slot])
            nEdgesOnEdge += valid.astype(np.int32)

    # --- assemble Mesh (scaled to sphere_radius) ---
    a = sphere_radius
    m = Mesh(nCells=C, nEdges=E, nVertices=V, maxEdges=maxEdges,
             maxEdges2=maxEdges2, vertexDegree=3, sphere_radius=a)
    m.latCell = np.arcsin(np.clip(pts[:, 2], -1, 1))
    m.lonCell = np.mod(np.arctan2(pts[:, 1], pts[:, 0]), 2 * np.pi)
    m.xCell, m.yCell, m.zCell = (pts * a).T
    m.latEdge, m.lonEdge = latEdge, lonEdge
    m.xEdge, m.yEdge, m.zEdge = (emid * a).T
    m.latVertex, m.lonVertex = latV, lonV
    m.xVertex, m.yVertex, m.zVertex = (vxyz * a).T
    m.areaCell = areaCell * a ** 2
    m.areaTriangle = areaTriangle * a ** 2
    m.kiteAreasOnVertex = kiteAreasOnVertex * a ** 2
    m.dvEdge = dvEdge * a
    m.dcEdge = dcEdge * a
    m.angleEdge = angleEdge
    if density_fn is not None:
        rho = density_fn(pts)
        m.meshDensity = rho / rho.max()
    else:
        m.meshDensity = np.ones(C)
    m.weightsOnEdge = weightsOnEdge
    m.invAreaCell = 1.0 / m.areaCell
    m.invAreaTriangle = 1.0 / m.areaTriangle
    m.invDvEdge = 1.0 / m.dvEdge
    m.invDcEdge = 1.0 / m.dcEdge
    m.nEdgesOnCell = nEdgesOnCell
    m.nEdgesOnEdge = nEdgesOnEdge
    m.cellsOnCell = cellsOnCell.astype(np.int32)
    m.edgesOnCell = edgesOnCell.astype(np.int32)
    m.verticesOnCell = verticesOnCell.astype(np.int32)
    m.cellsOnEdge = cellsOnEdge.astype(np.int32)
    m.verticesOnEdge = verticesOnEdge.astype(np.int32)
    m.edgesOnEdge = edgesOnEdge.astype(np.int32)
    m.cellsOnVertex = cellsOnVertex.astype(np.int32)
    m.edgesOnVertex = edgesOnVertex.astype(np.int32)
    cols = np.arange(maxEdges)[None, :]
    m.edgesOnCell_mask = (cols < nEdgesOnCell[:, None]).astype(np.float64)
    cols2 = np.arange(maxEdges2)[None, :]
    m.edgesOnEdge_mask = (cols2 < nEdgesOnEdge[:, None]).astype(np.float64)
    _compute_signs(m)
    trim_mesh_widths(m)
    return m
