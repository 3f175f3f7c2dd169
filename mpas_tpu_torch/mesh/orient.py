"""Ownership-aligned edge numbering (round-5 perf lever, docs/NEXT.md #1).

Every edge-pair stencil reads a cell field at BOTH cells of every edge; as
plain lane gathers that is ~2 ns per gathered column twice per pair table
(docs/PERF.md).  But a planar graph admits a 3-bounded orientation
(Nash-Williams: |E(H)| <= 3|V(H)| for every subgraph of a planar graph, and
an icosahedral CVT sphere has E = 3C - 6 exactly), i.e. every edge can be
assigned an OWNER cell such that each cell owns at most 3 edges.  With the
slot-major renumbering

    new_edge_id = slot * C + owner          (slot in 0..2, Ep = 3C)

the owner-side value of ANY cell field f [K, C] on every edge is

    f_owner_on_edges = concat([f, f, f], axis=1)     # [K, 3C], no gather

— a pure lane-dim tiling XLA emits as three full-width copies at streaming
bandwidth — and the reduction of a cell's 3 OWNED edges of an edge field
g [K, 3C] is the slice sum g[:, :C] + g[:, C:2C] + g[:, 2C:3C], no gather
at all.  Only the non-owner side of pair reads and the ~3 non-owned slots
of edgesOnCell reductions remain true gathers, halving the pair-gather
column count.

The transform is a pure mesh relabeling + orientation flip applied BEFORE
any coefficient building (config_orient_edges), so all derived tables
(signs, adv_coefs, deriv_two, Thuburn weights, kites) come out consistent
by construction: where the matching picks the old cell2 as owner the edge
flips — cellsOnEdge AND verticesOnEdge swap (keeping the MPAS right-handed
normal/tangent convention), angleEdge rotates by pi, and weightsOnEdge
obeys W[e, j] *= flip[e] * flip[edgesOnEdge[e, j]] (u and v both live
along flipped directions).  E pads from 3C - 6 to 3C with 6 inert dummy
edges (dvEdge = 0, both cells = owner, listed by no cell).

The reference has no analog — its AoS region layout makes task-side
indexing free and bandwidth irrelevant (mpas-regent runs per-element Regent
loops); this is purely a TPU-lane-economics construction.
"""

from __future__ import annotations

import numpy as np

from .loader import Mesh, _compute_signs


def three_bounded_orientation(m: Mesh) -> np.ndarray:
    """owner[e] in {cellsOnEdge[e,0], cellsOnEdge[e,1]} with every cell
    owning <= 3 edges, via max-flow (source -> edge cap 1, edge -> its two
    cells cap 1, cell -> sink cap 3; Dinic through scipy).  A full flow
    exists on any planar mesh (Nash-Williams: |E(H)| <= 3|V(H)|); raises
    otherwise.  Returns cell_slot = 3*owner + slot with distinct slots
    0..2 per owner."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow

    E, C = m.nEdges, m.nCells
    c1 = m.cellsOnEdge[:, 0].astype(np.int64)
    c2 = m.cellsOnEdge[:, 1].astype(np.int64)
    # nodes: 0 = source, 1..E = edges, E+1..E+C = cells, E+C+1 = sink
    S, T = 0, E + C + 1
    rows = np.concatenate([np.zeros(E, np.int64), 1 + np.arange(E),
                           1 + np.arange(E), E + 1 + np.arange(C)])
    cols = np.concatenate([1 + np.arange(E), E + 1 + c1, E + 1 + c2,
                           np.full(C, T, np.int64)])
    cap = np.concatenate([np.ones(3 * E, np.int32),
                          np.full(C, 3, np.int32)])
    g = csr_matrix((cap, (rows, cols)), shape=(T + 1, T + 1))
    res = maximum_flow(g, S, T)
    if res.flow_value != E:
        raise RuntimeError(
            f"3-bounded edge orientation failed: flow {res.flow_value} < {E} "
            f"(non-planar connectivity?)")
    fl = res.flow.tocsr()
    f1 = np.asarray(fl[1 + np.arange(E), E + 1 + c1]).ravel()
    owner = np.where(f1 == 1, c1, c2)
    # distinct slot 0..2 per owner, in edge-id order (stable)
    order = np.argsort(owner, kind="stable")
    slot = np.empty(E, np.int64)
    slot[order] = np.arange(E) - np.searchsorted(owner[order],
                                                 owner[order], side="left")
    assert slot.min() >= 0 and slot.max() <= 2
    return 3 * owner + slot


def orient_edges(m: Mesh) -> tuple[Mesh, dict]:
    """Return (oriented mesh with Ep = 3C edges, perms).

    perms: `new_of_old` [E] (old edge id -> new id), `flip` [E] (+1/-1 —
    multiply an old-orientation edge field by this when comparing against
    the oriented run), `owner` [E].
    """
    import dataclasses

    E, C = m.nEdges, m.nCells
    Ep = 3 * C
    cell_slot = three_bounded_orientation(m)
    owner = cell_slot // 3
    slot = cell_slot % 3
    new_of_old = slot * C + owner                               # [E]
    flip_needed = m.cellsOnEdge[:, 0].astype(np.int64) != owner
    flip = np.where(flip_needed, -1.0, 1.0)

    filled = np.zeros(Ep, bool)
    filled[new_of_old] = True
    assert filled.sum() == E

    n = Mesh(nCells=C, nEdges=Ep, nVertices=m.nVertices,
             maxEdges=m.maxEdges, maxEdges2=m.maxEdges2,
             vertexDegree=m.vertexDegree, sphere_radius=m.sphere_radius,
             on_a_sphere=m.on_a_sphere)
    n.nEdgesReal = E
    n.edges_owner_aligned = True

    def scatter(old, dummy):
        """Old per-edge array -> new numbering, dummies filled."""
        old = np.asarray(old)
        out = np.empty((Ep,) + old.shape[1:], old.dtype)
        out[...] = dummy
        out[new_of_old] = old
        return out

    # ---- plain per-edge scalars ----
    # Dummy values are chosen so every consumer stays FINITE and inert:
    # dvEdge = 1 (a divisor in the init-wind construction; the numerators
    # are exactly 0 because both vertices coincide), dcEdge = median (so
    # CFL diagnostics over all edges stay meaningful), inverse lengths = 0
    # (kills every gradient/mixing term), coordinates = the owner cell's
    # (keeps deriv_two's local-frame normalization finite).
    dummy_cell = np.arange(Ep, dtype=np.int64) % C              # slot-major
    dc_med = float(np.median(m.dcEdge))
    for f, dummy in (("dvEdge", 1.0), ("invDvEdge", 0.0),
                     ("dcEdge", dc_med), ("invDcEdge", 0.0),
                     ("angleEdge", 0.0), ("nEdgesOnEdge", 0)):
        src = getattr(m, f)
        if src is not None:
            setattr(n, f, scatter(src, dummy))
    for f, cf in (("latEdge", "latCell"), ("lonEdge", "lonCell"),
                  ("xEdge", "xCell"), ("yEdge", "yCell"),
                  ("zEdge", "zCell")):
        src = getattr(m, f)
        if src is not None:
            out = scatter(src, 0.0)
            out[~filled] = np.asarray(getattr(m, cf))[dummy_cell[~filled]]
            setattr(n, f, out)
    # flip rotates the edge normal by pi
    ang = n.angleEdge.copy()
    ang[new_of_old[flip_needed]] += np.pi
    n.angleEdge = np.where(ang > np.pi, ang - 2.0 * np.pi, ang)

    # ---- oriented pair tables: swap where flipped, dummies self-pointing ----
    coe = np.where(flip_needed[:, None], m.cellsOnEdge[:, ::-1],
                   m.cellsOnEdge).astype(np.int32)
    voe = np.where(flip_needed[:, None], m.verticesOnEdge[:, ::-1],
                   m.verticesOnEdge).astype(np.int32)
    n.cellsOnEdge = scatter(coe, 0)
    n.cellsOnEdge[~filled] = dummy_cell[~filled, None]          # both = owner
    # owner-side invariant: cellsOnEdge[slot*C + c, 0] == c for REAL edges;
    # dummies satisfy it by construction
    assert (n.cellsOnEdge[:, 0] == dummy_cell).all()
    v_dummy = m.verticesOnCell[dummy_cell, 0]
    n.verticesOnEdge = scatter(voe, 0)
    n.verticesOnEdge[~filled] = v_dummy[~filled, None]

    # ---- edgesOnEdge + weightsOnEdge (flip-consistent sign fix) ----
    eoe_mask = np.asarray(m.edgesOnEdge_mask)
    eoe_old = np.where(eoe_mask > 0, m.edgesOnEdge, 0).astype(np.int64)
    w = (np.asarray(m.weightsOnEdge)
         * flip[:, None] * flip[eoe_old] * eoe_mask)
    eoe_new = np.where(eoe_mask > 0, new_of_old[eoe_old], 0).astype(np.int32)
    # repoint padded slots at the row's own edge (benign, zero-weighted)
    self_id = new_of_old[:, None].astype(np.int32)
    eoe_new = np.where(eoe_mask > 0, eoe_new, self_id)
    n.edgesOnEdge = scatter(eoe_new, 0)
    n.edgesOnEdge[~filled] = np.nonzero(~filled)[0][:, None].astype(np.int32)
    n.weightsOnEdge = scatter(w, 0.0)
    n.edgesOnEdge_mask = scatter(eoe_mask, 0)

    # ---- cell/vertex tables: copy + remap edge ids ----
    for f in ("latCell", "lonCell", "xCell", "yCell", "zCell", "areaCell",
              "invAreaCell", "meshDensity", "nEdgesOnCell", "cellsOnCell",
              "verticesOnCell", "edgesOnCell_mask",
              "latVertex", "lonVertex", "xVertex", "yVertex", "zVertex",
              "areaTriangle", "invAreaTriangle", "kiteAreasOnVertex",
              "cellsOnVertex"):
        src = getattr(m, f)
        if src is not None:
            setattr(n, f, np.ascontiguousarray(np.asarray(src)))
    eoc = np.where(m.edgesOnCell_mask > 0, m.edgesOnCell, 0).astype(np.int64)
    eoc_new = new_of_old[eoc].astype(np.int32)
    first = eoc_new[:, :1]
    n.edgesOnCell = np.where(m.edgesOnCell_mask > 0, eoc_new, first)
    n.edgesOnVertex = new_of_old[
        m.edgesOnVertex.astype(np.int64)].astype(np.int32)

    # orientation-dependent derived tables rebuilt from the new topology
    _compute_signs(n)

    perms = dict(new_of_old=new_of_old, flip=flip, owner=owner)
    return n, perms
