"""Locality renumbering of the mesh for windowed gather kernels.

The dycore's horizontal indirection is all static (mesh topology), so its
cost on TPU is set by how the entity NUMBERING maps neighborhoods to memory:
a lane gather's operands, and any windowed (block-local) kernel, want every
index used by a block of consecutive outputs to fall in a narrow window of
the source array.  That is exactly graph-bandwidth minimization, so we
renumber cells with reverse Cuthill-McKee on the cell adjacency graph and
derive edge/vertex orders from the cell order (each edge/vertex is placed at
the position of its lowest-ranked adjacent cell).

The result is a pure relabeling: slot order inside every adjacency row is
preserved, so all per-output reductions sum in the same order and the model
trajectory on the renumbered mesh is the original trajectory with permuted
columns (tests/test_renumber.py asserts this bitwise).

The reference gets its locality implicitly from METIS partitions
(mesh_loading.rg:399-483 colors cells so Legion tasks touch compact
regions); this is the single-address-space analog, computed once at load.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .loader import Mesh


def _cell_rcm_order(m: Mesh) -> np.ndarray:
    """RCM ordering of the cell graph: returns old ids in new order."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    C, M = m.nCells, m.maxEdges
    rows = np.repeat(np.arange(C, dtype=np.int64), M)
    cols = m.cellsOnCell.astype(np.int64).ravel()
    mask = m.edgesOnCell_mask.ravel() > 0
    rows, cols = rows[mask], cols[mask]
    g = csr_matrix((np.ones(rows.size, np.int8), (rows, cols)), shape=(C, C))
    g = g + g.T
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True),
                      dtype=np.int64)


def _entity_order_from_cells(cell_rank: np.ndarray, ent_cells: np.ndarray,
                             valid: np.ndarray | None = None) -> np.ndarray:
    """Order entities by the rank of their lowest-ranked adjacent cell
    (stable, so entities of one cell stay consecutive in slot order)."""
    ranks = cell_rank[ent_cells.astype(np.int64)]
    if valid is not None:
        ranks = np.where(valid, ranks, np.iinfo(np.int64).max)
    key = ranks.min(axis=1)
    return np.argsort(key, kind="stable")


def renumber_mesh(m: Mesh) -> tuple[Mesh, dict]:
    """Relabel cells/edges/vertices for gather locality.

    Returns (new mesh, perms) where perms holds, per entity, `order`
    (old ids in new order; new_field = old_field[order]) and `rank`
    (rank[old_id] = new_id; use to remap index values and to carry state
    between the orderings: f_new[:, new] = f_old[:, old]).
    """
    cell_order = _cell_rcm_order(m)
    cell_rank = np.empty(m.nCells, np.int64)
    cell_rank[cell_order] = np.arange(m.nCells)

    edge_order = _entity_order_from_cells(cell_rank, m.cellsOnEdge)
    edge_rank = np.empty(m.nEdges, np.int64)
    edge_rank[edge_order] = np.arange(m.nEdges)

    vert_order = _entity_order_from_cells(cell_rank, m.cellsOnVertex)
    vert_rank = np.empty(m.nVertices, np.int64)
    vert_rank[vert_order] = np.arange(m.nVertices)

    def remap(f, order, rank_of_values=None):
        out = np.asarray(f)[order]
        if rank_of_values is not None:
            out = rank_of_values[out.astype(np.int64)].astype(np.int32)
        return np.ascontiguousarray(out)

    n = Mesh(nCells=m.nCells, nEdges=m.nEdges, nVertices=m.nVertices,
             maxEdges=m.maxEdges, maxEdges2=m.maxEdges2,
             vertexDegree=m.vertexDegree, sphere_radius=m.sphere_radius,
             on_a_sphere=m.on_a_sphere)

    per_cell = ["latCell", "lonCell", "xCell", "yCell", "zCell", "areaCell",
                "invAreaCell", "meshDensity", "nEdgesOnCell"]
    per_edge = ["latEdge", "lonEdge", "xEdge", "yEdge", "zEdge", "dvEdge",
                "dcEdge", "invDvEdge", "invDcEdge", "angleEdge",
                "nEdgesOnEdge", "weightsOnEdge", "edgesOnEdge_mask"]
    per_vert = ["latVertex", "lonVertex", "xVertex", "yVertex", "zVertex",
                "areaTriangle", "invAreaTriangle", "kiteAreasOnVertex"]
    for f in per_cell:
        setattr(n, f, remap(getattr(m, f), cell_order))
    for f in per_edge:
        setattr(n, f, remap(getattr(m, f), edge_order))
    for f in per_vert:
        setattr(n, f, remap(getattr(m, f), vert_order))
    # per-cell slot fields that carry no indices
    n.edgesOnCell_mask = remap(m.edgesOnCell_mask, cell_order)
    n.edgesOnCellSign = remap(m.edgesOnCellSign, cell_order)
    n.kiteForCell = remap(m.kiteForCell, cell_order)        # slot indices
    n.edgesOnVertexSign = remap(m.edgesOnVertexSign, vert_order)

    # adjacency: permute rows, then relabel values.  Padded slots (masked,
    # zero-weighted) are repointed at the row's first VALID entry instead of
    # the loader's global index 0 — a relabeled 0 lands at an arbitrary rank
    # and would wreck the per-block index spans the windowed kernels key on.
    def local_pad(idx, mask):
        idx = np.asarray(idx)
        first = idx[:, :1]                     # slot 0 is always valid
        return np.where(np.asarray(mask) > 0, idx, first)

    coc = local_pad(m.cellsOnCell, m.edgesOnCell_mask)
    eoc = local_pad(m.edgesOnCell, m.edgesOnCell_mask)
    voc = local_pad(m.verticesOnCell, m.edgesOnCell_mask)
    eoe = local_pad(m.edgesOnEdge, m.edgesOnEdge_mask)
    n.cellsOnCell = remap(coc, cell_order, cell_rank)
    n.edgesOnCell = remap(eoc, cell_order, edge_rank)
    n.verticesOnCell = remap(voc, cell_order, vert_rank)
    n.cellsOnEdge = remap(m.cellsOnEdge, edge_order, cell_rank)
    n.verticesOnEdge = remap(m.verticesOnEdge, edge_order, vert_rank)
    n.edgesOnEdge = remap(eoe, edge_order, edge_rank)
    n.cellsOnVertex = remap(m.cellsOnVertex, vert_order, cell_rank)
    n.edgesOnVertex = remap(m.edgesOnVertex, vert_order, edge_rank)

    perms = dict(cell_order=cell_order, cell_rank=cell_rank,
                 edge_order=edge_order, edge_rank=edge_rank,
                 vert_order=vert_order, vert_rank=vert_rank)
    return n, perms


def block_spans(idx: np.ndarray, block: int = 128) -> np.ndarray:
    """Per-block index span (max-min+1) of an [R, M] index array over blocks
    of `block` consecutive rows — the window width a windowed gather kernel
    needs.  Diagnostic for ordering quality."""
    idx = np.asarray(idx, np.int64)
    R = idx.shape[0]
    nb = (R + block - 1) // block
    pad = nb * block - R
    if pad:
        idx = np.concatenate([idx, idx[-1:].repeat(pad, 0)], axis=0)
    b = idx.reshape(nb, -1)
    return b.max(axis=1) - b.min(axis=1) + 1
