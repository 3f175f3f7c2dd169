"""Gather-based stencil primitives for the unstructured C-grid.

The port of `mpas_tpu.ops.stencils`. All
horizontal indirection in the dycore reduces to a handful of patterns,
expressed scatter-free (every output column pulls its inputs):

  - cell -> edge gathers via cellsOnEdge (`torch.index_select` along dim 1)
  - edge -> cell weighted sums via edgesOnCell, edge -> vertex sums via
    edgesOnVertex, the edgesOnEdge and advCellsForEdge reductions: all of
    them go through `slot_reduce`, which launches the gather-reduce kernel
    (ops/gather_reduce.py) on the card
  - vertical interface/mass interpolation and 3rd/4th-order vertical fluxes
  - the cell-form operators (`config_cell_form_ops`): per-cell directional
    Hessians and tangential matrices, read back per edge by one wide gather
    from the [K, M*C] concatenation of the M slot arrays

Layout: every per-column field is level-major [K, N] (core/state.py), so a
horizontal gather is a dim-1 `index_select` and fields that share an index
vector stack along dim 0 and gather together.

The `_m` forms take the MeshArrays. On the default edge numbering
(`owner_aligned` False) they call the plain forms. On the ownership-aligned
numbering (`config_orient_edges`, mesh/orient.py: edge s*C + c is the s-th
edge owned by cell c) the owner side of an edge pair is `owner_tile`, no
gather, and an edgesOnCell reduction reads each cell's 3 owned edges as
contiguous planes and gathers only the non-owned slots, in one gather-reduce
launch on the row-permuted table of `MeshArrays.eoc_split`.
"""

from __future__ import annotations

import torch

from .gather_reduce import gather_reduce


# ---------------------------------------------------------------------------
# horizontal gathers
# ---------------------------------------------------------------------------

def gather(f, idx):
    """Column gather: f [K, N] indexed by idx [R] -> [K, R]. The one place
    `take_packed` and the `edge_pair*` forms gather through."""
    return torch.index_select(f, 1, idx)


def _stack(fields):
    return fields[0] if len(fields) == 1 else torch.cat(fields, dim=0)


def take_packed(idx, *fields):
    """One gather serving several fields that share the index vector:
    fields [K_i, N] stack along dim 0 into one [sum K_i, N] table.
    Returns a list of gathered arrays, each [K_i, R]."""
    g = gather(_stack(fields), idx)
    outs, off = [], 0
    for f in fields:
        outs.append(g[off:off + f.shape[0]])
        off += f.shape[0]
    return outs


def edge_pairs(cellsOnEdge, *fields):
    """Packed edge pairs: one stacked gather per edge side.
    Returns [(f(cell1), f(cell2)), ...] per field, each side [K_i, E]."""
    g1 = take_packed(cellsOnEdge[:, 0], *fields)
    g2 = take_packed(cellsOnEdge[:, 1], *fields)
    return list(zip(g1, g2))


def edge_pair(f_c, cellsOnEdge):
    """Cell field [K, C] -> (f(cell1), f(cell2)) each [K, E]."""
    return gather(f_c, cellsOnEdge[:, 0]), gather(f_c, cellsOnEdge[:, 1])


def owner_tile(f_c, n_slots: int = 3):
    """Owner-side edge values of a cell field on an ownership-aligned mesh
    (cellsOnEdge[e, 0] == e % C): f [K, C] -> [K, n_slots*C], three copies
    side by side instead of a gather."""
    return f_c.repeat(1, n_slots)


def _aligned(mesh) -> bool:
    return bool(getattr(mesh, "owner_aligned", False))


def edge_pairs_m(mesh, *fields):
    """edge_pairs keyed off the MeshArrays: on an ownership-aligned mesh
    the cell1 side is owner_tile (no gather); only cell2 gathers."""
    if _aligned(mesh):
        g1 = [owner_tile(f) for f in fields]
        g2 = take_packed(mesh.cellsOnEdge[:, 1], *fields)
        return list(zip(g1, g2))
    return edge_pairs(mesh.cellsOnEdge, *fields)


def edge_pair_m(mesh, f_c):
    if _aligned(mesh):
        return owner_tile(f_c), gather(f_c, mesh.cellsOnEdge[:, 1])
    return edge_pair(f_c, mesh.cellsOnEdge)


def avg_cell_to_edge(f_c, cellsOnEdge):
    c1, c2 = edge_pair(f_c, cellsOnEdge)
    return 0.5 * (c1 + c2)


def avg_cell_to_edge_m(mesh, f_c):
    c1, c2 = edge_pair_m(mesh, f_c)
    return 0.5 * (c1 + c2)


def diff_cell_to_edge(f_c, cellsOnEdge):
    """f(cell2) - f(cell1): the gradient numerator along the edge normal."""
    c1, c2 = edge_pair(f_c, cellsOnEdge)
    return c2 - c1


def diff_cell_to_edge_m(mesh, f_c):
    c1, c2 = edge_pair_m(mesh, f_c)
    return c2 - c1


def slot_reduce(idx, specs, split_weights=None):
    """Weighted neighborhood reduction over the M stencil slots:
        out[i][j][:, r] = sum_m specs[i].weights[j][r, m] * field_i[:, idx[r, m]]

    `idx` [R, M]; specs = list of (field [K_i, N], [w_0 [R, M], w_1, ...]).
    Returns a list (per field) of lists (per weight set) of [K_i, R] arrays.

    Fields whose weight lists hold the same weight tensors (in any order)
    stack along dim 0 into one table and share one `gather_reduce` call,
    which applies every weight set of the list to every row of the table;
    fields with other weight lists go to separate calls. `split_weights`,
    where given, maps the stacked [S, R, M] weights of the specs to the
    columns of `idx` (slot_reduce_m on an aligned mesh)."""
    groups: dict = {}
    for i, (_, wl) in enumerate(specs):
        groups.setdefault(tuple(sorted(id(w) for w in wl)), []).append(i)
    accs = [None] * len(specs)
    for members in groups.values():
        wl = specs[members[0]][1]
        tbl = _stack([specs[i][0] for i in members]).contiguous()
        w = torch.stack(list(wl))                                # [S, R, M]
        if split_weights is not None:
            w = split_weights(w)
        out = gather_reduce(tbl, idx, w)                         # [S, Kt, R]
        off = 0
        for i in members:
            f, wl_i = specs[i]
            h = f.shape[0]
            pos = [next(j for j, x in enumerate(wl) if x is w_i)
                   for w_i in wl_i]
            accs[i] = [out[s, off:off + h] for s in pos]
            off += h
    return accs


def slot_reduce_m(mesh, idx, specs):
    """slot_reduce keyed off the MeshArrays. When `idx` is the mesh's own
    edgesOnCell tensor (`idx is mesh.edgesOnCell`) on an ownership-aligned
    mesh, the reduction runs on the split table [C, 3 + Mn] instead: the 3
    owned planes are contiguous reads, only the non-owned slots gather, and
    the weights are permuted to the split's columns and zeroed where a
    column is absent. Any other table goes to the plain slot_reduce."""
    if not (_aligned(mesh) and idx is mesh.edgesOnCell):
        return slot_reduce(idx, specs)
    split = mesh.eoc_split
    return slot_reduce(split.idx, specs, split.weights)


def sum_edges_to_cell_m(mesh, f_e, weights):
    ((out,),) = slot_reduce_m(mesh, mesh.edgesOnCell, [(f_e, [weights])])
    return out


def slot_gather(idx, field):
    """Per-slot gathers: list of M arrays [K, R] with slot m holding
    field[:, idx[:, m]]."""
    return [torch.index_select(field, 1, idx[:, m]) for m in range(idx.shape[1])]


def dir_second_deriv(dirHess, cellsOnCell, *fields):
    """Directional second derivatives (cell-form advection operator,
    mesh/coefficients.compute_dir_hessian): per field, a list of M arrays
    [K, C], D_m = dirHess[m, 0]*q + sum_i dirHess[m, 1+i]*q[nbr_i].
    dirHess is slot-major [M, 1+M, C]; the neighbourhood gathers stack all
    fields (one gather per neighbour slot)."""
    M = cellsOnCell.shape[1]
    tbl = _stack(fields)
    gs = [gather(tbl, cellsOnCell[:, i]) for i in range(M)]
    outs, off = [], 0
    for f in fields:
        sl = slice(off, off + f.shape[0])
        off += f.shape[0]
        D = []
        for m in range(M):
            acc = dirHess[m, 0][None, :] * f
            for i in range(M):
                acc = acc + dirHess[m, 1 + i][None, :] * gs[i][sl]
            D.append(acc)
        outs.append(D)
    return outs


def edge_slot_pair(slots, cellsOnEdge, slotOnCell):
    """Read per-(cell, edge-slot) values at both sides of every edge:
    `slots` is a list of M [K, C] arrays; returns (tbl[c1, slot1],
    tbl[c2, slot2]) each [K, E]."""
    ((s1, s2),) = edge_slot_pairs(cellsOnEdge, slotOnCell, slots)
    return s1, s2


def edge_slot_pairs(cellsOnEdge, slotOnCell, *slot_lists):
    """Stacked edge_slot_pair over several per-field slot-table lists that
    share the (cell, slot) index: each slot m stacks all fields along the
    level axis, the M slot arrays lie side by side in one [sum K_i, M*C]
    table, and two wide gathers at the flat index slot*C + cell serve every
    field. Returns [(f_side1 [K_i, E], f_side2), ...]."""
    C = slot_lists[0][0].shape[1]
    M = len(slot_lists[0])
    stacked = [_stack([sl[m] for sl in slot_lists]) for m in range(M)]
    flat = torch.cat(stacked, dim=1)                      # [sum K_i, M*C]
    i1 = slotOnCell[:, 0] * C + cellsOnEdge[:, 0]
    i2 = slotOnCell[:, 1] * C + cellsOnEdge[:, 1]
    g1 = gather(flat, i1)
    g2 = gather(flat, i2)
    outs, off = [], 0
    for sl in slot_lists:
        h = sl[0].shape[0]
        outs.append((g1[off:off + h], g2[off:off + h]))
        off += h
    return outs


def cell_tangential(tanWeights, g_slots):
    """Per-cell tangential (Thuburn) matrices: g_slots = slot_gather(
    edgesOnCell, u); tanWeights [M, M, C]; returns list of M arrays [K, C]:
    t_i = sum_j tanW[i, j] * g_j."""
    M = len(g_slots)
    return [sum(tanWeights[i, j][None, :] * g_slots[j] for j in range(M))
            for i in range(M)]


def sum_edges_to_cell(f_e, edgesOnCell, weights):
    """sum_m weights[c, m] * f_e[:, edgesOnCell[c, m]] -> [K, C].
    `weights` [C, M] already folds in sign/mask/length factors."""
    ((out,),) = slot_reduce(edgesOnCell, [(f_e, [weights])])
    return out


def zb_metric(flux_e, edgesOnCell, sign, zb_cell, zb3_cell):
    """Sloping-coordinate metric transport (the zb/zb3 omega correction):
        sum_m sign[c,m] * (zb[m,:,c] + sgn(F) * zb3[m,:,c]) * F[:, eoc[c,m]]
    zb_cell/zb3_cell are slot-major [M, K+1, C]. Plain torch: the weight
    depends on the sign of the gathered value, so this is no slot_reduce."""
    acc = None
    for m in range(edgesOnCell.shape[1]):
        g = torch.index_select(flux_e, 1, edgesOnCell[:, m])       # [K+1, C]
        zb = zb_cell[m] + torch.sign(g) * zb3_cell[m]
        t = sign[:, m][None, :] * zb * g
        acc = t if acc is None else acc + t
    return acc


def zb_metric_m(mesh, flux_e, sign, zb_cell, zb3_cell):
    """zb_metric keyed off the MeshArrays. On an ownership-aligned mesh the
    3 owned slots are the planes flux_e[:, s*C:(s+1)*C] and only the
    non-owned slots gather; zb/zb3/sign are re-indexed to the split's
    columns once (EocSplit.zb_planes)."""
    if not _aligned(mesh):
        return zb_metric(flux_e, mesh.edgesOnCell, sign, zb_cell, zb3_cell)
    split = mesh.eoc_split
    C = mesh.nCells
    zb_s, zb3_s, sign_s = split.zb_planes(zb_cell, zb3_cell, sign)
    acc = None
    for j in range(split.width):
        g = (flux_e[:, j * C:(j + 1) * C] if j < 3
             else torch.index_select(flux_e, 1, split.idx[:, j]))
        t = sign_s[:, j][None, :] * (zb_s[j] + torch.sign(g) * zb3_s[j]) * g
        acc = t if acc is None else acc + t
    return acc


def sum_edges_to_vertex(f_e, edgesOnVertex, weights):
    ((out,),) = slot_reduce(edgesOnVertex, [(f_e, [weights])])
    return out


def sum_vertices_to_edge(f_v, verticesOnEdge):
    return 0.5 * (torch.index_select(f_v, 1, verticesOnEdge[:, 0])
                  + torch.index_select(f_v, 1, verticesOnEdge[:, 1]))


def edges_on_edge_sum(f_e, edgesOnEdge, weightsOnEdge, mask):
    """Tangential reconstruction: sum_j w[e,j] * f_e[:, edgesOnEdge[e,j]]
    (Thuburn 2009 weights)."""
    ((out,),) = slot_reduce(edgesOnEdge, [(f_e, [weightsOnEdge * mask])])
    return out


def adv_flux_on_edge(q_c, flow_sign, adv_cells, adv_coefs, adv_coefs_3rd):
    """Horizontal 3rd/4th-order advective edge value:
    F[k, e] = sum_j (adv_coefs[e,j] + sign(flow[k,e]) * adv_coefs_3rd[e,j]) * q[k, advCells[e,j]]
    `flow_sign` [K, E] is sign(ru) (+-1).  Padding slots carry zero coefs."""
    ((base, third),) = slot_reduce(adv_cells,
                                   [(q_c, [adv_coefs, adv_coefs_3rd])])
    return base + flow_sign * third


def adv_flux_on_edge_cellform(q, flow_sign, mesh, coef3):
    """Cell-form equivalent of adv_flux_on_edge: the same 3rd/4th-order edge
    value via per-cell directional Hessians + slot gathers (an exact
    algebraic identity; see mesh/coefficients.compute_dir_hessian)."""
    (Dc,) = dir_second_deriv(mesh.dirHess, mesh.cellsOnCell, q)
    D1, D2 = edge_slot_pair(Dc, mesh.cellsOnEdge, mesh.slotOnCell)
    q1, q2 = edge_pair(q, mesh.cellsOnEdge)
    scale = (mesh.dvEdge * mesh.dcEdge ** 2 / 12.0)[None, :]
    return (0.5 * mesh.dvEdge[None, :] * (q1 + q2)
            - scale * ((D1 + D2) + flow_sign * coef3 * (D1 - D2)))


# ---------------------------------------------------------------------------
# vertical operators: the level axis is the last but one, so [K, N] fields
# and species-major stacks [nS, K, N] go through the same code and no
# species reaches into its neighbour's levels
# ---------------------------------------------------------------------------

def interface_interp(f, fzm, fzp):
    """Mass-level field [..., K, N] -> interface values [..., K+1, N];
    interior k: fzm[k]*f[k] + fzp[k]*f[k-1]; rows 0 and K are zero."""
    K = f.shape[-2]
    interior = (fzm[1:K, None] * f[..., 1:, :]
                + fzp[1:K, None] * f[..., :-1, :])
    zero = torch.zeros_like(f[..., :1, :])
    return torch.cat([zero, interior, zero], dim=-2)


def delta(g):
    """Difference along the level axis: g[1:] - g[:-1]."""
    return g[..., 1:, :] - g[..., :-1, :]


def flux4(q_im2, q_im1, q_i, q_ip1, ua):
    """4th-order flux."""
    return ua * (7.0 * (q_i + q_im1) - (q_ip1 + q_im2)) / 12.0


def flux3(q_im2, q_im1, q_i, q_ip1, ua, coef3):
    """3rd-order upwind-biased flux."""
    return (flux4(q_im2, q_im1, q_i, q_ip1, ua)
            + coef3 * torch.abs(ua) * ((q_ip1 - q_im2) - 3.0 * (q_i - q_im1)) / 12.0)


def vflux_mass_to_iface(q, m_iface, fzm, fzp, coef3):
    """Vertical flux of a mass-level quantity q [..., K, N] through
    interfaces, advected by m_iface [K+1, N]: returns [..., K+1, N].
    0 at interfaces 0 and K; 2nd-order fzm/fzp interpolation at interfaces
    1 and K-1; flux3 at 2..K-2."""
    K = q.shape[-2]
    out = m_iface * interface_interp(q, fzm, fzp)
    if K >= 4:
        ua = m_iface[2:K - 1]
        out[..., 2:K - 1, :] = flux3(
            q[..., 0:K - 3, :], q[..., 1:K - 2, :], q[..., 2:K - 1, :],
            q[..., 3:K, :], ua, coef3)
    return out


def vflux_iface_to_mass(w, rw, coef3):
    """Vertical flux of the interface quantity w [K+1, N] at mass levels,
    advected by rw [K+1, N]: returns [K, N] (the wdwz array).
    Mass level j uses advector 0.5*(rw[j] + rw[j+1]); 2nd-order average of w
    at j=0 and j=K-1, flux3 on the 4-point interface stencil in between;
    the top mass-level flux is zero."""
    K = w.shape[0] - 1
    ua = 0.5 * (rw[:-1] + rw[1:])
    out = ua * 0.5 * (w[:-1] + w[1:])
    if K >= 4:
        out[1:K - 2] = flux3(w[0:K - 3], w[1:K - 2], w[2:K - 1], w[3:K],
                             ua[1:K - 2], coef3)
    out[K - 1] = 0.0
    return out
