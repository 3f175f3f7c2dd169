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

Layout: every per-column field is level-major [K, N] (core/state.py), so a
horizontal gather is a dim-1 `index_select` and fields that share an index
vector stack along dim 0 and gather together.

Every form takes the mesh's own tables (the default edge numbering: the
benchmark's configurations leave `config_orient_edges` off).
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


def avg_cell_to_edge(f_c, cellsOnEdge):
    c1, c2 = edge_pair(f_c, cellsOnEdge)
    return 0.5 * (c1 + c2)


def slot_reduce(idx, specs):
    """Weighted neighborhood reduction over the M stencil slots:
        out[i][j][:, r] = sum_m specs[i].weights[j][r, m] * field_i[:, idx[r, m]]

    `idx` [R, M]; specs = list of (field [K_i, N], [w_0 [R, M], w_1, ...]).
    Returns a list (per field) of lists (per weight set) of [K_i, R] arrays.

    Fields whose weight lists hold the same weight tensors (in any order)
    stack along dim 0 into one table and share one `gather_reduce` call,
    which applies every weight set of the list to every row of the table;
    fields with other weight lists go to separate calls."""
    groups: dict = {}
    for i, (_, wl) in enumerate(specs):
        groups.setdefault(tuple(sorted(id(w) for w in wl)), []).append(i)
    accs = [None] * len(specs)
    for members in groups.values():
        wl = specs[members[0]][1]
        tbl = _stack([specs[i][0] for i in members]).contiguous()
        w = torch.stack(list(wl))                                # [S, R, M]
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


def slot_gather(idx, field):
    """Per-slot gathers: list of M arrays [K, R] with slot m holding
    field[:, idx[:, m]]."""
    return [torch.index_select(field, 1, idx[:, m]) for m in range(idx.shape[1])]


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
