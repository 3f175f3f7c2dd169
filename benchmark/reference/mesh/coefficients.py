"""Static mesh coefficient builders (host-side, float64, vectorized numpy).

These are the init-time "coefficient builder" tasks of the reference solver
(SURVEY.md section 2.3) rebuilt with correct MPAS semantics:

- deriv_two / advection coefficients: the reference consumes `deriv_two`
  (dynamics_tasks.rg:133-269) but never computes it (it is uninitialized in
  mesh_loading.rg); here it is built by the quadratic least-squares fit of
  MPAS's initialize_advection (mpas_advection.F semantics).
- adv_coefs / adv_coefs_3rd / advCellsForEdge: atm_adv_coef_compression
  (dynamics_tasks.rg:133-269), vectorized over edges.
- coeffs_reconstruct: the RBF reconstruction matrix of the reference
  (mpas_reconstruct_2d, dynamics_tasks.rg:1894-1948) is replaced by a
  tangent-plane least-squares reconstruction (exact for uniform fields,
  well-conditioned on pentagons); deviation from MPAS's RBF is documented.
- defc_a / defc_b: Smagorinsky deformation weights (consumed at
  dynamics_tasks.rg:873-876, never initialized in the reference), derived
  from the divergence-theorem estimate of the velocity-gradient tensor.
- meshScalingDel2/Del4: atm_compute_mesh_scaling (dynamics_tasks.rg:595-646).
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from .loader import Mesh

FIFTEEN = 15  # MPAS advection stencil padding (constants.rg:24)


# ---------------------------------------------------------------------------
# local tangent-plane geometry helpers
# ---------------------------------------------------------------------------

def _unit_xyz(x, y, z):
    p = np.stack([x, y, z], axis=-1)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def _east_north(rhat):
    """Local east/north unit vectors at points rhat [., 3] on the sphere."""
    zaxis = np.array([0.0, 0.0, 1.0])
    east = np.cross(zaxis, rhat)
    norm = np.linalg.norm(east, axis=-1, keepdims=True)
    # at the poles pick an arbitrary east
    east = np.where(norm > 1e-12, east / np.maximum(norm, 1e-300),
                    np.array([1.0, 0.0, 0.0]))
    north = np.cross(rhat, east)
    return east, north


def _azimuthal_coords(rhat_center, rhat_points, radius):
    """Azimuthal-equidistant coordinates of `rhat_points` [..., m, 3] in the
    tangent plane of `rhat_center` [..., 3]: distance = great-circle arc
    length, direction = tangent-plane projection."""
    east, north = _east_north(rhat_center)
    cosang = np.clip(np.einsum("...j,...mj->...m", rhat_center, rhat_points), -1.0, 1.0)
    arc = radius * np.arccos(cosang)
    t = rhat_points - cosang[..., None] * rhat_center[..., None, :]
    tn = np.linalg.norm(t, axis=-1, keepdims=True)
    that = t / np.maximum(tn, 1e-300)
    xp = arc * np.einsum("...mj,...j->...m", that, east)
    yp = arc * np.einsum("...mj,...j->...m", that, north)
    return xp, yp


# ---------------------------------------------------------------------------
# deriv_two: second-derivative fit coefficients
# ---------------------------------------------------------------------------

def compute_deriv_two(mesh: Mesh) -> np.ndarray:
    """deriv_two[E, 2, 1 + maxEdges].

    deriv_two[e, ind, 0] is the coefficient of cell_ind's own value,
    deriv_two[e, ind, 1 + i] that of cellsOnCell[cell_ind, i], in the
    estimate of d2 q / d s2 along the cell1->cell2 direction at cell_ind
    (ind in {0, 1}).  Built from a least-squares quadratic fit
    q ~ a0 + a1 x + a2 y + a3 x^2 + a4 x y + a5 y^2 over cell + neighbors
    in the local azimuthal-equidistant tangent plane.
    """
    C, M = mesh.nCells, mesh.maxEdges
    a = mesh.sphere_radius
    rc = _unit_xyz(mesh.xCell, mesh.yCell, mesh.zCell)        # [C, 3]

    nbr = mesh.cellsOnCell                                    # [C, M]
    nbr_mask = mesh.edgesOnCell_mask                          # [C, M]
    rn = rc[nbr]                                              # [C, M, 3]
    xp, yp = _azimuthal_coords(rc, rn, a)                     # [C, M]

    # Nondimensionalize per cell by the mean neighbor distance: in raw meters
    # the quadratic design matrix has condition ~ (5e5)^4 and the normal
    # equations lose all float64 precision.
    nn = np.maximum(nbr_mask.sum(axis=1), 1.0)
    L = (np.sqrt(xp ** 2 + yp ** 2) * nbr_mask).sum(axis=1) / nn      # [C]
    L = np.maximum(L, 1.0)
    xs = xp / L[:, None]
    ys = yp / L[:, None]

    # design matrix rows: center (0,0) then neighbors; invalid rows zeroed
    m_pts = 1 + M
    A = np.zeros((C, m_pts, 6))
    A[:, 0, 0] = 1.0
    A[:, 1:, 0] = nbr_mask
    A[:, 1:, 1] = xs * nbr_mask
    A[:, 1:, 2] = ys * nbr_mask
    A[:, 1:, 3] = xs ** 2 * nbr_mask
    A[:, 1:, 4] = xs * ys * nbr_mask
    A[:, 1:, 5] = ys ** 2 * nbr_mask

    AtA = np.einsum("cmi,cmj->cij", A, A)
    # tiny Tikhonov floor keeps exactly-determined pentagon fits well-posed
    AtA = AtA + 1e-10 * np.eye(6)
    Binv = np.linalg.solve(AtA, np.transpose(A, (0, 2, 1)))   # [C, 6, m_pts]
    # rescale second-derivative rows back to physical 1/m^2 units
    Binv[:, 3:6, :] /= (L ** 2)[:, None, None]

    # direction of the derivative: azimuth (at each cell) of the opposite cell
    E = mesh.nEdges
    deriv_two = np.zeros((E, 2, m_pts))
    coe = mesh.cellsOnEdge                                    # [E, 2]
    for ind in range(2):
        cell = coe[:, ind]
        other = coe[:, 1 - ind]
        xq, yq = _azimuthal_coords(rc[cell], rc[other][:, None, :], a)
        theta = np.arctan2(yq[:, 0], xq[:, 0])                # [E]
        ct, st = np.cos(theta), np.sin(theta)
        w4, w5, w6 = 2 * ct**2, 2 * ct * st, 2 * st**2
        Bc = Binv[cell]                                       # [E, 6, m_pts]
        deriv_two[:, ind, :] = (w4[:, None] * Bc[:, 3] +
                                w5[:, None] * Bc[:, 4] +
                                w6[:, None] * Bc[:, 5])
    return deriv_two


# ---------------------------------------------------------------------------
# advection stencil compression (atm_adv_coef_compression)
# ---------------------------------------------------------------------------

@dataclass
class AdvectionCoefs:
    nAdvCellsForEdge: np.ndarray    # [E] int32
    advCellsForEdge: np.ndarray     # [E, FIFTEEN] int32 (0-padded)
    advMaskForEdge: np.ndarray      # [E, FIFTEEN] float {0,1}
    adv_coefs: np.ndarray           # [E, FIFTEEN]
    adv_coefs_3rd: np.ndarray       # [E, FIFTEEN] (already * coef_3rd_order)


def compute_advection_coefficients(mesh: Mesh, deriv_two: np.ndarray,
                                   coef_3rd_order: float = 0.25) -> AdvectionCoefs:
    """3rd/4th-order flux stencil per edge (dynamics_tasks.rg:133-269 +
    atm_couple_coef_3rd_order at :303-325, vectorized).

    For each edge: ordered stencil {cell1, cell2, nbrs(cell1)\\{cell2},
    new nbrs(cell2)}; coefficients combine the two cells' second-derivative
    fits (-dcEdge^2/12 each), the centered 2nd-order weights (0.5/0.5), and
    the dvEdge factor so flux = sum_j adv_coefs[j] * q[advCells[j]] * ru.
    """
    E, M = mesh.nEdges, mesh.maxEdges
    coe = mesh.cellsOnEdge
    cell1, cell2 = coe[:, 0], coe[:, 1]

    # candidate list: [cell1, cell2, nbrs(cell1), nbrs(cell2)]  [E, 2+2M]
    n1 = mesh.cellsOnCell[cell1]          # [E, M]
    n1m = mesh.edgesOnCell_mask[cell1] > 0
    n2 = mesh.cellsOnCell[cell2]
    n2m = mesh.edgesOnCell_mask[cell2] > 0
    W = 2 + 2 * M
    cand = np.concatenate([cell1[:, None], cell2[:, None], n1, n2], axis=1)
    valid = np.concatenate([np.ones((E, 2), bool), n1m, n2m], axis=1)
    # nbrs(cell1) equal to cell2 are excluded from the list (they alias slot 1)
    valid[:, 2:2 + M] &= (n1 != cell2[:, None])

    # first-occurrence dedup among valid entries
    eq = cand[:, :, None] == cand[:, None, :]                 # [E, W, W]
    prior = np.tril(np.ones((W, W), bool), -1)
    dup = (eq & prior[None] & valid[:, None, :] & valid[:, :, None]).any(axis=2)
    keep = valid & ~dup                                       # [E, W]

    n_adv = keep.sum(axis=1)
    S = FIFTEEN
    assert n_adv.max() <= S, f"advection stencil overflow: {n_adv.max()} > {S}"
    # compress kept candidates into the first n_adv slots, preserving order
    order = np.argsort(~keep, axis=1, kind="stable")          # kept first
    adv_cells = np.take_along_axis(cand, order, axis=1)[:, :S]
    if adv_cells.shape[1] < S:                                # hex meshes: W < 15
        adv_cells = np.pad(adv_cells, ((0, 0), (0, S - adv_cells.shape[1])))
    slot_mask = np.arange(S)[None, :] < n_adv[:, None]
    # padded slots repoint at the edge's own cell1 (zero-weighted): a global
    # index-0 pad would destroy the per-block index locality the windowed
    # kernels and the gather engine's spatial locality rely on
    adv_cells = np.where(slot_mask, adv_cells, cell1[:, None]).astype(np.int32)

    # accumulate deriv_two contributions into matching stencil slots
    coefs = np.zeros((E, S))
    coefs3 = np.zeros((E, S))

    def accumulate(target_cells, values, tmask, sign3):
        # target_cells [E], values [E], tmask [E] -> add into matching slot.
        # Stencil slots are unique per edge, so each row has at most one hit.
        # The 4th-order weights take D1 + D2; the 3rd-order upwind weights
        # take D1 - D2 (cell2 contributions enter with sign3 = -1), which is
        # the d3q/ds3 upwind term of Skamarock & Gassmann 2011.  (The
        # reference adds both, an anti-diffusive defect.)
        hit = (adv_cells == target_cells[:, None]) & slot_mask
        rows, cols = np.nonzero(hit)
        coefs[rows, cols] += (values * tmask)[rows]
        coefs3[rows, cols] += sign3 * (values * tmask)[rows]

    ones = np.ones(E)
    accumulate(cell1, deriv_two[:, 0, 0], ones, +1.0)
    accumulate(cell2, deriv_two[:, 1, 0], ones, -1.0)
    for i in range(M):
        accumulate(n1[:, i], deriv_two[:, 0, 1 + i], n1m[:, i].astype(float), +1.0)
        accumulate(n2[:, i], deriv_two[:, 1, 1 + i], n2m[:, i].astype(float), -1.0)

    scale = -(mesh.dcEdge ** 2) / 12.0
    coefs *= scale[:, None]
    coefs3 *= scale[:, None]

    # centered 2nd-order part into cell1/cell2 slots (they are slots 0 and 1)
    coefs[:, 0] += 0.5
    coefs[:, 1] += 0.5

    coefs *= mesh.dvEdge[:, None]
    coefs3 *= mesh.dvEdge[:, None] * coef_3rd_order

    return AdvectionCoefs(
        nAdvCellsForEdge=n_adv.astype(np.int32),
        advCellsForEdge=adv_cells,
        advMaskForEdge=slot_mask.astype(np.float64),
        adv_coefs=coefs,
        adv_coefs_3rd=coefs3,
    )


# ---------------------------------------------------------------------------
# cell-center vector reconstruction coefficients
# ---------------------------------------------------------------------------

def compute_reconstruct_coefficients(mesh: Mesh) -> np.ndarray:
    """coeffs_reconstruct[C, maxEdges, 3]: cell-center Cartesian velocity
    V(c) = sum_i coeffs[c, i, :] * u[edgesOnCell[c, i]].

    Tangent-plane least squares: minimize sum_i (n_i . V - u_i)^2 with V
    constrained tangent to the sphere at the cell center.  (The reference /
    MPAS use precomputed RBF coefficients, dynamics_tasks.rg:1921-1929; LSQ
    is used here as the TPU-native equivalent — exact for uniform flow and
    spectrally close to RBF on quasi-uniform CVT meshes.)
    """
    C, M = mesh.nCells, mesh.maxEdges
    rc = _unit_xyz(mesh.xCell, mesh.yCell, mesh.zCell)
    re = _unit_xyz(mesh.xEdge, mesh.yEdge, mesh.zEdge)
    pc = np.stack([mesh.xCell, mesh.yCell, mesh.zCell], axis=-1)

    # edge normal direction: cell1 -> cell2, projected tangent at the edge
    d = pc[mesh.cellsOnEdge[:, 1]] - pc[mesh.cellsOnEdge[:, 0]]   # [E, 3]
    d = d - np.einsum("ej,ej->e", d, re)[:, None] * re
    # (the norm is guarded against edges whose two cells coincide)
    nhat = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-300)

    east, north = _east_north(rc)                                  # [C, 3]
    ne = nhat[mesh.edgesOnCell]                                    # [C, M, 3]
    mask = mesh.edgesOnCell_mask                                   # [C, M]
    P = np.stack([np.einsum("cmj,cj->cm", ne, east),
                  np.einsum("cmj,cj->cm", ne, north)], axis=-1)    # [C, M, 2]
    P = P * mask[..., None]
    PtP = np.einsum("cmi,cmj->cij", P, P)
    PtP += 1e-12 * np.eye(2)
    B = np.linalg.solve(PtP, np.transpose(P, (0, 2, 1)))           # [C, 2, M]
    coeffs = (B[:, 0, :, None] * east[:, None, :] +
              B[:, 1, :, None] * north[:, None, :])                # [C, M, 3]
    return coeffs * mask[..., None]


# ---------------------------------------------------------------------------
# Smagorinsky deformation weights
# ---------------------------------------------------------------------------

def compute_deformation_weights(mesh: Mesh):
    """defc_a/defc_b [C, maxEdges] such that, with edge normal velocity u and
    tangential velocity v,
        d_diag     = sum_i defc_a*u - defc_b*v  ~  du/dx - dv/dy
        d_off_diag = sum_i defc_b*u + defc_a*v  ~  du/dy + dv/dx
    at the cell center (divergence-theorem line integral; the (2*angle)
    doubling comes from resolving the edge velocity vector into the local
    east/north frame).  Consumed by the Smagorinsky closure
    (dynamics_tasks.rg:858-890)."""
    sign = mesh.edgesOnCellSign * mesh.edgesOnCell_mask           # [C, M]
    le = mesh.dvEdge[mesh.edgesOnCell]                            # [C, M]
    ang = mesh.angleEdge[mesh.edgesOnCell]
    w = sign * le * mesh.invAreaCell[:, None]
    defc_a = w * np.cos(2.0 * ang)
    defc_b = w * np.sin(2.0 * ang)
    return defc_a, defc_b


# ---------------------------------------------------------------------------
# mesh scaling for del2/del4 dissipation
# ---------------------------------------------------------------------------

def compute_mesh_scaling(mesh: Mesh, scale_with_mesh: bool = False):
    """meshScalingDel2/Del4 [E] plus the regional relaxation-zone scalings
    meshScalingRegionalCell [C] / meshScalingRegionalEdge [E]
    (atm_compute_mesh_scaling, dynamics_tasks.rg:595-646)."""
    E, C = mesh.nEdges, mesh.nCells
    if not scale_with_mesh:
        return np.ones(E), np.ones(E), np.ones(C), np.ones(E)
    md = 0.5 * (mesh.meshDensity[mesh.cellsOnEdge[:, 0]] +
                mesh.meshDensity[mesh.cellsOnEdge[:, 1]])
    return (md ** -0.25, md ** -0.75,
            mesh.meshDensity ** -0.25, md ** -0.25)

