"""The yardstick's frozen work counts and the card's published peaks.

Each count is a lower bound on what the work needs, computed from sizes
alone, the same whatever implements it: every input byte read once, every
output byte written once. A roofline share is the least time the card could
take (the larger of bytes over peak bandwidth and operations over peak rate)
over the time measured, so it cannot pass 100% unless a count is too high or
a time leaves out part of the work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the dense rates outside
# the tensor cores (the dycore does no matrix multiplication), at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# floating-point operations per column and level of the acoustic column
# update (the rs/ts assembly and the right-hand side ~37, the two sweeps 4,
# the damping, wwAvg and the recovery ~23)
ACOUSTIC_FLOPS_PER_POINT = 64


def bound_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: bytes at peak bandwidth or
    operations at peak rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def acoustic_column(K: int, C: int, itemsize: int):
    """(bytes, flops) of one call of the acoustic column update on K levels
    of C columns, as the step calls it (the rho and theta tendencies folded
    into rs0 and ts0 by the caller). Read: rs0, ts0, rho_pp, rtheta_pp, zz
    and cofwt on levels [K, C]; rw_p, wwAvg, tend_w, dss_i, zz_rho_i, w,
    dw_save and the coefficients cofwz, coftz, cofwr, a_tri, alpha_tri,
    gamma_tri on interfaces [K+1, C]; cofrz [K]. Written: rho_pp and
    rtheta_pp [K, C], rw_p and wwAvg [K+1, C]."""
    level, iface = K * C, (K + 1) * C
    read = 6 * level + 13 * iface + K
    written = 2 * level + 2 * iface
    return itemsize * (read + written), ACOUSTIC_FLOPS_PER_POINT * level


def acoustic_substeps(n_sub: int):
    """Acoustic substeps of the three RK stages of one dynamics step."""
    return [max(1, n_sub // 2), max(1, n_sub // 2), n_sub]


def step(sizes: dict):
    """(bytes, flops) of one model step, from the cell's sizes alone:
    nCells C, nEdges E, nVertices V, levels K, maxEdges, maxEdges2, the
    acoustic substeps a stage `n_sub`, the dynamics split steps `split`,
    the transported species `n_scalars`, the element size `itemsize` and
    the index size `index_itemsize`.

    Counted, each once where it must be:
      - each RK stage (3 per dynamics split step) reads the prognostic
        state u [K, E], w [K+1, C], theta_m and rho_zz [K, C] and writes
        the stage's new state of the same sizes;
      - each acoustic substep reads and writes the acoustic perturbations
        ru_p [K, E], rw_p [K+1, C], rho_pp and rtheta_pp [K, C];
      - the step reads once the 3-D metrics zz, rho_base, theta_base,
        rtheta_base, exner_base, pressure_base [K, C], zxu [K, E] and the
        Rayleigh damping dss [K+1, C];
      - the step reads once the mesh tables the horizontal operators need:
        cellsOnEdge, verticesOnEdge [E, 2], edgesOnEdge and weightsOnEdge
        [E, maxEdges2], edgesOnCell, cellsOnCell [C, maxEdges],
        edgesOnVertex, cellsOnVertex [V, 3] (indices), and dcEdge, dvEdge,
        angleEdge, fEdge [E], areaCell [C], areaTriangle, fVertex [V]
        (geometry);
      - with transported species, the step reads and writes scalars
        [n_scalars, K, C] once.
    Operations: the acoustic column update's, for each acoustic substep.
    Everything else the step does is left out, so the count is a lower
    bound and the share it gives an upper bound on none of the work."""
    C, E, V, K = sizes["nCells"], sizes["nEdges"], sizes["nVertices"], sizes["K"]
    item, idx = sizes["itemsize"], sizes["index_itemsize"]
    stages = 3 * sizes["split"]
    substeps = sum(acoustic_substeps(sizes["n_sub"])) * sizes["split"]
    state = K * E + (K + 1) * C + 2 * K * C
    elements = 2 * state * stages + 2 * state * substeps
    elements += 6 * K * C + K * E + (K + 1) * C
    elements += 2 * sizes["n_scalars"] * K * C
    # weightsOnEdge; dcEdge, dvEdge, angleEdge, fEdge; areaCell;
    # areaTriangle, fVertex
    geometry = E * sizes["maxEdges2"] + 4 * E + C + 2 * V
    # cellsOnEdge, verticesOnEdge; edgesOnEdge; edgesOnCell, cellsOnCell;
    # edgesOnVertex, cellsOnVertex
    tables = (4 * E + E * sizes["maxEdges2"] + 2 * C * sizes["maxEdges"]
              + 6 * V)
    nbytes = item * (elements + geometry) + idx * tables
    flops = ACOUSTIC_FLOPS_PER_POINT * K * C * substeps
    return nbytes, flops


# floating-point operations of Kernel 5 (csrc/sediment.cu) a level and
# substep for each fall law (its pow counted as one); a level and substep
# adds 7 more (the flux 2, the update 5), a substep 2 (the surface sum), a
# level 4 once (rhofac and rho dz)
SEDIMENT_LAW_FLOPS = {"rain": 7, "snow": 6, "graupel": 7}
# the species each microphysics scheme sediments, by fall law
FALLING = {"kessler": ("rain",), "wsm6lite": ("rain", "snow"),
           "wsm6": ("rain", "snow", "graupel")}


def sediment(K: int, C: int, laws, nfall: int, itemsize: int):
    """(bytes, flops) of one sedimentation of the species with fall laws
    `laws` through all `nfall` substeps, on K levels of C columns. Read:
    rho and dz [K, C] once, each species' q [K, C]; written: each species'
    new q [K, C] and surface accumulation [C]."""
    S = len(laws)
    nbytes = itemsize * (2 * K * C + 2 * S * K * C + S * C)
    flops = sum(C * (nfall * (K * (SEDIMENT_LAW_FLOPS[law] + 7) + 2) + 4 * K)
                for law in laws)
    return nbytes, flops
