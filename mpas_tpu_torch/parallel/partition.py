"""Domain decomposition: METIS-seeded (or geometric) cell partition ->
per-shard local meshes with multi-ring halos and exchange tables.

The port of `mpas_tpu.parallel.partition`, a numpy copy whose arrays are
mpas_tpu's, array for array. Where Legion derives private/shared/ghost
partitions from image/preimage operators at runtime
(mesh_loading.rg:399-483), the same halo topology is precomputed here into
dense index tables, which parallel/halo.py turns into one exchange per
field bundle: a column gather in one process, collectives across
processes.

Ring conventions (HALO_RINGS = 3):
  - cells: owned + rings 1..3 (the 2-ring advection stencil plus one ring of
    slack so a full dyn_tend chain — del2 -> del4 -> gradient — produces
    exact owned outputs from one stage-start exchange);
  - edges/vertices: all incident to local cells; owned by the owner of their
    first adjacent cell (cellsOnEdge[e,0] / cellsOnVertex[v,0]).

Entities outside the local set are remapped to slot 0 with their validity
masks left intact; the garbage this produces is confined to outer-ring
outputs that the exchange overwrites.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import numpy as np

from ..mesh.loader import Mesh
from . import native

HALO_RINGS = 3


def read_metis_partition(path: str, n_cells: int) -> np.ndarray:
    """Parse a gpmetis output file: one partition id per line
    (mesh_loading.rg:11-22, README.md 'Partitioning')."""
    part = np.loadtxt(path, dtype=np.int64)
    assert part.shape == (n_cells,), part.shape
    return part.astype(np.int32)


def geometric_partition(mesh: Mesh, n_shards: int,
                        use_native: bool | None = None) -> np.ndarray:
    """Recursive coordinate bisection on cell positions: a METIS-free
    fallback partitioner producing compact, balanced shards for any mesh.
    Uses the native C++ kernel (native/mesh_preprocess.cpp) when available."""
    xyz = np.stack([mesh.xCell, mesh.yCell, mesh.zCell], axis=1)
    if use_native is None:
        use_native = native.available()
    if use_native:
        return native.rcb_partition(xyz, n_shards)
    assign = np.zeros(mesh.nCells, dtype=np.int32)

    def split(idx, lo, hi):
        n = hi - lo
        if n == 1:
            assign[idx] = lo
            return
        n_left = n // 2
        pts = xyz[idx]
        spread = pts.max(0) - pts.min(0)
        axis = int(np.argmax(spread))
        order = np.argsort(pts[:, axis], kind="stable")
        k = int(round(len(idx) * n_left / n))
        split(idx[order[:k]], lo, lo + n_left)
        split(idx[order[k:]], lo + n_left, hi)

    split(np.arange(mesh.nCells), 0, n_shards)
    return assign


def partition_cells(mesh: Mesh, n_shards: int,
                    metis_path: str | None = None) -> np.ndarray:
    if metis_path is not None:
        part = read_metis_partition(metis_path, mesh.nCells)
        if part.max() + 1 == n_shards:
            return part
    return geometric_partition(mesh, n_shards)


@dataclass
class ExchangeTable:
    """Per-entity-type exchange plan (all arrays stacked over shards)."""
    send_idx: np.ndarray    # [S, S, max_send] local indices to send (0-padded)
    send_mask: np.ndarray   # [S, S, max_send]
    recv_pos: np.ndarray    # [S, L] position in flattened recv buffer (0 if none)
    recv_is_halo: np.ndarray  # [S, L] {0,1}
    max_send: int
    # neighbor-only ppermute schedule: list of rounds, each a dict with
    #   perm      tuple[(src, dst), ...]  (static)
    #   send_idx  [S, m_r] local indices to send this round (0-padded)
    #   send_mask [S, m_r]
    #   recv_slot [S, m_r] local slot to write (= L for padding -> dropped)
    rounds: list = None


@dataclass
class ShardedPartition:
    n_shards: int
    assignment: np.ndarray          # [C] global cell -> shard
    # local entity sets, 0-padded to the max local count over shards
    cell_l2g: np.ndarray            # [S, Lc]
    cell_mask: np.ndarray           # [S, Lc] {0,1} real local cell
    cell_owned_mask: np.ndarray     # [S, Lc]
    edge_l2g: np.ndarray            # [S, Le]
    edge_mask: np.ndarray
    edge_owned_mask: np.ndarray
    vertex_l2g: np.ndarray          # [S, Lv]
    vertex_mask: np.ndarray
    vertex_owned_mask: np.ndarray
    # global -> local maps (-1 where not local)
    cell_g2l: np.ndarray            # [S, C]
    edge_g2l: np.ndarray            # [S, E]
    vertex_g2l: np.ndarray          # [S, V]
    # exchange plans
    cell_x: ExchangeTable = None
    edge_x: ExchangeTable = None
    vertex_x: ExchangeTable = None


def _grow_rings(mesh: Mesh, owned: np.ndarray, rings: int):
    """Return (ordered local cells, in_local bool[C]) with owned first then
    rings 1..`rings` in order (sorted within each ring; identical output from
    the native and numpy paths)."""
    in_local = np.zeros(mesh.nCells, dtype=bool)
    in_local[owned] = True
    ordered = [owned]
    frontier = owned
    for _ in range(rings):
        nbrs = mesh.cellsOnCell[frontier]
        valid = mesh.edgesOnCell_mask[frontier] > 0
        cand = np.unique(nbrs[valid])
        new = cand[~in_local[cand]]
        in_local[new] = True
        ordered.append(np.sort(new))
        frontier = new
    return np.concatenate(ordered), in_local


def _build_exchange(l2g_list, owned_counts, owner_of, g2l, n_shards):
    """Build an ExchangeTable from per-shard local->global lists."""
    # collect (owner d, receiver s, global id g) triples for all halo entities
    sends = {}  # (d, s) -> list of d-local indices, aligned with receiver order
    recv_entries = []  # per shard: list of (local_slot, d, position)
    for s in range(n_shards):
        l2g = l2g_list[s]
        n_own = owned_counts[s]
        for slot in range(n_own, len(l2g)):
            g = l2g[slot]
            d = owner_of[g]
            lst = sends.setdefault((d, s), [])
            pos = len(lst)
            lst.append(g2l[d][g])
            recv_entries.append((s, slot, d, pos))

    max_send = max((len(v) for v in sends.values()), default=1)
    max_send = max(max_send, 1)
    L = max(len(l) for l in l2g_list)
    send_idx = np.zeros((n_shards, n_shards, max_send), dtype=np.int32)
    send_mask = np.zeros((n_shards, n_shards, max_send))
    for (d, s), lst in sends.items():
        send_idx[d, s, :len(lst)] = lst
        send_mask[d, s, :len(lst)] = 1.0
    recv_pos = np.zeros((n_shards, L), dtype=np.int32)
    recv_is_halo = np.zeros((n_shards, L))
    for (s, slot, d, pos) in recv_entries:
        recv_pos[s, slot] = d * max_send + pos
        recv_is_halo[s, slot] = 1.0

    # ---- neighbor-only ppermute schedule ----
    # Greedy edge-coloring of the communication digraph: within a round every
    # shard sends to <=1 peer and receives from <=1 peer, so each round is one
    # point-to-point exchange whose message is sized to that round's largest
    # pair — no all-pairs padding.  Receiver slot lists are aligned with the sender's
    # `sends[(d, s)]` ordering (position `pos` above).
    recv_slots = {}  # (d, s) -> [receiver local slots], aligned with sends
    for (s, slot, d, pos) in recv_entries:
        recv_slots.setdefault((d, s), []).append((pos, slot))
    rounds_pairs: list[list] = []
    for (d, s), lst in sorted(sends.items(), key=lambda kv: -len(kv[1])):
        placed = False
        for rp in rounds_pairs:
            if all(d != d2 and s != s2 for (d2, s2) in rp):
                rp.append((d, s))
                placed = True
                break
        if not placed:
            rounds_pairs.append([(d, s)])
    rounds = []
    for rp in rounds_pairs:
        m = max(len(sends[pair]) for pair in rp)
        r_send_idx = np.zeros((n_shards, m), dtype=np.int32)
        r_send_mask = np.zeros((n_shards, m))
        r_recv_slot = np.full((n_shards, m), L, dtype=np.int32)  # L = dropped
        for (d, s) in rp:
            lst = sends[(d, s)]
            r_send_idx[d, :len(lst)] = lst
            r_send_mask[d, :len(lst)] = 1.0
            for pos, slot in recv_slots[(d, s)]:
                r_recv_slot[s, pos] = slot
        rounds.append(dict(perm=tuple(rp), send_idx=r_send_idx,
                           send_mask=r_send_mask, recv_slot=r_recv_slot))

    return ExchangeTable(send_idx=send_idx, send_mask=send_mask,
                         recv_pos=recv_pos, recv_is_halo=recv_is_halo,
                         max_send=max_send, rounds=rounds)


def build_partition(mesh: Mesh, n_shards: int,
                    metis_path: str | None = None,
                    assignment: np.ndarray | None = None,
                    rings: int = HALO_RINGS,
                    use_native: str | bool = "auto") -> ShardedPartition:
    """`use_native`: True / False / "auto" — the C++ halo-growth and
    incident-entity kernels (native/mesh_preprocess.cpp) produce identical
    output to the numpy path (tested) and are used automatically for large
    meshes where the per-shard python loop dominates setup time."""
    if assignment is None:
        assignment = partition_cells(mesh, n_shards, metis_path)
    S = n_shards

    from . import native as native_mod
    if use_native == "auto":
        use_native = mesh.nCells >= 100_000 and native_mod.available()
    elif use_native and not native_mod.available():
        import warnings
        warnings.warn("build_partition(use_native=True) requested but the "
                      "native library is unavailable; using the numpy path "
                      "(identical output, slower setup)", RuntimeWarning)
        use_native = False

    edge_owner = assignment[mesh.cellsOnEdge[:, 0]]
    vertex_owner = assignment[mesh.cellsOnVertex[:, 0]]

    nEdgesOnCell = np.ascontiguousarray(mesh.nEdgesOnCell, dtype=np.int32)
    assign32 = np.ascontiguousarray(assignment, dtype=np.int32)

    cell_lists, cell_own_counts = [], []
    edge_lists, edge_own_counts = [], []
    vert_lists, vert_own_counts = [], []
    for s in range(S):
        if use_native:
            cells, n_owned_c = native_mod.grow_rings(
                mesh.cellsOnCell, nEdgesOnCell, assign32, s, rings)
            cell_lists.append(cells.astype(np.int64))
            cell_own_counts.append(n_owned_c)
            edges, n_owned_e = native_mod.incident_entities(
                mesh.edgesOnCell, nEdgesOnCell, cells, mesh.nEdges,
                edge_owner.astype(np.int32), s)
            edge_lists.append(edges.astype(np.int64))
            edge_own_counts.append(n_owned_e)
            verts, n_owned_v = native_mod.incident_entities(
                mesh.verticesOnCell, nEdgesOnCell, cells, mesh.nVertices,
                vertex_owner.astype(np.int32), s)
            vert_lists.append(verts.astype(np.int64))
            vert_own_counts.append(n_owned_v)
            continue
        owned = np.where(assignment == s)[0].astype(np.int64)
        cells, in_local = _grow_rings(mesh, owned, rings)
        cell_lists.append(cells)
        cell_own_counts.append(len(owned))

        # incident edges/vertices, owned-first ordering
        e_all = np.unique(mesh.edgesOnCell[cells][mesh.edgesOnCell_mask[cells] > 0])
        e_owned = e_all[edge_owner[e_all] == s]
        e_halo = e_all[edge_owner[e_all] != s]
        edge_lists.append(np.concatenate([e_owned, e_halo]))
        edge_own_counts.append(len(e_owned))

        v_all = np.unique(mesh.verticesOnCell[cells][mesh.edgesOnCell_mask[cells] > 0])
        v_owned = v_all[vertex_owner[v_all] == s]
        v_halo = v_all[vertex_owner[v_all] != s]
        vert_lists.append(np.concatenate([v_owned, v_halo]))
        vert_own_counts.append(len(v_owned))

    def stack(lists, own_counts, N):
        L = max(len(l) for l in lists)
        l2g = np.zeros((S, L), dtype=np.int32)
        mask = np.zeros((S, L))
        owned_mask = np.zeros((S, L))
        g2l = np.full((S, N), -1, dtype=np.int32)
        for s, l in enumerate(lists):
            l2g[s, :len(l)] = l
            mask[s, :len(l)] = 1.0
            owned_mask[s, :own_counts[s]] = 1.0
            g2l[s, l] = np.arange(len(l), dtype=np.int32)
        return l2g, mask, owned_mask, g2l

    cell_l2g, cell_mask, cell_owned_mask, cell_g2l = stack(
        cell_lists, cell_own_counts, mesh.nCells)
    edge_l2g, edge_mask, edge_owned_mask, edge_g2l = stack(
        edge_lists, edge_own_counts, mesh.nEdges)
    vertex_l2g, vertex_mask, vertex_owned_mask, vertex_g2l = stack(
        vert_lists, vert_own_counts, mesh.nVertices)

    p = ShardedPartition(
        n_shards=S, assignment=assignment,
        cell_l2g=cell_l2g, cell_mask=cell_mask, cell_owned_mask=cell_owned_mask,
        edge_l2g=edge_l2g, edge_mask=edge_mask, edge_owned_mask=edge_owned_mask,
        vertex_l2g=vertex_l2g, vertex_mask=vertex_mask,
        vertex_owned_mask=vertex_owned_mask,
        cell_g2l=cell_g2l, edge_g2l=edge_g2l, vertex_g2l=vertex_g2l)

    p.cell_x = _build_exchange(cell_lists, cell_own_counts, assignment,
                               cell_g2l, S)
    p.edge_x = _build_exchange(edge_lists, edge_own_counts, edge_owner,
                               edge_g2l, S)
    p.vertex_x = _build_exchange(vert_lists, vert_own_counts, vertex_owner,
                                 vertex_g2l, S)
    return p


def remap(g2l_row: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Remap global adjacency indices to shard-local (missing -> 0)."""
    out = g2l_row[idx]
    return np.where(out < 0, 0, out).astype(np.int32)


def exchange_bytes_per_step(p: "ShardedPartition", nl, K: int,
                            bytes_per_value: int = 4,
                            n_scalars: int = 0,
                            halo_rings: int = HALO_RINGS) -> dict:
    """Communication accounting for one SRK3 step under the ROUND-4
    schedule wired into dynamics/srk3.py (packed exchanges; tendencies
    exchanged once per RK stage; acoustic loop collective-free while
    ns + 1 <= halo rings):

      - refresh_state (8 cell + 2 edge fields, packed into 2 collectives)
        at every RK-stage top: 3 per dynamics substep;
      - refresh_tend (3 cell + 1 edge, 2 collectives) once per RK stage,
        OR the legacy per-acoustic-substep refresh_acoustic (4 cell +
        1 edge) for stages whose substep count exceeds the halo depth;
      - scalar refresh (n_scalars + 2 cell fields + 1 edge, 2 collectives)
        once per step when transported.

    Returns totals, exchange/collective counts, and the per-entity
    single-field volumes."""
    def vol(x):     # one exchange of one [K]-deep field, all shards [bytes]
        return float(np.asarray(x.send_mask).sum()) * K * bytes_per_value

    cell_v, edge_v = vol(p.cell_x), vol(p.edge_x)
    split = getattr(nl, "config_dynamics_split_steps", 1)
    n_sub = getattr(nl, "config_number_of_sub_steps", 2)
    stage_ns = [max(1, n_sub // 2), max(1, n_sub // 2), n_sub]
    state_refreshes = 3 * split
    tend_refreshes = sum(1 for ns in stage_ns if ns + 1 <= halo_rings) * split
    acoustic_refreshes = sum(ns for ns in stage_ns
                             if ns + 1 > halo_rings) * split
    total = (state_refreshes * (8 * cell_v + 2 * edge_v)
             + tend_refreshes * (3 * cell_v + 1 * edge_v)
             + acoustic_refreshes * (4 * cell_v + 1 * edge_v))
    exchanges = 2 * (state_refreshes + tend_refreshes + acoustic_refreshes)
    if n_scalars:
        total += (n_scalars + 2) * cell_v + edge_v
        exchanges += 2
    rounds_c = len(p.cell_x.rounds or []) or 1
    rounds_e = len(p.edge_x.rounds or []) or 1
    collectives = (exchanges // 2) * (rounds_c + rounds_e)
    return dict(cell_field_bytes=cell_v, edge_field_bytes=edge_v,
                state_refreshes=state_refreshes,
                tend_refreshes=tend_refreshes,
                acoustic_refreshes=acoustic_refreshes,
                packed_exchanges=exchanges, collectives=collectives,
                rounds_cell=rounds_c, rounds_edge=rounds_e,
                total_bytes_per_step=total)
