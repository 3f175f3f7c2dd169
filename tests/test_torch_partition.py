"""mpas_tpu_torch.parallel.{partition,native} against mpas_tpu's, on
generate_mesh(levels=3, lloyd_iterations=2) (642 cells): every array of
the partition (assignment, local sets and masks, global -> local maps, the
all-pairs exchange tables and the ppermute rounds) equal at S = 2, 4, 8 on
the numpy and the native path; the geometric partitioner, a METIS file,
remap, the halo's ring growth and the exchange accounting equal; the native
entry points equal to mpas_tpu's and to the numpy path."""

import numpy as np
import pytest

from mpas_tpu.config import Namelist as JNamelist
from mpas_tpu.mesh.generator import generate_mesh as j_generate
from mpas_tpu.parallel import native as JN
from mpas_tpu.parallel import partition as JP

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.mesh.generator import generate_mesh as t_generate
from mpas_tpu_torch.parallel import native as TN
from mpas_tpu_torch.parallel import partition as TP

SHARDS = (2, 4, 8)
ARRAYS = ("assignment", "cell_l2g", "cell_mask", "cell_owned_mask",
          "edge_l2g", "edge_mask", "edge_owned_mask", "vertex_l2g",
          "vertex_mask", "vertex_owned_mask", "cell_g2l", "edge_g2l",
          "vertex_g2l")
TABLE = ("send_idx", "send_mask", "recv_pos", "recv_is_halo")


@pytest.fixture(scope="module")
def meshes():
    return (j_generate(levels=3, lloyd_iterations=2),
            t_generate(levels=3, lloyd_iterations=2))


@pytest.fixture(scope="module")
def native_ok():
    if not (JN.available() and TN.available()):
        pytest.skip("no C++ compiler for the native library")


def same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def same_partition(a, b):
    assert a.n_shards == b.n_shards
    for name in ARRAYS:
        same_array(getattr(a, name), getattr(b, name), name)
    for ent in ("cell_x", "edge_x", "vertex_x"):
        x, y = getattr(a, ent), getattr(b, ent)
        assert x.max_send == y.max_send, ent
        for name in TABLE:
            same_array(getattr(x, name), getattr(y, name), f"{ent}.{name}")
        assert len(x.rounds) == len(y.rounds), ent
        for i, (r, s) in enumerate(zip(x.rounds, y.rounds)):
            assert r["perm"] == s["perm"], (ent, i)
            for k in ("send_idx", "send_mask", "recv_slot"):
                same_array(r[k], s[k], f"{ent}.rounds[{i}].{k}")


@pytest.mark.parametrize("S", SHARDS)
def test_build_partition_numpy_path_equal(meshes, S):
    a = JP.build_partition(meshes[0], S, use_native=False)
    b = TP.build_partition(meshes[1], S, use_native=False)
    same_partition(a, b)
    assert a.cell_x.rounds


@pytest.mark.parametrize("S", SHARDS)
def test_build_partition_native_path_equal(meshes, native_ok, S):
    a = JP.build_partition(meshes[0], S, use_native=True)
    b = TP.build_partition(meshes[1], S, use_native=True)
    same_partition(a, b)
    # the native path gives the numpy path's partition
    same_partition(b, TP.build_partition(meshes[1], S, use_native=False))


@pytest.mark.parametrize("S", SHARDS)
def test_geometric_partition_equal(meshes, native_ok, S):
    for use_native in (False, True):
        same_array(JP.geometric_partition(meshes[0], S, use_native),
                   TP.geometric_partition(meshes[1], S, use_native),
                   f"geometric use_native={use_native}")
    same_array(JN.rcb_partition(np.stack([meshes[0].xCell, meshes[0].yCell,
                                          meshes[0].zCell], 1), S),
               TN.rcb_partition(np.stack([meshes[1].xCell, meshes[1].yCell,
                                          meshes[1].zCell], 1), S), "rcb")


@pytest.mark.parametrize("S", [2, 4])
def test_native_rings_and_incident_entities_equal(meshes, native_ok, S):
    jm, tm = meshes
    assign = TP.geometric_partition(tm, S, use_native=False)
    nec = tm.nEdgesOnCell.astype(np.int32)
    for s in range(S):
        cells_j = JN.grow_rings(jm.cellsOnCell, nec, assign, s, TP.HALO_RINGS)
        cells_t = TN.grow_rings(tm.cellsOnCell, nec, assign, s, TP.HALO_RINGS)
        same_array(cells_j[0], cells_t[0], "grow_rings")
        assert cells_j[1] == cells_t[1] == int(np.sum(assign == s))
        # the numpy ring growth gives the same local set
        ordered, _ = TP._grow_rings(tm, np.where(assign == s)[0],
                                    TP.HALO_RINGS)
        assert np.array_equal(ordered, cells_t[0])
        owner = assign[tm.cellsOnEdge[:, 0]].astype(np.int32)
        ej = JN.incident_entities(jm.edgesOnCell, nec, cells_j[0], jm.nEdges,
                                  owner, s)
        et = TN.incident_entities(tm.edgesOnCell, nec, cells_t[0], tm.nEdges,
                                  owner, s)
        same_array(ej[0], et[0], "incident_entities")
        assert ej[1] == et[1]


def test_metis_file_and_partition_cells(meshes, tmp_path):
    mesh = meshes[1]
    part = (np.arange(mesh.nCells) * 7 // mesh.nCells).astype(np.int32)
    path = str(tmp_path / "graph.info.part.7")
    np.savetxt(path, part, fmt="%d")
    same_array(JP.read_metis_partition(path, mesh.nCells),
               TP.read_metis_partition(path, mesh.nCells), "metis")
    for S in (7, 4):       # the file's shard count is taken, another is not
        same_array(JP.partition_cells(meshes[0], S, path),
                   TP.partition_cells(mesh, S, path), f"partition_cells {S}")
    same_partition(JP.build_partition(meshes[0], 7, metis_path=path),
                   TP.build_partition(mesh, 7, metis_path=path))


def test_remap_and_exchange_bytes_equal(meshes):
    a = JP.build_partition(meshes[0], 4)
    b = TP.build_partition(meshes[1], 4)
    idx = meshes[1].cellsOnEdge[b.edge_l2g[1]]
    same_array(JP.remap(a.cell_g2l[1], idx), TP.remap(b.cell_g2l[1], idx),
               "remap")
    assert TP.remap(b.cell_g2l[1], idx).min() == 0
    for kw in (dict(), dict(config_number_of_sub_steps=6),
               dict(config_dynamics_split_steps=3)):
        for extra in (dict(), dict(bytes_per_value=8, n_scalars=6)):
            assert (JP.exchange_bytes_per_step(a, JNamelist(**kw), 41, **extra)
                    == TP.exchange_bytes_per_step(b, Namelist(**kw), 41,
                                                  **extra))
