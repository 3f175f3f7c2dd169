"""MPAS grid-file writer.

Completes the write_output round-trip parity (mesh_loading.rg:490-807: the
reference writes the loaded mesh back to `newfile.nc` "to test that we have
read the file correctly") and makes generated CVT meshes (mesh/generator.py)
persistable as standard MPAS grid netCDF files consumable by this framework
and by stock MPAS tooling.  Coordinates are stored on the unit sphere like
the bundled x1.* files (the loader rescales on ingest).
"""

from __future__ import annotations

import numpy as np

from .loader import Mesh, load_mesh
from .netcdf_io import write_netcdf


def save_grid(mesh: Mesh, path: str):
    """Write `mesh` as an MPAS grid.nc (netCDF classic, 1-based indices)."""
    a = mesh.sphere_radius
    C, E, V = mesh.nCells, mesh.nEdges, mesh.nVertices
    M, M2, D = mesh.maxEdges, mesh.maxEdges2, mesh.vertexDegree

    def one_based(idx, mask=None):
        out = idx.astype(np.int32) + 1
        if mask is not None:
            out = np.where(mask > 0, out, 0)
        return out

    dims = {
        "Time": None,          # unlimited must come first (netCDF classic)
        "nCells": C, "nEdges": E, "nVertices": V,
        "maxEdges": M, "maxEdges2": M2, "vertexDegree": D, "TWO": 2,
        "nVertLevels": 1,
    }
    variables = {
        "latCell": (("nCells",), mesh.latCell),
        "lonCell": (("nCells",), mesh.lonCell),
        "xCell": (("nCells",), mesh.xCell / a),
        "yCell": (("nCells",), mesh.yCell / a),
        "zCell": (("nCells",), mesh.zCell / a),
        "indexToCellID": (("nCells",), np.arange(1, C + 1, dtype=np.int32)),
        "latEdge": (("nEdges",), mesh.latEdge),
        "lonEdge": (("nEdges",), mesh.lonEdge),
        "xEdge": (("nEdges",), mesh.xEdge / a),
        "yEdge": (("nEdges",), mesh.yEdge / a),
        "zEdge": (("nEdges",), mesh.zEdge / a),
        "indexToEdgeID": (("nEdges",), np.arange(1, E + 1, dtype=np.int32)),
        "latVertex": (("nVertices",), mesh.latVertex),
        "lonVertex": (("nVertices",), mesh.lonVertex),
        "xVertex": (("nVertices",), mesh.xVertex / a),
        "yVertex": (("nVertices",), mesh.yVertex / a),
        "zVertex": (("nVertices",), mesh.zVertex / a),
        "indexToVertexID": (("nVertices",), np.arange(1, V + 1, dtype=np.int32)),
        "nEdgesOnCell": (("nCells",), mesh.nEdgesOnCell.astype(np.int32)),
        "nEdgesOnEdge": (("nEdges",), mesh.nEdgesOnEdge.astype(np.int32)),
        "cellsOnCell": (("nCells", "maxEdges"),
                        one_based(mesh.cellsOnCell, mesh.edgesOnCell_mask)),
        "edgesOnCell": (("nCells", "maxEdges"),
                        one_based(mesh.edgesOnCell, mesh.edgesOnCell_mask)),
        "verticesOnCell": (("nCells", "maxEdges"),
                           one_based(mesh.verticesOnCell, mesh.edgesOnCell_mask)),
        "cellsOnEdge": (("nEdges", "TWO"), one_based(mesh.cellsOnEdge)),
        "verticesOnEdge": (("nEdges", "TWO"), one_based(mesh.verticesOnEdge)),
        "edgesOnEdge": (("nEdges", "maxEdges2"),
                        one_based(mesh.edgesOnEdge, mesh.edgesOnEdge_mask)),
        "cellsOnVertex": (("nVertices", "vertexDegree"),
                          one_based(mesh.cellsOnVertex)),
        "edgesOnVertex": (("nVertices", "vertexDegree"),
                          one_based(mesh.edgesOnVertex)),
        "weightsOnEdge": (("nEdges", "maxEdges2"), mesh.weightsOnEdge),
        "dvEdge": (("nEdges",), mesh.dvEdge / a),
        "dv1Edge": (("nEdges",), mesh.dvEdge / a),
        "dv2Edge": (("nEdges",), mesh.dvEdge / a),
        "dcEdge": (("nEdges",), mesh.dcEdge / a),
        "angleEdge": (("nEdges",), mesh.angleEdge),
        "areaCell": (("nCells",), mesh.areaCell / a ** 2),
        "areaTriangle": (("nVertices",), mesh.areaTriangle / a ** 2),
        "kiteAreasOnVertex": (("nVertices", "vertexDegree"),
                              mesh.kiteAreasOnVertex / a ** 2),
        "meshDensity": (("nCells",), mesh.meshDensity),
    }
    write_netcdf(path, dims, variables,
                 attrs={"on_a_sphere": b"YES", "sphere_radius": 1.0,
                        "mesh_spec": b"1.0"})
    return path


def generate_and_cache(levels: int, cache_dir: str = None,
                       sphere_radius: float = None, **kw) -> Mesh:
    """Generate (or load a cached) CVT mesh of the given refinement level.
    `sphere_radius` scales the unit-sphere cache on load (small-planet
    DCMIP-style cases pass 6371229/X). A freshly generated mesh is written
    and read back, so every call returns the cached file's mesh: the scaling
    to the unit sphere and back moves the coordinates and areas by rounding,
    and a run resumed from a checkpoint must see the mesh of the run that
    wrote it. The file is written under a temporary name and renamed, so
    processes that start together (one per shard) never read a partial
    one."""
    import os
    import tempfile
    from .generator import generate_mesh
    from .. import constants
    cache_dir = cache_dir or os.path.expanduser("~/.cache/mpas_tpu_torch_meshes")
    os.makedirs(cache_dir, exist_ok=True)
    n = 10 * 4 ** levels + 2
    path = os.path.join(cache_dir, f"x1.{n}.grid.nc")
    radius = sphere_radius or constants.sphere_radius
    if os.path.exists(path):
        return load_mesh(path, sphere_radius=radius)
    fd, tmp = tempfile.mkstemp(suffix=".nc", dir=cache_dir)
    os.close(fd)
    try:
        save_grid(generate_mesh(levels=levels, sphere_radius=radius, **kw), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return load_mesh(path, sphere_radius=radius)
