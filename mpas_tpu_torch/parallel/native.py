"""ctypes bindings for the native mesh-preprocessing library.

The port of `mpas_tpu.parallel.native`. mpas_tpu builds
native/libmpas_mesh.so with `make -C native`; here g++ compiles
native/mesh_preprocess.cpp into mpas_tpu_torch/_build/ (gitignored), under a
name that carries a hash of the source and the flags, and never writes into
native/. `load_library()` returns None where there is no compiler, the
build fails or the library does not load; callers then treat the native
path as unavailable (`available()`), and parallel/partition.py takes its
numpy path, whose output is the same. The entry points: recursive
coordinate bisection (`rcb_partition`), multi-ring halo growth
(`grow_rings`) and incident-entity collection (`incident_entities`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mesh_preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmpas_mesh_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile the source into `lib` (written to a temporary name first, so
    processes that build at once do not see a partial file)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        try:
            res = subprocess.run([cxx, *FLAGS, "-o", str(out), str(SOURCE)],
                                 capture_output=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if res.returncode != 0:
            return False
        os.replace(out, lib)
    return True


@functools.cache
def load_library():
    """The loaded library, or None where it cannot be built or loaded.
    Callers declare the argument types of the entry points they use."""
    if not SOURCE.exists():
        return None
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


@functools.cache
def _partition_lib():
    """The library with the partitioning entry points' argument types
    declared, or None."""
    lib = load_library()
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.mpas_rcb_partition.argtypes = [f64p, ctypes.c_int64, ctypes.c_int32,
                                       i32p]
    lib.mpas_rcb_partition.restype = None
    lib.mpas_grow_rings.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                                    i32p, ctypes.c_int32, ctypes.c_int32,
                                    i32p, ctypes.c_int64, i64p]
    lib.mpas_grow_rings.restype = ctypes.c_int64
    lib.mpas_incident_entities.argtypes = [i32p, i32p, ctypes.c_int32, i32p,
                                           ctypes.c_int64, ctypes.c_int64,
                                           i32p, ctypes.c_int32, i32p,
                                           ctypes.c_int64, i64p]
    lib.mpas_incident_entities.restype = ctypes.c_int64
    return lib


def _lib():
    lib = _partition_lib()
    if lib is None:
        raise RuntimeError("the native mesh library is unavailable "
                           "(no C++ compiler, or the build failed)")
    return lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def available() -> bool:
    return _partition_lib() is not None


def rcb_partition(xyz: np.ndarray, n_parts: int) -> np.ndarray:
    """Native recursive coordinate bisection; xyz [C, 3] float64."""
    lib = _lib()
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    out = np.zeros(len(xyz), dtype=np.int32)
    lib.mpas_rcb_partition(_ptr(xyz, ctypes.c_double), len(xyz), n_parts,
                           _ptr(out, ctypes.c_int32))
    return out


def grow_rings(cells_on_cell, n_edges_on_cell, assign, shard: int, rings: int):
    """Native multi-ring halo growth; returns (local_cells, n_owned)."""
    lib = _lib()
    coc = np.ascontiguousarray(cells_on_cell, dtype=np.int32)
    nec = np.ascontiguousarray(n_edges_on_cell, dtype=np.int32)
    asn = np.ascontiguousarray(assign, dtype=np.int32)
    C, M = coc.shape
    out = np.zeros(C, dtype=np.int32)
    offs = np.zeros(rings + 1, dtype=np.int64)
    n = lib.mpas_grow_rings(_ptr(coc, ctypes.c_int32), _ptr(nec, ctypes.c_int32),
                            C, M, _ptr(asn, ctypes.c_int32), shard, rings,
                            _ptr(out, ctypes.c_int32), C,
                            _ptr(offs, ctypes.c_int64))
    if n < 0:
        raise RuntimeError(f"mpas_grow_rings failed ({n})")
    return out[:n].copy(), int(offs[0])


def incident_entities(ent_on_cell, n_on_cell, local_cells, n_ent, owner,
                      shard: int):
    """Native incident-entity collection; returns (entities, n_owned)."""
    lib = _lib()
    eoc = np.ascontiguousarray(ent_on_cell, dtype=np.int32)
    lc = np.ascontiguousarray(local_cells, dtype=np.int32)
    own = np.ascontiguousarray(owner, dtype=np.int32)
    width = eoc.shape[1]
    noc = (np.ascontiguousarray(n_on_cell, dtype=np.int32)
           if n_on_cell is not None else None)
    out = np.zeros(n_ent, dtype=np.int32)
    n_owned = np.zeros(1, dtype=np.int64)
    n = lib.mpas_incident_entities(
        _ptr(eoc, ctypes.c_int32),
        _ptr(noc, ctypes.c_int32) if noc is not None else None,
        width, _ptr(lc, ctypes.c_int32), len(lc), n_ent,
        _ptr(own, ctypes.c_int32), shard, _ptr(out, ctypes.c_int32),
        n_ent, _ptr(n_owned, ctypes.c_int64))
    if n < 0:
        raise RuntimeError(f"mpas_incident_entities failed ({n})")
    return out[:n].copy(), int(n_owned[0])
