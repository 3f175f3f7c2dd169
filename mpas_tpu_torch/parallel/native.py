"""ctypes loader for the native mesh-preprocessing library.

The port of `mpas_tpu.parallel.native.load_library`. mpas_tpu builds
native/libmpas_mesh.so with `make -C native`; here g++ compiles
native/mesh_preprocess.cpp into mpas_tpu_torch/_build/ (gitignored), under a
name that carries a hash of the source and the flags, and never writes into
native/. `load_library()` returns None where there is no compiler, the
build fails or the library does not load; callers then treat the native
path as unavailable. Its partitioning entry points (rcb_partition,
grow_rings, incident_entities) are bound with the multi-GPU path.
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
