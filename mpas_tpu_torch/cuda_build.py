"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process (gather_reduce.cu by two,
one per element type), all started together, for `sm_90a` into an object
file; the objects link into one shared library with
a plain C interface, loaded with `ctypes`. The library lands in
`mpas_tpu_torch/_build/` under a name that carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import: the first launch of a kernel builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# (source, extra flags, object name): gather_reduce.cu compiles once per
# element type, so that its two sets of instantiations build side by side
SOURCES = (("acoustic_column.cu", (), "acoustic_column"),
           ("gather_reduce.cu", ("-DGATHER_REDUCE_F32",), "gather_reduce_f32"),
           ("gather_reduce.cu", ("-DGATHER_REDUCE_F64",), "gather_reduce_f64"),
           ("windowed_reduce.cu", (), "windowed_reduce"),
           ("take_columns.cu", (), "take_columns"))
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found: building the kernels needs the "
                           "CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for name, flags, obj in SOURCES:
        h.update(" ".join((name, *flags, obj)).encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmpas_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources into the shared library unless it exists.
    Returns its path; the compiler's register/spill report is written next
    to it as `ptxas_<hash>.log`."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src, flags, stem in SOURCES:
            name = stem + ".o"
            obj = Path(tmp) / name
            cmd = [nvcc, *ARCH, *FLAGS, *flags, "-c", str(CSRC / src), "-o",
                   str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        tmp_lib = Path(tmp) / lib.name
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
                *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        (BUILD_DIR / f"ptxas_{_digest()}.log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib)
    return lib


def ptxas_report() -> dict:
    """What `ptxas -v` said of each kernel of the built library, by object:
    {object: [{"kernel", "registers", "smem_bytes", "spill_bytes"}, ...]},
    `smem_bytes` the static shared memory. Kernel names are demangled where
    the toolkit's cu++filt is at hand and cut before their argument list."""
    build()
    text = (BUILD_DIR / f"ptxas_{_digest()}.log").read_text()
    report: dict = {}
    for block in text.split("== ")[1:]:
        source, _, body = block.partition("\n")
        rows = []
        for part in body.split("Compiling entry function '")[1:]:
            name = part.split("'", 1)[0]
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                               r"loads", part)
            regs = re.search(r"Used (\d+) registers", part)
            smem = re.search(r"(\d+) bytes smem", part)
            rows.append({"kernel": name,
                         "registers": int(regs.group(1)) if regs else None,
                         "smem_bytes": int(smem.group(1)) if smem else 0,
                         "spill_bytes": (int(spills.group(1))
                                         + int(spills.group(2))) if spills
                         else None})
        report[source.strip()] = rows
    names = [r["kernel"] for rows in report.values() for r in rows]
    filt = Path(_nvcc()).parent / "cu++filt"
    if names and filt.exists():
        res = subprocess.run([str(filt), *names], capture_output=True,
                             text=True)
        plain = res.stdout.splitlines()
        if res.returncode == 0 and len(plain) == len(names):
            short = iter(re.split(r"\((?!int\))", n)[0].replace("(int)", "")
                         .replace("<unnamed>::", "").replace("void ", "")
                         for n in plain)
            for rows in report.values():
                for r in rows:
                    r["kernel"] = next(short)
    return report


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"acoustic_column_update_{suffix}")
        fn.argtypes = [_P] * 26 + [_I, _I, _D, _D, _P]
        fn.restype = _I
        for form in ("direct", "rows"):
            fn = getattr(lib, f"gather_reduce_{form}_{suffix}")
            fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
            fn.restype = _I
        fn = getattr(lib, f"transpose_table_{suffix}")
        fn.argtypes = [_P, _P, _I, _I, _I, _P]
        fn.restype = _I
        fn = getattr(lib, f"take_columns_{suffix}")
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        fn.restype = _I
    lib.windowed_reduce_f32.argtypes = [_P] * 6 + [_I] * 10 + [_P]
    lib.windowed_reduce_f32.restype = _I
    lib.mpas_cuda_error_string.argtypes = [_I]
    lib.mpas_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if code != 0:
        msg = library().mpas_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
